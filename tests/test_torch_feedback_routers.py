"""The rest of the feedback family and the MoE routers against ``vsr_tpu``,
on the same numpy-seeded inputs and weights:

- the sub-pixel transposed conv against ``F.conv_transpose2d`` and against
  ``vsr_tpu.ops.subpixel``;
- ``DRFSISRNet`` (forward, gradients, the flax tree), ``DRFNet`` with
  experts, sub-pixel deconvs and ``remat``, ``SRFBNet`` with sub-pixel
  deconvs and bf16 ``carry_f32``, ``RBPNet`` with sub-pixel deconvs,
  ``FRVSRNet`` with ``remat``;
- ``topk_mask`` and the ``sort`` / ``radix`` routers and the ``dense_nhwc``
  dispatch (selection masks first, ties included, then outputs);
- frame serving of the step-stacked feedback nets, and ``DRFSISRNet``
  through the SRFB trainers.

Cases are grouped (``tests/_torch_cases.run_cases``): ROADMAP.md, queue 3.
Widths are tiny (F = 8, G = 2, 2 steps); JAX runs jitted.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests._torch_cases import run_cases
from tests._torch_parity import (FORWARD_TOL, first, hold_train_step, init,
                                 last, randomize, window)
from tests.synth import make_processed_tree
from tests.test_torch_device_trainer import (_epoch_draws, _hold_params,
                                             _jax_step_losses)
from vsr_tpu import infer as jinfer
from vsr_tpu import losses as jlosses
from vsr_tpu import metrics as jmetrics
from vsr_tpu import optim as joptim
from vsr_tpu.callbacks.monitor import Monitor as JaxMonitor
from vsr_tpu.data import datasets as jdatasets
from vsr_tpu.data.loader import Dataloader as JaxDataloader
from vsr_tpu.models import moe as jmoe
from vsr_tpu.models.drf import DRFNet as JDRFNet
from vsr_tpu.models.drf import DRFSISRNet as JDRFSISRNet
from vsr_tpu.models.rbpn import RBPNet as JRBPNet
from vsr_tpu.models.srfbn import SRFBNet as JSRFBNet
from vsr_tpu.ops import select as jselect
from vsr_tpu.ops import subpixel as jsubpixel
from vsr_tpu.runner import device_trainer as jdt
from vsr_tpu.runner import trainers as jtrainers
from vsr_tpu_torch import infer, losses, metrics, optim
from vsr_tpu_torch.callbacks.monitor import Monitor
from vsr_tpu_torch.data import datasets
from vsr_tpu_torch.data.loader import Dataloader
from vsr_tpu_torch.export import export_serving
from vsr_tpu_torch.interop import (SCAN_BODIES, from_jax_tree,
                                   load_jax_params, module_slots)
from vsr_tpu_torch.models import (DRFNet, DRFSISRNet, FRVSRNet, RBPNet,
                                  SRFBNet, common, moe)
from vsr_tpu_torch.ops.rank import pairwise_rank_reference
from vsr_tpu_torch.ops.select import topk_mask
from vsr_tpu_torch.ops.subpixel import conv_transpose_subpixel
from vsr_tpu_torch.registry import get_class
from vsr_tpu_torch.runner import trainers
from vsr_tpu_torch.stream import make_stream

F8 = dict(in_channels=1, out_channels=1, num_features=8, num_groups=2,
          upscale_factor=2)
SISR = dict(F8, num_steps=2)
EXPERTS = dict(num_experts=2, expert_group_size=16)


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def rng():
    return np.random.default_rng(13)


def _variables(jnet, x, seed=0):
    return randomize(init(jnet, x, seed=seed), np.random.default_rng(seed))


def _port_grads(net):
    return {n: p.grad.clone() for n, p in net.named_parameters()}


# ----------------------------------------------------------- (a) subpixel


def test_subpixel_deconv_matches_the_transposed_conv_and_jax(rng):
    def case(k, s, p):
        x = rng.standard_normal((2, 7, 9, 3)).astype(np.float32)
        kernel = rng.standard_normal((k, k, 3, 5)).astype(np.float32) / k
        bias = rng.standard_normal(5).astype(np.float32)
        want = np.asarray(jax.jit(functools.partial(
            jsubpixel.conv_transpose_subpixel, s=s, p=p))(x, kernel, bias))
        # The port's weight is torch's (In, Out, k, k): the flax kernel with
        # both spatial axes flipped (interop's deconv layout).
        w = torch.from_numpy(np.ascontiguousarray(
            kernel.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])).requires_grad_()
        b, xt = torch.from_numpy(bias), first(x)
        got = conv_transpose_subpixel(xt, w, b, s, p)
        ref = F.conv_transpose2d(xt, w, b, s, p)
        assert got.shape == ref.shape == (2, 5, 7 * s, 9 * s)
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(last(got), want, rtol=1e-5, atol=1e-5)
        # The gradient reaches the transposed conv's weight.
        g = torch.randn_like(ref)
        (gw,) = torch.autograd.grad(got, w, g)
        (rw,) = torch.autograd.grad(ref, w, g)
        torch.testing.assert_close(gw, rw, rtol=1e-5, atol=1e-5)

    def module():
        plain = common.ConvTranspose(4, 3, 6, 2, 2)
        sub = common.ConvTranspose(4, 3, 6, 2, 2, subpixel=True,
                                   dtype="bfloat16")
        sub.load_state_dict(plain.state_dict())
        x = torch.randn(2, 4, 5, 6)
        out = sub(x)
        assert out.dtype == torch.bfloat16  # the compute dtype's policy
        ref = F.conv_transpose2d(x.bfloat16(), plain.weight.bfloat16(),
                                 plain.bias.bfloat16(), 2, 2)
        torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                                   atol=2e-2)
        with pytest.raises(ValueError, match="kernel - 2 \\* padding"):
            common.ConvTranspose(4, 3, 4, 2, 2, subpixel=True)

    run_cases([(f"k{k}s{s}p{p}", functools.partial(case, k, s, p))
               for k, s, p in ((6, 2, 2), (8, 4, 2), (4, 2, 1), (7, 3, 2))]
              + [("module", module)])


# ------------------------------------------------------- (b) DRFSISRNet


def test_drfsisrnet_forward_gradients_and_flax_tree(rng):
    kw = dict(SISR, fused_tail=True, **EXPERTS)
    x = rng.standard_normal((2, 6, 6, 1)).astype(np.float32)
    target = rng.standard_normal((2, 12, 12, 1)).astype(np.float32)
    jnet = JDRFSISRNet(**kw)
    net = DRFSISRNet(**kw, fused_squeeze=True)
    variables = hold_train_step(jnet, net, x, target, rng, to_port=first)
    # The flax tree: every leaf has its slot under the scan's own name.
    paths = sorted("/".join(p) for p, _, _ in module_slots(net))
    flat = jax.tree_util.tree_flatten_with_path(variables)[0]
    assert paths == sorted("/".join(k.key for k in p) for p, _ in flat)
    assert SCAN_BODIES[DRFSISRNet] == "Scan_DRFStep_0/"
    assert any(p.startswith("params/Scan_DRFStep_0/ExpertChoiceMoE_0/")
               for p in paths)
    with torch.no_grad():
        out = net(first(x))
    assert out.shape == (2, 2, 1, 12, 12)  # (steps, N, C, H, W)
    assert get_class("net", "DRFSISRNet") is DRFSISRNet
    assert DRFSISRNet.serving_mode == "frame"


# ------------------------------------------------ (c) DRFNet, (f) FRVSR


def test_drfnet_knobs_and_frvsr_remat(rng):
    """DRFNet's experts and sub-pixel deconvs against JAX; DRFNet's and
    FRVSRNet's remat against the plain step."""
    x = rng.standard_normal((2, 3, 6, 6, 1)).astype(np.float32)
    target = rng.standard_normal((2, 3, 12, 12, 1)).astype(np.float32)

    def against_jax(kw, port_kw):
        hold_train_step(JDRFNet(**F8, **kw), DRFNet(**F8, **kw, **port_kw),
                        x, target, rng)

    def remat():
        nets = [DRFNet(**F8, **EXPERTS, fused_squeeze=True, remat=r,
                       generator=torch.Generator().manual_seed(5))
                for r in (False, True)]
        grads = []
        for net in nets:
            net.train()
            out = net(window(x))
            torch.mean(torch.abs(out - window(target))).backward()
            grads.append(_port_grads(net))
        for name, g in grads[0].items():
            torch.testing.assert_close(grads[1][name], g, rtol=0, atol=1e-6)
        with torch.no_grad():  # serving never recomputes
            torch.testing.assert_close(nets[1](window(x)), nets[0](window(x)))

    def frvsr_remat():
        lr = torch.from_numpy(rng.standard_normal((1, 2, 1, 8, 8)).astype(
            np.float32))
        runs = []
        for remat in (False, True):
            net = FRVSRNet(1, 1, 2, num_resblocks=1, remat=remat,
                           generator=torch.Generator().manual_seed(2))
            sr, warped = net(lr)
            (sr.square().mean() + (warped - lr).abs().mean()).backward()
            runs.append((sr.detach(), _port_grads(net)))
        torch.testing.assert_close(runs[1][0], runs[0][0], rtol=0, atol=0)
        for name, g in runs[0][1].items():
            torch.testing.assert_close(runs[1][1][name], g, rtol=0,
                                       atol=1e-6)

    run_cases([
        ("experts", functools.partial(against_jax, EXPERTS, {})),
        ("subpixel", functools.partial(against_jax, dict(subpixel_deconv=True),
                                       dict(fused_squeeze=True))),
        ("remat", remat), ("frvsr_remat", frvsr_remat)])


# -------------------------------------------------- (d) SRFBNet, (e) RBPNet


def test_srfbnet_subpixel_and_bf16_carry_f32(rng):
    x = rng.standard_normal((2, 6, 6, 1)).astype(np.float32)
    target = rng.standard_normal((2, 12, 12, 1)).astype(np.float32)

    def subpixel():
        kw = dict(SISR, subpixel_deconv=True)
        hold_train_step(JSRFBNet(**kw), SRFBNet(**kw), x, target, rng,
                        to_port=first)

    def carry_f32():
        """Within twice JAX's own bf16 error (``test_torch_precision.py``'s
        bar), outputs and gradients of a squared-error loss."""
        variables = _variables(JSRFBNet(**SISR), x, seed=4)

        def jax_run(dtype, **kw):
            jnet = JSRFBNet(**SISR, dtype=dtype, **kw)

            def loss(p):
                y = jnet.apply({"params": p}, jnp.asarray(x))
                return jnp.mean(jnp.square(y.astype(jnp.float32) - target)), y
            (_, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
                variables["params"])
            return (np.asarray(y, np.float32),
                    jax.tree_util.tree_map(np.asarray, g))

        def flat(net, tree):
            named = from_jax_tree(net, tree)
            return np.concatenate([named[k].ravel() for k in sorted(named)])

        net = SRFBNet(**SISR, dtype="bfloat16", carry_f32=True)
        load_jax_params(net, variables)
        assert net.carry_f32
        y = net(first(x))
        assert y.dtype == torch.float32
        torch.mean(torch.square(y.float() - first(target))).backward()
        got = np.concatenate([p.grad.numpy().ravel() for _, p in
                              sorted(net.named_parameters())])
        (y32, g32), (y16, g16) = jax_run(None), jax_run(jnp.bfloat16,
                                                        carry_f32=True)
        g32, g16 = flat(net, g32), flat(net, g16)
        for got_, want, ref in ((last(y), y16, y32), (got, g16, g32)):
            envelope = float(np.abs(want - ref).max())
            assert envelope > 0
            assert float(np.abs(got_ - want).max()) <= 2 * envelope

    run_cases([("subpixel", subpixel), ("carry_f32_bf16", carry_f32)])


def test_rbpnet_subpixel_deconv(rng):
    kw = dict(in_channels=1, out_channels=1, base_filter=8, feat=8,
              num_stages=3, num_resblocks=1, num_frames=3, upscale_factor=2,
              subpixel_deconv=True)
    x = rng.standard_normal((2, 3, 6, 6, 1)).astype(np.float32)
    target = rng.standard_normal((2, 12, 12, 1)).astype(np.float32)
    net = RBPNet(**kw)
    assert all(m.subpixel for m in net.modules()
               if isinstance(m, common.ConvTranspose))
    hold_train_step(JRBPNet(**kw), net, x, target, rng)


# ------------------------------------------------------- (g), (h) routers


def _tied_affinities(rng, shape):
    """Non-negative affinities on a coarse grid: many exact ties."""
    return (rng.integers(0, 12, shape) / 16.0).astype(np.float32)


def test_topk_mask_matches_jax_and_the_rank_with_ties(rng):
    af = _tied_affinities(rng, (3, 4, 64))
    rank = pairwise_rank_reference(torch.from_numpy(af))

    def case(k, bits):
        got = topk_mask(torch.from_numpy(af), k, radix_bits=bits)
        want = np.asarray(jselect.topk_mask(jnp.asarray(af), k,
                                            radix_bits=bits))
        np.testing.assert_array_equal(got.numpy(), want)
        assert torch.equal(got, rank < k)
        assert torch.all(got.sum(-1) == k)

    def refusals():
        for kw, match in ((dict(k=0), "out of range"),
                          (dict(k=65), "out of range"),
                          (dict(k=4, radix_bits=9), "radix_bits=9")):
            with pytest.raises(ValueError, match=match):
                topk_mask(torch.from_numpy(af), **kw)

    run_cases([(f"k{k}_bits{b}", functools.partial(case, k, b))
               for k in (1, 20, 64) for b in (1, 4, 8)]
              + [("refusals", refusals)])


MOE_KW = dict(num_experts=4, group_size=16, capacity_factor=1.25)


def test_moe_sort_radix_and_dense_nhwc_match_jax(rng):
    x = rng.standard_normal((2, 5, 7, 8)).astype(np.float32)  # 35 tokens
    base = jmoe.ExpertChoiceMoE(**MOE_KW)
    variables = _variables(base, x, seed=3)

    def layer(router_impl, dispatch_impl, radix_bits=4):
        m = moe.ExpertChoiceMoE(8, **MOE_KW, router_impl=router_impl,
                                dispatch_impl=dispatch_impl,
                                radix_bits=radix_bits)
        load_jax_params(m, variables)
        return m

    def masks():
        """On one set of affinities with ties: the radix mask and the sort
        router's slots are the rank router's, bit for bit."""
        m = layer("rank", "dense")
        af = torch.from_numpy(_tied_affinities(rng, (6, 4, 16)))
        cap = m.capacity(16)
        rank = moe.route(af, "rank")
        for bits in (1, 4, 8):
            assert torch.equal(layer("radix", "dense", bits).selection(
                af, cap), rank < cap)
        _, idx = moe.ExpertChoiceMoE.slots(af, cap)
        _, jidx = jax.lax.top_k(jnp.asarray(af.numpy()), cap)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        # Slot c holds the token of rank c.
        assert torch.equal(torch.gather(rank, -1, idx),
                           torch.arange(cap).expand(6, 4, cap).int())
        assert torch.equal(layer("sort", "sparse").selection(af, cap),
                           rank < cap)

    def output(router_impl, dispatch_impl, radix_bits=4):
        jlayer = jmoe.ExpertChoiceMoE(**MOE_KW, router_impl=router_impl,
                                      dispatch_impl=dispatch_impl,
                                      radix_bits=radix_bits)
        # (Eager at 8 bits: XLA takes minutes to compile its 508 passes.)
        apply = jlayer.apply if radix_bits == 8 else jax.jit(jlayer.apply)
        want = np.asarray(apply(variables, jnp.asarray(x)))
        m = layer(router_impl, dispatch_impl, radix_bits)
        af, gs = m.affinities(first(x))
        cap = m.capacity(gs)
        # Masks first: the rank router's selection on these affinities.
        assert torch.equal(m.selection(af, cap),
                           moe.route(af, "rank") < cap)
        got = m(first(x))
        np.testing.assert_allclose(last(got), want, **FORWARD_TOL)
        assert np.abs(want - x).max() > 1e-2
        dense = layer("rank", "dense")(first(x))
        torch.testing.assert_close(got, dense, rtol=1e-5, atol=1e-5)

    def gradients():
        """dense_nhwc and sort/sparse give the rank router's gradients."""
        grads = []
        for r, d in (("rank", "sparse"), ("sort", "sparse"),
                     ("rank", "dense_nhwc"), ("radix", "dense_nhwc")):
            m = layer(r, d)
            xt = first(x).requires_grad_()
            m(xt).square().mean().backward()
            grads.append([xt.grad] + [p.grad for p in m.parameters()])
        for other in grads[1:]:
            for a, b in zip(other, grads[0]):
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)

    run_cases([("masks", masks),
               ("sort_sparse", functools.partial(output, "sort", "sparse")),
               ("radix_dense_1", functools.partial(output, "radix", "dense",
                                                   1)),
               ("radix_dense_nhwc_8", functools.partial(
                   output, "radix", "dense_nhwc", 8)),
               ("rank_dense_nhwc", functools.partial(output, "rank",
                                                     "dense_nhwc")),
               ("gradients", gradients)])


def test_refusals_keep_their_reasons():
    def moe_message(router_impl, dispatch_impl):
        """JAX raises at the call, the port at construction: the same
        words."""
        jlayer = jmoe.ExpertChoiceMoE(**MOE_KW, router_impl=router_impl,
                                      dispatch_impl=dispatch_impl)
        with pytest.raises(ValueError) as want:
            jlayer.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 8)))
        with pytest.raises(ValueError) as got:
            moe.ExpertChoiceMoE(8, **MOE_KW, router_impl=router_impl,
                                dispatch_impl=dispatch_impl)
        assert str(got.value) == str(want.value)

    def knobs():
        for make, match in (
                (lambda: DRFNet(**F8, unroll=2), "unroll"),
                (lambda: DRFNet(**F8, split_transpose=True),
                 "split_transpose"),
                (lambda: DRFSISRNet(**SISR, unroll=2), "unroll"),
                (lambda: DRFSISRNet(**SISR, dtype="bfloat16", carry_f32=True,
                                    **EXPERTS), "num_experts"),
                (lambda: DRFSISRNet(**SISR, dtype="bfloat16", carry_f32=True,
                                    fused_squeeze=True), "fused_squeeze"),
                (lambda: SRFBNet(**SISR, dtype="bfloat16", carry_f32=True,
                                 fused_squeeze=True), "fused_squeeze")):
            with pytest.raises(NotImplementedError, match=match):
                make()
        # Without a low-precision dtype carry_f32 is a no-op, as in JAX,
        # and so composes with the experts and the fused squeeze.
        assert not DRFSISRNet(**SISR, carry_f32=True, **EXPERTS).carry_f32
        for make, kw in ((DRFNet, F8), (DRFSISRNet, SISR), (SRFBNet, SISR)):
            assert not make(**kw, carry_f32=True, fused_squeeze=True).carry_f32
        # FRVSRNet's carry_f32 is ported with its bf16 policy.
        assert not FRVSRNet(1, 1, 2, carry_f32=True).carry_f32
        assert FRVSRNet(1, 1, 2, dtype="bfloat16", carry_f32=True).carry_f32
        with pytest.raises(ValueError, match="radix_bits=0"):
            moe.ExpertChoiceMoE(8, 2, router_impl="radix",
                                dispatch_impl="dense", radix_bits=0)

    run_cases([("radix_sparse", functools.partial(moe_message, "radix",
                                                  "sparse")),
               ("sort_dense_nhwc", functools.partial(moe_message, "sort",
                                                     "dense_nhwc")),
               ("sort_dense", functools.partial(moe_message, "sort",
                                                "dense")),
               ("knobs", knobs)])


# ------------------------------------------------ (i) frame serving


def test_frame_serving_takes_the_last_feedback_step(rng):
    frames = np.round(rng.random((6, 24, 24)) * 255).astype(np.float32)

    def nets(name):
        # The port's squeezes fused (the kernel's twin here), JAX's plain:
        # one parameter tree.
        jcls, pcls, kw = {
            "srfb": (JSRFBNet, SRFBNet, SISR),
            "drfsisr": (JDRFSISRNet, DRFSISRNet,
                        dict(SISR, fused_tail=True, **EXPERTS))}[name]
        jnet = jcls(**kw)
        variables = _variables(jnet, np.zeros((1, 12, 12, 1), np.float32), 6)
        net = pcls(**kw, fused_squeeze=True)
        load_jax_params(net, variables)
        return jnet, variables, net

    def agree(got, want):
        diff = np.abs(np.asarray(got, np.float64) - np.asarray(want))
        assert (diff == 0).mean() >= 0.999 and diff.max() <= 1.0

    def pipeline(name, chunk):
        jnet, variables, net = nets(name)
        _, want = jinfer.make_pipeline(jnet, variables, 2, "acdc",
                                       chunk=chunk)(frames)
        _, got = infer.make_pipeline(net, 2, "acdc", chunk=chunk)(
            torch.from_numpy(frames))
        assert got.shape == (6, 24, 24)
        agree(got.numpy(), want)
        assert np.asarray(want).std() > 1.0
        # The last step: the net's own stack, served by hand.
        with torch.no_grad():
            steps = net(infer.make_prep(2, "acdc")(
                torch.from_numpy(frames))[1])
        assert steps.shape[0] == 2

    def routes():
        """A stream, an artifact and a window stream of a stacked net give
        the pipeline's frames."""
        _, _, net = nets("srfb")
        hr = torch.from_numpy(frames)
        _, want = infer.make_pipeline(net, 2, "acdc")(hr)
        _, got = make_stream(net, 2).push(frames)
        assert torch.equal(got, want)
        program, _ = export_serving(net, frames.shape, 2, "acdc")
        with torch.no_grad():
            agree(program.module()(hr)[1].numpy(), want.numpy())

    run_cases([("srfb", functools.partial(pipeline, "srfb", 0)),
               ("srfb_chunk4", functools.partial(pipeline, "srfb", 4)),
               ("drfsisr", functools.partial(pipeline, "drfsisr", 0)),
               ("drfsisr_chunk4", functools.partial(pipeline, "drfsisr", 4)),
               ("routes", routes)])


# ------------------------------------------------ (j) the SRFB trainers


NORM = [{"name": "Normalize", "kwargs": {"means": [54.089],
                                         "stds": [48.084]}},
        {"name": "ToTensor"}]
AUG = [{"name": "RandomHorizontalFlip"}, {"name": "RandomVerticalFlip"}]
CROP = [*AUG, {"name": "RandomCropPatch", "kwargs": {"size": [8, 8],
                                                     "ratio": 2}}]
TRAIN_KW = dict(SISR, fused_tail=True)  # the port's squeezes fused


def test_drfsisrnet_trains_through_the_srfb_trainers(tmp_path):
    tree = make_processed_tree(tmp_path / "tree", hr_size=16, frames=4,
                               patients_per_type=1, slices=2)

    def dataset(module, type_, augments):
        return module.AcdcSISRDataset(data_dir=tree / "imgs", type=type_,
                                      downscale_factor=2, transforms=NORM,
                                      augments=augments)

    def common_kw(module, monitor, **extra):
        return dict(loss_fns=[module["losses"].L1Loss()], loss_weights=[1.0],
                    metric_fns=[module["metrics"].PSNR()],
                    optimizer=module["optim"].Adam(lr=1e-3),
                    lr_scheduler=None, logger=None, monitor=monitor,
                    num_epochs=1, **extra)

    jax_mods = dict(losses=jlosses, metrics=jmetrics, optim=joptim)
    port_mods = dict(losses=losses, metrics=metrics, optim=optim)

    def host_loop():
        jt = jtrainers.AcdcSISRSRFBTrainer(
            train_dataloader=JaxDataloader(dataset(jdatasets, "train", CROP),
                                           batch_size=4, shuffle=True),
            valid_dataloader=JaxDataloader(dataset(jdatasets, "valid", CROP),
                                           batch_size=1),
            net=JDRFSISRNet(**TRAIN_KW),
            **common_kw(jax_mods, JaxMonitor(
                checkpoints_dir=tmp_path / "jax", mode="min", target="Loss",
                saved_freq=1, early_stop=0), prefetch_to_device=False))
        jt._ensure_initialized()
        initial = jax.tree_util.tree_map(np.array, jt.params)
        jlog, _, _ = jt._run_epoch("training", 1)
        jvalid, _, _ = jt._run_epoch("validation", 1)
        net = DRFSISRNet(**TRAIN_KW, fused_squeeze=True)
        load_jax_params(net, initial)
        pt = trainers.AcdcSISRSRFBTrainer(
            train_dataloader=Dataloader(dataset(datasets, "train", CROP),
                                        batch_size=4, shuffle=True),
            valid_dataloader=Dataloader(dataset(datasets, "valid", CROP),
                                        batch_size=1),
            net=net, device="cpu",
            **common_kw(port_mods, Monitor(
                checkpoints_dir=tmp_path / "port", mode="min", target="Loss",
                saved_freq=1, early_stop=0)))
        log, _, _ = pt._run_epoch("training", 1)
        valid, _, _ = pt._run_epoch("validation", 1)
        for got, want in ((log, jlog), (valid, jvalid)):
            assert sorted(got) == sorted(want) == ["L1Loss", "Loss", "PSNR"]
            for key, value in want.items():
                np.testing.assert_allclose(got[key], value, rtol=2e-3,
                                           atol=2e-4, err_msg=key)
        _hold_params(net, jt.params)

    def device_epoch():
        steps, batch, patch = 3, 2, 4
        jt = jdt.AcdcSISRSRFBDeviceTrainer(
            train_dataloader=JaxDataloader(dataset(jdatasets, "train", AUG),
                                           batch_size=batch, shuffle=True),
            valid_dataloader=JaxDataloader(dataset(jdatasets, "valid", AUG),
                                           batch_size=1),
            net=JDRFSISRNet(**TRAIN_KW),
            **common_kw(jax_mods, JaxMonitor(
                checkpoints_dir=tmp_path / "jdev", mode="min", target="Loss",
                saved_freq=1, early_stop=0), patch=patch, ratio=2,
                steps_per_epoch=steps, prefetch_to_device=False))
        jt.params = randomize(init(jt.net, np.zeros(
            jt._example_inputs().shape, np.float32)), np.random.default_rng(0))
        jt.opt_state = jt.tx.init(jt.params["params"])
        initial = jax.tree_util.tree_map(np.array, jt.params)
        key = jt.rng_tree.jax_key("device-epoch", 1)
        step_losses = _jax_step_losses(jt, jax.random.split(key, steps))
        jt._run_epoch("training", 1)
        net = DRFSISRNet(**TRAIN_KW, fused_squeeze=True)
        load_jax_params(net, initial)
        pt = get_class("trainer", "AcdcSISRSRFBDeviceTrainer")(
            train_dataloader=Dataloader(dataset(datasets, "train", AUG),
                                        batch_size=batch, shuffle=True),
            valid_dataloader=Dataloader(dataset(datasets, "valid", AUG),
                                        batch_size=1),
            net=net, device="cpu",
            **common_kw(port_mods, Monitor(
                checkpoints_dir=tmp_path / "pdev", mode="min", target="Loss",
                saved_freq=1, early_stop=0), patch=patch, ratio=2,
                steps_per_epoch=steps))
        draws = _epoch_draws(key, steps, m=jt.m, batch=batch,
                             h=jt.lr_buf.shape[-3], w=jt.lr_buf.shape[-2],
                             patch=patch)
        pt.epoch_draws = lambda epoch: draws
        pt._run_epoch("training", 1)
        np.testing.assert_allclose(pt.engine.log[:, 0].numpy(), step_losses,
                                   rtol=1e-4)
        _hold_params(pt.net, jt.params)

    run_cases([("host_loop", host_loop), ("device_epoch", device_epoch)])
