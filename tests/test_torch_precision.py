"""bf16 mixed precision of the port against flax's: float32 parameters,
bf16 compute, the ``out_dtype`` accumulating conv and the ``carry_f32``
hybrid, on the same numpy-seeded inputs and weights.

- The policy modules alone (a conv, an ``out_dtype`` conv in 2D and 3D, the
  folded 2D and 3D convs, a PReLU) agree with flax at 1e-2 relative (with a
  floor of 1e-2 of the largest entry), outputs and gradients (input and
  parameters).
- The nets (DRFNet plain and ``carry_f32``, EDSRNet, SRFBNet,
  Volume3DSRNet) are held to JAX relative to JAX's own bf16 error:
  ``max|port_bf16 - jax_bf16| <= 2 * max|jax_bf16 - jax_f32|`` on the
  outputs and on the first step's gradients (cuDNN / MKL-DNN and XLA round
  at other places, so a fixed bar would prove little).
- ``carry_f32`` tracks float32 more closely than plain bf16.
- After one Adam step at lr 1e-4 a bf16-compute net's parameters move by
  JAX's float32 update; parameters held in bf16 would not move.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests._torch_parity import first, init, last, randomize, window
from vsr_tpu.models import DRFNet as JDRFNet
from vsr_tpu.models import EDSRNet as JEDSRNet
from vsr_tpu.models import SRFBNet as JSRFBNet
from vsr_tpu.models import Volume3DSRNet as JVolume3DSRNet
from vsr_tpu.models import common as jcommon
from vsr_tpu.models import feedback as jfeedback
from vsr_tpu_torch.interop import from_jax_tree, load_jax_params
from vsr_tpu_torch.models import (DRFNet, EDSRNet, SRFBNet, Volume3DSRNet,
                                  common, feedback)
from vsr_tpu_torch.runner import trainers

BF16 = jnp.bfloat16
MODULE_SHARE = 1e-2  # of the largest flax entry


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _close(got, want, what=""):
    """1e-2 relative, with a floor of 1e-2 of the largest entry."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(
        got, want, rtol=MODULE_SHARE,
        atol=MODULE_SHARE * float(np.abs(want).max()), err_msg=what)


# ------------------------------------------------------- policy modules


def _torch_kernel(k):
    """flax (*window, in, out) -> torch (out, in, *window)."""
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(np.moveaxis(k, -1, 0), -1, 1)))


def _hold_module(jmod, params, x, port, weights, port_x, out_last,
                 grad_last, seed=0):
    """Sum of the output times a random cotangent on both sides: outputs,
    the input's gradient and each parameter's gradient at 1e-2."""
    def loss(p, x):
        y = jmod.apply({"params": p}, x)
        return jnp.sum(y.astype(jnp.float32) * r), y

    y_shape = jax.eval_shape(lambda: jmod.apply({"params": params},
                                                jnp.asarray(x))).shape
    r = jnp.asarray(np.random.default_rng(seed).standard_normal(
        y_shape).astype(np.float32))
    (_, y), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    xt = port_x(x).requires_grad_(True)
    yt = port(xt)
    (yt.float() * grad_last(r)).sum().backward()
    assert yt.dtype == {jnp.dtype(BF16): torch.bfloat16,
                        jnp.dtype(jnp.float32): torch.float32}[y.dtype]
    _close(out_last(yt.detach().float()), np.asarray(y, np.float32), what="y")
    _close(out_last(xt.grad), gx, what="dx")
    for name, (param, to_jax) in weights.items():
        assert param.dtype == torch.float32
        _close(to_jax(param.grad.numpy()), np.asarray(gp_leaf(gp, name)),
               what=name)


def gp_leaf(tree, path):
    for key in path.split("/"):
        tree = tree[key]
    return tree


def _to_flax_kernel(w):
    return np.moveaxis(np.moveaxis(w, 0, -1), 0, -2)


@pytest.mark.parametrize("out_dtype", [None, jnp.float32])
def test_conv_policy_matches_flax(rng, out_dtype):
    x = rng.standard_normal((2, 6, 6, 3)).astype(np.float32)
    jmod = jcommon.Conv(4, 3, padding=1, dtype=BF16, out_dtype=out_dtype)
    params = randomize(init(jmod, x), rng)["params"]
    port = common.Conv(3, 4, 3, padding=1, dtype="bfloat16",
                       out_dtype=None if out_dtype is None else torch.float32)
    with torch.no_grad():
        port.weight.copy_(_torch_kernel(np.asarray(params["Conv_0"]["kernel"])))
        port.bias.copy_(torch.from_numpy(np.asarray(params["Conv_0"]["bias"])))
    _hold_module(jmod, params, x, port,
                 {"Conv_0/kernel": (port.weight, _to_flax_kernel),
                  "Conv_0/bias": (port.bias, lambda b: b)},
                 first, last, first)


def _vol_first(x):
    return first(x, 3)


def _vol_last(t):
    return last(t, 3)


@pytest.mark.parametrize("kw", [dict(out_dtype=jnp.float32),
                                dict(fold_shuffle2d=2)])
def test_conv3d_policy_matches_flax(rng, kw):
    """The accumulating 3D conv, and the fold (the weight cast to bf16,
    then folded)."""
    cin = 3 * 4 if kw.get("fold_shuffle2d") else 3
    x = rng.standard_normal((2, 3, 5, 5, cin)).astype(np.float32)
    jmod = jcommon.Conv3D(4, dtype=BF16, **kw)
    params = randomize(init(jmod, x), rng)["params"]
    port = common.Conv3D(3, 4, dtype=torch.bfloat16,
                         **({"fold_shuffle2d": 2} if "fold_shuffle2d" in kw
                            else {"out_dtype": torch.float32}))
    with torch.no_grad():
        port.weight.copy_(_torch_kernel(np.asarray(params["Conv_0"]["kernel"])))
        port.bias.copy_(torch.from_numpy(np.asarray(params["Conv_0"]["bias"])))
    _hold_module(jmod, params, x, port,
                 {"Conv_0/kernel": (port.weight, _to_flax_kernel),
                  "Conv_0/bias": (port.bias, lambda b: b)},
                 _vol_first, _vol_last, _vol_first)


def test_foldable_conv_policy_matches_flax(rng):
    x = rng.standard_normal((2, 5, 5, 8)).astype(np.float32)
    jmod = jcommon.FoldableConv(3, factor=2, dtype=BF16)
    params = randomize(init(jmod, x, folded=True), rng)["params"]
    port = common.FoldableConv(2, 3, factor=2, dtype="bfloat16")
    with torch.no_grad():
        port.weight.copy_(_torch_kernel(np.asarray(params["kernel"])))
        port.bias.copy_(torch.from_numpy(np.asarray(params["bias"])))
    folded = lambda p, x: jmod.apply(p, x, folded=True)  # noqa: E731
    wrapped = type("Folded", (), {"apply": staticmethod(folded)})
    _hold_module(wrapped, params, x, lambda t: port(t, folded=True),
                 {"kernel": (port.weight, _to_flax_kernel),
                  "bias": (port.bias, lambda b: b)},
                 first, last, first)


def test_prelu_keeps_a_float32_alpha_and_computes_in_the_input_dtype(rng):
    x = rng.standard_normal((2, 4, 4, 3)).astype(np.float32)
    jmod = jfeedback.PReLU()
    params = {"alpha": jnp.asarray([-0.3], jnp.float32)}
    port = feedback.PReLU()
    with torch.no_grad():
        port.weight.fill_(-0.3)

    class Bf16:
        @staticmethod
        def apply(p, x):
            return jmod.apply(p, x.astype(BF16))

    _hold_module(Bf16, params, x, lambda t: port(t.bfloat16()),
                 {"alpha": (port.weight, lambda a: a)}, first, last, first)


def test_accum_conv_backward_is_the_plain_bf16_backward(rng):
    """``out_dtype``'s gradients equal the compute-dtype conv's, bit for
    bit (``make_accum_conv``: a forward-precision upgrade only)."""
    x = torch.from_numpy(rng.standard_normal((2, 3, 6, 6)).astype(
        np.float32)).bfloat16().requires_grad_(True)
    w = torch.from_numpy(rng.standard_normal((4, 3, 3, 3)).astype(
        np.float32)).bfloat16().requires_grad_(True)
    g = torch.from_numpy(rng.standard_normal((2, 4, 6, 6)).astype(np.float32))
    y = common.accum_conv(x, w, None, torch.float32, (1, 1), (1, 1))
    assert y.dtype == torch.float32
    np.testing.assert_allclose(
        y.detach().numpy(), torch.nn.functional.conv2d(
            x.detach().double(), w.detach().double(), padding=1).numpy(),
        rtol=1e-6, atol=1e-5)
    dx, dw = torch.autograd.grad(y, (x, w), g)
    plain = torch.nn.functional.conv2d(x, w, padding=1)
    px, pw = torch.autograd.grad(plain, (x, w), g.bfloat16())
    assert torch.equal(dx, px) and torch.equal(dw, pw)


def test_folded_conv3d_computes_in_the_promoted_dtype_without_a_dtype(rng):
    """``vsr_tpu/models/common.py:318``: the JAX folded Conv3D computes in
    the input's dtype when its ``dtype`` is None; the port promotes the
    input's and the weight's dtypes, as the unfolded conv does, so a bf16
    input to an f32 conv folds in float32 and equals the unfolded conv."""
    torch.manual_seed(0)
    plain = common.Conv3D(2, 3)
    folded = common.Conv3D(2, 3, fold_shuffle2d=2)
    folded.load_state_dict(plain.state_dict())
    pre = torch.from_numpy(rng.standard_normal((1, 8, 3, 4, 4)).astype(
        np.float32)).bfloat16()
    got = common.pixel_shuffle_2d_in_3d(folded(pre), 2)
    assert got.dtype == torch.float32
    want = plain(common.pixel_shuffle_2d_in_3d(pre, 2))
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- nets


NETS = {
    "drf": (lambda dt, **kw: JDRFNet(1, 1, 8, 2, 2, dtype=dt, **kw),
            lambda dt, **kw: DRFNet(1, 1, 8, 2, 2, dtype=dt, **kw),
            (2, 3, 8, 8, 1), window, last),
    "edsr": (lambda dt, **kw: JEDSRNet(1, 1, 2, 8, 2, fused_tail=True,
                                       dtype=dt, **kw),
             lambda dt, **kw: EDSRNet(1, 1, 2, 8, 2, fused_tail=True,
                                      dtype=dt, **kw),
             (2, 8, 8, 1), first, last),
    "srfb": (lambda dt, **kw: JSRFBNet(1, 1, 2, 8, 2, 2, dtype=dt, **kw),
             lambda dt, **kw: SRFBNet(1, 1, 2, 8, 2, 2, dtype=dt, **kw),
             (2, 8, 8, 1), first, last),
    "vol3d": (lambda dt, **kw: JVolume3DSRNet(1, 1, 2, 4, 2, fused_tail=True,
                                              dtype=dt, **kw),
              lambda dt, **kw: Volume3DSRNet(1, 1, 2, 4, 2, fused_tail=True,
                                             dtype=dt, **kw),
              (2, 3, 6, 6, 1), _vol_first, _vol_last),
}
NET_CASES = [("drf", {}), ("drf", {"carry_f32": True}), ("edsr", {}),
             ("srfb", {}), ("vol3d", {})]


def _jax_run(jnet, variables, x, target):
    """Outputs and gradients of a squared-error loss. (Not L1: its
    gradient jumps where an output crosses its target, and which of the
    few outputs within bf16 rounding of the target cross is a coin toss on
    either side, so an L1 gradient would compare coin tosses.)"""
    def loss(p):
        y = jnet.apply({"params": p}, x)
        return jnp.mean(jnp.square(y.astype(jnp.float32) - target)), y

    (_, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    return np.asarray(y, np.float32), jax.tree_util.tree_map(np.asarray, g)


def _flat(named: dict) -> np.ndarray:
    return np.concatenate([np.asarray(named[k], np.float32).ravel()
                           for k in sorted(named)])


@pytest.fixture(scope="module")
def net_runs():
    """For each case: JAX's f32 and bf16 outputs and gradients, and the
    port's bf16 ones, from the same weights and inputs."""
    out = {}
    for name, kw in NET_CASES:
        jmake, pmake, shape, to_port, to_last = NETS[name]
        rng = np.random.default_rng(7)
        x = rng.standard_normal(shape).astype(np.float32)
        variables = randomize(init(jmake(None), x), rng)
        y_shape = jax.eval_shape(jmake(None).apply, variables, x).shape
        target = rng.standard_normal(y_shape).astype(np.float32)
        y32, g32 = _jax_run(jmake(None), variables, jnp.asarray(x), target)
        y16, g16 = _jax_run(jmake(BF16, **kw), variables, jnp.asarray(x),
                            target)
        net = pmake("bfloat16", **kw)
        load_jax_params(net, variables)
        yt = net(to_port(x))
        t = torch.from_numpy(np.ascontiguousarray(
            np.moveaxis(target, -1, -1 - (3 if name == "vol3d" else 2))))
        torch.mean(torch.square(yt.float() - t)).backward()
        got = {k: p.grad.numpy() for k, p in net.named_parameters()}
        out[(name, tuple(kw))] = dict(
            y32=y32, y16=y16, yt=to_last(yt.detach().float()),
            g32=_flat(from_jax_tree(net, g32)),
            g16=_flat(from_jax_tree(net, g16)), gt=_flat(got), net=net)
    return out


@pytest.mark.parametrize("name,kw", NET_CASES)
def test_bf16_net_matches_jax_within_its_own_bf16_error(net_runs, name, kw):
    run = net_runs[(name, tuple(kw))]
    assert {p.dtype for p in run["net"].parameters()} == {torch.float32}
    for what in ("y", "g"):
        got, want, ref = (run[what + "t"], run[what + "16"],
                          run[what + "32"])
        envelope = float(np.abs(want - ref).max())
        assert envelope > 0, what
        assert float(np.abs(got - want).max()) <= 2 * envelope, what


def test_carry_f32_tracks_float32_closer_than_plain_bf16(net_runs):
    """``tests/test_carry_f32.py``'s check, on the port: the hybrid DRFNet's
    output is strictly closer to float32 than the plain bf16 one's."""
    plain, hybrid = net_runs[("drf", ())], net_runs[("drf", ("carry_f32",))]

    def rms(run):
        return float(np.sqrt(np.mean((run["yt"] - run["y32"]) ** 2)))

    assert rms(hybrid) < rms(plain)


def test_carry_f32_keeps_float32_features_and_hidden_state(rng):
    net = DRFNet(1, 1, 8, 2, 2, dtype="bfloat16", carry_f32=True)
    x = torch.from_numpy(rng.standard_normal((1, 2, 1, 6, 6)).astype(
        np.float32))
    feats = net.in_block(x[:, 0])
    assert feats.dtype == torch.float32
    hidden, out = net.step(feats, feats)
    assert hidden.dtype == torch.float32 and out.dtype == torch.bfloat16
    # Without a low-precision dtype carry_f32 is a no-op.
    assert not DRFNet(1, 1, 8, 2, 2, carry_f32=True).carry_f32


@pytest.mark.parametrize("kw,match", [
    (dict(carry_f32=True, fused_squeeze=True), "does not compose"),
    (dict(carry_f32=True, num_experts=2), "num_experts")])
def test_carry_f32_refusals(kw, match):
    with pytest.raises(NotImplementedError, match=match):
        DRFNet(1, 1, 8, 2, 2, dtype="bfloat16", **kw)


# ------------------------------------------------------------- the repair


def test_one_adam_step_moves_float32_parameters_as_jax_does(rng, tmp_path):
    """The fault this policy repairs: a bf16 parameter of about 0.05 cannot
    take an Adam step of 1e-4 (bf16's spacing there is about 2e-4); flax's
    float32 parameter does. The host-loop trainer's step on a bf16-compute
    EDSRNet moves each parameter by JAX's update (optax Adam on f32
    parameters) to 1e-6 of its largest entry; held in bf16 they stay."""
    jnet = JEDSRNet(1, 1, 0, 4, 2, dtype=BF16)
    x = rng.uniform(0.5, 1.5, (2, 6, 6, 1)).astype(np.float32)
    target = np.full((2, 12, 12, 1), 10.0, np.float32)  # far: sign(y - t) = -1
    variables = randomize(init(jnet, x), rng)
    params = variables["params"]

    def loss(p):
        y = jnet.apply({"params": p}, jnp.asarray(x))
        return jnp.mean(jnp.abs(y.astype(jnp.float32) - target))

    tx = optax.adam(1e-4)
    grads = jax.grad(loss)(params)
    updates, _ = tx.update(grads, tx.init(params), params)
    want = from_jax_tree(EDSRNet(1, 1, 0, 4, 2),
                         jax.tree_util.tree_map(np.asarray,
                                                optax.apply_updates(params,
                                                                    updates)))

    def step(net):
        trainer = trainers.SISRTrainer(
            train_dataloader=None, valid_dataloader=None, net=net,
            loss_fns=[torch.nn.L1Loss()], loss_weights=[1.0], metric_fns=[],
            optimizer=torch.optim.Adam(net.parameters(), lr=1e-4),
            lr_scheduler=None, logger=None, monitor=None, num_epochs=1,
            device="cpu")
        trainer._train_step(first(x), first(target))
        return {k: p.detach().float().numpy()
                for k, p in net.named_parameters()}

    net = EDSRNet(1, 1, 0, 4, 2, dtype="bfloat16")
    load_jax_params(net, variables)
    before = {k: p.detach().clone().numpy() for k, p in net.named_parameters()}
    got = step(net)
    for name, value in got.items():
        scale = float(np.abs(want[name]).max())
        assert np.abs(value - want[name]).max() <= 1e-6 * scale, name
        assert np.abs(value - before[name]).max() > 5e-5, name  # it moved
    # The old fault: the same gradients and Adam step on parameters held in
    # bf16 leave most entries where they were.
    jgrads = from_jax_tree(net, jax.tree_util.tree_map(np.asarray, grads))
    still, total = 0, 0
    for name, value in before.items():
        held = torch.nn.Parameter(torch.from_numpy(value).bfloat16())
        held.grad = torch.from_numpy(jgrads[name]).bfloat16()
        torch.optim.Adam([held], lr=1e-4).step()
        still += int((held.detach() == torch.from_numpy(value).bfloat16()
                      ).sum())
        total += value.size
    assert still > total // 2, (still, total)
