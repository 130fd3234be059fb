"""The port's volumetric nets against the flax ones, weight for weight: the
in-plane shuffle and the 3D fold of the final conv (1e-6), ``Conv3D`` with
``fold_shuffle2d``, ``Volume3DSRNet`` at factors 2, 3 and 4 and
``Volume4DSRNet`` at factors 2 and 4 with ``fused_tail``, ``hoist_tail`` and
``remat`` (train-mode forward at ``FORWARD_TOL``, every parameter's gradient
within ``GRAD_SHARE`` of its own largest entry), remat's gradients against
the plain ones, a folded checkpoint in an unfolded net, and the refusals."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import (first, hold_train_step, init, last,
                                 randomize)
from vsr_tpu.models import common as jcommon
from vsr_tpu.models.vol3d import Volume3DSRNet as JaxVolume3DSRNet
from vsr_tpu.models.vol3d import _pixel_shuffle_2d_in_3d
from vsr_tpu.models.vol4d import Volume4DSRNet as JaxVolume4DSRNet
from vsr_tpu.ops import fused_tail as jfused_tail
from vsr_tpu_torch.interop import load_jax_params
from vsr_tpu_torch.models import Volume3DSRNet, Volume4DSRNet, common
from vsr_tpu_torch.models.vol3d import _ResBlock3D
from vsr_tpu_torch.models.vol4d import _Vol4DStep
from vsr_tpu_torch.ops.fused_tail import fuse_conv3d_through_shuffle2d

EXACT = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("r", [2, 3])
def test_pixel_shuffle_2d_in_3d_packs_like_jax(rng, r):
    # Channels c*r^2 + i*r + j: row phase i, column phase j.
    x = rng.standard_normal((2, 3, 4, 5, 2 * r * r)).astype(np.float32)
    want = np.asarray(_pixel_shuffle_2d_in_3d(jnp.asarray(x), r))
    got = last(common.pixel_shuffle_2d_in_3d(first(x, 3), r), 3)
    assert got.shape == want.shape == (2, 3, 4 * r, 5 * r, 2)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kernel,r", [((3, 3, 3), 2), ((1, 3, 3), 3),
                                      ((3, 5, 5), 2)])
def test_fuse_conv3d_through_shuffle2d_matches_jax(rng, kernel, r):
    k = rng.standard_normal((*kernel, 3, 2)).astype(np.float32)  # DHWIO
    b = rng.standard_normal(2).astype(np.float32)
    K, B = jfused_tail.fuse_conv3d_through_shuffle2d(jnp.asarray(k),
                                                     jnp.asarray(b), r)
    got_k, got_b = fuse_conv3d_through_shuffle2d(
        torch.from_numpy(k.transpose(4, 3, 0, 1, 2).copy()),
        torch.from_numpy(b), r)
    np.testing.assert_allclose(got_k.numpy(),
                               np.asarray(K).transpose(4, 3, 0, 1, 2), **EXACT)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(B), **EXACT)


@pytest.mark.parametrize("r,padding", [(2, (1, 1, 1)), (3, (0, 1, 1))])
def test_conv3d_fold_matches_jax_and_the_unfolded_conv(rng, r, padding):
    pre = rng.standard_normal((2, 3, 5, 6, 2 * r * r)).astype(np.float32)
    jconv = jcommon.Conv3D(3, (3, 3, 3), padding=padding, fold_shuffle2d=r)
    variables = init(jconv, pre)
    variables = randomize(variables, rng)
    want = np.asarray(jax.jit(jconv.apply)(variables, pre))
    conv = common.Conv3D(2, 3, padding=padding, fold_shuffle2d=r)
    load_jax_params(conv, variables)
    plain = common.Conv3D(2, 3, padding=padding)
    plain.load_state_dict(conv.state_dict())  # one parameter set
    with torch.no_grad():
        folded = conv(first(pre, 3))
        unfolded = plain(common.pixel_shuffle_2d_in_3d(first(pre, 3), r))
    assert folded.shape == (2, 3 * r * r, 3 - 2 + 2 * padding[0], 5, 6)
    np.testing.assert_allclose(last(folded, 3), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        common.pixel_shuffle_2d_in_3d(folded, r).numpy(), unfolded.numpy(),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kw,match", [
    (dict(strides=(1, 2, 2)), "stride-1, odd-H/W-kernel"),
    (dict(kernel_size=(3, 2, 2), padding=(1, 1, 1)), "stride-1, odd-H/W-kernel"),
    (dict(padding=(1, 0, 0)), "SAME H/W padding")])
def test_conv3d_fold_refusals(kw, match):
    # The JAX module's three refusals, with its messages.
    with pytest.raises(NotImplementedError, match=match):
        common.Conv3D(4, 4, fold_shuffle2d=2, **kw)
    common.Conv3D(4, 4, **kw)  # unfolded, each is a plain conv


def _vol3d_kw(factor, fused_tail):
    return dict(in_channels=1, out_channels=1, num_resblocks=1, num_features=4,
                upscale_factor=factor, fused_tail=fused_tail)


@pytest.mark.parametrize("factor", [2, 3, 4])
@pytest.mark.parametrize("fused_tail", [False, True])
def test_volume3d_forward_and_gradients_match_jax(rng, factor, fused_tail):
    kw = _vol3d_kw(factor, fused_tail)
    x = rng.standard_normal((2, 3, 8, 8, 1)).astype(np.float32)
    target = rng.standard_normal(
        (2, 3, 8 * factor, 8 * factor, 1)).astype(np.float32)
    hold_train_step(JaxVolume3DSRNet(**kw), Volume3DSRNet(**kw), x, target,
                    rng, seed=factor, to_port=lambda a: first(a, 3),
                    spatial_out=3)


@pytest.mark.parametrize("factor,extra", [
    (2, dict(fused_tail=True, remat=True)),
    (2, dict(hoist_tail=True)),
    (4, dict(fused_tail=True, hoist_tail=True)),
    (4, dict())])
def test_volume4d_forward_and_gradients_match_jax(rng, factor, extra):
    kw = dict(in_channels=1, out_channels=1, num_features=4, num_resblocks=1,
              upscale_factor=factor, **extra)
    x = rng.standard_normal((1, 3, 3, 8, 8, 1)).astype(np.float32)
    target = rng.standard_normal(
        (1, 3, 3, 8 * factor, 8 * factor, 1)).astype(np.float32)
    hold_train_step(JaxVolume4DSRNet(**kw), Volume4DSRNet(**kw), x, target,
                    rng, seed=factor, to_port=lambda a: first(a, 3),
                    spatial_out=3)


def _vol4d(seed=0, **kw):
    return Volume4DSRNet(1, 1, num_features=4, num_resblocks=2,
                         generator=torch.Generator().manual_seed(seed), **kw)


def test_volume4d_hidden_state_starts_as_frame_zero(rng):
    net = _vol4d()
    x = torch.from_numpy(rng.standard_normal((2, 3, 1, 3, 6, 6)).astype(
        np.float32))
    with torch.no_grad():
        feats = net.head(x.reshape(6, 1, 3, 6, 6)).reshape(2, 3, 4, 3, 6, 6)
        for seed, want_equal in ((feats[:, 0], True),
                                 (torch.zeros_like(feats[:, 0]), False)):
            hidden, outs = seed, []
            for t in range(3):
                hidden, out = net.step(hidden, feats[:, t])
                outs.append(out)
            equal = torch.equal(torch.stack(outs, 1), net(x))
            assert equal == want_equal


def test_remat_gradients_equal_the_plain_ones(rng):
    x = torch.from_numpy(rng.standard_normal((2, 3, 1, 3, 6, 6)).astype(
        np.float32))
    grads = []
    for remat in (False, True):
        net = _vol4d(remat=remat, fused_tail=True)
        net(x).square().mean().backward()
        grads.append({k: p.grad for k, p in net.named_parameters()})
    plain, rematted = grads
    assert sorted(plain) == sorted(rematted)
    for name, g in plain.items():
        assert (rematted[name] - g).abs().max().item() <= 1e-7, name


def test_a_fused_tail_checkpoint_loads_into_an_unfused_net(rng):
    # The 4D train config trains with fused_tail, the test config serves
    # without it (and with remat): one state_dict for both.
    x = torch.from_numpy(rng.standard_normal((1, 3, 1, 3, 6, 6)).astype(
        np.float32))
    trained = _vol4d(seed=1, fused_tail=True)
    tested = _vol4d(seed=2, remat=True)
    tested.load_state_dict(trained.state_dict(), strict=True)
    with torch.no_grad():
        np.testing.assert_allclose(tested(x).numpy(), trained(x).numpy(),
                                   rtol=1e-5, atol=1e-5)
    variables = randomize(init(JaxVolume3DSRNet(**_vol3d_kw(2, True)),
                               np.zeros((1, 3, 8, 8, 1), np.float32)), rng)
    for fused in (False, True):  # one flax tree for both
        load_jax_params(Volume3DSRNet(**_vol3d_kw(2, fused)), variables)


def test_interop_covers_the_step_and_is_strict(rng):
    x = np.zeros((1, 2, 3, 8, 8, 1), np.float32)
    kw = dict(in_channels=1, out_channels=1, num_features=4, num_resblocks=2,
              upscale_factor=2)
    variables = randomize(init(JaxVolume4DSRNet(**kw), x), rng)
    assert sorted(variables["params"]) == ["Conv3D_0", "step"]
    assert sorted(variables["params"]["step"]) == [
        "Conv3D_0", "Conv3D_1", "Conv3D_2", "_ResBlock3D_0", "_ResBlock3D_1"]
    step = _Vol4DStep(4, 2, 1, 2, 0.1)
    load_jax_params(step, {"params": variables["params"]["step"]})
    np.testing.assert_array_equal(
        step.squeeze.weight.detach().numpy()[:, :, 0, 0, 0],
        variables["params"]["step"]["Conv3D_0"]["Conv_0"]["kernel"][0, 0, 0].T)
    block = _ResBlock3D(4, 0.1)
    load_jax_params(block, {"params": variables["params"]["step"][
        "_ResBlock3D_1"]})
    with pytest.raises(ValueError, match="missing.*step/Conv3D_2"):
        del variables["params"]["step"]["Conv3D_2"]
        load_jax_params(Volume4DSRNet(**kw), variables)


@pytest.mark.parametrize("build,match", [
    (lambda: Volume3DSRNet(1, 1, upscale_factor=1, fused_tail=True),
     "fused_tail needs an upsampling tail"),
    (lambda: Volume3DSRNet(1, 1, upscale_factor=5), "upscale_factor=5"),
    (lambda: Volume3DSRNet(1, 1, dtype="bfloat16"), "dtype=bfloat16"),
    (lambda: _ResBlock3D(4, 0.1, acc_f32=True, dtype=torch.bfloat16),
     "acc_f32"),
    (lambda: Volume4DSRNet(1, 1, upscale_factor=1, fused_tail=True),
     "fused_tail needs an upsampling tail"),
    (lambda: Volume4DSRNet(1, 1, dtype=torch.bfloat16), "dtype="),
    (lambda: Volume4DSRNet(1, 1, carry_f32=True), "carry_f32"),
    (lambda: Volume4DSRNet(1, 1, unroll=2), "TPU lax.scan knob"),
    (lambda: common.Conv3D(4, 4, fold_shuffle2d=2, out_dtype=torch.float32),
     "out_dtype")])
def test_refusals(build, match):
    if match in ("dtype=bfloat16", "acc_f32"):
        # Ported since the bf16 slice: bf16 compute on float32 parameters,
        # and the float32 residual accumulator.
        net = build()
        assert {p.dtype for p in net.parameters()} == {torch.float32}
        x = torch.zeros((1, 1, 2, 4, 4) if match == "dtype=bfloat16"
                        else (1, 4, 2, 4, 4)).bfloat16()
        with torch.no_grad():
            out = net(x)
        assert out.dtype == (torch.bfloat16 if match == "dtype=bfloat16"
                             else torch.float32)
        return
    if match in ("dtype=", "carry_f32"):
        # Volume4DSRNet's bf16 dtype and carry_f32 are ported: float32
        # parameters; carry_f32 is a no-op without a bf16 dtype, and with
        # one the head emits the float32 features the hidden volume keeps.
        net = build()
        assert {p.dtype for p in net.parameters()} == {torch.float32}
        assert not net.carry_f32
        hybrid = Volume4DSRNet(1, 1, num_features=4, num_resblocks=1,
                               dtype=torch.bfloat16, carry_f32=True)
        x = torch.zeros((1, 2, 1, 2, 4, 4))
        assert hybrid.head(x[:, 0]).dtype == torch.float32
        with torch.no_grad():
            out = (hybrid if match == "carry_f32" else net)(x)
        assert out.dtype == torch.bfloat16 and out.shape == (1, 2, 1, 2, 8, 8)
        return
    with pytest.raises(NotImplementedError, match=match):
        build()


def test_a_fold_first_made_under_inference_mode_still_trains(rng):
    # Serving folds the tail under inference_mode and caches the fold's
    # index; a fused tail trained afterwards in the same process records
    # the same fold with autograd.
    from vsr_tpu_torch.ops import fused_tail

    fused_tail._fold_index.cache_clear()
    net = Volume3DSRNet(**_vol3d_kw(2, True))
    x = torch.from_numpy(rng.standard_normal((1, 1, 3, 6, 6)).astype(
        np.float32))
    with torch.inference_mode():
        served = net(x)
    net(x).square().mean().backward()
    assert net.tail.last.weight.grad.abs().max() > 0
    with torch.no_grad():
        torch.testing.assert_close(net(x), served.clone())


def test_volume3d_factor_one_and_step_modes(rng):
    # Factor 1 without a fold is a plain trunk + final conv, as in JAX.
    kw = dict(in_channels=1, out_channels=1, num_resblocks=1, num_features=4,
              upscale_factor=1)
    x = rng.standard_normal((1, 3, 6, 6, 1)).astype(np.float32)
    jnet = JaxVolume3DSRNet(**kw)
    variables = randomize(init(jnet, x), rng)
    net = Volume3DSRNet(**kw)
    load_jax_params(net, variables)
    with torch.no_grad():
        got = last(net(first(x, 3)), 3)
    np.testing.assert_allclose(got, np.asarray(jnet.apply(variables, x)),
                               rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError, match="mode must be one of"):
        _vol4d().step(torch.zeros(1), None, "scan")
