"""The port's FRVSR net against ``vsr_tpu``'s, weight for weight
(``load_jax_params``): a train step of the FRVSR trainer's two-term loss
(outputs at 2e-4, every parameter's gradient within 1e-3 of its largest JAX
entry), ``is_prediction``, the x3 tail, and the refusals."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import (FORWARD_TOL, first, hold_train_step, init,
                                 last, randomize, window)
from vsr_tpu.models import FRVSRNet as JaxFRVSRNet
from vsr_tpu_torch.interop import load_jax_params
from vsr_tpu_torch.models import FRVSRNet
from vsr_tpu_torch.registry import get_class


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_frvsr_train_step_matches_jax(rng):
    # x4 as the configs; 6 x 10 LR frames: FNet pads them to 8 x 16.
    n, t, f = 2, 3, 4
    x = rng.standard_normal((n, t, 6, 10, 1)).astype(np.float32)
    hr = rng.standard_normal((n, t, 6 * f, 10 * f, 1)).astype(np.float32)
    kw = dict(in_channels=1, out_channels=1, upscale_factor=f,
              num_resblocks=1)

    def loss_of(out):  # the FRVSR trainer's two terms, frame means
        sr, warped = out
        return (jnp.mean(jnp.abs(sr - hr))
                + jnp.mean((warped - jnp.asarray(x)) ** 2))

    def port_loss_of(out):
        sr, warped = out
        return (torch.mean(torch.abs(sr - first(hr)))
                + torch.mean((warped - window(x)) ** 2))

    net = FRVSRNet(**kw)
    variables = hold_train_step(JaxFRVSRNet(**kw), net, x, hr, rng,
                                out_of=lambda o: o[0], loss_of=loss_of,
                                port_loss_of=port_loss_of)
    # is_prediction: the SR frames alone, the same ones.
    jpred = JaxFRVSRNet(**kw, is_prediction=True)
    want = jax.jit(jpred.apply)(variables, jnp.asarray(x))
    pred = FRVSRNet(**kw, is_prediction=True).eval()
    load_jax_params(pred, variables)
    with torch.no_grad():
        got = pred(window(x))
    assert isinstance(got, torch.Tensor) and got.shape == (n, t, 1, 24, 40)
    np.testing.assert_allclose(last(got), np.asarray(want), **FORWARD_TOL)


def test_frvsr_x3_tail_matches_jax(rng):
    kw = dict(in_channels=1, out_channels=1, upscale_factor=3,
              num_resblocks=1)
    x = rng.standard_normal((1, 2, 8, 8, 1)).astype(np.float32)
    jnet = JaxFRVSRNet(**kw)
    variables = randomize(init(jnet, x), rng)
    want_sr, want_warped = jax.jit(jnet.apply)(variables, jnp.asarray(x))
    net = FRVSRNet(**kw)
    load_jax_params(net, variables)
    with torch.no_grad():
        sr, warped = net(window(x))
    np.testing.assert_allclose(last(sr), np.asarray(want_sr), **FORWARD_TOL)
    np.testing.assert_allclose(last(warped), np.asarray(want_warped),
                               **FORWARD_TOL)


@pytest.mark.parametrize("kw,match", [
    (dict(unroll=2), "unroll"),
    (dict(carry_f32=True), "carry_f32")])
def test_frvsr_refuses_tpu_knobs_by_name(kw, match):
    if match == "carry_f32":
        # Ported with the bf16 policy: a no-op without a bf16 dtype, as in
        # JAX; with one the final SR conv emits float32.
        assert not FRVSRNet(1, 1, 4, **kw).carry_f32
        net = FRVSRNet(1, 1, 4, num_resblocks=1, dtype="bfloat16", **kw)
        assert net.carry_f32
        assert {p.dtype for p in net.parameters()} == {torch.float32}
        with torch.no_grad():
            sr, warped = net(torch.zeros(1, 2, 1, 8, 8))
        assert sr.dtype == torch.float32 and sr.shape == (1, 2, 1, 32, 32)
        assert warped.dtype == torch.float32
        return
    with pytest.raises(NotImplementedError, match=match):
        FRVSRNet(1, 1, 4, **kw)
    assert FRVSRNet.serving_mode == "video"
    assert get_class("net", "FRVSRNet") is FRVSRNet


def test_frvsr_is_served_in_video_mode(rng):
    """``infer``'s video mode serves the SR frames of the pair FRVSR
    returns: the same frames as the net built with ``is_prediction``."""
    from vsr_tpu_torch.infer import make_pipeline

    kw = dict(in_channels=1, out_channels=1, upscale_factor=2,
              num_resblocks=1)
    net = FRVSRNet(**kw, generator=torch.Generator().manual_seed(0))
    pred = FRVSRNet(**kw, is_prediction=True)
    pred.load_state_dict(net.state_dict())
    frames = torch.from_numpy(rng.uniform(0, 255, (6, 24, 24)).astype(
        np.float32))  # one slice of 6 frames
    _, sr = make_pipeline(net, 2, "acdc", video_t=6)(frames)
    _, want = make_pipeline(pred, 2, "acdc", video_t=6)(frames)
    assert sr.shape == (6, 24, 24) and torch.equal(sr, want)
