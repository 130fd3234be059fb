"""The port's DUF net and its 3D blocks against the flax ones, weight for
weight: the same numpy-seeded inputs, the flax variables (``params`` and
``batch_stats``, with non-trivial running statistics) carried by
``load_jax_params``. JAX runs as its own tests run it on the CPU: the Pallas
dynamic-filter kernel in interpret mode."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vsr_tpu.ops.pallas_duf as pallas_duf
from tests._torch_parity import init as _init
from vsr_tpu.models import DUFNet as JaxDUFNet
from vsr_tpu.models import common as jcommon
from vsr_tpu.models import duf as jduf
from vsr_tpu_torch.interop import load_jax_params
from vsr_tpu_torch.models import DUFNet, EDSRNet
from vsr_tpu_torch.models import common, duf

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def interpret_mode(monkeypatch):
    """Run ``duf_dynamic_filter_pallas`` in the Pallas interpreter."""
    from jax.experimental import pallas as pl

    original = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return original(*args, **kwargs)

    monkeypatch.setattr(pallas_duf.pl, "pallas_call", interp)
    pallas_duf.duf_dynamic_filter_pallas._clear_cache()
    yield
    pallas_duf.duf_dynamic_filter_pallas._clear_cache()


def _first(x, ndim_spatial=2):
    """Channels-last numpy -> channel-first torch."""
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(x, -1, -ndim_spatial - 1)))


def _last(t, ndim_spatial=2):
    return np.moveaxis(t.detach().numpy(), -ndim_spatial - 1, -1)


def _apply(module, variables, x, **kw):
    """``module.apply`` under ``jit``: eager, DUF's backbone runs op by op
    and took most of this file's time."""
    return np.asarray(jax.jit(functools.partial(module.apply, **kw))(
        variables, jnp.asarray(x)))


def _randomize(variables, rng):
    """Non-trivial BatchNorm state and biases: random running mean / var,
    scale and bias (the init values 0 / 1 would hide a swapped leaf), and
    non-zero values for every zero-initialised leaf."""
    def fill(path, leaf):
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.7, 1.3, leaf.shape).astype(np.float32)
        if name in ("mean", "bias", "expert_bi", "expert_bo"):
            return (0.2 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return leaf
    return jax.tree_util.tree_map_with_path(fill, variables)


def test_conv3d(rng):
    x = rng.standard_normal((2, 5, 6, 7, 3)).astype(np.float32)
    jconv = jcommon.Conv3D(4, (3, 3, 3), padding=(0, 1, 1))
    variables = _randomize(_init(jconv, x), rng)
    want = _apply(jconv, variables, x)
    conv = common.Conv3D(3, 4, (3, 3, 3), padding=(0, 1, 1))
    load_jax_params(conv, variables)
    with torch.no_grad():
        got = _last(conv(_first(x, 3)), 3)
    assert got.shape == want.shape == (2, 3, 6, 7, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kw", [dict(fold_shuffle2d=2),
                                dict(out_dtype=torch.float32)])
def test_conv3d_refuses_volumetric_knobs(kw):
    if "out_dtype" in kw:
        # Ported since the bf16 slice: bf16 operands accumulated in float32
        # and not rounded back; refused with the fold, as in the JAX module.
        with pytest.raises(NotImplementedError, match="out_dtype"):
            common.Conv3D(4, 4, fold_shuffle2d=2, **kw)
        conv = common.Conv3D(4, 4, dtype="bfloat16", **kw)
        x = torch.randn(1, 4, 3, 5, 6, generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            got = conv(x)
            want = torch.nn.functional.conv3d(
                x.bfloat16().double(), conv.weight.bfloat16().double(),
                conv.bias.bfloat16().double(), padding=1)
        assert got.dtype == torch.float32
        torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=1e-5)
        return
    # Ported since the volumetric slice: the conv folded through the
    # in-plane shuffle before it, on the plain conv's parameters.
    conv = common.Conv3D(4, 4, **kw)
    plain = common.Conv3D(4, 4)
    plain.load_state_dict(conv.state_dict())
    pre = torch.randn(1, 16, 3, 5, 6, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        folded = common.pixel_shuffle_2d_in_3d(conv(pre), 2)
        want = plain(common.pixel_shuffle_2d_in_3d(pre, 2))
    assert folded.shape == want.shape == (1, 4, 3, 10, 12)
    torch.testing.assert_close(folded, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backbone", ["_DenseLayer16"])
def test_dense_backbone(rng, backbone):
    x = rng.standard_normal((1, 7, 6, 6, 64)).astype(np.float32)
    jback = jduf._DenseBackbone(backbone)
    variables = _randomize(_init(jback, x, train=False), rng)
    want = _apply(jback, variables, x, train=False)
    back = duf._DenseBackbone(backbone).eval()
    load_jax_params(back, variables)
    with torch.no_grad():
        got = _last(back(_first(x, 3)), 3)
    assert got.shape == want.shape == (1, 1, 6, 6, 256)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("backbone,use_pallas_filter", [
    ("_DenseLayer16", False), ("_DenseLayer16", True),
    ("_DenseLayer28", True), ("_DenseLayer52", False)])
def test_dufnet(rng, interpret_mode, backbone, use_pallas_filter):
    kw = dict(in_channels=1, out_channels=1, num_frames=7, size_filter=5,
              upscale_factor=2, backbone=backbone,
              use_pallas_filter=use_pallas_filter)
    x = rng.standard_normal((2, 7, 8, 8, 1)).astype(np.float32)
    jnet = JaxDUFNet(**kw)
    variables = _randomize(_init(jnet, x, seed=5, train=False), rng)
    assert set(variables) == {"params", "batch_stats"}
    want = _apply(jnet, variables, x, train=False)
    net = DUFNet(**kw).eval()
    load_jax_params(net, variables)
    with torch.no_grad():
        got = _last(net(torch.from_numpy(
            np.ascontiguousarray(np.moveaxis(x, -1, 2)))))
    assert got.shape == want.shape == (2, 16, 16, 1)
    np.testing.assert_allclose(got, want, **TOL)
    assert np.abs(want).std() > 1e-2


def test_dufnet_even_window_and_three_channels(rng):
    # The general-C route (no kernel, whatever use_pallas_filter says) and
    # the even window's target frame, nf // 2 - 1.
    kw = dict(in_channels=3, out_channels=3, num_frames=8, size_filter=3,
              upscale_factor=2, use_pallas_filter=True)
    x = rng.standard_normal((1, 8, 8, 8, 3)).astype(np.float32)
    jnet = JaxDUFNet(**kw)
    variables = _randomize(_init(jnet, x, seed=6, train=False), rng)
    want = _apply(jnet, variables, x, train=False)
    net = DUFNet(**kw).eval()
    load_jax_params(net, variables)
    with torch.no_grad():
        got = _last(net(torch.from_numpy(
            np.ascontiguousarray(np.moveaxis(x, -1, 2)))))
    assert got.shape == want.shape == (1, 16, 16, 3)
    np.testing.assert_allclose(got, want, **TOL)


def test_dufnet_refusals():
    with pytest.raises(ValueError, match="Unknown backbone"):
        DUFNet(1, 1, 7, 5, 2, backbone="_DenseLayer99")
    net = DUFNet(1, 1, 7, 3, 2).eval()
    with pytest.raises(ValueError, match="windows of 7"):
        net(torch.zeros(1, 5, 1, 8, 8))


def test_load_jax_params_fills_buffers_strictly(rng):
    x = np.zeros((1, 7, 8, 8, 1), np.float32)
    kw = dict(in_channels=1, out_channels=1, num_frames=7, size_filter=3,
              upscale_factor=2)
    variables = _randomize(_init(JaxDUFNet(**kw), x, train=False), rng)
    net = DUFNet(**kw)
    load_jax_params(net, variables)
    stats = variables["batch_stats"]["_DenseBackbone_0"]["BatchNorm_0"]
    np.testing.assert_array_equal(net.backbone.norm.running_mean.numpy(),
                                  stats["mean"])
    np.testing.assert_array_equal(net.backbone.norm.running_var.numpy(),
                                  stats["var"])
    with pytest.raises(ValueError, match="missing.*batch_stats"):
        load_jax_params(net, {"params": variables["params"]})
    with pytest.raises(ValueError, match="unused flax leaves.*batch_stats"):
        load_jax_params(EDSRNet(1, 1, 1, 4, 2), variables)
    with pytest.raises(ValueError, match="'params' collection"):
        load_jax_params(net, dict(variables, cache={}))


