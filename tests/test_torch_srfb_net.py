"""The feedback SISR net and what it stands on: the matrix up-samplers, the
parameter-free ``Bicubic`` net, ``SRFBNet`` forward and gradients (with the
fused squeeze on and off) and its weights carried through ``interop``, each
against ``vsr_tpu`` on the same numpy-seeded inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import init, randomize
from vsr_tpu.models.bicubic import Bicubic as JaxBicubic
from vsr_tpu.models.srfbn import SRFBNet as JaxSRFBNet
from vsr_tpu.ops import upsample as jupsample
from vsr_tpu_torch.interop import from_jax_tree, load_jax_params, module_slots
from vsr_tpu_torch.models import Bicubic, SRFBNet
from vsr_tpu_torch.ops import upsample
from vsr_tpu_torch.registry import build

KWARGS = dict(in_channels=1, out_channels=1, num_steps=2, num_features=8,
              num_groups=2, upscale_factor=2)


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, -3)))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), -3, -1)


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("mode", ["bicubic", "bilinear"])
@pytest.mark.parametrize("sizes", [(12, 24), (24, 12), (7, 19), (5, 1)])
def test_resize_matrix_is_bit_equal_to_the_jax_packages(mode, align_corners, sizes):
    got = upsample._resize_matrix_1d(*sizes, mode, align_corners)
    want = jupsample._resize_matrix_1d(*sizes, mode, align_corners)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_resize_matrix_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="nearest"):
        upsample._resize_matrix_1d(4, 8, "nearest", False)
    with pytest.raises(ValueError, match="scale or size"):
        upsample.upsample_bilinear(torch.zeros(1, 1, 4, 4))


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("name", ["upsample_bicubic", "upsample_bilinear"])
@pytest.mark.parametrize("how", [dict(scale=2), dict(scale=3),
                                 dict(size=(17, 9))])
def test_upsample_matches_jax(rng, name, align_corners, how):
    x = rng.standard_normal((2, 12, 14, 3)).astype(np.float32)
    want = np.asarray(getattr(jupsample, name)(
        jnp.asarray(x), align_corners=align_corners, **how))
    got = getattr(upsample, name)(_nchw(x), align_corners=align_corners, **how)
    assert got.dtype == torch.float32
    # Two float32 products of the same float64-built matrices.
    np.testing.assert_allclose(_nhwc(got), want, atol=1e-5, rtol=0)


def test_upsample_keeps_the_dtype_and_restores_the_tf32_flag(rng):
    x = torch.from_numpy(rng.standard_normal((1, 1, 6, 6)).astype(np.float32))
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        out = upsample.upsample_bilinear(x.bfloat16(), scale=2)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    assert out.dtype == torch.bfloat16 and out.shape == (1, 1, 12, 12)


@pytest.mark.parametrize("factor", [2, 3])
def test_bicubic_net_matches_jax_and_has_no_parameters(rng, factor):
    x = rng.standard_normal((2, 9, 11, 1)).astype(np.float32)
    jnet = JaxBicubic(upscale_factor=factor)
    want = np.asarray(jnet.apply(jnet.init(jax.random.PRNGKey(0),
                                           jnp.asarray(x)), jnp.asarray(x)))
    net = build("net", {"name": "Bicubic",
                        "kwargs": {"upscale_factor": factor}}, device="cpu")
    assert isinstance(net, Bicubic) and not list(net.parameters())
    np.testing.assert_allclose(_nhwc(net(_nchw(x))), want, atol=1e-5, rtol=0)


def _jax_net_and_variables(fused_squeeze, rng, steps=2):
    kwargs = dict(KWARGS, num_steps=steps)
    jnet = JaxSRFBNet(**kwargs, fused_squeeze=fused_squeeze)
    # Drawn with numpy over the traced shapes (no flax init compiled).
    variables = randomize(init(jnet, np.zeros((1, 12, 12, 1), np.float32),
                               seed=2), np.random.default_rng(2))
    # Distinct PReLU weights, a negative one among them.
    alphas = iter(rng.uniform(-0.3, 0.5, 64).astype(np.float32))
    variables = jax.tree_util.tree_map_with_path(
        lambda path, a: np.full(a.shape, next(alphas), np.float32)
        if path[-1].key == "alpha" else np.asarray(a), variables)
    return jnet, variables, kwargs


@pytest.mark.parametrize("fused_squeeze", [False, True])
def test_srfbnet_forward_matches_jax(rng, fused_squeeze):
    jnet, variables, kwargs = _jax_net_and_variables(fused_squeeze, rng, steps=3)
    x = rng.standard_normal((2, 12, 14, 1)).astype(np.float32)
    want = np.asarray(jax.jit(jnet.apply)(variables, jnp.asarray(x)))
    net = SRFBNet(**kwargs, fused_squeeze=fused_squeeze, device="cpu")
    load_jax_params(net, variables)
    with torch.no_grad():
        got = net(_nchw(x))
    assert got.shape == (3, 2, 1, 24, 28)
    np.testing.assert_allclose(_nhwc(got), want, atol=2e-4, rtol=0)
    # The steps share one parameter set and differ in their outputs.
    assert not np.allclose(want[0], want[-1])


@pytest.mark.parametrize("fused_squeeze", [False, True])
def test_srfbnet_parameter_gradients_match_jax(rng, fused_squeeze):
    jnet, variables, kwargs = _jax_net_and_variables(fused_squeeze, rng)
    x = rng.standard_normal((2, 12, 12, 1)).astype(np.float32)
    target = rng.standard_normal((2, 24, 24, 1)).astype(np.float32)

    def loss(params):
        out = jnet.apply({"params": params}, jnp.asarray(x))
        return jnp.mean(jnp.abs(out - jnp.asarray(target)[None]))

    want = jax.tree_util.tree_map(np.asarray,
                                  jax.jit(jax.grad(loss))(variables["params"]))
    net = SRFBNet(**kwargs, fused_squeeze=fused_squeeze, device="cpu")
    load_jax_params(net, variables)
    torch.mean(torch.abs(net(_nchw(x)) - _nchw(target)[None])).backward()
    want = from_jax_tree(net, want)
    names = [name for name, _ in net.named_parameters()]
    assert sorted(want) == sorted(names)
    for name, p in net.named_parameters():
        scale = np.abs(want[name]).max()
        assert scale > 0, name
        np.testing.assert_allclose(p.grad.numpy(), want[name],
                                   atol=1e-3 * scale, rtol=0, err_msg=name)


def test_srfbnet_slots_cover_the_scanned_steps_one_parameter_set(rng):
    _, variables, kwargs = _jax_net_and_variables(False, rng)
    net = SRFBNet(**kwargs, device="cpu")
    paths = ["/".join(path) for path, _, _ in module_slots(net)]
    flat = jax.tree_util.tree_flatten_with_path(variables)[0]
    assert sorted(paths) == sorted("/".join(k.key for k in path)
                                   for path, _ in flat)
    assert any(p.startswith("params/Scan_SRFBStep_0/_RBlock_0/") for p in paths)
    missing = {"params": {k: v for k, v in variables["params"].items()
                          if k != "InBlock_0"}}
    with pytest.raises(ValueError, match="missing"):
        load_jax_params(net, missing)


@pytest.mark.parametrize("kw,match", [
    (dict(unroll=2), "unroll"),
    (dict(carry_f32=True, fused_squeeze=True, dtype="bfloat16"), "carry_f32"),
    (dict(upscale_factor=5), "upscale factor")])
def test_srfbnet_refuses_unported_knobs_by_name(kw, match):
    with pytest.raises((NotImplementedError, ValueError), match=match):
        SRFBNet(**{**KWARGS, **kw})


def test_srfbnet_builds_from_the_config_kwargs_and_takes_bf16():
    net = build("net", {"name": "SRFBNet", "kwargs": dict(
        KWARGS, fused_squeeze=True, unroll=1, dtype="bfloat16")}, device="cpu",
        generator=torch.Generator().manual_seed(0))
    out = net(torch.zeros(1, 1, 8, 8))
    # float32 parameters, bf16 convs; the bilinear global residual keeps the
    # float32 input's dtype, so the outputs are float32, as in the JAX net.
    assert {p.dtype for p in net.parameters()} == {torch.float32}
    assert out.dtype == torch.float32 and out.shape == (2, 1, 1, 16, 16)


def test_srfbnet_hands_the_squeeze_contiguous_features(monkeypatch):
    """A channels-last input makes the library's convs return channels-last
    features; the fused squeeze's kernel takes contiguous NCHW only."""
    from vsr_tpu_torch.models import common

    seen = []
    plain = common.concat_conv1x1

    def spy(xs, *args):
        seen.extend(x.is_contiguous() for x in xs)
        return plain(xs, *args)

    monkeypatch.setattr(common, "concat_conv1x1", spy)
    net = SRFBNet(**dict(KWARGS, in_channels=3), fused_squeeze=True,
                  device="cpu")
    x = torch.rand(2, 3, 8, 8).contiguous(memory_format=torch.channels_last)
    net(x)
    assert seen and all(seen)
