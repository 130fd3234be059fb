"""The port's DRFNet modules against the flax ones, weight for weight: the
same numpy-seeded inputs, the flax variables carried by ``load_jax_params``.
JAX runs as its own tests run it (the Pallas fused squeeze in interpret
mode on the CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import init, randomize
from vsr_tpu.models import DRFNet as JaxDRFNet
from vsr_tpu.models import common as jcommon
from vsr_tpu.models import feedback as jfeedback
from vsr_tpu_torch.interop import load_jax_params
from vsr_tpu_torch.models import DRFNet
from vsr_tpu_torch.models import common, feedback


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, -3)))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), -3, -1)


def _jax(module, *xs, seed=0):
    """A flax module's variables drawn with numpy over its traced shapes
    (``tests/_torch_parity.init``: no flax init compiled; biases
    randomized, PReLU alphas at flax's 0.2) and its jitted output; returns
    (numpy variables, numpy output)."""
    variables = jax.tree_util.tree_map_with_path(
        lambda path, v: np.full_like(v, 0.2) if path[-1].key == "alpha" else v,
        randomize(init(module, *xs, seed=seed), np.random.default_rng(seed)))
    args = [jnp.asarray(x) for x in xs]
    return variables, np.asarray(jax.jit(module.apply)(variables, *args))


@pytest.mark.parametrize("k,s,p", [(3, 1, 1), (1, 1, 0), (6, 2, 2)])
def test_conv(rng, k, s, p):
    x = rng.standard_normal((2, 12, 12, 3)).astype(np.float32)
    variables, want = _jax(jcommon.Conv(5, k, strides=s, padding=p), x)
    conv = common.Conv(3, 5, k, s, p)
    load_jax_params(conv, variables)
    with torch.no_grad():
        got = _nhwc(conv(_nchw(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_conv_transpose_k6_s2_p2(rng):
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    variables, want = _jax(jcommon.ConvTranspose(3, 6, 2, 2), x)
    deconv = common.ConvTranspose(4, 3, 6, 2, 2)
    load_jax_params(deconv, variables)
    with torch.no_grad():
        got = _nhwc(deconv(_nchw(x)))
    assert got.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_prelu(rng):
    x = rng.standard_normal((2, 6, 6, 3)).astype(np.float32)
    variables, want = _jax(jfeedback.PReLU(), x)
    act = feedback.PReLU()
    load_jax_params(act, variables)
    with torch.no_grad():
        got = _nhwc(act(_nchw(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("factor", [2, 3])
def test_shuffle_conv(rng, fused, factor):
    x = rng.standard_normal((2, 6, 6, 4 * factor * factor)).astype(np.float32)
    variables, want = _jax(jcommon.ShuffleConv(2, 3, factor=factor,
                                               fused=fused), x)
    tail = common.ShuffleConv(4, 2, 3, factor=factor, fused=fused)
    load_jax_params(tail, variables)
    with torch.no_grad():
        got = _nhwc(tail(_nchw(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("groups", [2, 3])
@pytest.mark.parametrize("fused_squeeze", [False, True])
def test_fblock(rng, groups, fused_squeeze):
    f = 8
    x = rng.standard_normal((2, 8, 8, f)).astype(np.float32)
    h = rng.standard_normal((2, 8, 8, f)).astype(np.float32)
    variables, want = _jax(jfeedback.FBlock(f, groups, 2,
                                            fused_squeeze=fused_squeeze), x, h)
    block = feedback.FBlock(f, groups, 2, fused_squeeze=fused_squeeze)
    n_fused = sum(isinstance(m, common.FusedSqueezeConv) for m in block.convs)
    assert n_fused == (2 * groups if fused_squeeze else 0)
    load_jax_params(block, variables)
    with torch.no_grad():
        got = _nhwc(block(_nchw(x), _nchw(h)))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("groups", [2, 3])
@pytest.mark.parametrize("fused_squeeze", [False, True])
@pytest.mark.parametrize("fused_tail", [False, True])
def test_drfnet(rng, groups, fused_squeeze, fused_tail):
    kw = dict(in_channels=1, out_channels=1, num_features=8,
              num_groups=groups, upscale_factor=2, fused_tail=fused_tail,
              fused_squeeze=fused_squeeze)
    x = rng.standard_normal((2, 3, 8, 8, 1)).astype(np.float32)
    variables, want = _jax(JaxDRFNet(**kw), x, seed=3)
    net = DRFNet(**kw)
    load_jax_params(net, variables)
    with torch.no_grad():
        got = _nhwc(net(_nchw(x)))
    assert got.shape == want.shape == (2, 3, 16, 16, 1)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert np.abs(want).max() > 1e-3


def test_load_jax_params_is_strict(rng):
    kw = dict(in_channels=1, out_channels=1, num_features=4, num_groups=2,
              upscale_factor=2)
    x = np.zeros((1, 2, 8, 8, 1), np.float32)
    variables, _ = _jax(JaxDRFNet(**kw), x)
    net = DRFNet(**kw)
    extra = {"params": dict(variables["params"], Extra_0={"kernel": x})}
    with pytest.raises(ValueError, match="unused flax leaves.*Extra_0"):
        load_jax_params(net, extra)
    with pytest.raises(ValueError, match="missing.*InBlock_0"):
        load_jax_params(net, {"params": {
            k: v for k, v in variables["params"].items() if k != "InBlock_0"}})
    with pytest.raises(ValueError, match="flax shape"):
        load_jax_params(DRFNet(**dict(kw, num_features=6)), variables)
    with pytest.raises(ValueError, match="'params' collection"):
        load_jax_params(net, dict(variables, cache={}))
    with pytest.raises(ValueError, match="'params' collection"):
        load_jax_params(net, {"batch_stats": {}})
    with pytest.raises(ValueError, match="unused flax leaves.*batch_stats"):
        load_jax_params(net, dict(variables, batch_stats={
            "BatchNorm_0": {"mean": np.zeros(4, np.float32)}}))


@pytest.mark.parametrize("kw,match", [
    # carry_f32 is ported (tests/test_torch_precision.py); with the MoE
    # blocks it is refused, as in the JAX net.
    (dict(carry_f32=True, num_experts=2, dtype="bfloat16"), "carry_f32"),
    (dict(carry_f32=True, fused_squeeze=True, dtype="bfloat16"),
     "does not compose"),
    (dict(unroll=1), "unroll"),
    (dict(split_transpose=False), "split_transpose"),
])
def test_unported_knobs_raise(kw, match):
    with pytest.raises(NotImplementedError, match=match):
        DRFNet(1, 1, 4, 2, 2, **kw)


def test_seeded_init_is_deterministic_and_bf16_casts():
    def make(seed, **kw):
        return DRFNet(1, 1, 4, 2, 2, generator=torch.Generator().manual_seed(seed),
                      **kw)

    a, b, c = make(0), make(0), make(1)
    pa, pb, pc = (torch.cat([p.flatten() for p in n.parameters()])
                  for n in (a, b, c))
    assert torch.equal(pa, pb) and not torch.equal(pa, pc)
    half = make(0, dtype="bfloat16")  # bf16 compute, float32 parameters
    assert {p.dtype for p in half.parameters()} == {torch.float32}
    assert torch.equal(torch.cat([p.flatten() for p in half.parameters()]), pa)
    with torch.no_grad():
        out = half(torch.zeros(1, 2, 1, 8, 8))
    assert out.dtype == torch.bfloat16 and out.shape == (1, 2, 1, 16, 16)
