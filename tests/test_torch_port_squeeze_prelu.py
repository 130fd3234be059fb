"""The redesigned kernels' arithmetic, held on the CPU.

- The fused squeeze with its PReLU epilogue: the plain twin with
  ``prelu_weight`` against the JAX ``concat_matmul`` (Pallas, interpret mode)
  followed by the flax PReLU, on the same numpy-seeded inputs; the feedback
  block and DRFNet, which now hand the squeeze its PReLU, against flax.
- The float32 route of the CUDA kernel (three TF32 products of split
  operands), modelled in numpy against a float64 product.
- The pairwise rank's one-compare form (``>=`` below the diagonal, ``>``
  above), modelled in numpy against the two-compare twin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import init, randomize
from vsr_tpu.models import DRFNet as JaxDRFNet
from vsr_tpu.models import feedback as jfeedback
from vsr_tpu.ops.fused_squeeze import concat_matmul
from vsr_tpu_torch.interop import load_jax_params
from vsr_tpu_torch.models import DRFNet, common, feedback
from vsr_tpu_torch.ops import fused_squeeze as fs
from vsr_tpu_torch.ops.rank import pairwise_rank_reference


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, -3)))


def _nhwc(t):
    return np.moveaxis(t.detach().float().numpy(), -3, -1)


# ------------------------------------------- squeeze + PReLU: twin vs JAX

CHANNELS = {"k1": (16,), "k2": (16, 16), "k6": (16,) * 6, "k8": (8,) * 8,
            "ragged": (3, 17, 40)}


def _squeeze_operands(rng, channels, f=12, alpha=0.2):
    xs = [rng.standard_normal((2, 5, 7, c)).astype(np.float32)
          for c in channels]
    w = (rng.standard_normal((sum(channels), f)) * 0.1).astype(np.float32)
    b = rng.standard_normal(f).astype(np.float32)
    return xs, w, b, np.full((1,), alpha, np.float32)


def _jax_squeeze_prelu(xs, w, b, alpha, dtype):
    y = concat_matmul(tuple(jnp.asarray(x, dtype) for x in xs),
                      jnp.asarray(w), jnp.asarray(b))
    y = jfeedback.PReLU().apply({"params": {"alpha": jnp.asarray(alpha)}}, y)
    assert y.dtype == dtype
    return np.asarray(y.astype(jnp.float32))


@pytest.mark.parametrize("case", sorted(CHANNELS))
def test_twin_with_prelu_matches_jax_f32(rng, case):
    xs, w, b, alpha = _squeeze_operands(rng, CHANNELS[case])
    want = _jax_squeeze_prelu(xs, w, b, alpha, jnp.float32)
    got = fs.concat_conv1x1(
        [_nchw(x) for x in xs], torch.from_numpy(w.T.copy()),
        torch.from_numpy(b), torch.from_numpy(alpha))
    assert (want < 0).any() and (want > 0).any()
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", sorted(CHANNELS))
def test_twin_with_prelu_matches_jax_bf16(rng, case):
    """Both sides round operands and results to bf16 and sum in another
    order: one bf16 rounding of the squeeze and one of the PReLU."""
    xs, w, b, alpha = _squeeze_operands(rng, CHANNELS[case])
    want = _jax_squeeze_prelu(xs, w, b, alpha, jnp.bfloat16)
    got = fs.concat_conv1x1(
        [_nchw(x).bfloat16() for x in xs], torch.from_numpy(w.T.copy()),
        torch.from_numpy(b), torch.from_numpy(alpha))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_nhwc(got), want, rtol=8e-3, atol=2e-2)


@pytest.mark.parametrize("alpha_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CHANNELS))
def test_fused_then_activated_is_twin_then_prelu_bit_for_bit(rng, case,
                                                             alpha_dtype):
    xs, w, b, alpha = _squeeze_operands(rng, CHANNELS[case], alpha=0.3)
    xs16 = [_nchw(x).bfloat16() for x in xs]
    wt, bt = torch.from_numpy(w.T.copy()), torch.from_numpy(b)
    at = torch.from_numpy(alpha).to(alpha_dtype)
    got = fs.concat_conv1x1(xs16, wt, bt, at)
    act = torch.nn.PReLU(1).bfloat16()
    with torch.no_grad():
        act.weight.copy_(at)
        want = act(fs.concat_conv1x1_reference(xs16, wt, bt))
    assert got.dtype == want.dtype == torch.bfloat16
    assert torch.equal(got, want)
    # The epilogue's own formula on the rounded output, in float32.
    r = fs.concat_conv1x1_reference(xs16, wt, bt).float()
    a = at.bfloat16().float()
    assert torch.equal(got, torch.where(r > 0, r, a * r).bfloat16())


@pytest.mark.parametrize("case,error,match", [
    ("shape", ValueError, "one value"),
    ("device", ValueError, "inputs' device"),
    ("dtype", TypeError, "float32 or bfloat16"),
])
def test_wrong_prelu_weight_raises(case, error, match):
    xs = [torch.zeros(1, 2, 3, 3), torch.zeros(1, 2, 3, 3)]
    w, b = torch.zeros(4, 4), torch.zeros(4)
    alpha = {"shape": torch.zeros(4),
             "device": torch.zeros(1, device="meta"),
             "dtype": torch.zeros(1, dtype=torch.float64)}[case]
    with pytest.raises(error, match=match):
        fs.concat_conv1x1(xs, w, b, alpha)
    with pytest.raises(error, match=match):
        fs.concat_conv1x1_reference(xs, w, b, alpha)


def test_requires_grad_refusal_covers_the_prelu_weight(monkeypatch):
    """The CUDA branch no longer refuses a call that needs gradients: it
    launches the kernel WITHOUT its epilogue and applies the PReLU as an
    autograd op, whichever operand asks for the gradient, so the PReLU
    weight's gradient is never dropped; without gradients the epilogue
    stays fused."""
    launched = []

    class OnCuda(torch.Tensor):
        """A CPU tensor that says it lies on a CUDA device."""

        @property
        def device(self):
            return torch.device("cuda", 0)

    def cuda_like(t):
        return t.as_subclass(OnCuda)

    def plain(t):
        return None if t is None else t.detach().as_subclass(torch.Tensor)

    def fake_launch(xs, weight, bias, prelu_weight, counter="launches"):
        launched.append((counter, prelu_weight is not None))
        return cuda_like(fs.concat_conv1x1_reference(
            [plain(x) for x in xs], plain(weight), plain(bias),
            plain(prelu_weight)))

    def fake_dw(xs, g):
        return tuple(cuda_like(t) for t in fs.concat_conv1x1_dw_reference(
            [plain(x) for x in xs], plain(g)))

    monkeypatch.setattr(fs, "_launch", fake_launch)
    monkeypatch.setattr(fs, "concat_conv1x1_dw", fake_dw)
    gen = torch.Generator().manual_seed(0)
    xs = [cuda_like(torch.randn(1, 2, 3, 3, generator=gen)) for _ in range(2)]
    b = cuda_like(torch.randn(4, generator=gen))
    for grad_on in ("weight", "alpha"):
        w = cuda_like(torch.randn(4, 4, generator=gen))
        alpha = cuda_like(torch.full((1,), -0.3))
        leaf = w if grad_on == "weight" else alpha
        leaf.requires_grad_(True)
        launched.clear()
        fs.concat_conv1x1(xs, w, b, alpha).sum().backward()
        assert launched == [("launches", False)]  # no fused epilogue
        wr, ar = plain(w).requires_grad_(True), plain(alpha).requires_grad_(True)
        fs.concat_conv1x1_reference([plain(x) for x in xs], wr, plain(b),
                                    ar).sum().backward()
        want = wr.grad if grad_on == "weight" else ar.grad
        torch.testing.assert_close(plain(leaf.grad), want, rtol=1e-5, atol=1e-5)
    # Serving reaches the kernel through the custom op, whose CUDA kernel
    # is called here as the dispatcher calls it for a CUDA tensor.
    launched.clear()
    handed = []

    def op(xs_, w_, b_, alpha_):
        handed.append(alpha_ is alpha)
        return fs._concat_conv1x1_cuda(xs_, w_, b_, alpha_)

    monkeypatch.setattr(torch.ops.vsr_tpu_torch, "concat_conv1x1", op)
    with torch.no_grad():
        fs.concat_conv1x1(xs, w, b, alpha)
    assert handed == [True]
    assert launched == [("launches", True)]  # serving keeps the epilogue


# ------------------------------------ the nets that hand over their PReLU


def _jax(module, *xs, seed=0):
    """Variables drawn with numpy over the module's traced shapes (no flax
    init compiled; ``tests/_torch_parity.init``), biases randomized, and the
    jitted apply."""
    variables = randomize(init(module, *xs, seed=seed),
                          np.random.default_rng(seed))
    return variables, jax.jit(module.apply)


def _randomize_alphas(variables, rng):
    """Distinct PReLU alphas, so that a squeeze handed the wrong PReLU
    shows."""
    def visit(tree):
        return {k: (rng.uniform(0.05, 0.6, (1,)).astype(np.float32)
                    if k == "alpha" else visit(v) if isinstance(v, dict) else v)
                for k, v in tree.items()}

    return {"params": visit(variables["params"])}


@pytest.mark.parametrize("groups", [1, 2, 3])
def test_fblock_fused_squeeze_with_epilogue_matches_flax(rng, groups):
    f = 8
    x = rng.standard_normal((2, 8, 8, f)).astype(np.float32)
    h = rng.standard_normal((2, 8, 8, f)).astype(np.float32)
    jblock = jfeedback.FBlock(f, groups, 2, fused_squeeze=True)
    variables, apply = _jax(jblock, x, h)
    variables = _randomize_alphas(variables, rng)
    want = np.asarray(apply(variables, jnp.asarray(x), jnp.asarray(h)))
    block = feedback.FBlock(f, groups, 2, fused_squeeze=True)
    load_jax_params(block, variables)  # strict: every leaf used once
    assert len(block.prelus) == 4 * groups
    with torch.no_grad():
        got = _nhwc(block(_nchw(x), _nchw(h)))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("fused_squeeze", [False, True])
def test_fblock_hands_every_squeeze_its_own_prelu(rng, fused_squeeze):
    """Fused and unfused blocks with the same weights and distinct alphas
    agree, and every PReLU of the block is used exactly once."""
    f, groups = 4, 3
    gen = torch.Generator().manual_seed(5)
    block = feedback.FBlock(f, groups, 2, fused_squeeze=fused_squeeze,
                            generator=gen)
    plain = feedback.FBlock(f, groups, 2, fused_squeeze=False,
                            generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        for i, (a, b) in enumerate(zip(block.prelus, plain.prelus)):
            a.weight.fill_(0.05 * (i + 1))
            b.weight.fill_(0.05 * (i + 1))
    used = []
    for i, act in enumerate(block.prelus):
        act.register_forward_hook(lambda *_, i=i: used.append(i))
    seen = []
    real = fs.concat_conv1x1

    def spy(xs, weight, bias, prelu_weight=None):
        seen.append(prelu_weight)
        return real(xs, weight, bias, prelu_weight)

    x = torch.from_numpy(rng.standard_normal((1, f, 6, 6)).astype(np.float32))
    h = torch.from_numpy(rng.standard_normal((1, f, 6, 6)).astype(np.float32))
    import unittest.mock as mock

    with torch.no_grad(), mock.patch.object(common, "concat_conv1x1", spy):
        got, want = block(x, h), plain(x, h)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    if fused_squeeze:
        # The 2 * groups fused squeezes took their PReLU's weight; the
        # other PReLUs ran as modules.
        assert len(seen) == 2 * groups and all(a is not None for a in seen)
        handed = {id(a) for a in seen}
        assert handed == {id(p.weight) for i, p in enumerate(block.prelus)
                          if i not in used}
        assert len(used) == 4 * groups - 2 * groups
    else:
        assert not seen and sorted(used) == list(range(4 * groups))


@pytest.mark.parametrize("groups", [2, 3])
@pytest.mark.parametrize("fused_tail", [False, True])
def test_drfnet_fused_squeeze_with_epilogue_matches_flax(rng, groups,
                                                         fused_tail):
    kw = dict(in_channels=1, out_channels=1, num_features=8,
              num_groups=groups, upscale_factor=2, fused_tail=fused_tail,
              fused_squeeze=True)
    x = rng.standard_normal((2, 3, 8, 8, 1)).astype(np.float32)
    jnet = JaxDRFNet(**kw)
    variables, apply = _jax(jnet, x, seed=3)
    variables = _randomize_alphas(variables, rng)
    want = np.asarray(apply(variables, jnp.asarray(x)))
    net = DRFNet(**kw)
    load_jax_params(net, variables)
    with torch.no_grad():
        got = _nhwc(net(_nchw(x)))
    assert got.shape == want.shape == (2, 3, 16, 16, 1)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert np.abs(want).max() > 1e-3


def test_parameter_names_are_unchanged_by_the_epilogue():
    """The PReLU modules stay where they were: same state-dict keys with
    and without ``fused_squeeze``, apart from the squeeze's own layout."""
    kw = dict(in_channels=1, out_channels=1, num_features=4, num_groups=2,
              upscale_factor=2)
    fused = DRFNet(**kw, fused_squeeze=True).state_dict()
    plain = DRFNet(**kw, fused_squeeze=False).state_dict()
    assert list(fused) == list(plain)
    assert sum(k.endswith("weight") and "prelus" in k for k in fused) > 8


# --------------------------------------------- the float32 route: 3 x TF32


def tf32x3_matmul(w: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Numpy model of the CUDA kernel's float32 product ``w @ x``: each
    operand is split into a TF32 head (its top 19 bits: sign, exponent, 10
    mantissa bits) and a TF32 tail (the exact remainder, cut to 19 bits
    again); tail x head, head x tail and head x head are summed in
    float32."""
    def split(a):
        a = np.ascontiguousarray(a, dtype=np.float32)
        head = (a.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)
        rest = a - head
        tail = (rest.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)
        assert np.array_equal(head.astype(np.float64) + rest, a)  # exact
        return head, tail

    (w_hi, w_lo), (x_hi, x_lo) = split(w), split(x)
    return (w_lo @ x_hi + w_hi @ x_lo) + w_hi @ x_hi


def _one_tf32_matmul(w, x):
    mask = np.uint32(0xFFFFE000)
    return ((w.view(np.uint32) & mask).view(np.float32)
            @ (x.view(np.uint32) & mask).view(np.float32))


@pytest.mark.parametrize("k", [128, 192, 256, 320, 384, 512])
def test_three_tf32_products_stay_inside_the_f32_bar(rng, k):
    """At the smoke run's value ranges (inputs N(0, 1), weights uniform in
    +-K^-1/2), the three-product split stays two orders of magnitude inside
    the kernel-vs-twin bar of atol = rtol = 1e-4, as a plain float32 product
    does, while a single TF32 product breaks it."""
    f, pixels = 64, 2048
    w = (rng.uniform(-1, 1, (f, k)) * k ** -0.5).astype(np.float32)
    x = rng.standard_normal((k, pixels)).astype(np.float32)
    exact = w.astype(np.float64) @ x.astype(np.float64)
    bar = 1e-4 + 1e-4 * np.abs(exact)
    err3 = np.abs(tf32x3_matmul(w, x) - exact)
    err_f32 = np.abs((w @ x) - exact)
    err1 = np.abs(_one_tf32_matmul(w, x) - exact)
    # Found here, K = 128 .. 512: the three products err by at most
    # 1.7e-6 .. 2.4e-6, 0.7 .. 1.1 % of the bar (a float32 product by
    # 1.0e-6 .. 2.0e-6); one TF32 product by ~2e-3, 7 .. 8 times the bar.
    assert (err3 <= bar / 50).all(), err3.max()
    assert err3.max() <= 4 * err_f32.max() + 1e-6
    assert (err1 > bar).any()


def test_three_tf32_products_with_large_and_tiny_values(rng):
    """Relative accuracy holds across magnitudes (the split is by bits, not
    by absolute size)."""
    k = 384
    scale = np.exp2(rng.integers(-20, 20, (k, 1))).astype(np.float32)
    w = rng.standard_normal((8, k)).astype(np.float32)
    x = (rng.standard_normal((k, 256)) * scale).astype(np.float32)
    exact = w.astype(np.float64) @ x.astype(np.float64)
    magnitude = np.abs(w).astype(np.float64) @ np.abs(x).astype(np.float64)
    err = np.abs(tf32x3_matmul(w, x) - exact)
    assert (err <= 4e-6 * magnitude).all()


# -------------------------------------------- pairwise rank: one compare


def one_compare_rank(a: np.ndarray) -> np.ndarray:
    """Numpy model of the CUDA kernel's count: for j < i the pair counts
    iff a_j >= a_i, for j > i iff a_j > a_i."""
    gs = a.shape[-1]
    a_i, a_j = a[..., :, None], a[..., None, :]
    j_lt_i = np.tri(gs, k=-1, dtype=bool)  # [i, j]: j < i
    with np.errstate(invalid="ignore"):
        counted = np.where(j_lt_i, a_j >= a_i, (a_j > a_i) & ~np.eye(gs, dtype=bool))
    return counted.sum(-1).astype(np.int32)


def _rank_rows(rng, kind, gs):
    rows = 6
    if kind == "softmax":
        z = rng.standard_normal((rows, gs, 4)).astype(np.float32)
        e = np.exp(z - z.max(-1, keepdims=True))
        return np.ascontiguousarray((e / e.sum(-1, keepdims=True))[..., 0])
    a = rng.random((rows, gs)).astype(np.float32)
    if kind == "ties":
        return np.round(a * 4).astype(np.float32) / 4
    if kind == "signed_zeros":
        a = np.round(a * 2 - 1).astype(np.float32)  # -1, 0, 1
        a[:, ::2] *= -1.0  # -0.0 among the +0.0
        return a
    assert kind == "nan"
    a = np.round(a * 8).astype(np.float32)
    a[rng.random(a.shape) < 0.3] = np.nan
    return a


@pytest.mark.parametrize("gs", [1, 31, 200, 256])
@pytest.mark.parametrize("kind", ["softmax", "ties", "signed_zeros", "nan"])
def test_one_compare_rank_equals_the_twin(rng, kind, gs):
    a = _rank_rows(rng, kind, gs)
    if kind == "signed_zeros" and gs > 1:
        assert np.signbit(a[a == 0]).any() and not np.signbit(a[a == 0]).all()
    want = pairwise_rank_reference(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(one_compare_rank(a), want)
    if kind != "nan":  # a permutation of 0..gs-1 in every row
        np.testing.assert_array_equal(np.sort(want, -1),
                                      np.broadcast_to(np.arange(gs), a.shape))
