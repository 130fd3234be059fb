"""The plain twins of the port's pairwise-rank (K3) and DUF dynamic-filter
(K2) kernels against the JAX package: the Pallas kernels in interpret mode
on the CPU and their XLA forms, on the same numpy-seeded inputs; the general
dynamic-filter op; and the CPU dispatch and input checks of both wrappers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vsr_tpu.ops.pallas_duf as pallas_duf
from vsr_tpu.ops.dynamic_filter import apply_dynamic_filters as jax_apply
from vsr_tpu.ops.rank import pairwise_rank as jax_pairwise_rank
from vsr_tpu.ops.rank import supports_pallas_rank
from vsr_tpu_torch.ops import duf_filter as df
from vsr_tpu_torch.ops import rank as rk
from vsr_tpu_torch.ops.dynamic_filter import (apply_dynamic_filters,
                                              extract_patches)


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def interpret_mode(monkeypatch):
    """Run ``duf_dynamic_filter_pallas`` in the Pallas interpreter, as the
    JAX package's own test of it does on the CPU."""
    from jax.experimental import pallas as pl

    original = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return original(*args, **kwargs)

    monkeypatch.setattr(pallas_duf.pl, "pallas_call", interp)
    # The jit cache would keep a compiled (non-interpret) version.
    pallas_duf.duf_dynamic_filter_pallas._clear_cache()
    yield
    pallas_duf.duf_dynamic_filter_pallas._clear_cache()


# ------------------------------------------------------------------ K3 rank


def _scores(rng, shape, ties: bool) -> np.ndarray:
    af = rng.random(shape).astype(np.float32)
    if ties:
        af[..., ::3] = af[..., :1]        # a third of each row is one value
        af[..., 5:9] = 0.0
        af[..., 6] = -0.0                 # ties with +0.0 under > and ==
    return af


def _xla_rank(af: np.ndarray) -> np.ndarray:
    """The XLA form of ``ExpertChoiceMoE._route`` (router_impl='rank')."""
    a = jnp.asarray(af)
    gs = a.shape[-1]
    a_i, a_j = a[..., :, None], a[..., None, :]
    j_lt_i = jnp.arange(gs)[None, :] < jnp.arange(gs)[:, None]
    return np.asarray(jnp.sum(
        ((a_j > a_i) | ((a_j == a_i) & j_lt_i)).astype(jnp.int32), axis=-1))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("gs", [128, 256])
def test_rank_twin_is_bit_equal_to_pallas(rng, gs, ties):
    assert supports_pallas_rank(gs)
    af = _scores(rng, (5, 4, gs), ties)  # 20 rows: a ragged TILE_R tail
    want = np.asarray(jax_pairwise_rank(jnp.asarray(af), interpret=True))
    got = rk.pairwise_rank_reference(torch.from_numpy(af))
    assert got.dtype == torch.int32 and got.shape == af.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # On a CPU tensor the wrapper is the twin, and counts no launch.
    before = rk.pairwise_rank.launches
    np.testing.assert_array_equal(
        rk.pairwise_rank(torch.from_numpy(af)).numpy(), want)
    assert rk.pairwise_rank.launches == before


@pytest.mark.parametrize("gs", [96, 1, 200])
def test_rank_twin_is_bit_equal_to_xla_where_pallas_refuses(rng, gs):
    assert not supports_pallas_rank(gs)
    af = _scores(rng, (7, gs), ties=gs > 9)
    got = rk.pairwise_rank(torch.from_numpy(af))
    np.testing.assert_array_equal(got.numpy(), _xla_rank(af))


def test_rank_twin_chunks_rows(rng, monkeypatch):
    af = torch.from_numpy(_scores(rng, (11, 32), ties=True))
    want = rk.pairwise_rank_reference(af)
    monkeypatch.setattr(rk, "_TWIN_CHUNK_ELEMENTS", 3 * 32 * 32)  # 3 rows
    assert torch.equal(rk.pairwise_rank_reference(af), want)
    # A rank is a permutation of 0..gs-1 in every row.
    assert torch.equal(want.sort(dim=-1).values,
                       torch.arange(32, dtype=torch.int32).expand(11, 32))


def test_rank_orders_like_a_stable_descending_sort(rng):
    af = torch.from_numpy(_scores(rng, (6, 64), ties=True).clip(min=0.0))
    order = torch.argsort(af, dim=-1, descending=True, stable=True)
    want = torch.empty_like(order)
    want.scatter_(-1, order, torch.arange(64).expand(6, 64))
    assert torch.equal(rk.pairwise_rank(af).long(), want)


@pytest.mark.parametrize("bad,exc,match", [
    (lambda: torch.zeros(2, 8, dtype=torch.float64), TypeError, "float32"),
    (lambda: torch.zeros(2, 8, dtype=torch.bfloat16), TypeError, "float32"),
    (lambda: torch.zeros(8, 2).t(), ValueError, "contiguous"),
    (lambda: torch.zeros(2, rk.MAX_GS + 1), ValueError, "at most"),
    (lambda: torch.zeros(0, 8), ValueError, "empty"),
    (lambda: torch.zeros(2, 8, requires_grad=True), RuntimeError, "detach"),
    (lambda: torch.zeros(2, 8, device="meta"), ValueError, "cpu or cuda"),
])
def test_rank_wrapper_refuses(bad, exc, match):
    with pytest.raises(exc, match=match):
        rk.pairwise_rank(bad())


# ------------------------------------------------------------ K2 DUF filter

DUF_CASES = [(3, 2, 16, 16), (5, 2, 8, 24), (3, 3, 9, 12)]


def _duf_inputs(rng, size, upscale, h, w, n=2):
    x = rng.random((n, h, w)).astype(np.float32)
    logits = rng.standard_normal(
        (n, h, w, size * size, upscale * upscale)).astype(np.float32)
    return x, logits


def _channel_first(logits: np.ndarray) -> torch.Tensor:
    """(N, H, W, k2, r2) -> (N, k2*r2, H, W), channel = tap * r2 + s."""
    n, h, w, k2, r2 = logits.shape
    return torch.from_numpy(np.ascontiguousarray(
        logits.transpose(0, 3, 4, 1, 2).reshape(n, k2 * r2, h, w)))


@pytest.mark.parametrize("size,upscale,h,w", DUF_CASES)
def test_duf_twin_matches_pallas(rng, interpret_mode, size, upscale, h, w):
    x, logits = _duf_inputs(rng, size, upscale, h, w)
    want = np.asarray(pallas_duf.duf_dynamic_filter_pallas(
        jnp.asarray(x), jnp.asarray(logits), size=size, upscale=upscale))
    got = df.duf_dynamic_filter_reference(
        torch.from_numpy(x), _channel_first(logits), size, upscale)
    assert got.shape == (2, h * upscale, w * upscale)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("size,upscale,h,w", DUF_CASES)
def test_duf_twin_matches_xla_path(rng, size, upscale, h, w):
    x, logits = _duf_inputs(rng, size, upscale, h, w)
    want = np.asarray(jax_apply(
        jnp.asarray(x)[..., None], jax.nn.softmax(jnp.asarray(logits), axis=3),
        upscale))[..., 0]
    before = df.duf_dynamic_filter.launches
    got = df.duf_dynamic_filter(  # a CPU tensor: the twin, no launch
        torch.from_numpy(x), _channel_first(logits), size, upscale)
    assert df.duf_dynamic_filter.launches == before
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_duf_uniform_logits_average(rng):
    # Equal logits -> the mean over the k^2 neighbourhood for every sub-pixel.
    x = rng.random((1, 8, 8)).astype(np.float32)
    out = df.duf_dynamic_filter(torch.from_numpy(x),
                                torch.zeros(1, 9 * 4, 8, 8), 3, 2).numpy()
    xp = np.pad(x[0], 1)
    mean33 = np.stack([xp[dy:dy + 8, dx:dx + 8]
                       for dy in range(3) for dx in range(3)]).mean(axis=0)
    for dy in range(2):
        for dx in range(2):
            np.testing.assert_allclose(out[0, dy::2, dx::2], mean33, atol=1e-5)


def test_duf_casts_low_precision_inputs_to_f32(rng):
    x, logits = _duf_inputs(rng, 3, 2, 6, 6)
    xb = torch.from_numpy(x).bfloat16()
    lb = _channel_first(logits).bfloat16()
    got = df.duf_dynamic_filter(xb, lb, 3, 2)
    assert got.dtype == torch.float32
    want = df.duf_dynamic_filter_reference(xb.float(), lb.float(), 3, 2)
    assert torch.equal(got, want)


@pytest.mark.parametrize("size,upscale,c", [(3, 2, 3), (5, 3, 2)])
def test_apply_dynamic_filters_general_channels(rng, size, upscale, c):
    n, h, w = 2, 7, 9
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    filters = np.asarray(jax.nn.softmax(jnp.asarray(rng.standard_normal(
        (n, h, w, size * size, upscale * upscale)).astype(np.float32)), axis=3))
    want = np.asarray(jax_apply(jnp.asarray(x), jnp.asarray(filters), upscale))
    got = apply_dynamic_filters(
        torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))),
        torch.from_numpy(np.ascontiguousarray(filters.transpose(0, 3, 4, 1, 2))),
        upscale)
    assert got.shape == (n, c, h * upscale, w * upscale)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want,
                               atol=1e-5)


def test_extract_patches_tap_order():
    x = torch.arange(2 * 3 * 4 * 5, dtype=torch.float32).reshape(2, 3, 4, 5)
    patches = extract_patches(x, 3)
    assert patches.shape == (2, 3, 9, 4, 5)
    padded = torch.nn.functional.pad(x, (1, 1, 1, 1))
    for ky in range(3):
        for kx in range(3):
            assert torch.equal(patches[:, :, ky * 3 + kx],
                               padded[:, :, ky:ky + 4, kx:kx + 5])


@pytest.mark.parametrize("x_shape,l_shape,size,upscale,match", [
    ((2, 3, 8, 8), (2, 36, 8, 8), 3, 2, "one channel"),      # C != 1
    ((2, 8, 8), (2, 8, 8, 9, 4), 3, 2, "channel-first"),     # the JAX layout
    ((2, 8, 8), (2, 36, 8, 8), 4, 2, "odd"),
    ((2, 8, 8), (2, 36, 8, 7), 3, 2, "channel-first"),
    ((2, 8, 8), (2, 17 * 17 * 4, 8, 8), 17, 2, "at most"),
])
def test_duf_wrapper_refuses(x_shape, l_shape, size, upscale, match):
    with pytest.raises(ValueError, match=match):
        df.duf_dynamic_filter(torch.zeros(x_shape), torch.zeros(l_shape),
                              size, upscale)


def test_apply_dynamic_filters_refuses_bad_filters():
    x = torch.zeros(1, 1, 4, 4)
    with pytest.raises(ValueError, match="odd square"):
        apply_dynamic_filters(x, torch.zeros(1, 8, 4, 4, 4), 2)
    with pytest.raises(ValueError, match="filters must be"):
        apply_dynamic_filters(x, torch.zeros(1, 9, 4, 4, 4), 3)
