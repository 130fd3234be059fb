"""Training slice, kernel K1's gradient: ``concat_conv1x1`` against
``jax.grad`` through ``vsr_tpu.ops.fused_squeeze.concat_matmul`` (the Pallas
kernel in interpret mode, as ``tests/test_fused_squeeze.py`` runs it) and
against the twin's autograd, with and without the PReLU, for alpha positive,
zero and negative. The autograd Function that the CUDA branch uses is driven
on the CPU with its kernel launch replaced by the twin, which holds its
backward (dx through W^T in one launch, dW and db in float32) to the same
references."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsr_tpu.ops.fused_squeeze import concat_matmul
from vsr_tpu_torch.ops import fused_squeeze as fs

# float32 sums of at most 2*5*7 terms per weight entry, values O(1).
TOL = dict(rtol=1e-4, atol=1e-4)
CHANNELS = (8, 8, 5)
F_OUT = 6


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _operands(rng):
    xs = [rng.standard_normal((2, 5, 7, c)).astype(np.float32)
          for c in CHANNELS]
    w = (rng.standard_normal((sum(CHANNELS), F_OUT)) * 0.3).astype(np.float32)
    b = rng.standard_normal(F_OUT).astype(np.float32)
    g = rng.standard_normal((2, 5, 7, F_OUT)).astype(np.float32)
    return xs, w, b, g


def _jax_grads(xs, w, b, g, alpha):
    """d<out, g>/d(xs, w, b, alpha) through the Pallas kernel's custom VJP."""

    def loss(xs, w, b, a):
        out = concat_matmul(xs, w, b)
        if alpha is not None:
            out = jnp.where(out >= 0, out, a * out)
        return jnp.sum(out * g)

    a = jnp.float32(0.0 if alpha is None else alpha)
    grads = jax.grad(loss, argnums=(0, 1, 2, 3))(
        tuple(jnp.asarray(x) for x in xs), jnp.asarray(w), jnp.asarray(b), a)
    return jax.tree_util.tree_map(np.asarray, grads)


def _torch_grads(fn, xs, w, b, g, alpha):
    txs = [torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))
                            ).requires_grad_(True) for x in xs]
    tw = torch.from_numpy(np.ascontiguousarray(w.T)).requires_grad_(True)
    tb = torch.from_numpy(b.copy()).requires_grad_(True)
    ta = (None if alpha is None
          else torch.tensor([alpha], dtype=torch.float32, requires_grad=True))
    out = fn(txs, tw, tb, ta)
    out.backward(torch.from_numpy(np.ascontiguousarray(np.moveaxis(g, -1, 1))))
    dxs = [np.moveaxis(x.grad.numpy(), 1, -1) for x in txs]
    return dxs, tw.grad.numpy().T, tb.grad.numpy(), (
        None if ta is None else ta.grad.numpy()[0])


def _check(got, want, alpha):
    for a, c in zip(got[0], want[0]):
        np.testing.assert_allclose(a, c, **TOL)
    np.testing.assert_allclose(got[1], want[1], **TOL)
    np.testing.assert_allclose(got[2], want[2], **TOL)
    if alpha is not None:
        np.testing.assert_allclose(got[3], want[3], **TOL)


@pytest.mark.parametrize("alpha", [None, 0.2, 0.0, -0.3])
def test_concat_conv1x1_grads_match_jax_grad(rng, alpha):
    xs, w, b, g = _operands(rng)
    want = _jax_grads(xs, w, b, g, alpha)
    _check(_torch_grads(fs.concat_conv1x1, xs, w, b, g, alpha), want, alpha)
    _check(_torch_grads(fs.concat_conv1x1_reference, xs, w, b, g, alpha),
           want, alpha)


@pytest.fixture
def function_on_cpu(monkeypatch):
    """``concat_conv1x1`` as its CUDA branch runs it where a gradient is
    needed (the autograd Function, then the PReLU as an autograd op), with
    every kernel launch replaced by the twin under ``no_grad``."""
    launches = []

    def fake_launch(xs, weight, bias, prelu_weight, counter="launches"):
        launches.append((counter, len(xs), tuple(weight.shape),
                         prelu_weight is not None))
        with torch.no_grad():
            return fs.concat_conv1x1_reference(xs, weight, bias, prelu_weight)

    monkeypatch.setattr(fs, "_launch", fake_launch)

    def run(xs, weight, bias, prelu_weight):
        out = fs._ConcatConv1x1.apply(weight, bias, *xs)
        if prelu_weight is None:
            return out
        return torch.nn.functional.prelu(out, prelu_weight)

    return run, launches


@pytest.mark.parametrize("alpha", [None, 0.2, 0.0, -0.3])
def test_autograd_function_backward_matches_jax_grad(rng, function_on_cpu,
                                                     alpha):
    run, launches = function_on_cpu
    xs, w, b, g = _operands(rng)
    got = _torch_grads(run, xs, w, b, g, alpha)
    _check(got, _jax_grads(xs, w, b, g, alpha), alpha)
    k = sum(CHANNELS)
    # One forward launch without epilogue; one backward launch whose single
    # input is g and whose weight is W^T, (sum C_i, F).
    assert launches == [("launches", len(CHANNELS), (F_OUT, k), False),
                        ("backward_launches", 1, (k, F_OUT), False)]


def test_autograd_function_skips_what_needs_no_gradient(rng, function_on_cpu):
    run, launches = function_on_cpu
    xs, w, b, g = _operands(rng)
    txs = [torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))
           for x in xs]
    tw = torch.from_numpy(np.ascontiguousarray(w.T)).requires_grad_(True)
    tb = torch.from_numpy(b.copy())
    run(txs, tw, tb, None).sum().backward()
    assert [l[0] for l in launches] == ["launches"]  # no dx launch
    assert tw.grad is not None and tb.grad is None


def test_autograd_function_saves_no_concatenated_copy(rng, function_on_cpu):
    run, _ = function_on_cpu
    xs, w, b, _ = _operands(rng)
    txs = [torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))
                            ).requires_grad_(True) for x in xs]
    tw = torch.from_numpy(np.ascontiguousarray(w.T)).requires_grad_(True)
    out = run(txs, tw, torch.from_numpy(b.copy()), None)
    saved = out.grad_fn.saved_tensors
    assert {t.data_ptr() for t in saved} == {
        t.data_ptr() for t in (tw, *txs)}
    assert all(t.shape[1] != sum(CHANNELS) or t is tw for t in saved)


def test_bf16_grads_come_back_in_the_operand_dtypes(rng, function_on_cpu):
    run, _ = function_on_cpu
    xs, w, b, g = _operands(rng)
    txs = [torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))
                            ).bfloat16().requires_grad_(True) for x in xs]
    tw = torch.from_numpy(np.ascontiguousarray(w.T)).requires_grad_(True)
    tb = torch.from_numpy(b.copy()).requires_grad_(True)
    out = run(txs, tw, tb, None)
    assert out.dtype == torch.bfloat16
    out.backward(torch.from_numpy(
        np.ascontiguousarray(np.moveaxis(g, -1, 1))).bfloat16())
    assert all(x.grad.dtype == torch.bfloat16 for x in txs)
    assert tw.grad.dtype == tb.grad.dtype == torch.float32
    want = _jax_grads(xs, w, b, g, None)
    # Operands and g rounded to bf16 (2^-8 relative each); sums in float32.
    np.testing.assert_allclose(tw.grad.numpy().T, want[1], rtol=0.05, atol=0.1)
    np.testing.assert_allclose(tb.grad.numpy(), want[2], rtol=0.05, atol=0.1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dw_wrapper_on_cpu_is_the_twin_and_matches_a_float64_einsum(rng, dtype):
    """``concat_conv1x1_dw`` on CPU tensors: float32 dW (F, sum C_i) and db
    (F,) whatever the inputs' type, equal to the sums taken in float64."""
    xs, _, _, g = _operands(rng)
    txs = [torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))
                            ).to(dtype) for x in xs]
    tg = torch.from_numpy(np.ascontiguousarray(np.moveaxis(g, -1, 1))).to(dtype)
    before = fs.concat_conv1x1_dw.launches
    dw, db = fs.concat_conv1x1_dw(txs, tg)
    assert fs.concat_conv1x1_dw.launches == before  # no kernel on the CPU
    assert dw.dtype == db.dtype == torch.float32
    assert dw.shape == (F_OUT, sum(CHANNELS)) and db.shape == (F_OUT,)
    g64 = tg.double()
    want_dw = torch.cat([torch.einsum("nfhw,nchw->fc", g64, x.double())
                         for x in txs], dim=1)
    # Sums of 70 float32 products of values O(1), taken in float32.
    np.testing.assert_allclose(dw.numpy(), want_dw.numpy(), **TOL)
    np.testing.assert_allclose(db.numpy(), g64.sum(dim=(0, 2, 3)).numpy(),
                               **TOL)
    twin = fs.concat_conv1x1_dw_reference(txs, tg)
    assert torch.equal(dw, twin[0]) and torch.equal(db, twin[1])
    with pytest.raises(ValueError, match="at least one input"):
        fs.concat_conv1x1_dw([], tg)


def test_counters_exist_and_cpu_calls_count_nothing(rng):
    xs, w, b, g = _operands(rng)
    before = (fs.concat_conv1x1.launches, fs.concat_conv1x1.backward_launches)
    _torch_grads(fs.concat_conv1x1, xs, w, b, g, 0.2)
    assert (fs.concat_conv1x1.launches,
            fs.concat_conv1x1.backward_launches) == before


@pytest.mark.parametrize("n,hw,channels,f_out", [
    (16, 1024, (64,) * 2, 64), (16, 4096, (64,) * 6, 64), (16, 1024, (64,) * 6, 64),
    (2, 117, (3, 17, 40), 70), (5, 2, (5, 130), 9), (7, 1, (8,), 8),
    (40, 32, (64,) * 8, 512), (1, 9216, (64, 64), 64)])
def test_dw_split_cuts_the_summed_dimension_into_whole_steps(n, hw, channels,
                                                             f_out):
    """What ``concat_conv1x1_dw`` hands its kernel: chunks that are multiples
    of the kernel's pixel step, at most one block per unit of work, at most
    about one wave of blocks on a 132-SM card."""
    chunk, splits = fs._dw_split(n, hw, channels, f_out, sms=132)
    units = n * -(-hw // chunk)
    tiles = sum(-(-c // 64) for c in channels) * -(-f_out // 64)
    assert chunk % 64 == 0 and chunk >= 64
    assert 1 <= splits <= units and splits <= 65535
    assert splits * tiles <= max(3 * 132, tiles)
    # Never a chunk so long that a second one per image would be empty.
    assert (-(-hw // chunk) - 1) * chunk < hw
