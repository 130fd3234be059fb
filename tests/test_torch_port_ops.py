"""The port's ops against the JAX package: the fused squeeze's plain twin
against ``concat_matmul`` (Pallas, interpret mode on the CPU), the fused-tail
weight fold against ``fuse_conv_through_shuffle``, and the CPU dispatch and
input checks of the CUDA kernel's wrapper."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsr_tpu.ops.fused_squeeze import concat_matmul
from vsr_tpu.ops.fused_tail import fuse_conv_through_shuffle as jax_fold
from vsr_tpu_torch.ops import fused_squeeze as fs
from vsr_tpu_torch.ops.fused_tail import fuse_conv_through_shuffle


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("k", [2, 3, 6])
def test_twin_matches_jax_concat_matmul(rng, k):
    c, f = 16, 12
    xs = [rng.standard_normal((2, 5, 7, c)).astype(np.float32)
          for _ in range(k)]
    w = (rng.standard_normal((k * c, f)) * 0.1).astype(np.float32)
    b = rng.standard_normal(f).astype(np.float32)
    want = np.asarray(concat_matmul(tuple(map(jnp.asarray, xs)),
                                    jnp.asarray(w), jnp.asarray(b)))
    got = fs.concat_conv1x1_reference(
        [torch.from_numpy(x.transpose(0, 3, 1, 2).copy()) for x in xs],
        torch.from_numpy(w.T.copy()), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want,
                               rtol=1e-5, atol=1e-5)


def test_cpu_tensors_take_the_twin_and_launch_nothing(rng):
    xs = [torch.from_numpy(rng.standard_normal((1, c, 4, 4)).astype(np.float32))
          for c in (3, 5)]
    w = torch.from_numpy(rng.standard_normal((6, 8)).astype(np.float32))
    b = torch.zeros(6)
    before = fs.concat_conv1x1.launches
    got = fs.concat_conv1x1(xs, w, b)
    assert fs.concat_conv1x1.launches == before
    torch.testing.assert_close(got, fs.concat_conv1x1_reference(xs, w, b),
                               rtol=0, atol=0)


def test_bf16_twin_rounds_weights_to_the_input_dtype(rng):
    xs = [torch.from_numpy(rng.standard_normal((1, 4, 3, 3)).astype(np.float32)
                           ).bfloat16() for _ in range(2)]
    w = torch.from_numpy(rng.standard_normal((5, 8)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(5).astype(np.float32))
    got = fs.concat_conv1x1(xs, w, b)
    assert got.dtype == torch.bfloat16
    want = fs.concat_conv1x1_reference(
        [x.float() for x in xs], w.bfloat16().float(), b.bfloat16().float())
    torch.testing.assert_close(got.float(), want, rtol=8e-3, atol=1e-4)


def test_non_cpu_non_cuda_device_is_refused():
    xs = [torch.empty(1, 2, 3, 3, device="meta")]
    with pytest.raises(ValueError, match="cpu or cuda"):
        fs.concat_conv1x1(xs, torch.empty(4, 2, device="meta"),
                          torch.empty(4, device="meta"))


@pytest.mark.parametrize("case,match", [
    ("too_many", "at most 8"),
    ("dtype", "float32 and bfloat16"),
    ("rank", "NCHW"),
    ("spatial", r"disagree on \(N, H, W\)"),
    ("strided", "contiguous"),
    ("weight", r"weight must be \(F, 6\)"),
    ("bias", r"bias must be \(4,\)"),
    ("empty", "empty"),
])
def test_kernel_input_checks(case, match):
    xs = [torch.zeros(2, 3, 5, 5), torch.zeros(2, 3, 5, 5)]
    w, b = torch.zeros(4, 6), torch.zeros(4)
    if case == "too_many":
        xs = [torch.zeros(2, 1, 5, 5)] * 9
        w = torch.zeros(4, 9)
    elif case == "dtype":
        xs = [x.half() for x in xs]
    elif case == "rank":
        xs = [x[0] for x in xs]
    elif case == "spatial":
        xs[1] = torch.zeros(2, 3, 5, 4)
    elif case == "strided":
        xs[1] = torch.zeros(2, 3, 5, 10)[..., ::2]
    elif case == "weight":
        w = torch.zeros(4, 7)
    elif case == "bias":
        b = torch.zeros(5)
    elif case == "empty":
        xs = [torch.zeros(0, 3, 5, 5), torch.zeros(0, 3, 5, 5)]
    with pytest.raises((ValueError, TypeError), match=match):
        fs._check(xs, w, b)


@pytest.mark.parametrize("k,r,cin,cout", [(3, 2, 4, 1), (3, 2, 3, 5),
                                          (3, 3, 2, 2), (5, 2, 2, 3)])
def test_fold_matches_jax(rng, k, r, cin, cout):
    kernel = rng.standard_normal((k, k, cin, cout)).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    K_j, B_j = jax_fold(jnp.asarray(kernel), jnp.asarray(bias), r)
    K_t, B_t = fuse_conv_through_shuffle(
        torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()),
        torch.from_numpy(bias), r)
    # flax (kq, kq, Cin*r^2, Cout*r^2) vs torch (Cout*r^2, Cin*r^2, kq, kq):
    # a pure gather on both sides, so equal bit for bit.
    np.testing.assert_array_equal(K_t.numpy(),
                                  np.asarray(K_j).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(B_t.numpy(), np.asarray(B_j))


def test_cpu_path_never_builds_the_kernel(rng, monkeypatch):
    from vsr_tpu_torch import _build

    def fail():
        raise AssertionError("the CPU path must not build the CUDA kernel")

    monkeypatch.setattr(_build, "load", fail)
    xs = [torch.zeros(1, 2, 3, 3), torch.zeros(1, 2, 3, 3)]
    fs.concat_conv1x1(xs, torch.zeros(4, 4), torch.zeros(4))


def test_library_name_follows_the_sources(tmp_path, monkeypatch):
    from vsr_tpu_torch import _build

    assert [p.name for p in _build.sources()] == [
        "duf_filter.cu", "fused_squeeze.cu", "fused_squeeze_dw.cu",
        "pairwise_rank.cu", "w8a8_conv.cu"]
    # Every C entry point the wrappers call is declared, and defined in csrc.
    text = "".join(p.read_text() for p in _build.sources())
    assert sorted(_build.SIGNATURES) == [
        "vsr_concat_conv1x1", "vsr_concat_dw", "vsr_duf_filter",
        "vsr_pairwise_rank", "vsr_w8a8_conv"]
    for name in _build.SIGNATURES:
        assert f'extern "C" int {name}(' in text
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    (tmp_path / "a.cu").write_text("// one\n")
    first = _build.library_path()
    assert first == _build.library_path()
    assert first.parent == _build.BUILD_DIR
    (tmp_path / "a.cu").write_text("// two\n")
    second = _build.library_path()
    assert second != first
    (tmp_path / "b.cu").write_text("// a second source\n")  # every file counts
    third = _build.library_path()
    assert third not in (first, second)
    (tmp_path / "b.cu").write_text("// a second source, edited\n")
    assert _build.library_path() != third


def test_missing_nvcc_raises(monkeypatch):
    from vsr_tpu_torch import _build

    monkeypatch.setattr(_build.os.path, "isfile", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
