"""The hand-written CUDA kernels on the card, each against its plain twin:
the fused squeeze (K1, with its backward: dx through the same kernel, dW / db
through their own), the DUF dynamic filter (K2), the pairwise rank (K3),
the W8A8 convolution (``ops/w8a8_conv.py``) and the quantized serving
routes.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false (decided in the fixture, never at import). On a machine with an H100:
``python -m pytest tests/test_torch_port_cuda.py -m cuda -q``.
"""

import numpy as np
import pytest
import torch

# Imported by its own name (pytest puts tests/ on sys.path): an installed
# ``tests`` package would shadow ``tests._torch_cases``.
from _torch_cases import run_cases, subdir
from _torch_w8a8 import W8A8_CASES
from vsr_tpu_torch.ops import duf_filter as df
from vsr_tpu_torch.ops import fused_squeeze as fs
from vsr_tpu_torch.ops import rank as rk

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the f32 twin in full f32
    yield torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = prev


def _operands(rng, dev, channels, f, n=2, h=9, w=13):
    xs = [torch.from_numpy(rng.standard_normal((n, c, h, w)).astype(np.float32)
                           ).to(dev) for c in channels]
    bound = sum(channels) ** -0.5
    wt = torch.from_numpy(
        rng.uniform(-bound, bound, (f, sum(channels))).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.uniform(-bound, bound, f).astype(np.float32)).to(dev)
    return xs, wt, b


# Ragged shapes on purpose: channel counts off the 32-channel K step, F off
# the 64-channel tile, pixel counts off the 128-pixel tile and off the
# 16-byte vector (9 x 13 pixels: the kernel's element-wise loads).
TWIN_F32 = [((64, 64), 64), ((3, 17, 40), 70), ((64,) * 8, 64), ((5,), 1)]
TWIN_BF16 = [((64, 64, 64), 64), ((7, 33), 20)]


def _case_twin_f32(rng, dev, channels, f):
    xs, w, b = _operands(rng, dev, channels, f)
    before = fs.concat_conv1x1.launches
    with torch.inference_mode():
        got = fs.concat_conv1x1(xs, w, b)
        want = fs.concat_conv1x1_reference(xs, w, b)
    torch.cuda.synchronize()
    assert fs.concat_conv1x1.launches == before + 1
    assert got.shape == want.shape and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def _case_twin_bf16(rng, dev, channels, f):
    xs, w, b = _operands(rng, dev, channels, f)
    xs16 = [x.bfloat16() for x in xs]
    with torch.inference_mode():
        got = fs.concat_conv1x1(xs16, w, b)  # weights rounded to bf16 inside
        want = fs.concat_conv1x1_reference(
            [x.float() for x in xs16], w.bfloat16().float(),
            b.bfloat16().float())
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want, rtol=8e-3, atol=1e-4)


def test_kernel_matches_twin_f32(rng, dev):
    """The f32 and bf16 twin cases, grouped, each run and each failure
    named (ROADMAP.md, queue 3)."""
    run_cases(
        [(f"f32_{c}_{f}", lambda c=c, f=f: _case_twin_f32(rng, dev, c, f))
         for c, f in TWIN_F32]
        + [(f"bf16_{c}_{f}", lambda c=c, f=f: _case_twin_bf16(rng, dev, c, f))
           for c, f in TWIN_BF16])


# name -> channels, F, N, H, W. 16-byte copies need H*W*itemsize % 16 == 0.
K1_CASES = {
    "aligned_k2": ((64, 64), 64, 2, 8, 16),
    "unaligned_hw_ragged_channels_f70": ((3, 17, 40), 70, 2, 9, 13),
    "k1_n1": ((5,), 1, 1, 9, 13),
    "k8_channels_off_the_k_tile": ((24,) * 8, 64, 1, 16, 16),
    "aligned_hw_ragged_channels": ((3, 17, 40), 70, 1, 8, 24),
    # 1600 input channels: the weights travel through the ring (bf16 too).
    "k8_streamed_weights": ((200,) * 8, 64, 1, 8, 24),
    # 360 pixel tiles: more than the grid, so blocks walk several tiles.
    "many_tiles": ((64, 64), 64, 5, 96, 96),
    # 64 output tiles of the dW kernel: fewer splits than images, so its
    # blocks sum over several images each.
    "many_images_wide_f": ((64,) * 8, 512, 40, 4, 8),
}


def _k1_close(got, want, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        torch.testing.assert_close(got.float(), want, rtol=8e-3, atol=1e-4)


def _k1_run(xs, w, b, alpha, dtype):
    """Kernel and twin on the same operands; in bf16 the twin computes in
    f32 on the bf16-rounded operands."""
    xs = [x.to(dtype) for x in xs]
    with torch.inference_mode():
        got = fs.concat_conv1x1(xs, w, b, alpha)
        want = fs.concat_conv1x1_reference(
            [x.float() for x in xs], w.to(dtype).float(), b.to(dtype).float(),
            None if alpha is None else alpha.to(dtype).float())
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    return got, want


def _k1_case(rng, dev, case, dtype, epilogue):
    channels, f, n, h, w = K1_CASES[case]
    xs, wt, b = _operands(rng, dev, channels, f, n, h, w)
    alpha = torch.tensor([0.2], device=dev) if epilogue else None
    got, want = _k1_run(xs, wt, b, alpha, dtype)
    _k1_close(got, want, dtype)
    if epilogue:
        # Bit for bit the separate PReLU on the kernel's own output.
        with torch.inference_mode():
            plain = fs.concat_conv1x1([x.to(dtype) for x in xs], wt, b)
            want_act = torch.nn.functional.prelu(plain, alpha.to(dtype))
        assert torch.equal(got, want_act)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_kernel_cases(rng, dev, case, dtype):
    """Without and with the PReLU epilogue, each run and each failure
    named (the two were separate items; ROADMAP.md, queue 3)."""
    run_cases([(f"epilogue={epilogue}",
                lambda epilogue=epilogue: _k1_case(rng, dev, case, dtype,
                                                   epilogue))
               for epilogue in (False, True)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_takes_inputs_off_16_byte_alignment(rng, dev, dtype):
    """A contiguous slice at an odd storage offset: aligned H*W, but a
    ``data_ptr()`` that no 16-byte copy may touch."""
    channels, f, n, h, w = (16, 16), 8, 2, 8, 16
    xs, wt, b = _operands(rng, dev, channels, f, n, h, w)
    shifted = []
    for x in xs:
        flat = torch.empty(x.numel() + 1, dtype=dtype, device=dev)
        flat[1:] = x.to(dtype).reshape(-1)
        shifted.append(flat[1:].view(x.shape))
    assert all(x.is_contiguous() and x.data_ptr() % 16 for x in shifted)
    with torch.inference_mode():
        got = fs.concat_conv1x1(shifted, wt, b)
        want = fs.concat_conv1x1([x.clone() for x in shifted], wt, b)
    torch.cuda.synchronize()
    assert torch.equal(got, want)  # the two load paths sum in one order
    _k1_close(got, _k1_run(xs, wt, b, None, dtype)[1], dtype)


def test_kernel_refuses_grad_and_strided_inputs(rng, dev):
    # A call that needs gradients is no longer refused: it launches the
    # kernel through the autograd Function (the backward cases are below).
    xs, w, b = _operands(rng, dev, (4, 4), 8)
    w.requires_grad_(True)
    before = fs.concat_conv1x1.launches
    assert fs.concat_conv1x1(xs, w, b).requires_grad
    assert fs.concat_conv1x1.launches == before + 1
    with torch.no_grad():
        with pytest.raises(ValueError, match="contiguous"):
            fs.concat_conv1x1(
                [xs[0], xs[1].contiguous(memory_format=torch.channels_last)],
                w, b)


# ------------------------------------------------------------- K1 backward


def _grads(fn, xs, w, b, alpha, g):
    """Forward through ``fn``, backward with ``g``: the output and the
    gradients of (xs..., w, b, alpha)."""
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (*xs, w, b, alpha)]
    out = fn(leaves[:len(xs)], *leaves[len(xs):])
    return out.detach(), torch.autograd.grad(out, leaves, g)


def _off_the_kink(g, xs, w, b):
    """``g`` zeroed where the twin's pre-activation is within the forward's
    bar (1e-4) of 0: there the kernel's and the twin's last bits may fall on
    different sides of the PReLU's kink, where the derivative jumps by
    (1 - alpha). Which side is the forward's rounding, not the backward."""
    with torch.no_grad():
        pre = fs.concat_conv1x1_reference(xs, w, b)
    return g.masked_fill(pre.abs() < 1e-4, 0)


# The twin's autograd is the reference (torch.autograd.gradcheck wants
# float64, which the kernel does not take). alpha 0 and negative: the sign of
# the pre-activation cannot be read off a fused output.
@pytest.mark.parametrize("alpha", [0.2, 0.0, -0.3])
@pytest.mark.parametrize("case", ["aligned_k2",
                                  "unaligned_hw_ragged_channels_f70",
                                  "k8_channels_off_the_k_tile", "many_tiles"])
def test_kernel_backward_matches_twin_autograd_f32(rng, dev, case, alpha):
    channels, f, n, h, w = K1_CASES[case]
    xs, wt, b = _operands(rng, dev, channels, f, n, h, w)
    a = torch.tensor([alpha], device=dev)
    g = torch.from_numpy(rng.standard_normal((n, f, h, w)).astype(np.float32)
                         ).to(dev)
    g = _off_the_kink(g, xs, wt, b)
    before = (fs.concat_conv1x1.launches, fs.concat_conv1x1.backward_launches,
              fs.concat_conv1x1_dw.launches)
    out, got = _grads(fs.concat_conv1x1, xs, wt, b, a, g)
    assert (fs.concat_conv1x1.launches, fs.concat_conv1x1.backward_launches,
            fs.concat_conv1x1_dw.launches) == tuple(c + 1 for c in before)
    ref, want = _grads(fs.concat_conv1x1_reference, xs, wt, b, a, g)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    k = len(xs)
    for d, r in zip(got[:k], want[:k]):  # dx: sums of F products
        assert d.dtype == torch.float32 and d.shape == r.shape
        torch.testing.assert_close(d, r, rtol=1e-4, atol=1e-4)
    # dW, db, dalpha: float32 sums over N*H*W terms in another order than the
    # twin's; 1e-5 of the largest entry times sqrt(terms) covers the order,
    # a wrong term would be off by O(1).
    terms = n * h * w
    for d, r in zip(got[k:], want[k:]):
        assert d.shape == r.shape
        bar = 1e-5 * max(r.abs().max().item(), 1.0) * terms ** 0.5
        torch.testing.assert_close(d, r, rtol=1e-4, atol=bar)


@pytest.mark.parametrize("alpha", [0.2, -0.3])
def test_kernel_backward_bf16(rng, dev, alpha):
    """bf16 activations and float32 parameters: dx comes back in bf16, dW and
    db in float32, against the float32 twin on the bf16-rounded operands."""
    channels, f, n, h, w = (64, 64, 64), 64, 2, 16, 16
    xs, wt, b = _operands(rng, dev, channels, f, n, h, w)
    xs16 = [x.bfloat16() for x in xs]
    a = torch.tensor([alpha], device=dev)
    g = torch.from_numpy(rng.standard_normal((n, f, h, w)).astype(np.float32)
                         ).to(dev).bfloat16()
    twin_ops = ([x.float() for x in xs16], wt.bfloat16().float(),
                b.bfloat16().float())
    g = _off_the_kink(g, *twin_ops)
    out, got = _grads(fs.concat_conv1x1, xs16, wt, b, a, g)
    ref, want = _grads(fs.concat_conv1x1_reference, *twin_ops,
                       a.bfloat16().float(), g.float())
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref, rtol=8e-3, atol=1e-4)
    # The kernel's PReLU input is the bf16-rounded pre-activation, the twin's
    # is float32: gradients are held to bf16's 2^-8 of their scale.
    for d, r in zip(got[:3], want[:3]):
        assert d.dtype == torch.bfloat16
        torch.testing.assert_close(d.float(), r, rtol=2e-2,
                                   atol=2e-2 * r.abs().max().item())
    for d, r in zip(got[3:5], want[3:5]):
        assert d.dtype == torch.float32
        torch.testing.assert_close(d, r, rtol=2e-2,
                                   atol=2e-2 * r.abs().max().item())


# --------------------------------------------------------- K1 dW / db kernel


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_dw_kernel_matches_twin(rng, dev, case, dtype):
    """The split-K dW / db kernel against its plain twin: ragged channel
    counts, F off the 64-row tile, pixel counts off the kernel's step,
    streamed sums over several images per block (many_tiles)."""
    channels, f, n, h, w = K1_CASES[case]
    xs, _, _ = _operands(rng, dev, channels, f, n, h, w)
    xs = [x.to(dtype) for x in xs]
    g = torch.from_numpy(rng.standard_normal((n, f, h, w)).astype(np.float32)
                         ).to(dev).to(dtype)
    before = fs.concat_conv1x1_dw.launches
    dw, db = fs.concat_conv1x1_dw(xs, g)
    again = fs.concat_conv1x1_dw(xs, g)
    assert fs.concat_conv1x1_dw.launches == before + 2
    floats = [x.float() for x in xs]
    want_dw, want_db = fs.concat_conv1x1_dw_reference(floats, g.float())
    # The sums of the terms' magnitudes: float32 sums in another order are
    # held to 1e-5 of them (the kernel sums in float32 in bf16 mode too).
    scale_dw, scale_db = fs.concat_conv1x1_dw_reference(
        [x.abs() for x in floats], g.float().abs())
    torch.cuda.synchronize()
    assert dw.dtype == db.dtype == torch.float32
    assert dw.shape == (f, sum(channels)) and db.shape == (f,)
    assert bool(((dw - want_dw).abs() <= 1e-5 * scale_dw + 1e-6).all())
    assert bool(((db - want_db).abs() <= 1e-5 * scale_db + 1e-6).all())
    # No atomics: the same bits every launch.
    assert torch.equal(dw, again[0]) and torch.equal(db, again[1])


# Shapes off the kernel's steps and off 16-byte rows: (channels, F, N, H, W).
DW_RAGGED_CASES = {
    "rows_of_8_bytes": ((5, 130), 9, 5, 1, 2),
    "one_pixel": ((8,), 8, 7, 1, 1),
    "odd_hw_one_part": ((64,), 64, 3, 7, 9),
    # 1023 pixels: element-wise loads, a chunk edge off the step, F and the
    # last input off the 64-wide tile, an odd first column of the last input.
    "odd_hw_many_channels": ((64, 63, 100), 130, 2, 33, 31),
    "aligned_hw_off_the_step": ((64, 32), 64, 4, 20, 20),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("case", sorted(DW_RAGGED_CASES))
def test_dw_kernel_ragged_and_unaligned(rng, dev, case, offset, dtype):
    """Ragged and unaligned pixel rows stay inside the kernel: ``offset``
    puts every operand one element into its storage, so that no pointer is
    a multiple of 16 bytes. Two launches give the same bits."""
    channels, f, n, h, w = DW_RAGGED_CASES[case]

    def make(c):
        flat = torch.from_numpy(rng.standard_normal(
            n * c * h * w + offset).astype(np.float32)).to(dev).to(dtype)
        return flat[offset:].view(n, c, h, w)

    xs, g = [make(c) for c in channels], make(f)
    assert all(t.is_contiguous() for t in (*xs, g))
    if offset:
        assert all(t.data_ptr() % 16 for t in (*xs, g))
    before = fs.concat_conv1x1_dw.launches
    dw, db = fs.concat_conv1x1_dw(xs, g)
    again = fs.concat_conv1x1_dw(xs, g)
    assert fs.concat_conv1x1_dw.launches == before + 2
    floats = [x.float() for x in xs]
    want_dw, want_db = fs.concat_conv1x1_dw_reference(floats, g.float())
    scale_dw, scale_db = fs.concat_conv1x1_dw_reference(
        [x.abs() for x in floats], g.float().abs())
    torch.cuda.synchronize()
    assert dw.shape == (f, sum(channels)) and db.shape == (f,)
    assert dw.is_contiguous() and dw.dtype == db.dtype == torch.float32
    assert bool(((dw - want_dw).abs() <= 1e-5 * scale_dw + 1e-6).all())
    assert bool(((db - want_db).abs() <= 1e-5 * scale_db + 1e-6).all())
    assert torch.equal(dw, again[0]) and torch.equal(db, again[1])


def test_dw_kernel_refuses_what_it_cannot_take(rng, dev):
    xs, _, _ = _operands(rng, dev, (4, 4), 8)
    g = torch.zeros(2, 8, 9, 13, device=dev)
    with pytest.raises(ValueError, match="g must be"):
        fs.concat_conv1x1_dw(xs, g.bfloat16())
    with pytest.raises(ValueError, match="g must be"):
        fs.concat_conv1x1_dw(xs, g[:, :, :8])
    with pytest.raises(ValueError, match="g must be"):
        fs.concat_conv1x1_dw(xs, g.contiguous(memory_format=torch.channels_last))
    with pytest.raises(ValueError, match="contiguous"):
        fs.concat_conv1x1_dw(
            [xs[0], xs[1].contiguous(memory_format=torch.channels_last)], g)


# -------------------------------------------------------------- the trainers


def _write_tree(root, rng, frames=5, size=32):
    """A processed tree of one training and one validation sequence, LR by
    2 x 2 averaging, written with the port's own NIfTI writer."""
    from vsr_tpu_torch.io.nifti import save_nifti

    for split in ("train", "valid"):
        hr = rng.integers(0, 256, (size, size, 1, frames)).astype(np.uint8)
        lr = hr.reshape(size // 2, 2, size // 2, 2, 1, frames).mean(
            axis=(1, 3)).astype(np.uint8)
        for sub, vol in (("HR", hr), ("LR/X2", lr)):
            save_nifti(vol, root / "videos" / split / sub / "patient001"
                       / "patient001_2d+1d_sequence01.nii.gz")
            for t in range(frames):
                save_nifti(vol[..., t], root / "imgs" / split / sub
                           / "patient001"
                           / f"patient001_2d_slice01_frame{t + 1:02d}.nii.gz")
    return root


@pytest.mark.parametrize("task", ["sisr", "vsr"])
def test_trainer_takes_two_steps_on_the_card(rng, dev, tmp_path, task):
    from vsr_tpu_torch.config import load_config
    from vsr_tpu_torch.main import run_train
    from vsr_tpu_torch.utils.checkpoint import load_checkpoint

    tree = _write_tree(tmp_path / "tree", rng)
    name = {"sisr": "acdc_sisr_edsr_x2", "vsr": "acdc_vsr_drf_x2"}[task]
    cfg = load_config(f"configs/train/{name}.yaml")
    cfg.main.saved_dir = str(tmp_path / "run")
    cfg.dataset.kwargs.data_dir = str(
        tree / ("imgs" if task == "sisr" else "videos"))
    cfg.dataset.kwargs.augments = [
        {"name": "RandomCropPatch", "kwargs": {"size": [8, 8], "ratio": 2}}]
    # 5 samples in batches of 3: two steps an epoch, the second one partial.
    cfg.dataloader.kwargs.update(train_batch_size=3, num_workers=2)
    if task == "sisr":
        cfg.net.kwargs.update(num_resblocks=2, num_features=8)
    else:
        cfg.dataset.kwargs.num_frames = 3
        cfg.net.kwargs.update(num_features=8, num_groups=2, fused_squeeze=True)
    cfg.monitor.kwargs.saved_freq = 1
    cfg.trainer.kwargs.num_epochs = 1
    fs.concat_conv1x1.launches = fs.concat_conv1x1.backward_launches = 0
    fs.concat_conv1x1_dw.launches = 0
    trainer = run_train(cfg)  # the default device: cuda
    assert trainer.device.type == "cuda"
    state, aux = load_checkpoint(tmp_path / "run" / "checkpoints" / "model_1.ckpt")
    assert aux["epoch"] == 1
    assert all(torch.isfinite(v).all() for v in state["net"].values())
    assert (tmp_path / "run" / "checkpoints" / "model_best.ckpt").is_file()
    # G = 2: four squeezes of more than one part per frame step. Two train
    # steps of T = 3 frames, one validation sequence of 5 frames.
    want = (4 * (2 * 3 + 5), 4 * 2 * 3, 4 * 2 * 3) if task == "vsr" else (0, 0, 0)
    assert (fs.concat_conv1x1.launches, fs.concat_conv1x1.backward_launches,
            fs.concat_conv1x1_dw.launches) == want


@pytest.mark.parametrize("alpha", [0.2, -0.3])
def test_fused_squeeze_module_bf16_training_backward(rng, dev, alpha):
    """bf16 training's K1: ``FusedSqueezeConv(dtype=bfloat16)`` casts its
    float32 masters to bf16 at use; its output and gradients against the
    plain module path (``Conv`` on the ``torch.cat``) in float32 on the same
    bf16-rounded operands: output and dx at the bf16 forward's bar, dW / db /
    dalpha within 1e-2 of their terms' magnitudes, all float32 where the
    parameters are."""
    from vsr_tpu_torch.models import common, feedback

    channels, f, n, h, w = (64, 64, 64), 64, 4, 16, 16
    xs, wt, b = _operands(rng, dev, channels, f, n, h, w)
    fused = common.FusedSqueezeConv(sum(channels), f, dtype="bfloat16").to(dev)
    plain = common.Conv(sum(channels), f, 1, padding=0).to(dev)
    act_f, act_p = feedback.PReLU(alpha).to(dev), feedback.PReLU(alpha).to(dev)
    with torch.no_grad():
        fused.weight.copy_(wt)
        fused.bias.copy_(b)
        plain.weight.copy_(wt.bfloat16().float()[:, :, None, None])
        plain.bias.copy_(b.bfloat16().float())
    x16 = [x.bfloat16().requires_grad_(True) for x in xs]
    x16p = [x.detach().float().requires_grad_(True) for x in x16]
    g = torch.from_numpy(rng.standard_normal((n, f, h, w)).astype(np.float32)
                         ).to(dev).bfloat16()
    with torch.no_grad():
        pre = plain(torch.cat(x16p, dim=1))
    g = g.masked_fill(pre.abs() < 1e-4, 0.0)
    out = fused(x16, act_f.weight)
    # The squeeze rounded to bf16 before the PReLU, as the kernel's is: both
    # backwards see the same bf16 gradient at the squeeze's output.
    ref = act_p(plain(torch.cat(x16p, dim=1)).bfloat16())
    out.backward(g)
    ref.backward(g)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref.float(), rtol=8e-3, atol=1e-4)
    for a, r in zip(x16, x16p):
        assert a.grad.dtype == torch.bfloat16
        torch.testing.assert_close(a.grad.float(), r.grad.float(), rtol=8e-3,
                                   atol=1e-4)
    g_pre = torch.where(pre > 0, g.float().abs(), abs(alpha) * g.float().abs())
    terms_w = torch.einsum("nfhw,nchw->fc", g_pre,
                           torch.cat(x16p, dim=1).detach().abs())
    for got, want, terms in (
            (fused.weight.grad, plain.weight.grad[:, :, 0, 0], terms_w),
            (fused.bias.grad, plain.bias.grad, g_pre.sum(dim=(0, 2, 3))),
            (act_f.weight.grad, act_p.weight.grad,
             (g.float().abs() * pre.abs()).sum())):
        assert got.dtype == torch.float32
        assert bool(((got - want).abs() <= 1e-2 * terms + 1e-6).all())


def test_device_epoch_graph_equals_eager(rng, dev, tmp_path):
    """One device epoch of a bf16 DRFNet through K1 as a captured CUDA
    graph (3 eager steps, a capture, replays) and all eager, from the same
    seed and draws: per-step losses within 1e-5 relative, K1 launched by
    the Python calls of the eager steps and the capture only."""
    from vsr_tpu_torch.config import load_config
    from vsr_tpu_torch.main import run_train

    tree = _write_tree(tmp_path / "tree", rng)
    logs = {}
    for graph in (True, False):
        cfg = load_config("configs/train/acdc_vsr_drf_x2_device.yaml")
        cfg.main.saved_dir = str(tmp_path / f"run_{graph}")
        cfg.dataset.kwargs.data_dir = str(tree / "videos")
        cfg.dataset.kwargs.num_frames = 3
        cfg.dataloader.kwargs.update(train_batch_size=3, num_workers=0)
        cfg.net.kwargs.update(num_features=8, num_groups=2, carry_f32=False,
                              fused_squeeze=True)
        cfg.trainer.kwargs.update(num_epochs=0, patch=8, steps_per_epoch=7)
        trainer = run_train(cfg)  # built on the card, not trained
        trainer._ensure_buffers()
        trainer.engine.use_graph = graph
        fs.concat_conv1x1.launches = fs.concat_conv1x1.backward_launches = 0
        trainer._run_epoch("training", 1)
        torch.cuda.synchronize()
        logs[graph] = trainer.engine.log[:, 0].cpu()
        calls = 4 if graph else 7  # 3 eager + the capture, or 7 eager
        assert trainer.engine.replays == (4 if graph else 0)
        assert fs.concat_conv1x1.backward_launches == 4 * 3 * calls
        assert all(p.dtype == torch.float32 and torch.isfinite(p).all()
                   for p in trainer.net.parameters())
    torch.testing.assert_close(logs[True], logs[False], rtol=1e-5, atol=0)


def test_device_trainers_capture_one_after_another(dev):
    """Device trainers built one after another in one process, as the
    tuner's rows are: each earlier trainer is garbage of a reference cycle
    (its engine's step refers back to it) when the next one captures, with
    the collector set to run at nearly every allocation. A collection
    inside a capture that frees those graphs would invalidate it, so the
    collector is off for each capture and on for the eager steps; the last
    trainer is a bf16 Volume4DSRNet with ``remat`` and ``carry_f32``."""
    import gc

    from vsr_tpu_torch.losses import L1Loss
    from vsr_tpu_torch.models import Volume4DSRNet
    from vsr_tpu_torch.runner.device_trainer import (WARMUP_STEPS,
                                                     DeviceEpochTrainer)

    class Probe(L1Loss):
        """The L1 loss, noting whether the collector was on at each call."""

        def __init__(self, seen):
            super().__init__()
            self.seen = seen

        def forward(self, output, target):
            self.seen.append(gc.isenabled())
            return super().forward(output, target)

    data = np.random.default_rng(0)
    hr = np.round(data.random((4, 3, 1, 4, 32, 32)) * 255).astype(np.float32)
    lr = np.ascontiguousarray(hr[..., ::2, ::2])
    steps = WARMUP_STEPS + 2
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        for dtype in (None, None, "bfloat16"):
            kw = dict(dtype=dtype, carry_f32=True) if dtype else {}
            net = Volume4DSRNet(1, 1, num_features=8, num_resblocks=2,
                                remat=True, device=dev,
                                generator=torch.Generator().manual_seed(0),
                                **kw)
            seen = []
            trainer = DeviceEpochTrainer(
                net, [Probe(seen)], [1.0], [],
                torch.optim.Adam(net.parameters(), lr=1e-4), lr, hr,
                batch_size=2, patch=8, ratio=2, steps_per_epoch=steps,
                device=dev)
            out = trainer.train_epoch()
            torch.cuda.synchronize()
            assert (trainer.engine.captures, trainer.engine.replays) == (
                1, steps - WARMUP_STEPS)
            assert seen == [True] * WARMUP_STEPS + [False], seen
            assert gc.isenabled()
            assert np.isfinite(out["Loss"])
            assert torch.isfinite(trainer.engine.log).all()
            assert all(p.dtype == torch.float32 and torch.isfinite(p).all()
                       for p in trainer.net.parameters())
    finally:
        gc.set_threshold(*thresholds)


# ------------------------------------------------------------------ K3 rank


# Row counts 1, 7 and 9: one past a multiple of the rows a block takes
# (8, 4 or 1, by gs).
@pytest.mark.parametrize("rows,gs", [
    ((5, 4), 256), ((37,), 200), ((3,), 1), ((2, 3), 1024), ((2,), 4096),
    *[((r,), gs) for gs in (1, 31, 200, 256, 1024, 4096) for r in (1, 7, 9)]])
def test_rank_kernel_is_bit_equal_to_twin(rng, dev, rows, gs):
    af = rng.random((*rows, gs)).astype(np.float32)
    af[..., ::3] = af[..., :1]  # many exact ties
    af.reshape(-1, gs)[0, : gs // 2] = 0.0
    af.reshape(-1, gs)[0, 0] = -0.0  # ties with +0.0
    if gs > 4:
        af.reshape(-1, gs)[-1, [1, gs - 2]] = np.nan  # compares false
    a = torch.from_numpy(af).to(dev)
    before = rk.pairwise_rank.launches
    got = rk.pairwise_rank(a)
    want = rk.pairwise_rank_reference(a)
    torch.cuda.synchronize()
    assert rk.pairwise_rank.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == a.shape
    assert torch.equal(got, want)
    # A rank is a permutation of 0..gs-1 in every row without a NaN.
    clean = ~torch.isnan(a).any(dim=-1)
    assert torch.equal(got[clean].sort(dim=-1).values,
                       torch.arange(gs, device=dev, dtype=torch.int32
                                    ).expand_as(got[clean]))


def test_rank_kernel_refuses_what_it_cannot_take(dev):
    with pytest.raises(ValueError, match="at most"):
        rk.pairwise_rank(torch.zeros(2, rk.MAX_GS + 1, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        rk.pairwise_rank(torch.zeros(8, 4, device=dev).t())
    with pytest.raises(TypeError, match="float32"):
        rk.pairwise_rank(torch.zeros(2, 4, device=dev, dtype=torch.bfloat16))


# ------------------------------------------------------------ K2 DUF filter


@pytest.mark.parametrize("n,size,upscale,h,w", [(2, 3, 2, 16, 16),
                                                (2, 5, 2, 8, 24),
                                                (3, 3, 3, 9, 12),
                                                (1, 7, 4, 33, 41),
                                                (2, 1, 2, 5, 70)])
def test_duf_kernel_matches_twin(rng, dev, n, size, upscale, h, w):
    x = torch.from_numpy(rng.random((n, h, w)).astype(np.float32)).to(dev)
    logits = torch.from_numpy((3 * rng.standard_normal(
        (n, size * size * upscale * upscale, h, w))).astype(np.float32)).to(dev)
    before = df.duf_dynamic_filter.launches
    with torch.inference_mode():
        got = df.duf_dynamic_filter(x, logits, size, upscale)
        want = df.duf_dynamic_filter_reference(x, logits, size, upscale)
    torch.cuda.synchronize()
    assert df.duf_dynamic_filter.launches == before + 1
    assert got.shape == (n, h * upscale, w * upscale)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_duf_kernel_casts_bf16_and_refuses_grad(rng, dev):
    x = torch.from_numpy(rng.random((2, 8, 8)).astype(np.float32)).to(dev)
    logits = torch.from_numpy(rng.standard_normal(
        (2, 36, 8, 8)).astype(np.float32)).to(dev)
    with torch.inference_mode():
        got = df.duf_dynamic_filter(x.bfloat16(), logits.bfloat16(), 3, 2)
        want = df.duf_dynamic_filter_reference(
            x.bfloat16().float(), logits.bfloat16().float(), 3, 2)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    logits.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        df.duf_dynamic_filter(x, logits, 3, 2)


# ------------------------- the MISR / FRVSR slice: warps, DUF route, MoE


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("w", [17, 31, 64, 96])
def test_warp_gradient_conventions_on_the_card(rng, dev, w, padding_mode):
    """Integer samples (zero and integer flows, on and past the border) and
    FRVSR's normalized mesh: the card's gradients are the CPU's, which the
    CPU tests hold against JAX's hat convention."""
    from vsr_tpu_torch.models.frvsr import stn_warp
    from vsr_tpu_torch.ops.warp import flow_warp

    img = rng.standard_normal((2, 2, 6, w)).astype(np.float32)
    cot = rng.standard_normal((2, 2, 6, w)).astype(np.float32)
    flows = [np.zeros((2, 2, 6, w), np.float32),
             rng.integers(-2, 3, (2, 2, 6, w)).astype(np.float32)]
    for fn in (flow_warp, stn_warp):
        for flow in flows:
            grads = []
            for device in (dev, torch.device("cpu")):
                i = torch.from_numpy(img).to(device).requires_grad_(True)
                f = torch.from_numpy(flow).to(device).requires_grad_(True)
                out = fn(i, f, padding_mode=padding_mode)
                (out * torch.from_numpy(cot).to(device)).sum().backward()
                grads.append([t.detach().cpu() for t in (out, i.grad, f.grad)])
            for got, want in zip(*grads):
                scale = max(1.0, want.abs().max().item())
                torch.testing.assert_close(got, want, rtol=1e-5,
                                           atol=1e-5 * scale)


def test_deform_conv_gradients_on_the_card(rng, dev):
    from vsr_tpu_torch.ops.deform_conv import deform_conv2d

    x = rng.standard_normal((2, 8, 9, 11)).astype(np.float32)
    offsets = [np.zeros((2, 2, 2, 9, 9, 11), np.float32),
               (1.3 * rng.standard_normal((2, 2, 2, 9, 9, 11))).astype(
                   np.float32)]
    wt = (0.2 * rng.standard_normal((5, 8, 3, 3))).astype(np.float32)
    mask = rng.uniform(0, 1, (2, 2, 9, 9, 11)).astype(np.float32)
    for off in offsets:
        grads = []
        for device in (dev, torch.device("cpu")):
            leaves = [torch.from_numpy(a).to(device).requires_grad_(True)
                      for a in (x, off, wt, mask)]
            out = deform_conv2d(leaves[0], leaves[1], leaves[2], None,
                                leaves[3])
            (out ** 2).sum().backward()
            grads.append([out.detach().cpu()]
                         + [t.grad.cpu() for t in leaves])
        for got, want in zip(*grads):
            scale = max(1.0, want.abs().max().item())
            torch.testing.assert_close(got, want, rtol=1e-5,
                                       atol=1e-5 * scale)


def test_dufnet_takes_the_plain_route_under_autograd(rng, dev):
    from vsr_tpu_torch.models import DUFNet

    net = DUFNet(1, 1, 7, 5, 2, use_pallas_filter=True, device=dev,
                 generator=torch.Generator().manual_seed(0)).train()
    x = torch.from_numpy(rng.standard_normal((2, 7, 1, 8, 8)).astype(
        np.float32)).to(dev)
    before = df.duf_dynamic_filter.launches
    net(x).mean().backward()  # a train step: no K2, no refusal
    assert df.duf_dynamic_filter.launches == before
    assert all(p.grad is not None for p in net.parameters())
    net.eval()
    with torch.no_grad():
        served = net(x)
    assert df.duf_dynamic_filter.launches == before + 1
    plain = DUFNet(1, 1, 7, 5, 2, device=dev).eval()
    plain.load_state_dict(net.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(served, plain(x), rtol=1e-4, atol=1e-4)


def test_rank_kernel_inside_a_moe_train_step(rng, dev):
    """K3 runs in the forward of a train step, once per MoE layer, on the
    detached affinities; its ranks are the twin's, bit for bit."""
    from vsr_tpu_torch.models import MoEEDSRNet

    net = MoEEDSRNet(1, 1, num_resblocks=4, num_features=16,
                     upscale_factor=2, num_experts=4, group_size=64,
                     moe_every=2, router_impl="rank_pallas", device=dev,
                     generator=torch.Generator().manual_seed(1)).train()
    affinities = []
    hooks = [layer.register_forward_pre_hook(
        lambda m, args: affinities.append(
            m.affinities(args[0])[0].detach()))
        for layer in net.moes.values()]
    x = torch.from_numpy(rng.standard_normal((4, 1, 16, 16)).astype(
        np.float32)).to(dev)
    before = rk.pairwise_rank.launches
    net(x).abs().mean().backward()
    for h in hooks:
        h.remove()
    assert rk.pairwise_rank.launches == before + len(net.moes) == before + 2
    for af in affinities:
        torch.testing.assert_close(rk.pairwise_rank(af),
                                   rk.pairwise_rank_reference(af), rtol=0,
                                   atol=0)
    assert net.moes["1"].router.grad is not None


# ------------------------------------------------------- the volumetric nets


def _kernel_launches():
    return (fs.concat_conv1x1.launches, fs.concat_conv1x1_dw.launches,
            df.duf_dynamic_filter.launches, rk.pairwise_rank.launches)


@pytest.mark.parametrize("net_name,shape", [
    ("Volume3DSRNet", (2, 1, 4, 16, 16)),
    ("Volume4DSRNet", (2, 3, 1, 4, 16, 16))])
def test_volume_nets_on_the_card_equal_the_cpu(rng, dev, net_name, shape):
    """A train-mode forward and backward of each volume net (``fused_tail``;
    4D with ``remat``) on the card against the CPU: outputs at the forward
    bar, the loss within 1e-4 relative, every gradient within 1e-3 of the
    net's largest gradient entry (no kernel of the port runs here: PyTorch
    on the card against PyTorch on the CPU). No port kernel is launched."""
    from vsr_tpu_torch import models

    kw = dict(fused_tail=True, **({"remat": True} if "4D" in net_name else {}))
    cpu_net = getattr(models, net_name)(
        1, 1, num_features=8, num_resblocks=2, upscale_factor=2,
        generator=torch.Generator().manual_seed(0), **kw).train()
    card_net = getattr(models, net_name)(
        1, 1, num_features=8, num_resblocks=2, upscale_factor=2, device=dev,
        **kw).train()
    card_net.load_state_dict(cpu_net.state_dict())
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    before = _kernel_launches()
    results = []
    for net, device in ((cpu_net, "cpu"), (card_net, dev)):
        out = net(x.to(device))
        loss = out.square().mean()
        loss.backward()
        results.append((out.detach().cpu(), loss.item(), {
            k: p.grad.cpu() for k, p in net.named_parameters()}))
    assert _kernel_launches() == before
    (out_cpu, loss_cpu, g_cpu), (out_card, loss_card, g_card) = results
    torch.testing.assert_close(out_card, out_cpu, rtol=1e-4, atol=1e-4)
    assert abs(loss_card - loss_cpu) <= 1e-4 * abs(loss_cpu)
    scale = max(g.abs().max().item() for g in g_cpu.values())
    for name, g in g_cpu.items():
        assert (g_card[name] - g).abs().max().item() <= 1e-3 * scale, name


def test_volume4d_remat_on_the_card_keeps_the_gradients(rng, dev):
    from vsr_tpu_torch.models import Volume4DSRNet

    x = torch.from_numpy(rng.standard_normal((2, 3, 1, 4, 16, 16)).astype(
        np.float32)).to(dev)
    grads = []
    for remat in (False, True):
        net = Volume4DSRNet(1, 1, num_features=8, num_resblocks=2,
                            remat=remat, fused_tail=True, device=dev,
                            generator=torch.Generator().manual_seed(0))
        net(x).square().mean().backward()
        grads.append({k: p.grad for k, p in net.named_parameters()})
    scale = max(g.abs().max().item() for g in grads[0].values())
    for name, g in grads[0].items():
        assert (grads[1][name] - g).abs().max().item() <= 1e-6 * scale, name


# ------------------------------------------- serving routes: ops, artifact,
# daemon, stream


def _case_custom_ops_launch_their_kernels(rng, dev):
    """The ops a traced program calls: on CUDA tensors each launches its
    kernel (counted on the wrapper) and matches the twin."""
    xs, w, b = _operands(rng, dev, (64, 64), 64)
    alpha = torch.tensor([0.2], device=dev)
    x = torch.from_numpy(rng.standard_normal((3, 12, 16)).astype(
        np.float32)).to(dev)
    logits = torch.from_numpy(rng.standard_normal((3, 25 * 4, 12, 16)).astype(
        np.float32)).to(dev)
    af = torch.from_numpy(rng.random((6, 256)).astype(np.float32)).to(dev)
    before = (fs.concat_conv1x1.launches, df.duf_dynamic_filter.launches,
              rk.pairwise_rank.launches)
    ops = torch.ops.vsr_tpu_torch
    with torch.inference_mode():
        k1 = ops.concat_conv1x1(xs, w, b, alpha)
        k2 = ops.duf_dynamic_filter(x, logits, 5, 2)
        k3 = ops.pairwise_rank(af)
    torch.cuda.synchronize()
    assert (fs.concat_conv1x1.launches, df.duf_dynamic_filter.launches,
            rk.pairwise_rank.launches) == tuple(n + 1 for n in before)
    torch.testing.assert_close(
        k1, fs.concat_conv1x1_reference(xs, w, b, alpha), rtol=1e-4,
        atol=1e-4)
    torch.testing.assert_close(
        k2, df.duf_dynamic_filter_reference(x, logits, 5, 2), rtol=0,
        atol=1e-4)
    assert torch.equal(k3, rk.pairwise_rank_reference(af))


_DRF_KW = dict(in_channels=1, out_channels=1, num_features=16, num_groups=2,
               upscale_factor=2, fused_squeeze=True, fused_tail=True)


def _drf_artifact(tmp_path, dev, t=3, d=2, side=48):
    from vsr_tpu_torch import export
    from vsr_tpu_torch.infer import build_serving_net

    net = build_serving_net("DRFNet", _DRF_KW, device=dev)
    program, meta = export.export_serving(net, (d * t, side, side), 2,
                                          video_t=t)
    path = tmp_path / "drf.pt2.zip"
    export.save_artifact(path, program, {**meta, "net": "DRFNet"})
    return net, path


def _case_artifact_traced_on_the_card_launches_k1(rng, dev, tmp_path):
    from vsr_tpu_torch import export
    from vsr_tpu_torch.infer import make_pipeline

    net, path = _drf_artifact(tmp_path, dev)
    with pytest.raises(ValueError, match="traced for device 'cuda'"):
        export.ExportedServing(path, device="cpu")
    served = export.ExportedServing(path, device=dev)
    assert served.meta["device"] == "cuda"
    frames = np.round(rng.random((6, 48, 48)) * 255).astype(np.float32)
    before = fs.concat_conv1x1.launches
    _, sr = served(frames)
    torch.cuda.synchronize()
    assert fs.concat_conv1x1.launches - before == 3 * 4  # T x squeezes
    _, want = make_pipeline(net, 2, "acdc", video_t=3)(
        torch.from_numpy(frames).to(dev))
    diff = (sr - want).abs()
    assert (diff == 0).float().mean().item() >= 0.999
    assert diff.max().item() <= 1.0


def _case_daemon_round_trip_on_the_card(rng, dev, tmp_path):
    import io
    import threading
    import urllib.request

    from vsr_tpu_torch import export
    from vsr_tpu_torch.serve import make_server

    _, path = _drf_artifact(tmp_path, dev)
    srv = make_server([path], port=0, warmup=True, device=dev)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        frames = np.round(rng.random((6, 48, 48)) * 255).astype(np.float32)
        buf = io.BytesIO()
        np.save(buf, frames)
        before = fs.concat_conv1x1.launches
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/v1/sr",
            data=buf.getvalue(), headers={"Content-Type": "application/x-npy"})
        with urllib.request.urlopen(req) as resp:
            got = np.load(io.BytesIO(resp.read()))
        assert fs.concat_conv1x1.launches - before == 12
        want = export.ExportedServing(path, device=dev)(frames)[1]
        np.testing.assert_array_equal(got, want.cpu().numpy())
    finally:
        srv.shutdown()
        srv.server_close()


def _case_stream_on_the_card_launches_k1(rng, dev):
    from vsr_tpu_torch.infer import build_serving_net, make_pipeline
    from vsr_tpu_torch.stream import make_stream

    net = build_serving_net("DRFNet", _DRF_KW, device=dev)
    hr = np.round(rng.random((2, 3, 48, 48)) * 255).astype(np.float32)
    stream = make_stream(net, factor=2)
    before = fs.concat_conv1x1.launches
    outs = [stream.push(hr[:, t])[1] for t in range(3)]
    torch.cuda.synchronize()
    assert fs.concat_conv1x1.launches - before == 3 * 4
    got = torch.stack(outs, dim=1).reshape(6, 48, 48)
    _, want = make_pipeline(net, 2, "acdc", video_t=3)(
        torch.from_numpy(hr.reshape(6, 48, 48)).to(dev))
    diff = (got - want).abs()
    assert (diff == 0).float().mean().item() >= 0.999
    assert diff.max().item() <= 1.0


def test_serving_routes_launch_their_kernels_on_the_card(rng, dev, tmp_path):
    """One test for the four cases, every case run and each failure named
    (see tests/test_torch_serve.py for why): the ops, an artifact traced on
    the card, a daemon round trip, a stream."""
    run_cases([
        ("_case_custom_ops_launch_their_kernels",
         lambda: _case_custom_ops_launch_their_kernels(rng, dev)),
        *[(c.__name__, lambda c=c: c(rng, dev, subdir(tmp_path, c.__name__)))
          for c in (_case_artifact_traced_on_the_card_launches_k1,
                    _case_daemon_round_trip_on_the_card)],
        ("_case_stream_on_the_card_launches_k1",
         lambda: _case_stream_on_the_card_launches_k1(rng, dev))])


# ------------------------------------------------------------ W8A8 conv

# The geometries of the W8A8 cases: tests/_torch_w8a8.py.
def _w8a8_case(rng, dev, case, dtype, scale):
    from vsr_tpu_torch.ops import w8a8_conv as wc

    xshape, wshape, stride, padding, groups = W8A8_CASES[case]
    x = torch.from_numpy(rng.standard_normal(xshape).astype(np.float32)
                         ).to(dev).to(dtype)
    w = torch.from_numpy((0.1 * rng.standard_normal(wshape)).astype(
        np.float32)).to(dev)
    b = torch.from_numpy(rng.standard_normal(wshape[0]).astype(np.float32)
                         ).to(dev)
    args = (x, w, b, scale, stride, padding, groups)
    before = wc.w8a8_conv.launches
    with torch.inference_mode():
        acc = wc.w8a8_conv(*args, out_dtype=torch.int32)
        out = wc.w8a8_conv(*args, out_dtype=dtype)
        # The twin on the same card tensors: its float64 conv is exact.
        want_acc = wc.w8a8_conv_reference(*args, out_dtype=torch.int32)
        want = wc.w8a8_conv_reference(*args, out_dtype=dtype)
    torch.cuda.synchronize()
    assert wc.w8a8_conv.launches == before + 2
    assert torch.equal(acc, want_acc)
    assert out.dtype == dtype and torch.equal(out, want)


def _w8a8_quantize_edges(rng, dev, dtype):
    """The kernel's quantization of every element, seen through a 1x1
    identity conv (its accumulators are 127 x the int8 activations): values
    on, and a few ulps off, every half-integer multiple of the scale up to
    +-130 of it, random ones, and huge and denormal ones."""
    from vsr_tpu_torch.ops import w8a8_conv as wc

    xs = np.float32(0.0173)
    k = np.arange(-131, 131, dtype=np.float64) + 0.5
    on = (k * np.float64(xs)).astype(np.float32)
    vals = [on]
    for steps in (1, 2, 3):
        for direction in (np.inf, -np.inf):
            off = on
            for _ in range(steps):
                off = np.nextafter(off, np.float32(direction))
            vals.append(off)
    vals += [(rng.standard_normal(200_000) * 40 * xs).astype(np.float32),
             np.float32([1e30, -1e30, 3e38, -3e38, 1e-40, -1e-40, 0.0])]
    flat = np.concatenate(vals)
    c = 32
    flat = np.concatenate([flat, np.zeros(-flat.size % (c * 64), np.float32)])
    x = torch.from_numpy(flat.reshape(1, c, -1, 64)).to(dev).to(dtype)
    w = torch.eye(c, device=dev).reshape(c, c, 1, 1)
    for scale in (float(xs), None):
        args = (x, w, None, scale, (1, 1), (0, 0))
        with torch.inference_mode():
            got = wc.w8a8_conv(*args, out_dtype=torch.int32)
            want = wc.w8a8_conv_reference(*args, out_dtype=torch.int32)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (scale, (got != want).sum().item())


def test_w8a8_kernel_matches_twin_on_the_card(rng, dev):
    """The int32 accumulators and the dequantized outputs bit-equal to the
    twin, float32 and bf16, static and dynamic scale, on every geometry;
    and the quantization of each element at the rounding edges."""
    run_cases([(f"{case}_{str(dtype)[6:]}_{scale}",
                lambda c=case, d=dtype, s=scale: _w8a8_case(rng, dev, c, d, s))
               for case in W8A8_CASES
               for dtype in (torch.float32, torch.bfloat16)
               for scale in (None, 0.0173)]
              + [(f"quantize_edges_{str(dtype)[6:]}",
                  lambda d=dtype: _w8a8_quantize_edges(rng, dev, d))
                 for dtype in (torch.float32, torch.bfloat16)])


def _case_w8a8_refuses_grad(rng, dev):
    from vsr_tpu_torch.ops import w8a8_conv as wc

    x = torch.zeros(1, 16, 8, 8, device=dev, requires_grad=True)
    w = torch.zeros(16, 16, 3, 3, device=dev)
    with pytest.raises(RuntimeError, match="no backward"):
        wc.w8a8_conv(x, w, None, None, (1, 1), (1, 1))


_EDSR_KW = dict(in_channels=1, out_channels=1, num_resblocks=1,
                num_features=16, upscale_factor=2)


def _serving_net(name, kw, dev):
    from vsr_tpu_torch.infer import build_serving_net

    return build_serving_net(name, kw, device=dev)


def _grey_bar(got, want):
    diff = (got.float().cpu() - want.float().cpu()).abs()
    assert (diff == 0).float().mean().item() >= 0.999
    assert diff.max().item() <= 1.0


def _case_w8a8_pipelines_launch_the_kernel(rng, dev):
    """EDSR dynamic: one launch per eligible conv and call; DRF with
    callback scales: the k6 s2 convs through the kernel, K1 unchanged on
    the squeezes. Each against the same pipeline on the CPU (the twin)."""
    from vsr_tpu_torch import quantize
    from vsr_tpu_torch.infer import make_pipeline, make_prep
    from vsr_tpu_torch.ops import w8a8_conv as wc

    frames = torch.from_numpy(
        np.round(rng.random((6, 48, 48)) * 255).astype(np.float32))
    before = wc.w8a8_conv.launches
    got = make_pipeline(_serving_net("EDSRNet", _EDSR_KW, dev), 2, "acdc",
                        w8a8="dynamic")(frames.to(dev))[1]
    torch.cuda.synchronize()
    assert wc.w8a8_conv.launches - before == 4
    want = make_pipeline(_serving_net("EDSRNet", _EDSR_KW, "cpu"), 2, "acdc",
                         w8a8="dynamic")(frames)[1]
    _grey_bar(got, want)

    net = _serving_net("DRFNet", _DRF_KW, "cpu")
    _, z = make_prep(2, "acdc", video_t=3)(frames)
    scales = quantize.calibrate_w8a8(net, [z], method="callback")
    plain = make_pipeline(_serving_net("DRFNet", _DRF_KW, dev), 2, "acdc",
                          video_t=3)
    k1 = fs.concat_conv1x1.launches
    plain(frames.to(dev))
    k1_plain = fs.concat_conv1x1.launches - k1
    k1, before = fs.concat_conv1x1.launches, wc.w8a8_conv.launches
    got = make_pipeline(_serving_net("DRFNet", _DRF_KW, dev), 2, "acdc",
                        video_t=3, w8a8=scales)(frames.to(dev))[1]
    torch.cuda.synchronize()
    assert fs.concat_conv1x1.launches - k1 == k1_plain == 3 * 4
    assert wc.w8a8_conv.launches - before > 0
    want = make_pipeline(net, 2, "acdc", video_t=3, w8a8=scales)(frames)[1]
    _grey_bar(got, want)


def _case_int8_and_w8a8_artifacts_on_the_card(rng, dev, tmp_path):
    from vsr_tpu_torch import export, quantize
    from vsr_tpu_torch.infer import make_pipeline, make_prep
    from vsr_tpu_torch.ops import w8a8_conv as wc

    frames = np.round(rng.random((6, 48, 48)) * 255).astype(np.float32)
    _, z = make_prep(2, "acdc")(torch.from_numpy(frames))
    scales = quantize.calibrate_w8a8(_serving_net("EDSRNet", _EDSR_KW, "cpu"),
                                     [z])
    for name, kw in (("w8a8", dict(w8a8=scales)), ("int8", dict(int8=True))):
        program, meta = export.export_serving(
            _serving_net("EDSRNet", _EDSR_KW, dev), frames.shape, 2, **kw)
        path = tmp_path / f"{name}.pt2.zip"
        export.save_artifact(path, program, {**meta, "net": "EDSRNet"})
        served = export.ExportedServing(path, device=dev)
        before = wc.w8a8_conv.launches
        got = served(frames)[1]
        torch.cuda.synchronize()
        assert wc.w8a8_conv.launches - before == (4 if name == "w8a8" else 0)
        want = make_pipeline(_serving_net("EDSRNet", _EDSR_KW, dev), 2,
                             "acdc", **kw)(torch.from_numpy(frames).to(dev))[1]
        _grey_bar(got, want)


def test_quantized_serving_on_the_card(rng, dev, tmp_path):
    """The W8A8 kernel refuses gradients; the W8A8 pipelines launch it once
    per eligible conv and call (K1 unchanged on DRF's squeezes) and agree
    with the CPU twin's; int8 and W8A8 artifacts traced on the card."""
    run_cases([
        ("_case_w8a8_refuses_grad", lambda: _case_w8a8_refuses_grad(rng, dev)),
        ("_case_w8a8_pipelines_launch_the_kernel",
         lambda: _case_w8a8_pipelines_launch_the_kernel(rng, dev)),
        ("_case_int8_and_w8a8_artifacts_on_the_card",
         lambda: _case_int8_and_w8a8_artifacts_on_the_card(
             rng, dev, subdir(tmp_path, "artifacts")))])


# ------------------------------------------------------- the training knobs


def _case_two_graph_accumulation_equals_eager(rng, dev, tmp_path):
    """A device epoch of a small EDSR with every knob and QAT: two graphs
    (accumulate; accumulate and apply) against the eager epoch."""
    from vsr_tpu_torch.config import load_config
    from vsr_tpu_torch.main import run_train

    tree = _write_tree(tmp_path / "tree", rng)
    logs, emas = {}, {}
    for graph in (True, False):
        cfg = load_config("configs/train/acdc_sisr_edsr_x2_device.yaml")
        cfg.main.saved_dir = str(tmp_path / f"run_{graph}")
        cfg.dataset.kwargs.data_dir = str(tree / "imgs")
        cfg.dataloader.kwargs.update(train_batch_size=3, num_workers=0)
        cfg.net.kwargs.update(num_resblocks=2, num_features=16)
        cfg.trainer.kwargs.update(
            num_epochs=0, patch=8, steps_per_epoch=8, grad_accumulation=2,
            grad_clip=0.5, ema_decay=0.9, qat=True)
        trainer = run_train(cfg)  # built on the card, not trained
        trainer._ensure_buffers()
        trainer.engine.use_graph = graph
        trainer._run_epoch("training", 1)
        torch.cuda.synchronize()
        eng = trainer.engine
        assert (eng.eager_steps, eng.captures, eng.replays) == (
            (3, 2, 5) if graph else (8, 0, 0))
        assert sorted(eng.graphs) == ([False, True] if graph else [])
        logs[graph] = eng.log[:, 0].cpu()
        emas[graph] = [e.cpu() for e in trainer.chain.ema]
        assert trainer.chain.mini_step == 0
    torch.testing.assert_close(logs[True], logs[False], rtol=1e-5, atol=0)
    for a, b in zip(emas[True], emas[False]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def _case_clip_and_ema_capture_without_a_host_sync(rng, dev):
    from vsr_tpu_torch import optim
    from vsr_tpu_torch.runner.device_trainer import make_capturable

    net = torch.nn.Linear(16, 8).to(dev)
    twin = torch.nn.Linear(16, 8).to(dev)
    twin.load_state_dict(net.state_dict())
    chains = [optim.GradientChain(make_capturable(
        optim.Adam(lr=1e-2).bind(m.parameters()), dev), m, grad_clip=0.1,
        ema_decay=0.9) for m in (net, twin)]
    x = torch.from_numpy(rng.standard_normal((4, 16)).astype(np.float32)).to(
        dev)

    def step(m, chain):
        chain.optimizer.zero_grad(set_to_none=True)
        m(x).square().sum().backward()
        chain.step()

    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):  # warm-up: the optimizer's state
        for m, chain in zip((net, twin), chains):
            step(m, chain)
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.set_sync_debug_mode("error")  # a host sync would raise
    try:
        step(twin, chains[1])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step(net, chains[0])
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip((*net.parameters(), *chains[0].ema),
                    (*twin.parameters(), *chains[1].ema)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def _case_bicubic_exports_and_streams_on_the_card(rng, dev, tmp_path):
    from vsr_tpu_torch import export
    from vsr_tpu_torch.infer import build_serving_net, make_pipeline, net_device
    from vsr_tpu_torch.stream import make_stream

    net = build_serving_net("Bicubic", {"upscale_factor": 2}, device=dev)
    assert net_device(net).type == "cuda"
    frames = np.round(rng.random((6, 48, 48)) * 255).astype(np.float32)
    path = tmp_path / "bicubic.pt2.zip"
    export.main(["--net", "Bicubic", "--net-kwargs", '{"upscale_factor": 2}',
                 "--shape", "6,48,48", "--out", str(path)])
    served = export.ExportedServing(path, device=dev)
    assert served.meta["device"] == "cuda"
    _, sr = served(frames)
    _, want = make_pipeline(net, 2, "acdc")(torch.from_numpy(frames).to(dev))
    assert sr.device.type == "cuda"
    torch.testing.assert_close(sr, want, rtol=0, atol=1.0)
    stream = make_stream(net, factor=2)
    assert stream.device.type == "cuda"
    _, out = stream.push(frames)
    assert out.device.type == "cuda"
    torch.testing.assert_close(out, want, rtol=0, atol=1.0)


def _case_qat_forward_equals_w8a8_on_the_card(rng, dev):
    """``tests/test_qat.py``'s bar: the fake-quant forward against the W8A8
    kernel's pipeline with the same scales, 2e-3 on normalized outputs, and
    unlike the unquantized forward."""
    from vsr_tpu_torch import models, quantize

    net = models.EDSRNet(in_channels=1, out_channels=1, num_resblocks=2,
                         num_features=16, upscale_factor=2).to(dev).eval()
    z = torch.from_numpy(rng.standard_normal((4, 1, 24, 24)).astype(
        np.float32)).to(dev)
    scales = quantize.calibrate_w8a8(net, [z])
    before = quantize.w8a8_conv.launches
    with torch.inference_mode():
        fake = quantize.make_fake_quant_apply(net, scales)(z)
        w8a8 = quantize.make_w8a8_apply(net, scales)(z)
        plain = net(z)
    torch.cuda.synchronize()
    assert quantize.w8a8_conv.launches - before == len(scales) == 6
    assert (fake - w8a8).abs().max().item() <= 2e-3
    assert (plain - w8a8).abs().max().item() > 1e-4


def test_training_knobs_on_the_card(rng, dev, tmp_path):
    """The gradient chain and QAT inside two captured graphs against eager;
    the clip and the EMA captured with no host sync; Bicubic exported and
    streamed on the card; QAT's forward against W8A8's."""
    run_cases([
        ("_case_two_graph_accumulation_equals_eager",
         lambda: _case_two_graph_accumulation_equals_eager(
             rng, dev, subdir(tmp_path, "graphs"))),
        ("_case_clip_and_ema_capture_without_a_host_sync",
         lambda: _case_clip_and_ema_capture_without_a_host_sync(rng, dev)),
        ("_case_bicubic_exports_and_streams_on_the_card",
         lambda: _case_bicubic_exports_and_streams_on_the_card(
             rng, dev, subdir(tmp_path, "bicubic"))),
        ("_case_qat_forward_equals_w8a8_on_the_card",
         lambda: _case_qat_forward_equals_w8a8_on_the_card(rng, dev))])


# --------------------------------------- the feedback family and the routers


def _card_and_cpu(make, dev):
    """The same seeded net on the CPU and on the card."""
    cpu = make(torch.device("cpu"))
    card = make(dev)
    card.load_state_dict(cpu.state_dict())
    return cpu, card


def _case_feedback_nets_on_the_card(rng, dev):
    """DRFSISRNet (experts, sub-pixel deconvs) and DRFNet (experts) through
    K1 on the card against the CPU: outputs at the forward bar, 2 G fused
    squeezes a step, no K3 (the DRF experts run the plain rank)."""
    from vsr_tpu_torch.models import DRFNet, DRFSISRNet

    kw = dict(in_channels=1, out_channels=1, num_features=8, num_groups=2,
              upscale_factor=2, fused_squeeze=True, num_experts=2,
              expert_group_size=16)
    for make, shape, steps in (
            (lambda d: DRFSISRNet(num_steps=3, subpixel_deconv=True,
                                  device=d, **kw), (2, 1, 6, 6), 3),
            (lambda d: DRFNet(device=d, **kw), (2, 3, 1, 6, 6), 3)):
        cpu, card = _card_and_cpu(make, dev)
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        before = _kernel_launches()
        with torch.no_grad():
            got = card(x.to(dev)).cpu()
            want = cpu(x)
        after = _kernel_launches()
        assert after[0] - before[0] == 2 * 2 * steps and after[3] == before[3]
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def _case_drfnet_remat_recomputes_through_k1(rng, dev):
    """remat on the card, with cuDNN's deterministic algorithms (its
    default f32 dgrad alone moves tiny gradients of two plain runs):
    gradients within 1e-3 of each gradient's largest entry of the plain
    run's, the recompute's K1 forward launches counted."""
    from vsr_tpu_torch.models import DRFNet

    x = torch.from_numpy(rng.standard_normal((2, 3, 1, 8, 8)).astype(
        np.float32)).to(dev)
    runs = []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for remat in (False, True):
            net = DRFNet(1, 1, 8, 2, 2, fused_squeeze=True, remat=remat,
                         device=dev,
                         generator=torch.Generator().manual_seed(1))
            before = _kernel_launches()
            net(x).square().mean().backward()
            torch.cuda.synchronize()
            after = _kernel_launches()
            runs.append(([a - b for a, b in zip(after, before)],
                         {k: p.grad for k, p in net.named_parameters()}))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    # 4 squeezes a frame step, 3 frames: K1's forward (twice under remat)
    # and its dW / db kernel.
    assert runs[0][0] == [12, 12, 0, 0] and runs[1][0] == [24, 12, 0, 0]
    for name, g in runs[0][1].items():
        scale = g.abs().max().item()
        assert (runs[1][1][name] - g).abs().max().item() <= 1e-3 * scale


def _case_moe_routers_on_the_card(rng, dev):
    """rank_pallas + dense_nhwc launches K3 once a layer; sort / sparse and
    radix / dense launch none; every mask equals the kernel's rank's."""
    from vsr_tpu_torch.models import moe

    x = torch.from_numpy(rng.standard_normal((2, 8, 12, 12)).astype(
        np.float32)).to(dev)
    outs = {}
    for router, dispatch in (("rank_pallas", "dense_nhwc"),
                             ("sort", "sparse"), ("radix", "dense")):
        torch.manual_seed(2)
        layer = moe.ExpertChoiceMoE(8, 4, group_size=64, router_impl=router,
                                    dispatch_impl=dispatch).to(dev)
        before = _kernel_launches()
        with torch.no_grad():
            outs[router] = layer(x)
            af, gs = layer.affinities(x)
        torch.cuda.synchronize()
        assert _kernel_launches()[3] - before[3] == (
            1 if router == "rank_pallas" else 0)
        cap = layer.capacity(gs)
        if router != "rank_pallas":
            assert torch.equal(layer.selection(af, cap),
                               moe.route(af, "rank_pallas") < cap)
    for router in ("sort", "radix"):
        torch.testing.assert_close(outs[router], outs["rank_pallas"],
                                   rtol=1e-4, atol=1e-4)


def _case_feedback_frame_serving_on_the_card(rng, dev):
    """SRFBNet served in frame mode on the card: the last step, K1 2 G a
    step of each chunk's call, at the grey bar of the CPU pipeline."""
    from vsr_tpu_torch.infer import make_pipeline
    from vsr_tpu_torch.models import SRFBNet

    cpu, card = _card_and_cpu(lambda d: SRFBNet(
        1, 1, 2, 8, 2, 2, fused_squeeze=True, subpixel_deconv=True, device=d,
        generator=torch.Generator().manual_seed(3)), dev)
    frames = torch.from_numpy(np.round(rng.random((6, 24, 24)) * 255).astype(
        np.float32))
    before = _kernel_launches()
    got = make_pipeline(card, 2, "acdc", chunk=4)(frames.to(dev))[1].cpu()
    assert _kernel_launches()[0] - before[0] == 2 * 2 * 2 * 2  # 2 calls
    want = make_pipeline(cpu, 2, "acdc")(frames)[1]
    _grey_bar(got, want)


def test_feedback_family_and_routers_on_the_card(rng, dev):
    """The slice of the rest of the feedback family and the MoE routers:
    K1 and K3 launch where they should and nowhere else, card = CPU."""
    run_cases([
        ("_case_feedback_nets_on_the_card",
         lambda: _case_feedback_nets_on_the_card(rng, dev)),
        ("_case_drfnet_remat_recomputes_through_k1",
         lambda: _case_drfnet_remat_recomputes_through_k1(rng, dev)),
        ("_case_moe_routers_on_the_card",
         lambda: _case_moe_routers_on_the_card(rng, dev)),
        ("_case_feedback_frame_serving_on_the_card",
         lambda: _case_feedback_frame_serving_on_the_card(rng, dev))])


def _case_w8a8_deconv_banks(rng, dev):
    """The W8A8 kernel on both transposed-conv banks of the zoo (k6 s2 p2,
    k8 s4 p2; 64 -> 64): int32 accumulators bit-equal to the twin's and to
    the unfused int8 transposed conv, the served deconv equal to the
    twin's, one launch a call."""
    import torch.nn.functional as F

    from vsr_tpu_torch import quantize
    from vsr_tpu_torch.models.common import ConvTranspose
    from vsr_tpu_torch.ops import w8a8_conv as wc

    torch.manual_seed(0)
    for k, s, p, side in ((6, 2, 2, 24), (8, 4, 2, 12)):
        mod = ConvTranspose(64, 64, k, s, p).to(dev)
        x = torch.from_numpy(rng.standard_normal((2, 64, side, side)).astype(
            np.float32)).to(dev)
        bank = quantize.deconv_bank(mod)
        pad = bank["padding"][0]
        args = (x, bank["weight"], bank["bias"], None, (1, 1), (pad, pad), 1)
        kw = dict(weight_scale=bank["weight_scale"])
        with torch.inference_mode():
            before = wc.w8a8_conv.launches
            acc = wc.w8a8_conv(*args, out_dtype=torch.int32, **kw)
            assert wc.w8a8_conv.launches == before + 1
            assert torch.equal(acc, wc.w8a8_conv_reference(
                *args, out_dtype=torch.int32, **kw))
            xs = wc.dynamic_scale(x)
            xq = wc.quantize_activations(x, xs)
            wq, _ = wc.quantize_weight(mod.weight.transpose(0, 1))
            unfused = F.conv_transpose2d(xq.double(),
                                         wq.transpose(0, 1).double(), None,
                                         s, p).to(torch.int32)
            assert torch.equal(F.pixel_shuffle(acc, s), unfused)
            got = quantize._w8a8_deconv(mod, x, None)
            want = F.pixel_shuffle(wc.w8a8_conv_reference(*args, **kw), s)
            assert (got - want).abs().max().item() <= 1e-6 * want.abs().max()


def _case_infer_preset_fast(tmp_path, dev):
    """``infer --preset fast`` on a small EDSRNet: the preset's knobs,
    W8A8 launched where the card's table sets it, PSNR within 0.5 dB of
    the run without a preset."""
    import json

    from vsr_tpu_torch import infer
    from vsr_tpu_torch.io import nifti
    from vsr_tpu_torch.ops import w8a8_conv as wc
    from vsr_tpu_torch.presets import SERVING_PRESETS

    yy, xx = np.mgrid[:48, :48]
    vol = (120 + 80 * np.sin(yy / 5.0)[..., None, None]
           * np.cos(xx / 7.0)[..., None, None]) * np.ones((1, 1, 2, 4))
    nifti.save_nifti(vol.astype(np.float32), tmp_path / "in" / "p" / "p.nii")
    kw = dict(in_channels=1, out_channels=1, num_resblocks=2, num_features=32,
              upscale_factor=2)
    stats = {}
    for preset in ("", "fast"):
        before = wc.w8a8_conv.launches
        stats[preset] = infer.main(
            [str(tmp_path / "in"), str(tmp_path / f"out{preset}"), "--psnr",
             "--net", "EDSRNet", "--net-kwargs", json.dumps(kw), "--device",
             str(dev)] + (["--preset", preset] if preset else []))
        stats[preset]["launches"] = wc.w8a8_conv.launches - before
    lazy = SERVING_PRESETS["EDSRNet"].get("w8a8") == "lazy"
    assert (stats["fast"]["launches"] > 0) == lazy
    assert stats[""]["launches"] == 0
    assert abs(stats["fast"]["psnr_mean"] - stats[""]["psnr_mean"]) < 0.5


def test_w8a8_deconvs_and_presets_on_the_card(rng, dev, tmp_path):
    run_cases([
        ("w8a8_deconv_banks", lambda: _case_w8a8_deconv_banks(rng, dev)),
        ("infer_preset_fast", lambda: _case_infer_preset_fast(
            subdir(tmp_path, "preset"), dev)),
    ])
