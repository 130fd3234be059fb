"""Fused concat + 1x1 conv squeeze (the port of the Pallas kernel K1).

The FBlock dense ladders of DRFNet concatenate their growing feature lists
and feed each concat to a 1x1 squeeze conv. ``concat_conv1x1`` computes
``conv1x1(cat(xs, dim=1), W) + b`` WITHOUT materializing the concat: on a
CUDA tensor it launches the hand-written kernel of ``csrc/fused_squeeze.cu``
(which replaces ``vsr_tpu/ops/fused_squeeze.py``'s ``concat_matmul``); on a
CPU tensor it runs the plain twin ``concat_conv1x1_reference``. There is no
fallback from the kernel to the twin: a CUDA call that the kernel cannot
take raises.

The kernel streams the inputs once through a shared-memory ring filled by
asynchronous copies and multiplies on the tensor cores: bf16 directly,
float32 as three TF32 products of split operands, which keeps float32
accuracy (``tests/test_torch_port_squeeze_prelu.py`` models that arithmetic
in numpy against float64). With
``prelu_weight`` the PReLU that follows every squeeze of the feedback block
runs in the kernel's epilogue, on the rounded output, so the result is
what a separate ``nn.PReLU`` gives, bit for bit, without its pass over
device memory.

Training: ``concat_conv1x1`` is differentiable. Where a gradient is needed
the kernel is launched without its epilogue through a
``torch.autograd.Function`` and the PReLU follows as an ordinary autograd
op, so gradients are right for any alpha (zero and negative ones too: the
sign of the pre-activation cannot be recovered from a fused output). The
backward computes what the JAX ``_bwd`` computes: ``dx_i = g W_i^T`` in the
inputs' dtype, ``dW_i = x_i^T g`` and ``db = sum g`` accumulated in float32
and cast to the parameter's dtype. ``dx`` runs through the same hand-written
kernel: with the one input ``g (N, F, H, W)`` and the weight ``W^T`` (which
is ``(sum C_i, F)``, the kernel's ``(F_out, K)`` convention) and a zero bias,
one launch writes ``(N, sum C_i, H, W)`` and the ``dx_i`` are its channel
slices; in float32 that is the three-TF32-product route again, with the
accuracy of a plain float32 product. ``dW`` and ``db`` come from
``concat_conv1x1_dw``: on a CUDA tensor the hand-written split-K kernel of
``csrc/fused_squeeze_dw.cu`` (tensor cores, one launch for both; the JAX
package computes them in plain XLA, outside its Pallas kernel, so no TPU
kernel stands behind this one), on a CPU tensor its plain twin (one matmul
over the images and pixels of each ``x_i``, and a sum). Saved for the
backward are the ``x_i`` and ``W``, never a concatenated copy. Under
``torch.no_grad()`` serving keeps the fused epilogue bit for bit.

Serving: where no gradient is recorded the call goes through the custom op
``torch.ops.vsr_tpu_torch.concat_conv1x1`` (its CPU implementation is the
twin, its CUDA one the kernel, its fake one the output's shape and dtype),
so ``torch.export`` records the op, not ``torch.cat`` + conv, and a loaded
program launches the kernel and counts its launches on the wrapper.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

_MAX_INPUTS = 8  # kMaxInputs of csrc/fused_squeeze.cu, fused_squeeze_dw.cu
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def concat_conv1x1_reference(xs: Sequence[torch.Tensor], weight: torch.Tensor,
                             bias: torch.Tensor,
                             prelu_weight: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """Plain twin: ``torch.cat`` then a 1x1 conv, then (with
    ``prelu_weight``) ``F.prelu``, in the type of ``xs`` (weight, bias and
    the PReLU weight are cast to it first, as the JAX kernel does)."""
    dtype = xs[0].dtype
    w = weight.to(dtype)
    out = F.conv2d(torch.cat(list(xs), dim=1), w.reshape(*w.shape, 1, 1),
                   bias.to(dtype))
    if prelu_weight is None:
        return out
    _check_prelu_weight(prelu_weight, xs[0].device)
    return F.prelu(out, prelu_weight.to(dtype).reshape(1))


def concat_conv1x1(xs: Sequence[torch.Tensor], weight: torch.Tensor,
                   bias: torch.Tensor,
                   prelu_weight: torch.Tensor | None = None) -> torch.Tensor:
    """``conv1x1(cat(xs, 1), weight) + bias`` without the concat, and with
    ``prelu_weight`` the PReLU of that.

    xs: NCHW tensors ``(N, C_i, H, W)``, 1 to 8 of them, contiguous, one
    dtype (float32 or bfloat16). weight ``(F, sum C_i)``, bias ``(F,)``,
    prelu_weight one element (float32 or bfloat16) or None; all are cast to
    the dtype of ``xs`` (bf16-rounded in bf16 mode). Returns ``(N, F, H,
    W)`` in that dtype, accumulated in float32 and rounded once; the PReLU
    applies to the rounded value and rounds again, as a separate
    ``nn.PReLU`` would. Any H x W, C_i and F are taken; rows and pointers
    that are not multiples of 16 bytes go through the kernel's element-wise
    loads.

    Differentiable with respect to every tensor argument (see the module
    docstring). ``concat_conv1x1.launches`` counts the forward launches of
    the kernel, ``concat_conv1x1.backward_launches`` the launches that
    compute ``dx`` in a backward."""
    xs = list(xs)
    if not xs:
        raise ValueError("concat_conv1x1 needs at least one input")
    device = xs[0].device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"concat_conv1x1 runs on cpu or cuda, not {device}")
    if prelu_weight is not None:
        _check_prelu_weight(prelu_weight, device)
    if not (torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (*xs, weight, bias, prelu_weight))):
        return torch.ops.vsr_tpu_torch.concat_conv1x1(xs, weight, bias,
                                                      prelu_weight)
    if device.type == "cpu":
        return concat_conv1x1_reference(xs, weight, bias, prelu_weight)
    _check(xs, weight, bias)
    out = _ConcatConv1x1.apply(weight, bias, *xs)
    if prelu_weight is None:
        return out
    return F.prelu(out, prelu_weight.to(out.dtype).reshape(1))


concat_conv1x1.launches = 0
concat_conv1x1.backward_launches = 0


@torch.library.custom_op("vsr_tpu_torch::concat_conv1x1", mutates_args=(),
                         device_types="cpu")
def _concat_conv1x1_op(xs: list[torch.Tensor], weight: torch.Tensor,
                       bias: torch.Tensor, prelu_weight: torch.Tensor | None
                       ) -> torch.Tensor:
    """The op without autograd that serving reaches: the twin on CPU
    tensors, the kernel on CUDA tensors."""
    return concat_conv1x1_reference(xs, weight, bias, prelu_weight)


@_concat_conv1x1_op.register_kernel("cuda")
def _concat_conv1x1_cuda(xs, weight, bias, prelu_weight):
    xs = list(xs)
    _check(xs, weight, bias)
    if prelu_weight is not None:
        _check_prelu_weight(prelu_weight, xs[0].device)
    return _launch(xs, weight, bias, prelu_weight)


@_concat_conv1x1_op.register_fake
def _concat_conv1x1_fake(xs, weight, bias, prelu_weight):
    n, _, h, w = xs[0].shape
    return xs[0].new_empty((n, weight.shape[0], h, w))


def _launch(xs: list[torch.Tensor], weight: torch.Tensor, bias: torch.Tensor,
            prelu_weight: torch.Tensor | None,
            counter: str = "launches") -> torch.Tensor:
    """One launch of the kernel on checked CUDA operands; adds one to
    ``concat_conv1x1.<counter>``."""
    device, dtype = xs[0].device, xs[0].dtype
    n, _, h, w = xs[0].shape
    f_out = weight.shape[0]
    wt = weight.detach().to(dtype).contiguous()
    bt = bias.detach().to(dtype).contiguous()
    # The PReLU weight travels as a device pointer: no host read of it.
    at = (None if prelu_weight is None
          else prelu_weight.detach().to(dtype).contiguous())

    from vsr_tpu_torch import _build

    lib = _build.load()
    out = torch.empty((n, f_out, h, w), dtype=dtype, device=device)
    ptrs = (ctypes.c_void_p * _MAX_INPUTS)(*[x.data_ptr() for x in xs])
    chans = (ctypes.c_int * _MAX_INPUTS)(*[x.shape[1] for x in xs])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.vsr_concat_conv1x1(ptrs, chans, len(xs), wt.data_ptr(),
                                    bt.data_ptr(),
                                    None if at is None else at.data_ptr(),
                                    out.data_ptr(), n, h * w, f_out,
                                    _DTYPE_CODES[dtype], stream)
    if rc != 0:
        raise RuntimeError(f"concat_conv1x1 kernel launch failed: "
                           f"cudaError_t {rc}")
    setattr(concat_conv1x1, counter, getattr(concat_conv1x1, counter) + 1)
    return out


class _ConcatConv1x1(torch.autograd.Function):
    """The kernel without its epilogue, with the backward of the JAX
    ``_bwd``. CUDA only: CPU tensors take the twin and plain autograd."""

    @staticmethod
    def forward(ctx, weight, bias, *xs):
        ctx.save_for_backward(weight, *xs)
        ctx.bias_dtype = bias.dtype
        return _launch([x.detach() for x in xs], weight, bias, None)

    @staticmethod
    def backward(ctx, grad_out):
        weight, *xs = ctx.saved_tensors
        dtype = xs[0].dtype
        g = grad_out.to(dtype).contiguous()
        channels = [x.shape[1] for x in xs]
        need_w, need_b, *need_x = ctx.needs_input_grad
        d_weight = d_bias = None
        d_xs: list[torch.Tensor | None] = [None] * len(xs)
        if any(need_x):
            # dx = g W^T for all inputs in one launch: the kernel's weight is
            # (F_out, K) = (sum C_i, F) = W^T; no bias, no epilogue.
            wt = weight.detach().to(dtype).t().contiguous()
            zero = torch.zeros(wt.shape[0], dtype=dtype, device=g.device)
            dx = _launch([g], wt, zero, None, counter="backward_launches")
            d_xs = [part if need else None
                    for part, need in zip(dx.split(channels, dim=1), need_x)]
        if need_w or need_b:
            dw, db = concat_conv1x1_dw(xs, g)
            d_weight = dw.to(weight.dtype) if need_w else None
            d_bias = db.to(ctx.bias_dtype) if need_b else None
        return d_weight, d_bias, *d_xs


def concat_conv1x1_dw_reference(xs: Sequence[torch.Tensor], g: torch.Tensor
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of ``concat_conv1x1_dw``: one product per input with the
    images folded into the summed dimension, ``(F, N*HW) @ (N*HW, C_i)``, on
    channel-major float32 copies of ``g`` and of one ``x_i`` at a time, and a
    sum of ``g`` over images and pixels."""
    def channel_major(t: torch.Tensor) -> torch.Tensor:
        return t.flatten(2).transpose(0, 1).reshape(t.shape[1], -1).float()

    gp = channel_major(g)
    dw = torch.cat([gp @ channel_major(x).t() for x in xs], dim=1)
    return dw, gp.sum(dim=1)


def concat_conv1x1_dw(xs: Sequence[torch.Tensor], g: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The weight and bias gradient of ``concat_conv1x1`` for the output
    gradient ``g (N, F, H, W)``: ``dW (F, sum C_i)`` with ``dW[:, off_i + c]
    = sum_n sum_p g[n, :, p] x_i[n, c, p]`` and ``db (F,) = sum_n sum_p g``,
    both float32 (accumulated in float32 whatever the inputs' type), without
    a concatenated or transposed copy.

    xs as for ``concat_conv1x1``; ``g`` contiguous, of their dtype and
    device. On CUDA tensors it launches the split-K tensor-core kernel of
    ``csrc/fused_squeeze_dw.cu`` and the small kernel that adds its partial
    tiles in a fixed order (no atomics: the same bits every run), as one
    launch; on CPU tensors it runs the plain twin.
    ``concat_conv1x1_dw.launches`` counts the kernel's launches."""
    xs = list(xs)
    if not xs:
        raise ValueError("concat_conv1x1_dw needs at least one input")
    device, dtype = xs[0].device, xs[0].dtype
    if device.type == "cpu":
        return concat_conv1x1_dw_reference(xs, g)
    if device.type != "cuda":
        raise ValueError(f"concat_conv1x1_dw runs on cpu or cuda, not {device}")
    n, k_total, h, w = _check_inputs(xs)
    if (g.dim() != 4 or (g.shape[0], g.shape[2], g.shape[3]) != (n, h, w)
            or g.dtype != dtype or g.device != device
            or not g.is_contiguous()):
        raise ValueError(f"g must be a contiguous (N, F, H, W) = ({n}, F, {h}, "
                         f"{w}) {dtype} tensor on {device}, got "
                         f"{tuple(g.shape)} {g.dtype} on {g.device}")
    f_out, hw = g.shape[1], h * w
    channels = [x.shape[1] for x in xs]
    chunk, splits = _dw_split(
        n, hw, channels, f_out,
        torch.cuda.get_device_properties(device).multi_processor_count)
    # One split's partial: f_out rows of k_total (rounded up to even)
    # channels, then the f_out row sums for db; an even count of floats.
    stride = f_out * (k_total + k_total % 2 + 1)
    stride += stride % 2

    from vsr_tpu_torch import _build

    lib = _build.load()
    partial = torch.empty((splits, stride), dtype=torch.float32,
                          device=device)
    dw = torch.empty((f_out, k_total), dtype=torch.float32, device=device)
    db = torch.empty((f_out,), dtype=torch.float32, device=device)
    ptrs = (ctypes.c_void_p * _MAX_INPUTS)(*[x.data_ptr() for x in xs])
    chans = (ctypes.c_int * _MAX_INPUTS)(*channels)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.vsr_concat_dw(ptrs, chans, len(xs), g.data_ptr(),
                               partial.data_ptr(), dw.data_ptr(),
                               db.data_ptr(), n, hw, f_out, chunk, splits,
                               stride, _DTYPE_CODES[dtype], stream)
    if rc != 0:
        raise RuntimeError(f"concat_conv1x1_dw kernel launch failed: "
                           f"cudaError_t {rc}")
    concat_conv1x1_dw.launches += 1
    return dw, db


concat_conv1x1_dw.launches = 0


_DW_BLOCKS_PER_SM = 3  # kMinBlocks of csrc/fused_squeeze_dw.cu: one wave
_DW_STEP = 64  # pixels: the kernel's step in bfloat16 (two steps in float32)


def _dw_split(n: int, hw: int, channels: Sequence[int], f_out: int,
              sms: int) -> tuple[int, int]:
    """How ``concat_conv1x1_dw`` cuts the summed dimension: ``(chunk,
    splits)``. A unit of work is an image x a chunk of pixels (a multiple of
    the kernel's step, at least 128 where the image has them); ``splits``
    blocks per output tile walk the units, so that all blocks together are
    about one wave of the card."""
    tiles = sum(_ceil_div(c, 64) for c in channels) * _ceil_div(f_out, 64)
    want = max(1, _DW_BLOCKS_PER_SM * sms // tiles)
    per_image = max(1, min(want // n, _ceil_div(hw, 128)))
    chunk = _ceil_div(_ceil_div(hw, per_image), _DW_STEP) * _DW_STEP
    splits = min(n * _ceil_div(hw, chunk), want, 65535)
    return chunk, splits


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _check_prelu_weight(prelu_weight: torch.Tensor, device) -> None:
    if prelu_weight.dtype not in _DTYPE_CODES:
        raise TypeError(f"prelu_weight must be float32 or bfloat16, not "
                        f"{prelu_weight.dtype}")
    if prelu_weight.numel() != 1:
        raise ValueError(f"prelu_weight must hold one value (one alpha for "
                         f"all channels), got {tuple(prelu_weight.shape)}")
    if prelu_weight.device != device:
        raise ValueError("prelu_weight must be on the inputs' device")


def _check_inputs(xs) -> tuple[int, int, int, int]:
    """Validate the inputs the CUDA kernels take; returns (N, sum C, H, W)."""
    x0 = xs[0]
    if len(xs) > _MAX_INPUTS:
        raise ValueError(f"concat_conv1x1 takes at most {_MAX_INPUTS} "
                         f"inputs, got {len(xs)}")
    if x0.dtype not in _DTYPE_CODES:
        raise TypeError(f"concat_conv1x1 supports float32 and bfloat16, "
                        f"not {x0.dtype}")
    if x0.dim() != 4:
        raise ValueError(f"concat_conv1x1 inputs are NCHW, got {x0.shape}")
    n, _, h, w = x0.shape
    for x in xs:
        if x.device != x0.device or x.dtype != x0.dtype:
            raise ValueError("concat_conv1x1 inputs must share device and "
                             "dtype")
        if x.dim() != 4 or (x.shape[0], x.shape[2], x.shape[3]) != (n, h, w):
            raise ValueError(f"concat_conv1x1 inputs disagree on (N, H, W): "
                             f"{[tuple(t.shape) for t in xs]}")
        if not x.is_contiguous():
            raise ValueError("concat_conv1x1 inputs must be contiguous NCHW")
    if n * h * w == 0:
        raise ValueError("concat_conv1x1 got an empty input")
    if n > 65535:
        raise ValueError(f"concat_conv1x1 takes at most 65535 images, got {n}")
    return n, sum(x.shape[1] for x in xs), h, w


def _check(xs, weight, bias) -> tuple[int, int, int, int]:
    """Validate what the forward kernel takes; returns (N, sum C, H, W)."""
    n, k_total, h, w = _check_inputs(xs)
    x0 = xs[0]
    if weight.dim() != 2 or weight.shape[1] != k_total:
        raise ValueError(f"weight must be (F, {k_total}), got "
                         f"{tuple(weight.shape)}")
    if tuple(bias.shape) != (weight.shape[0],):
        raise ValueError(f"bias must be ({weight.shape[0]},), got "
                         f"{tuple(bias.shape)}")
    if weight.device != x0.device or bias.device != x0.device:
        raise ValueError("weight and bias must be on the inputs' device")
    return n, k_total, h, w
