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

Serving only: the backward (per-input slices of W, as the JAX ``_bwd``)
comes with the training slice, so a CUDA call that would need gradients
is refused.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

_MAX_INPUTS = 8  # kMaxInputs of csrc/fused_squeeze.cu
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
    loads. ``concat_conv1x1.launches`` counts the kernel's launches."""
    xs = list(xs)
    if not xs:
        raise ValueError("concat_conv1x1 needs at least one input")
    device = xs[0].device
    if device.type == "cpu":
        return concat_conv1x1_reference(xs, weight, bias, prelu_weight)
    if device.type != "cuda":
        raise ValueError(f"concat_conv1x1 runs on cpu or cuda, not {device}")
    dtype = xs[0].dtype
    n, _, h, w = _check(xs, weight, bias)
    if prelu_weight is not None:
        _check_prelu_weight(prelu_weight, device)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (*xs, weight, bias, prelu_weight)):
        raise RuntimeError(
            "concat_conv1x1's CUDA kernel has no backward yet: call it under "
            "torch.no_grad() / torch.inference_mode() (serving only)")
    f_out = weight.shape[0]
    wt = weight.to(dtype).contiguous()
    bt = bias.to(dtype).contiguous()
    # The PReLU weight travels as a device pointer: no host read of it.
    at = None if prelu_weight is None else prelu_weight.to(dtype).contiguous()

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
    concat_conv1x1.launches += 1
    return out


concat_conv1x1.launches = 0


def _check_prelu_weight(prelu_weight: torch.Tensor, device) -> None:
    if prelu_weight.dtype not in _DTYPE_CODES:
        raise TypeError(f"prelu_weight must be float32 or bfloat16, not "
                        f"{prelu_weight.dtype}")
    if prelu_weight.numel() != 1:
        raise ValueError(f"prelu_weight must hold one value (one alpha for "
                         f"all channels), got {tuple(prelu_weight.shape)}")
    if prelu_weight.device != device:
        raise ValueError("prelu_weight must be on the inputs' device")


def _check(xs, weight, bias) -> tuple[int, int, int, int]:
    """Validate what the CUDA kernel takes; returns (N, sum C, H, W)."""
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
    k_total = sum(x.shape[1] for x in xs)
    if weight.dim() != 2 or weight.shape[1] != k_total:
        raise ValueError(f"weight must be (F, {k_total}), got "
                         f"{tuple(weight.shape)}")
    if tuple(bias.shape) != (weight.shape[0],):
        raise ValueError(f"bias must be ({weight.shape[0]},), got "
                         f"{tuple(bias.shape)}")
    if weight.device != x0.device or bias.device != x0.device:
        raise ValueError("weight and bias must be on the inputs' device")
    if n * h * w == 0:
        raise ValueError("concat_conv1x1 got an empty input")
    if n > 65535:
        raise ValueError(f"concat_conv1x1 takes at most 65535 images, got {n}")
    return n, k_total, h, w
