"""W8A8 convolution: int8 activations times int8 weights into int32, then a
float dequantization (the body of ``vsr_tpu/quantize.py:_w8a8_conv``).

``w8a8_conv(x, weight, bias, act_scale, stride, padding, groups,
out_dtype)`` takes the float activations and the module's dense float
weights and computes, as the JAX function does:

- the activation scale ``xs``: ``act_scale`` (static, a calibrated scale
  rounded to float32) or ``max(max|x|, 1e-8) / 127`` (dynamic, per call);
- ``xq = clip(round(float32(x) / xs), -127, 127)``: IEEE division, round
  half to even;
- per output channel ``ws = where(amax > 0, amax / 127, 1)`` of the dense
  weights, ``wq = clip(round(w / ws), -127, 127)``, quantized at each call
  (no cache: nothing derived from a weight outlives the call);
- the convolution ``acc = conv(xq, wq)`` in int32;
- ``out = float32(acc) * (ws * xs)``, ``+ bias``, cast to ``out_dtype``.

On a CUDA tensor the activation quantization, the product and the epilogue
are one launch of the hand-written kernel of ``csrc/w8a8_conv.cu`` (an
implicit GEMM on the int8 tensor cores); the wrapper computes the weight
quantization and a dynamic scale with PyTorch on the card and hands the
kernel the scale as a device pointer (no host sync). On a CPU tensor it runs
the plain twin ``w8a8_conv_reference``: the same arithmetic with the integer
product taken as a float64 convolution, which is exact (the sums stay below
2^53). There is no fallback: a CUDA call that the kernel cannot take raises.

This stands for no Pallas kernel: the JAX package leaves the ``s8 x s8 ->
s32`` convolution to XLA (``vsr_tpu/quantize.py:241-322``), and PyTorch on
CUDA reaches no int8 convolution. Geometry: 2D (NCHW) and 3D (NCDHW)
inputs, any kernel size, stride and explicit zero padding, grouped convs;
no dilation. Serving only: a CUDA call that would need gradients is
refused.

Calls go through the custom op ``torch.ops.vsr_tpu_torch.w8a8_conv`` (CPU:
the twin, CUDA: the kernel, fake: the output's shape), so ``torch.export``
records it and a loaded program launches the kernel and counts it on the
wrapper.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

# csrc/w8a8_conv.cu: the K tile of the kernel (the weights' rows are padded
# to a multiple of it) and its output kinds.
K_TILE = 32
_OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_X_KINDS = {torch.float32: 0, torch.bfloat16: 1}


def _geometry(x: torch.Tensor, weight: torch.Tensor, stride: Sequence[int],
              padding: Sequence[int], groups: int) -> tuple[int, ...]:
    """Checks the arguments; returns the output's shape."""
    rank = weight.dim() - 2
    if rank not in (2, 3) or x.dim() != rank + 2:
        raise ValueError(f"w8a8_conv takes a 2D conv of NCHW or a 3D conv of "
                         f"NCDHW input; got x {tuple(x.shape)}, weight "
                         f"{tuple(weight.shape)}")
    if len(stride) != rank or len(padding) != rank:
        raise ValueError(f"stride {tuple(stride)} and padding "
                         f"{tuple(padding)} must have {rank} entries")
    if min(stride) < 1 or min(padding) < 0 or groups < 1:
        raise ValueError(f"bad geometry: stride {tuple(stride)}, padding "
                         f"{tuple(padding)}, groups {groups}")
    f, cg = weight.shape[:2]
    if x.shape[1] != cg * groups or f % groups:
        raise ValueError(f"x has {x.shape[1]} channels; weight "
                         f"{tuple(weight.shape)} with {groups} groups wants "
                         f"{cg * groups} and F a multiple of {groups}")
    out = _out_shape(x, weight, stride, padding)
    if min(out[2:]) < 1:
        raise ValueError(f"empty output {out} for x {tuple(x.shape)}")
    return out


def _out_shape(x, weight, stride, padding) -> tuple[int, ...]:
    out = [(size + 2 * p - k) // s + 1 for size, p, k, s in
           zip(x.shape[2:], padding, weight.shape[2:], stride)]
    return (x.shape[0], weight.shape[0], *out)


def dynamic_scale(x: torch.Tensor) -> torch.Tensor:
    """``max(max|x|, 1e-8) / 127`` as a float32 0-dim tensor on ``x``'s
    device (the maximum is exact in any float type)."""
    return torch.clamp_min(x.abs().amax().float(), 1e-8) / 127.0


def activation_scale(x: torch.Tensor,
                     act_scale: float | None) -> torch.Tensor:
    """The float32 activation scale of a call, a 0-dim tensor on ``x``'s
    device: static (``act_scale`` rounded to float32) or dynamic."""
    if act_scale is None:
        return dynamic_scale(x)
    return torch.tensor(act_scale, dtype=torch.float32, device=x.device)


def quantize_weight(weight: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per output channel (axis 0): ``(wq int8, ws float32 (F,))``."""
    kf = weight.detach().float()
    amax = kf.abs().amax(dim=tuple(range(1, kf.dim())))
    ws = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    wq = torch.clamp(torch.round(kf / ws.reshape(-1, *[1] * (kf.dim() - 1))),
                     -127, 127).to(torch.int8)
    return wq, ws


def quantize_activations(x: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """``clip(round(float32(x) / xs), -127, 127)``, as float32 values."""
    return torch.clamp(torch.round(x.float() / xs), -127, 127)


def _dequantize(acc: torch.Tensor, ws: torch.Tensor, xs: torch.Tensor,
                bias: torch.Tensor | None,
                out_dtype: torch.dtype) -> torch.Tensor:
    shape = (1, -1, *[1] * (acc.dim() - 2))
    out = acc.float() * (ws * xs).reshape(shape)
    if bias is not None:
        out = out + bias.float().reshape(shape)
    return out.to(out_dtype)


def w8a8_conv_reference(x: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor | None, act_scale: float | None,
                        stride: Sequence[int], padding: Sequence[int],
                        groups: int = 1,
                        out_dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
    """Plain twin: same arguments and result as :func:`w8a8_conv`
    (``out_dtype=torch.int32``: the int32 accumulators)."""
    _geometry(x, weight, stride, padding, groups)
    xs = activation_scale(x, act_scale)
    wq, ws = quantize_weight(weight)
    conv = F.conv2d if weight.dim() == 4 else F.conv3d
    acc = conv(quantize_activations(x, xs).double(), wq.double(), None,
               tuple(stride), tuple(padding), 1, groups)
    if out_dtype == torch.int32:
        return acc.to(torch.int32)
    return _dequantize(acc, ws, xs, bias, out_dtype)


def w8a8_conv(x: torch.Tensor, weight: torch.Tensor,
              bias: torch.Tensor | None, act_scale: float | None,
              stride: Sequence[int], padding: Sequence[int], groups: int = 1,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x: ``(N, C, H, W)`` or ``(N, C, D, H, W)``, float32 or bfloat16;
    weight: the dense ``(F, C / groups, *kernel)`` float weights; bias
    ``(F,)`` or ``None``; ``act_scale``: a static activation scale or
    ``None`` (dynamic). Returns ``(N, F, *out)`` in ``out_dtype`` (float32,
    bfloat16, or int32 for the accumulators). ``w8a8_conv.launches`` counts
    the kernel's launches."""
    _geometry(x, weight, stride, padding, groups)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"w8a8_conv runs on cpu or cuda, not {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        if x.device.type == "cpu":
            return w8a8_conv_reference(x, weight, bias, act_scale, stride,
                                       padding, groups, out_dtype)
        raise RuntimeError(
            "w8a8_conv's CUDA kernel has no backward: call it under "
            "torch.no_grad() / torch.inference_mode() (serving only)")
    return torch.ops.vsr_tpu_torch.w8a8_conv(
        x, weight, bias, act_scale, [int(s) for s in stride],
        [int(p) for p in padding], int(groups), out_dtype)


w8a8_conv.launches = 0


@torch.library.custom_op("vsr_tpu_torch::w8a8_conv", mutates_args=(),
                         device_types="cpu")
def _w8a8_conv_op(x: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor | None, act_scale: float | None,
                  stride: list[int], padding: list[int], groups: int,
                  out_dtype: torch.dtype) -> torch.Tensor:
    """The op without autograd that serving reaches: the twin on CPU
    tensors, the kernel on CUDA tensors."""
    return w8a8_conv_reference(x, weight, bias, act_scale, stride, padding,
                               groups, out_dtype)


@_w8a8_conv_op.register_kernel("cuda")
def _w8a8_conv_cuda(x, weight, bias, act_scale, stride, padding, groups,
                    out_dtype):
    out_shape = _geometry(x, weight, stride, padding, groups)
    if out_dtype not in _OUT_KINDS:
        raise ValueError(f"w8a8_conv writes float32, bfloat16 or int32, not "
                         f"{out_dtype}")
    if x.dtype not in _X_KINDS:
        x = x.float()
    x = x.contiguous()
    rank = weight.dim() - 2
    n, c = x.shape[:2]
    f = weight.shape[0]
    spatial = [1] * (3 - rank) + list(x.shape[2:])
    kernel = [1] * (3 - rank) + list(weight.shape[2:])
    strides = [1] * (3 - rank) + list(stride)
    pads = [0] * (3 - rank) + list(padding)
    outs = [1] * (3 - rank) + list(out_shape[2:])
    fg = f // groups
    if -(-fg // 64) > 65535 or groups > 65535:
        raise ValueError(f"w8a8_conv takes at most 65535 tiles of 64 output "
                         f"channels and 65535 groups; got F={f}, "
                         f"groups={groups}")
    # The weights quantized here, their rows (C/g * kernel) padded with
    # zeros to the kernel's K tile.
    wq, ws = quantize_weight(weight)
    k = wq[0].numel()
    k_pad = -(-k // K_TILE) * K_TILE
    wq_rows = torch.zeros((f, k_pad), dtype=torch.int8, device=x.device)
    wq_rows[:, :k] = wq.reshape(f, k)
    xs = activation_scale(x, act_scale).reshape(1)
    b = None if bias is None else bias.detach().float().contiguous()
    out = torch.empty(out_shape, dtype=out_dtype, device=x.device)

    import ctypes

    from vsr_tpu_torch import _build

    lib = _build.load()
    dims = (ctypes.c_int * 20)(n, c, *spatial, f, groups, *kernel, *strides,
                               *pads, *outs, k_pad)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.vsr_w8a8_conv(
            x.data_ptr(), _X_KINDS[x.dtype], wq_rows.data_ptr(),
            ws.data_ptr(), None if b is None else b.data_ptr(),
            xs.data_ptr(), out.data_ptr(), _OUT_KINDS[out_dtype], dims,
            stream)
    if rc != 0:
        raise RuntimeError(f"w8a8_conv kernel launch failed: cudaError_t {rc}")
    w8a8_conv.launches += 1
    return out


@_w8a8_conv_op.register_fake
def _w8a8_conv_fake(x, weight, bias, act_scale, stride, padding, groups,
                    out_dtype):
    return x.new_empty(_out_shape(x, weight, stride, padding),
                       dtype=out_dtype)

