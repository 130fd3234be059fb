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
  (no cache: nothing derived from a weight outlives the call); or, with
  ``weight_scale``, the int8 weights and their scales as given (a
  transposed conv's sub-pixel bank, sliced from the weights it quantized
  whole, ``quantize._w8a8_deconv``);
- the convolution ``acc = conv(xq, wq)`` in int32;
- ``out = float32(acc) * (ws * xs)``, ``+ bias``, cast to ``out_dtype``.

On a CUDA tensor the activation quantization, the product and the epilogue
are one launch of a hand-written kernel of ``csrc/w8a8_conv.cu`` on the
int8 tensor cores; the wrapper computes the weight quantization, repacks
the weights tap-major (:func:`repack_weight`), computes a dynamic scale
with PyTorch on the card, hands the kernel the scale as a device pointer
(no host sync), and chooses the kernel and its tiles from the geometry
(:func:`kernel_plan`): the patch kernel (producer warps quantize each
activation once into a ring of shared-memory stages, consumer warps run
the reduction tap by tap and write the outputs) wherever its stages fit in
shared memory, which every conv of the zoo does, else the gather kernel
(the general path). Both count in ``w8a8_conv.launches``. On a CPU tensor it runs
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

import math
from typing import Sequence

import torch
import torch.nn.functional as F

# csrc/w8a8_conv.cu: the K step (32 channels of one tap: the repacked
# weights' channels are padded to a multiple of it) and the output kinds.
CHANNEL_STEP = 32
_OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_X_KINDS = {torch.float32: 0, torch.bfloat16: 1}
# The patch kernel's shared memory (one block an SM): its stages'
# mbarriers, the accumulators' staging area (64 channels x 132 int32) and
# the N tile's scales and biases (2 x 128 float32), a ring of 2-4 stages
# (an int8 patch of 32 bytes a pixel, and the chunk's weights where they
# are streamed), the resident weights. SMEM_LIMIT is the H100's opt-in
# maximum per block (the kernel checks it against the card's).
TILE_M = 128
FIXED_BYTES = 128 + 64 * 132 * 4 + 2 * 128 * 4
SMEM_LIMIT = 232448
# Output tiles (tz, ty, tx) of 128 pixels, tx first so that ties go to the
# longer rows along x.
TILES = tuple((tz, TILE_M // (tz * tx), tx) for tx in (32, 16, 8)
              for tz in (1, 2, 4, 8) if TILE_M // (tz * tx) >= 1)


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


def repack_weight(wq: torch.Tensor) -> torch.Tensor:
    """``(F, C / g, *kernel)`` -> ``(F, *kernel, cpad)``, contiguous: each
    output channel's weights tap-major, channels innermost, padded with
    zeros to ``cpad``, a multiple of :data:`CHANNEL_STEP` (the kernels' K
    order ``(kz, ky, kx, c)``)."""
    f, cg = wq.shape[:2]
    taps = wq[0, 0].numel()
    cpad = -(-cg // CHANNEL_STEP) * CHANNEL_STEP
    rows = torch.zeros((f, taps, cpad), dtype=wq.dtype, device=wq.device)
    rows[:, :, :cg] = wq.reshape(f, cg, taps).transpose(1, 2)
    return rows.reshape(f, *wq.shape[2:], cpad)


def kernel_plan(x_shape: Sequence[int], weight_shape: Sequence[int],
                stride: Sequence[int], padding: Sequence[int],
                groups: int) -> dict:
    """The kernel and tiles a CUDA call takes, from the geometry alone:

    - ``kernel``: ``"patch"`` where its shared memory fits and its (N
      tile, group) pairs fit a grid's 65535 rows, else ``"gather"`` (then
      nothing else is set);
    - ``bn``: the N tile, 32, 64 or 128 output channels of a group;
    - ``tile``: ``(tz, ty, tx)``, the output box of 128 pixels whose input
      patch costs the least: tiles x (5 x patch pixels + 2 x taps x bn),
      the fill of each patch pixel (a load and a quantization a channel)
      against the products of each output pixel, in SM cycles a chunk;
    - ``resident``: the N tile's weights stay in shared memory for all its
      tiles, else each stage brings its chunk's;
    - ``stages``: the ring's stages, 4, 3 or 2, as many as fit (resident
      weights first at 4 and 3 stages);
    - ``smem``: its bytes of dynamic shared memory."""
    rank = len(weight_shape) - 2
    kernel = [1] * (3 - rank) + list(weight_shape[2:])
    strides = [1] * (3 - rank) + list(stride)
    spatial = [1] * (3 - rank) + list(x_shape[2:])
    pads = [0] * (3 - rank) + list(padding)
    out = [(size + 2 * p - k) // st + 1 for size, p, k, st in
           zip(spatial, pads, kernel, strides)]
    fg = weight_shape[0] // groups
    cg = weight_shape[1]
    taps = kernel[0] * kernel[1] * kernel[2]
    nq = -(-cg // CHANNEL_STEP)
    bn = 32 if fg <= 32 else 64 if fg <= 64 else 128
    if -(-fg // bn) * groups > 65535:
        return {"kernel": "gather"}
    chunk_w = taps * bn * 32
    best = None
    for tile in TILES:
        patch = [(t - 1) * st + k for t, st, k in zip(tile, strides, kernel)]
        p = patch[0] * patch[1] * patch[2]
        plan = None
        for resident, stages in ((True, 4), (True, 3), (False, 4),
                                 (False, 3), (True, 2), (False, 2)):
            stage = -(-(p * 32 + (0 if resident else chunk_w)) // 128) * 128
            smem = (FIXED_BYTES + stages * stage
                    + (nq * chunk_w if resident else 0))
            if smem <= SMEM_LIMIT:
                plan = dict(resident=resident, stages=stages, smem=smem)
                break
        if plan is None:
            continue
        tiles = x_shape[0] * math.prod(-(-o // t) for o, t in zip(out, tile))
        cost = tiles * (5 * p + 2 * taps * bn)
        if best is None or cost < best[0]:
            best = (cost, dict(kernel="patch", bn=bn, tile=tile, **plan))
    return best[1] if best else {"kernel": "gather"}


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


def _weights(weight: torch.Tensor, weight_scale: torch.Tensor | None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(wq int8, ws float32 (F,))``: quantized here, or as given."""
    if weight_scale is None:
        return quantize_weight(weight)
    if weight.dtype != torch.int8 or weight_scale.shape != weight.shape[:1]:
        raise ValueError(f"weight_scale {tuple(weight_scale.shape)} goes "
                         f"with int8 weights of {weight.shape[0]} output "
                         f"channels; got {weight.dtype} {tuple(weight.shape)}")
    return weight, weight_scale.detach().float()


def w8a8_conv_reference(x: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor | None, act_scale: float | None,
                        stride: Sequence[int], padding: Sequence[int],
                        groups: int = 1,
                        out_dtype: torch.dtype = torch.float32,
                        weight_scale: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """Plain twin: same arguments and result as :func:`w8a8_conv`
    (``out_dtype=torch.int32``: the int32 accumulators)."""
    _geometry(x, weight, stride, padding, groups)
    xs = activation_scale(x, act_scale)
    wq, ws = _weights(weight, weight_scale)
    conv = F.conv2d if weight.dim() == 4 else F.conv3d
    acc = conv(quantize_activations(x, xs).double(), wq.double(), None,
               tuple(stride), tuple(padding), 1, groups)
    if out_dtype == torch.int32:
        return acc.to(torch.int32)
    return _dequantize(acc, ws, xs, bias, out_dtype)


def w8a8_conv(x: torch.Tensor, weight: torch.Tensor,
              bias: torch.Tensor | None, act_scale: float | None,
              stride: Sequence[int], padding: Sequence[int], groups: int = 1,
              out_dtype: torch.dtype = torch.float32,
              weight_scale: torch.Tensor | None = None) -> torch.Tensor:
    """x: ``(N, C, H, W)`` or ``(N, C, D, H, W)``, float32 or bfloat16;
    weight: the dense ``(F, C / groups, *kernel)`` float weights, or with
    ``weight_scale`` (float32 ``(F,)``) int8 weights already quantized by
    it; bias ``(F,)`` or ``None``; ``act_scale``: a static activation scale
    or ``None`` (dynamic). Returns ``(N, F, *out)`` in ``out_dtype``
    (float32, bfloat16, or int32 for the accumulators).
    ``w8a8_conv.launches`` counts the kernel's launches."""
    _geometry(x, weight, stride, padding, groups)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"w8a8_conv runs on cpu or cuda, not {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        if x.device.type == "cpu":
            return w8a8_conv_reference(x, weight, bias, act_scale, stride,
                                       padding, groups, out_dtype,
                                       weight_scale)
        raise RuntimeError(
            "w8a8_conv's CUDA kernel has no backward: call it under "
            "torch.no_grad() / torch.inference_mode() (serving only)")
    return torch.ops.vsr_tpu_torch.w8a8_conv(
        x, weight, bias, act_scale, [int(s) for s in stride],
        [int(p) for p in padding], int(groups), out_dtype, weight_scale)


w8a8_conv.launches = 0


@torch.library.custom_op("vsr_tpu_torch::w8a8_conv", mutates_args=(),
                         device_types="cpu")
def _w8a8_conv_op(x: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor | None, act_scale: float | None,
                  stride: list[int], padding: list[int], groups: int,
                  out_dtype: torch.dtype,
                  weight_scale: torch.Tensor | None) -> torch.Tensor:
    """The op without autograd that serving reaches: the twin on CPU
    tensors, the kernel on CUDA tensors."""
    return w8a8_conv_reference(x, weight, bias, act_scale, stride, padding,
                               groups, out_dtype, weight_scale)


@_w8a8_conv_op.register_kernel("cuda")
def _w8a8_conv_cuda(x, weight, bias, act_scale, stride, padding, groups,
                    out_dtype, weight_scale):
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
    plan = kernel_plan(x.shape, weight.shape, stride, padding, groups)
    # The weights quantized here (or as given) and repacked tap-major,
    # channels padded.
    wq, ws = _weights(weight, weight_scale)
    ws = ws.contiguous()
    packed = repack_weight(wq)
    xs = activation_scale(x, act_scale).reshape(1)
    b = None if bias is None else bias.detach().float().contiguous()
    out = torch.empty(out_shape, dtype=out_dtype, device=x.device)

    import ctypes

    from vsr_tpu_torch import _build

    lib = _build.load()
    dims = (ctypes.c_int * 20)(n, c, *spatial, f, groups, *kernel, *strides,
                               *pads, *outs, packed.shape[-1])
    if plan["kernel"] == "patch":
        plan_args = (ctypes.c_int * 7)(0, plan["bn"], *plan["tile"],
                                       int(plan["resident"]), plan["stages"])
    else:
        plan_args = (ctypes.c_int * 7)(1, 0, 0, 0, 0, 0, 0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.vsr_w8a8_conv(
            x.data_ptr(), _X_KINDS[x.dtype], packed.data_ptr(),
            ws.data_ptr(), None if b is None else b.data_ptr(),
            xs.data_ptr(), out.data_ptr(), _OUT_KINDS[out_dtype], dims,
            plan_args, stream)
    if rc != 0:
        raise RuntimeError(f"w8a8_conv kernel launch failed: cudaError_t {rc}")
    w8a8_conv.launches += 1
    return out


@_w8a8_conv_op.register_fake
def _w8a8_conv_fake(x, weight, bias, act_scale, stride, padding, groups,
                    out_dtype, weight_scale):
    return x.new_empty(_out_shape(x, weight, stride, padding),
                       dtype=out_dtype)

