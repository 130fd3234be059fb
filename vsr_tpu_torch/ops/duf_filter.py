"""Fused DUF dynamic-filter application (the port of the Pallas kernel K2).

``duf_dynamic_filter(x, logits, size, upscale)`` fuses the softmax over the
filter taps, the per-pixel k x k contraction with the LR neighbourhood and
the pixel shuffle. On a CUDA tensor it launches the hand-written kernel of
``csrc/duf_filter.cu`` (which replaces ``vsr_tpu/ops/pallas_duf.py``'s
``duf_dynamic_filter_pallas``); on a CPU tensor it runs the plain twin
``duf_dynamic_filter_reference`` (softmax, then
``ops/dynamic_filter.apply_dynamic_filters``). There is no fallback from the
kernel to the twin: a CUDA call that the kernel cannot take raises.

Layout: the JAX op takes logits ``(N, H, W, k^2, r^2)``. The port's filter
branch ends in a conv whose output is channel-first, so the logits come as
``(N, k^2 * r^2, H, W)`` with channel ``= tap * r^2 + s`` (``tap = ky*k +
kx``, ``s = dy*r + dx``): W is the contiguous axis, the kernel's loads
coalesce along it, and no transpose is paid. One channel only (``x`` is
``(N, H, W)``, the cardiac data); the general-C path is
``ops/dynamic_filter.py``.

Inputs are cast to float32 and the result is float32, as in the JAX
wrapper. Serving only: a CUDA call that would need gradients is refused.

Where no gradient is recorded the call goes through the custom op
``torch.ops.vsr_tpu_torch.duf_dynamic_filter`` (CPU: the twin, CUDA: the
kernel, fake: the output's shape), so ``torch.export`` records the op and a
loaded program launches the kernel and counts it on the wrapper.
"""

from __future__ import annotations

import torch

from vsr_tpu_torch.ops.dynamic_filter import apply_dynamic_filters

MAX_SIZE = 15  # kMaxSize of csrc/duf_filter.cu


def _check(x: torch.Tensor, logits: torch.Tensor, size: int,
           upscale: int) -> tuple[int, int, int]:
    if x.dim() != 3:
        raise ValueError(
            f"duf_dynamic_filter takes one channel, x (N, H, W); got "
            f"{tuple(x.shape)} (for C != 1 use "
            "ops.dynamic_filter.apply_dynamic_filters)")
    if size < 1 or size % 2 == 0 or size > MAX_SIZE:
        raise ValueError(f"size must be odd and at most {MAX_SIZE}, got {size}")
    if upscale < 1:
        raise ValueError(f"upscale must be >= 1, got {upscale}")
    n, h, w = x.shape
    want = (n, size * size * upscale * upscale, h, w)
    if tuple(logits.shape) != want:
        raise ValueError(f"logits must be channel-first {want}, got "
                         f"{tuple(logits.shape)}")
    if logits.device != x.device:
        raise ValueError("x and logits must be on one device")
    if n * h * w == 0:
        raise ValueError("duf_dynamic_filter got an empty input")
    return n, h, w


def duf_dynamic_filter_reference(x: torch.Tensor, logits: torch.Tensor,
                                 size: int, upscale: int) -> torch.Tensor:
    """Plain twin: softmax over the taps, then the unfold + einsum + pixel
    shuffle of ``apply_dynamic_filters``. Same arguments and result as
    :func:`duf_dynamic_filter`."""
    n, h, w = _check(x, logits, size, upscale)
    filters = logits.float().reshape(
        n, size * size, upscale * upscale, h, w).softmax(dim=1)
    return apply_dynamic_filters(x.float()[:, None], filters, upscale)[:, 0]


def duf_dynamic_filter(x: torch.Tensor, logits: torch.Tensor, size: int,
                       upscale: int) -> torch.Tensor:
    """x: ``(N, H, W)``; logits: ``(N, size^2 * upscale^2, H, W)``,
    *pre-softmax*, channel ``= tap * upscale^2 + s``. Returns float32
    ``(N, H*upscale, W*upscale)``: softmax + filtering + pixel shuffle.
    ``duf_dynamic_filter.launches`` counts the kernel's launches."""
    _check(x, logits, size, upscale)
    device = x.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"duf_dynamic_filter runs on cpu or cuda, not {device}")
    if torch.is_grad_enabled() and (x.requires_grad or logits.requires_grad):
        if device.type == "cpu":
            return duf_dynamic_filter_reference(x, logits, size, upscale)
        raise RuntimeError(
            "duf_dynamic_filter's CUDA kernel has no backward: call it under "
            "torch.no_grad() / torch.inference_mode() (serving only)")
    return torch.ops.vsr_tpu_torch.duf_dynamic_filter(x, logits, size, upscale)


duf_dynamic_filter.launches = 0


@torch.library.custom_op("vsr_tpu_torch::duf_dynamic_filter", mutates_args=(),
                         device_types="cpu")
def _duf_dynamic_filter_op(x: torch.Tensor, logits: torch.Tensor, size: int,
                           upscale: int) -> torch.Tensor:
    """The op without autograd that serving reaches: the twin on CPU
    tensors, the kernel on CUDA tensors."""
    return duf_dynamic_filter_reference(x, logits, size, upscale)


@_duf_dynamic_filter_op.register_kernel("cuda")
def _duf_dynamic_filter_cuda(x, logits, size, upscale):
    n, h, w = _check(x, logits, size, upscale)
    if n > 65535:
        raise ValueError(f"duf_dynamic_filter takes at most 65535 images, "
                         f"got {n}")
    xf = x.float().contiguous()
    lf = logits.float().contiguous()

    from vsr_tpu_torch import _build

    lib = _build.load()
    out = torch.empty((n, h * upscale, w * upscale), dtype=torch.float32,
                      device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.vsr_duf_filter(xf.data_ptr(), lf.data_ptr(), out.data_ptr(),
                                n, h, w, size, upscale, stream)
    if rc != 0:
        raise RuntimeError(f"duf_dynamic_filter kernel launch failed: "
                           f"cudaError_t {rc}")
    duf_dynamic_filter.launches += 1
    return out


@_duf_dynamic_filter_op.register_fake
def _duf_dynamic_filter_fake(x, logits, size, upscale):
    n, h, w = x.shape
    return x.new_empty((n, h * upscale, w * upscale), dtype=torch.float32)
