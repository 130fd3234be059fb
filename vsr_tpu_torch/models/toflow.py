"""TOFlow: task-oriented flow for MISR (port of ``vsr_tpu/models/toflow.py``),
NCHW.

Every frame of the window is bicubic-upsampled to HR first
(``align_corners=False``) and padded to a multiple of 16 with the batch
minimum; a 4-level SpyNet (7 x 7 conv + BatchNorm blocks, coarse to fine,
the flow doubled at each bilinear upsample) estimates the flow from each
neighbour to the reference frame; the neighbours are backward-warped
(zeros padding) and the stacked frames go through a 9 x 9 / 1 x 1 fusion
head with a reference-frame residual.

BatchNorm is the port's ``models.common.BatchNorm`` (flax's statistics and
running update); the JAX net's ``train`` flag is the module's own mode. One
SpyNet serves every neighbour, so its running statistics are updated once
per neighbour, in frame order, as in flax. Submodule lists keep flax's
creation order (``interop.py`` relies on it).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vsr_tpu_torch.data.datasets import misr_target_index
from vsr_tpu_torch.models.common import BatchNorm, Conv, resolve_dtype
from vsr_tpu_torch.ops.upsample import upsample_bicubic, upsample_bilinear
from vsr_tpu_torch.ops.warp import flow_warp
from vsr_tpu_torch.registry import register

_SPY_WIDTHS = (32, 64, 32, 16)


def pad_to_multiple(x: torch.Tensor, multiple: int) -> tuple[torch.Tensor,
                                                             tuple]:
    """Pad the last two axes of ``x`` up to a multiple of ``multiple``,
    centred (the odd pixel at the end), with the minimum of the whole
    tensor, as the JAX nets' ``jnp.pad(..., constant_values=x.min())``:
    the fill carries the minimum's gradient. Returns (padded, (top, bottom,
    left, right))."""
    h, w = x.shape[-2:]
    dh, dw = (-h) % multiple, (-w) % multiple
    pads = (dh // 2, dh - dh // 2, dw // 2, dw - dw // 2)
    if not (dh or dw):
        return x, pads
    out = x.min().expand(*x.shape[:-2], h + dh, w + dw).clone()
    out[..., pads[0]:pads[0] + h, pads[2]:pads[2] + w] = x
    return out, pads


def crop(x: torch.Tensor, pads: tuple, scale: int = 1) -> torch.Tensor:
    """Undo :func:`pad_to_multiple` on an output ``scale`` times larger."""
    top, bottom, left, right = (p * scale for p in pads)
    h, w = x.shape[-2:]
    return x[..., top:h - bottom, left:w - right]


class _SpyNetBlock(nn.Module):
    """Four 7 x 7 conv + BatchNorm + ReLU layers, then a 7 x 7 conv to the
    2 flow channels."""

    def __init__(self, in_channels: int, *,
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        widths = (in_channels, *_SPY_WIDTHS, 2)
        self.convs = nn.ModuleList(
            Conv(a, b, 7, padding=3, dtype=dtype, generator=generator)
            for a, b in zip(widths[:-1], widths[1:]))
        self.norms = nn.ModuleList(BatchNorm(w) for w in _SPY_WIDTHS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv, norm in zip(self.convs, self.norms):
            x = F.relu(norm(conv(x)))
        return self.convs[-1](x)


class SpyNet(nn.Module):
    """4-level pyramid flow estimator: ``forward(ref, nbr)`` on ``(N, C, H,
    W)`` frames, H and W multiples of 16, -> ``(N, 2, H, W)`` pixel
    displacement, channel 0 = x, 1 = y."""

    def __init__(self, in_channels: int = 1, *,
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.blocks = nn.ModuleList(
            _SpyNetBlock(2 * in_channels + 2, dtype=dtype,
                         generator=generator)
            for _ in range(4))

    def forward(self, ref: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
        n, _, h, w = ref.shape
        refs, nbrs = [ref], [nbr]
        for _ in range(3):
            refs.insert(0, F.avg_pool2d(refs[0], 2))
            nbrs.insert(0, F.avg_pool2d(nbrs[0], 2))
        flow = ref.new_zeros(n, 2, h // 16, w // 16)
        for block, r, nb in zip(self.blocks, refs, nbrs):
            flow_up = 2.0 * upsample_bilinear(flow, scale=2,
                                              align_corners=True)
            warped = flow_warp(nb, flow_up, padding_mode="zeros")
            flow = flow_up + block(torch.cat([r, warped, flow_up], dim=1))
        return flow


@register("net")
class TOFlowNet(nn.Module):
    """MISR: a window ``(N, T, C, h, w)`` -> the SR reference frame ``(N, C,
    H, W)``. ``dtype``, ``device``, ``generator``: as ``DRFNet``."""

    serving_mode = "window"

    def __init__(self, in_channels: int, out_channels: int, num_frames: int,
                 upscale_factor: int,
                 dtype: torch.dtype | str | None = None, *,
                 device: torch.device | str | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dt = resolve_dtype(dtype)
        self.num_frames = num_frames
        self.upscale_factor = upscale_factor
        self.spynet = SpyNet(in_channels, dtype=dt, generator=generator)
        # The fusion head: 9 x 9, 9 x 9, 1 x 1, 1 x 1.
        g = dict(dtype=dt, generator=generator)
        self.convs = nn.ModuleList([
            Conv(num_frames * in_channels, 64, 9, padding=4, **g),
            Conv(64, 64, 9, padding=4, **g),
            Conv(64, 64, 1, padding=0, **g),
            Conv(64, out_channels, 1, padding=0, **g)])
        self.to(device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, t, c, h, w = x.shape
        if t != self.num_frames:
            raise ValueError(f"TOFlowNet was built for windows of "
                             f"{self.num_frames} frames, got {t}")
        ref_idx = misr_target_index(t)
        y = upsample_bicubic(x.reshape(n * t, c, h, w),
                             scale=self.upscale_factor, align_corners=False)
        y, pads = pad_to_multiple(y, 16)
        frames = y.reshape(n, t, c, *y.shape[-2:])
        ref = frames[:, ref_idx]
        warped = [ref if i == ref_idx else
                  flow_warp(frames[:, i], self.spynet(ref, frames[:, i]),
                            padding_mode="zeros")
                  for i in range(t)]
        z = torch.cat(warped, dim=1)  # (N, T*C, H, W)
        for conv in self.convs[:3]:
            z = F.relu(conv(z))
        return crop(self.convs[3](z) + ref, pads)
