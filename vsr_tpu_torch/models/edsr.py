"""EDSR — Enhanced Deep Residual Networks for SISR (port of
``vsr_tpu/models/edsr.py``), NCHW: head conv -> ``num_resblocks`` residual
blocks with ``res_scale`` + global skip -> sub-pixel upsampling tail.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from vsr_tpu_torch.models.common import Conv, ShuffleConv, resolve_dtype
from vsr_tpu_torch.registry import register


class _ResBlock(nn.Module):
    def __init__(self, num_features: int, res_scale: float, *,
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.res_scale = res_scale
        self.convs = nn.ModuleList(
            Conv(num_features, num_features, 3, padding=1, dtype=dtype,
                 generator=generator)
            for _ in range(2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = self.convs[1](F.relu(self.convs[0](x)))
        return x + res * self.res_scale


class _UpBlock(nn.Module):
    """Sub-pixel upsampling ladder. Returns the PRE-shuffle array of the
    last stage (factor ``split(upscale_factor)``); the caller's ShuffleConv
    tail performs that final shuffle (optionally folded into its conv)."""

    def __init__(self, num_features: int, upscale_factor: int, *,
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        f = upscale_factor
        if f not in (2, 3, 4, 8):
            raise NotImplementedError(f"upscale_factor={f}")
        stages = 1 if f == 3 else int(math.log2(f))
        self.convs = nn.ModuleList(
            Conv(num_features, self.split(f) ** 2 * num_features, 3,
                 padding=1, dtype=dtype, generator=generator)
            for _ in range(stages))

    @staticmethod
    def split(upscale_factor: int) -> int:
        """Factor of the LAST shuffle stage."""
        return 3 if upscale_factor == 3 else 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self.convs[:-1]:
            x = F.pixel_shuffle(conv(x), 2)
        return self.convs[-1](x)  # pre-shuffle of the last stage


@register("net")
class EDSRNet(nn.Module):
    """Single-image SR: ``(N, C, h, w) -> (N, C_out, H, W)``.
    ``fused_tail=True`` folds the final conv through the last pixel shuffle
    (same parameters, same result). ``dtype`` (the compute dtype; the
    parameters stay float32), ``device``, ``generator``: as ``DRFNet``."""

    serving_mode = "frame"

    def __init__(self, in_channels: int, out_channels: int, num_resblocks: int,
                 num_features: int, upscale_factor: int, res_scale: float = 0.1,
                 fused_tail: bool = False,
                 dtype: torch.dtype | str | None = None, *,
                 device: torch.device | str | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dt = resolve_dtype(dtype)
        f = num_features
        self.head = Conv(in_channels, f, 3, padding=1, dtype=dt,
                         generator=generator)
        self.blocks = nn.ModuleList(
            _ResBlock(f, res_scale, dtype=dt, generator=generator)
            for _ in range(num_resblocks))
        self.body_end = Conv(f, f, 3, padding=1, dtype=dt, generator=generator)
        self.up = _UpBlock(f, upscale_factor, dtype=dt, generator=generator)
        self.tail = ShuffleConv(f, out_channels, 3,
                                factor=_UpBlock.split(upscale_factor),
                                fused=fused_tail, dtype=dt,
                                generator=generator)
        self.to(device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        head = self.head(x)
        body = head
        for block in self.blocks:
            body = block(body)
        body = self.body_end(body) + head
        return self.tail(self.up(body))
