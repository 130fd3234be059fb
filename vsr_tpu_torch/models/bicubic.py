"""Bicubic upsampling baseline net (port of ``vsr_tpu/models/bicubic.py``):
``nn.Upsample(scale_factor, mode='bicubic', align_corners=True)``, a
parameter-free baseline that never loads a checkpoint. It holds one empty
buffer, not saved, on the device it is built for (``device``), so that its
callers find where it serves (``infer.net_device``)."""

from __future__ import annotations

import torch
from torch import nn

from vsr_tpu_torch.ops.upsample import upsample_bicubic
from vsr_tpu_torch.registry import register


@register("net")
class Bicubic(nn.Module):
    serving_mode = "frame"

    def __init__(self, upscale_factor: int, *,
                 device: torch.device | str | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.upscale_factor = upscale_factor
        self.register_buffer("anchor", torch.empty(0, device=device),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample_bicubic(x, scale=self.upscale_factor,
                                align_corners=True)
