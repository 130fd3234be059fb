"""Volumetric (3D) super-resolution net (port of ``vsr_tpu/models/vol3d.py``),
NCDHW: an EDSR-style residual trunk of 3x3x3 convs over ``(N, C, D, h, w)``
volumes with an in-plane-only pixel-shuffle tail (cardiac stacks are
anisotropic, so only H and W are upscaled).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from vsr_tpu_torch.models.common import (Conv3D, pixel_shuffle_2d_in_3d,
                                         resolve_dtype)
from vsr_tpu_torch.registry import register




def upsample_stages(upscale_factor: int, fused_tail: bool) -> tuple[int, int]:
    """(shuffle stages, factor of the last stage) of a volumetric tail."""
    f = upscale_factor
    if math.log2(f).is_integer():
        stages, r_last = int(math.log2(f)), 2
    elif f == 3:
        stages, r_last = 1, 3
    else:
        raise NotImplementedError(f"upscale_factor={f}")
    if fused_tail and stages == 0:
        # f=1: there is no shuffle to fold through.
        raise NotImplementedError(
            "fused_tail needs an upsampling tail (upscale_factor>=2)")
    return stages, r_last


class _ResBlock3D(nn.Module):
    """``x + res_scale * conv(relu(conv(x)))`` in the compute ``dtype``.
    ``acc_f32``: the second conv accumulates in float32 and emits float32
    (``Conv3D.out_dtype``), so the ``x + 0.1 y`` add runs in float32."""

    def __init__(self, num_features: int, res_scale: float,
                 acc_f32: bool = False, *, dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.res_scale = res_scale
        self.convs = nn.ModuleList([
            Conv3D(num_features, num_features, dtype=dtype,
                   generator=generator),
            Conv3D(num_features, num_features, dtype=dtype,
                   out_dtype=torch.float32 if acc_f32 else None,
                   generator=generator)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.convs[1](F.relu(self.convs[0](x))) * self.res_scale


class VolumeTail(nn.Module):
    """The upsample tail: ``stages`` convs to ``r^2 F`` channels, each but
    (with ``fused_tail``) the last followed by the in-plane shuffle, then
    the final conv, folded through the last shuffle under ``fused_tail``
    (one parameter set either way)."""

    def __init__(self, num_features: int, out_channels: int,
                 upscale_factor: int, fused_tail: bool = False, *,
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        f = num_features
        self.stages, self.r_last = upsample_stages(upscale_factor, fused_tail)
        self.fused_tail = fused_tail
        self.ups = nn.ModuleList(
            Conv3D(f, self.r_last ** 2 * f, dtype=dtype, generator=generator)
            for _ in range(self.stages))
        self.last = Conv3D(f, out_channels,
                           fold_shuffle2d=self.r_last if fused_tail else 0,
                           dtype=dtype, generator=generator)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        for i, conv in enumerate(self.ups):
            y = conv(y)
            if i < self.stages - 1 or not self.fused_tail:
                y = pixel_shuffle_2d_in_3d(y, self.r_last)
        if not self.fused_tail:
            return self.last(y)
        return pixel_shuffle_2d_in_3d(self.last(y), self.r_last)


@register("net")
class Volume3DSRNet(nn.Module):
    """``(N, C, D, h, w) -> (N, C_out, D, h r, w r)``. ``fused_tail``
    computes the final conv folded through the last shuffle (same
    parameters, same result to float reassociation). ``dtype`` (the compute
    dtype; the parameters stay float32), ``device``, ``generator``: as
    ``DRFNet``."""

    serving_mode = "volume"

    def __init__(self, in_channels: int, out_channels: int,
                 num_resblocks: int = 8, num_features: int = 32,
                 upscale_factor: int = 2, res_scale: float = 0.1,
                 dtype: torch.dtype | str | None = None,
                 fused_tail: bool = False, *,
                 device: torch.device | str | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dt = resolve_dtype(dtype)
        f = num_features
        self.head = Conv3D(in_channels, f, dtype=dt, generator=generator)
        self.blocks = nn.ModuleList(
            _ResBlock3D(f, res_scale, dtype=dt, generator=generator)
            for _ in range(num_resblocks))
        self.body_end = Conv3D(f, f, dtype=dt, generator=generator)
        self.tail = VolumeTail(f, out_channels, upscale_factor, fused_tail,
                               dtype=dt, generator=generator)
        self.to(device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        head = self.head(x)
        body = head
        for block in self.blocks:
            body = block(body)
        return self.tail(self.body_end(body) + head)
