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


def refuse_non_f32(net: str, dtype) -> None:
    """The volumetric nets compute in float32 only: the JAX package's bf16
    compute (with its f32 carries) is the mixed-precision work still to
    port."""
    if resolve_dtype(dtype) != torch.float32:
        raise NotImplementedError(
            f"{net} dtype={dtype} is not yet ported to vsr_tpu_torch (bf16 "
            "compute of the volumetric nets is mixed-precision work)")


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
    """``x + res_scale * conv(relu(conv(x)))``. The JAX block's ``acc_f32``
    (an f32 accumulator under bf16 compute) is refused."""

    def __init__(self, num_features: int, res_scale: float,
                 acc_f32: bool = False, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        if acc_f32:
            raise NotImplementedError(
                "_ResBlock3D acc_f32 is not yet ported to vsr_tpu_torch")
        self.res_scale = res_scale
        self.convs = nn.ModuleList(
            Conv3D(num_features, num_features, generator=generator)
            for _ in range(2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.convs[1](F.relu(self.convs[0](x))) * self.res_scale


class VolumeTail(nn.Module):
    """The upsample tail: ``stages`` convs to ``r^2 F`` channels, each but
    (with ``fused_tail``) the last followed by the in-plane shuffle, then
    the final conv, folded through the last shuffle under ``fused_tail``
    (one parameter set either way)."""

    def __init__(self, num_features: int, out_channels: int,
                 upscale_factor: int, fused_tail: bool = False, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        f = num_features
        self.stages, self.r_last = upsample_stages(upscale_factor, fused_tail)
        self.fused_tail = fused_tail
        self.ups = nn.ModuleList(
            Conv3D(f, self.r_last ** 2 * f, generator=generator)
            for _ in range(self.stages))
        self.last = Conv3D(f, out_channels,
                           fold_shuffle2d=self.r_last if fused_tail else 0,
                           generator=generator)

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
    parameters, same result to float reassociation). ``device``,
    ``generator``: as ``DRFNet``; ``dtype`` other than float32 is refused."""

    serving_mode = "volume"

    def __init__(self, in_channels: int, out_channels: int,
                 num_resblocks: int = 8, num_features: int = 32,
                 upscale_factor: int = 2, res_scale: float = 0.1,
                 dtype: torch.dtype | str | None = None,
                 fused_tail: bool = False, *,
                 device: torch.device | str | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        refuse_non_f32("Volume3DSRNet", dtype)
        f = num_features
        self.head = Conv3D(in_channels, f, generator=generator)
        self.blocks = nn.ModuleList(
            _ResBlock3D(f, res_scale, generator=generator)
            for _ in range(num_resblocks))
        self.body_end = Conv3D(f, f, generator=generator)
        self.tail = VolumeTail(f, out_channels, upscale_factor, fused_tail,
                               generator=generator)
        self.to(device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        head = self.head(x)
        body = head
        for block in self.blocks:
            body = block(body)
        return self.tail(self.body_end(body) + head)
