"""FRVSR: frame-recurrent video super-resolution (port of
``vsr_tpu/models/frvsr.py``), NCHW.

A per-frame recurrence whose state is the previous LR frame and the previous
SR estimate: an encoder-decoder flow net (FNet, tanh output in normalized
flow units) between the previous and the current LR frame, the flow
upscaled bilinearly (``align_corners=True``), the *gradient-stopped*
previous SR frame warped by it in normalized [-1, 1] coordinates with border
padding, repacked by space-to-depth, and an SRNet of resblocks and a deconv
tail. Returns ``(sr, warped_lr)`` for the two-term FRVSR loss, or SR only
with ``is_prediction``. Convs are Xavier-uniform with zero bias, like the
reference; the SRNet tail follows the upscale factor (one x2 deconv, one x3,
or two x2) as in the JAX net.

``remat`` runs each frame step under ``torch.utils.checkpoint`` while a
gradient is recorded (its activations are recomputed in the backward). The
JAX net's ``unroll`` (its scan's unroll, a TPU knob) raises when set. A bf16
``dtype`` computes every conv in bf16 on float32 parameters (the policy of
``models/common.py``); ``carry_f32`` keeps the final SR conv's float32
accumulation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vsr_tpu_torch.models.common import (PlainConv2d, PlainConvTranspose2d,
                                         remat_step, resolve_dtype)
from vsr_tpu_torch.models.toflow import crop, pad_to_multiple
from vsr_tpu_torch.ops.upsample import upsample_bilinear
from vsr_tpu_torch.ops.warp import grid_sample_bilinear, linspace
from vsr_tpu_torch.registry import register


def _xavier_(module: nn.Module,
             generator: torch.Generator | None) -> nn.Module:
    with torch.no_grad():
        nn.init.xavier_uniform_(module.weight, generator=generator)
        module.bias.zero_()
    return module


def _conv(in_channels: int, out_channels: int,
          generator: torch.Generator | None,
          dtype: torch.dtype | None = None,
          out_dtype: torch.dtype | None = None) -> nn.Conv2d:
    return _xavier_(PlainConv2d(in_channels, out_channels, 3, padding=1,
                                dtype=dtype, out_dtype=out_dtype), generator)


def _deconv(features: int, stride: int, generator: torch.Generator | None,
            dtype: torch.dtype | None = None) -> nn.ConvTranspose2d:
    """x2: ConvTranspose2d(k=3, s=2, p=1, output_padding=1); x3: (k=3, s=3,
    p=0)."""
    padding, extra = (1, 1) if stride == 2 else (0, 0)
    return _xavier_(PlainConvTranspose2d(features, features, 3, stride,
                                         padding, output_padding=extra,
                                         dtype=dtype), generator)


def stn_warp(img: torch.Tensor, flow_uv: torch.Tensor,
             padding_mode: str = "border") -> torch.Tensor:
    """The reference STN: a normalized [-1, 1] mesh plus the flow, sampled
    bilinearly with ``align_corners=True``. ``img`` ``(N, C, H, W)``,
    ``flow_uv`` ``(N, 2, H, W)``, channel 0 = u (x), 1 = v (y)."""
    h, w = img.shape[-2:]
    xs = linspace(-1.0, 1.0, w, device=img.device).reshape(1, 1, w)
    ys = linspace(-1.0, 1.0, h, device=img.device).reshape(1, h, 1)
    px = (xs + flow_uv[:, 0] + 1.0) * (w - 1) / 2.0
    py = (ys + flow_uv[:, 1] + 1.0) * (h - 1) / 2.0
    return grid_sample_bilinear(img, py, px, padding_mode=padding_mode)


class _ResBlock(nn.Module):
    def __init__(self, features: int, *, dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.convs = nn.ModuleList(_conv(features, features, generator, dtype)
                                   for _ in range(2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.convs[1](F.relu(self.convs[0](x)))


class SRNet(nn.Module):
    """``forward(warped_s2d, lr_img)`` -> the SR frame. ``out_f32``: the
    final conv accumulates in float32 and emits float32 (``carry_f32``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 upscale_factor: int, num_resblocks: int = 10, *,
                 dtype: torch.dtype | None = None, out_f32: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        strides = {2: (2,), 3: (3,), 4: (2, 2)}.get(upscale_factor)
        if strides is None:
            raise NotImplementedError(f"upscale_factor={upscale_factor}")
        r2 = upscale_factor ** 2
        self.convs = nn.ModuleList([
            _conv(in_channels * r2 + in_channels, 64, generator, dtype),
            _conv(64, out_channels, generator, dtype,
                  torch.float32 if out_f32 else None)])
        self.blocks = nn.ModuleList(_ResBlock(64, dtype=dtype,
                                              generator=generator)
                                    for _ in range(num_resblocks))
        self.deconvs = nn.ModuleList(_deconv(64, s, generator, dtype)
                                     for s in strides)

    def forward(self, warped_s2d: torch.Tensor,
                lr_img: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.convs[0](torch.cat([warped_s2d, lr_img], dim=1)))
        for block in self.blocks:
            x = block(x)
        for deconv in self.deconvs:
            x = F.relu(deconv(x))
        return self.convs[1](x)


class FNet(nn.Module):
    """Encoder-decoder flow net; the pair is padded to a multiple of 8 with
    the batch minimum; tanh output in normalized flow units."""

    def __init__(self, in_channels: int, out_channels: int = 2, *,
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        widths = [2 * in_channels]
        for f in (32, 64, 128, 256, 128, 64):
            widths += [f, f]
        widths += [32, out_channels]
        self.convs = nn.ModuleList(_conv(a, b, generator, dtype)
                                   for a, b in zip(widths[:-1], widths[1:]))

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        x, pads = pad_to_multiple(torch.cat([a, b], dim=1), 8)
        convs = iter(self.convs)
        for stage in range(6):
            x = F.leaky_relu(next(convs)(x), 0.2)
            x = F.leaky_relu(next(convs)(x), 0.2)
            if stage < 3:
                x = F.max_pool2d(x, 2)
            else:
                x = upsample_bilinear(x, scale=2, align_corners=False)
        x = F.leaky_relu(next(convs)(x), 0.2)
        return crop(torch.tanh(next(convs)(x)), pads)


class _FRVSRStep(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 upscale_factor: int, num_resblocks: int, *,
                 dtype: torch.dtype | None = None, carry_f32: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.upscale_factor = upscale_factor
        self.fnet = FNet(in_channels, 2, dtype=dtype, generator=generator)
        self.srnet = SRNet(in_channels, out_channels, upscale_factor,
                           num_resblocks, dtype=dtype, out_f32=carry_f32,
                           generator=generator)

    def forward(self, lr_last: torch.Tensor, sr_last: torch.Tensor,
                lr_img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """-> (the SR frame, the previous LR frame warped onto this one)."""
        f = self.upscale_factor
        lr_flow = self.fnet(lr_last, lr_img)
        sr_flow = upsample_bilinear(lr_flow, scale=f, align_corners=True)
        warped_sr = stn_warp(sr_last.detach(), sr_flow, padding_mode="border")
        sr_img = self.srnet(F.pixel_unshuffle(warped_sr, f), lr_img)
        warped_lr = stn_warp(lr_last, lr_flow, padding_mode="border")
        return sr_img, warped_lr


@register("net")
class FRVSRNet(nn.Module):
    """VSR: ``(N, T, C, h, w)`` -> ``(sr (N, T, C, H, W), warped_lr (N, T,
    C, h, w))``, or ``sr`` alone with ``is_prediction``. ``dtype``,
    ``device``, ``generator``: as ``DRFNet``; the frames and the SR carry
    stay in the input's dtype (each step's SR frame is cast to it before it
    is warped again). ``carry_f32`` (under a bf16 ``dtype``; a no-op
    without one): the final SR conv accumulates in float32 and emits
    float32, as ``vsr_tpu/models/frvsr.py``'s."""

    serving_mode = "video"

    def __init__(self, in_channels: int, out_channels: int,
                 upscale_factor: int, is_prediction: bool = False,
                 num_resblocks: int = 10, remat: bool = False,
                 dtype: torch.dtype | str | None = None, unroll: int = 1,
                 carry_f32: bool = False, *,
                 device: torch.device | str | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if unroll != 1:
            raise NotImplementedError(
                "FRVSRNet unroll is a TPU lax.scan knob; the port's frame "
                "loop is a Python loop and has no such setting")
        self.remat = remat
        self.dtype = dt = resolve_dtype(dtype)
        self.carry_f32 = carry_f32 and dt != torch.float32
        self.upscale_factor = upscale_factor
        self.is_prediction = is_prediction
        self.step = _FRVSRStep(in_channels, out_channels, upscale_factor,
                               num_resblocks, dtype=dt,
                               carry_f32=self.carry_f32, generator=generator)
        self.to(device=device)

    def forward(self, x: torch.Tensor):
        n, t, c, h, w = x.shape
        f = self.upscale_factor
        lr_last = x[:, 0]
        sr_last = x.new_zeros(n, c, h * f, w * f)
        srs, warped = [], []
        for i in range(t):
            sr, warped_lr = remat_step(self.remat, self.step, lr_last,
                                       sr_last, x[:, i])
            lr_last, sr_last = x[:, i], sr.to(x.dtype)
            srs.append(sr)
            warped.append(warped_lr)
        sr = torch.stack(srs, dim=1)
        if self.is_prediction:
            return sr
        return sr, torch.stack(warped, dim=1)
