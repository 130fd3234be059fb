"""RBPN: recurrent back-projection network for MISR (port of
``vsr_tpu/models/rbpn.py``), NCHW.

Per neighbour, one recurrent back-projection step: the SISR path (a DBPN
up/down projection ladder) on the running feature state, the MISR path
(resblocks + deconv) on the [centre, neighbour] pair's features, the error
feedback ``h = h0 + res2(h0 - h1)``, and ``res3(h)`` fed back as the next
state; every ``h`` concats into a reconstruction conv. PReLUs start at 0.25
(torch's default). A ``_ResnetBlock`` applies ONE PReLU module at both of
its activation sites, as the reference does, so the two sites share one
alpha. Submodules keep flax's creation order (``interop.py`` relies on it).

``subpixel_deconv`` runs every transposed conv (the DBPN projections' and
the MISR path's) as a sub-pixel phase conv (``ops/subpixel.py``): the same
parameters and map.
"""

from __future__ import annotations

import torch
from torch import nn

from vsr_tpu_torch.data.datasets import misr_target_index
from vsr_tpu_torch.models.common import Conv, ConvTranspose, resolve_dtype
from vsr_tpu_torch.models.feedback import (PROJECTION_PARAMS, PReLU,
                                           check_upscale_factor)
from vsr_tpu_torch.registry import register


class _ConvP(nn.Module):
    """Conv + PReLU (no PReLU with ``act=False``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 stride: int = 1, pad: int = 1, act: bool = True, *,
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv = Conv(in_channels, out_channels, kernel, stride, pad,
                         dtype=dtype, generator=generator)
        self.act = PReLU(0.25) if act else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        return self.act(y) if self.act is not None else y


class _DeconvP(nn.Module):
    """Transposed conv (torch geometry) + PReLU."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int, pad: int, *, subpixel: bool = False,
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv = ConvTranspose(in_channels, out_channels, kernel, stride,
                                  pad, dtype=dtype, subpixel=subpixel,
                                  generator=generator)
        self.act = PReLU(0.25)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.conv(x))


class _ResnetBlock(nn.Module):
    """conv-act-conv + skip, then the same act again."""

    def __init__(self, features: int, *, dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.act = PReLU(0.25)
        self.convs = nn.ModuleList(
            Conv(features, features, 3, padding=1, dtype=dtype,
                 generator=generator)
            for _ in range(2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.act(self.convs[0](x))
        return self.act(self.convs[1](y) + x)


class _UpBlock(nn.Module):
    def __init__(self, features: int, k: int, s: int, p: int, *,
                 subpixel: bool = False, dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = dict(dtype=dtype, generator=generator)
        self.deconvs = nn.ModuleList(
            _DeconvP(features, features, k, s, p, subpixel=subpixel, **g)
            for _ in range(2))
        self.conv = _ConvP(features, features, k, s, p, **g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h0 = self.deconvs[0](x)
        return self.deconvs[1](self.conv(h0) - x) + h0


class _DownBlock(nn.Module):
    def __init__(self, features: int, k: int, s: int, p: int, *,
                 subpixel: bool = False, dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = dict(dtype=dtype, generator=generator)
        self.convs = nn.ModuleList(
            _ConvP(features, features, k, s, p, **g) for _ in range(2))
        self.deconv = _DeconvP(features, features, k, s, p, subpixel=subpixel,
                               **g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        l0 = self.convs[0](x)
        return self.convs[1](self.deconv(l0) - x) + l0


class DBPNet(nn.Module):
    """The 3-stage DBPN ladder: ``base_filter`` LR channels in, ``feat`` HR
    channels out. ``num_stages`` is carried as in the JAX net (which builds
    three stages whatever it says)."""

    def __init__(self, base_filter: int, feat: int, num_stages: int,
                 upscale_factor: int, *, subpixel_deconv: bool = False,
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        k, s, p = PROJECTION_PARAMS[upscale_factor]
        g = dict(dtype=dtype, generator=generator)
        sp = dict(subpixel=subpixel_deconv, **g)
        self.head = _ConvP(base_filter, feat, 1, 1, 0, **g)
        self.ups = nn.ModuleList(_UpBlock(feat, k, s, p, **sp)
                                 for _ in range(3))
        self.downs = nn.ModuleList(_DownBlock(feat, k, s, p, **sp)
                                   for _ in range(2))
        self.tail = _ConvP(3 * feat, feat, 1, 1, 0, act=False, **g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h1 = self.ups[0](self.head(x))
        h2 = self.ups[1](self.downs[0](h1))
        h3 = self.ups[2](self.downs[1](h2))
        return self.tail(torch.cat([h3, h2, h1], dim=1))


class _ResChain(nn.Sequential):
    def __init__(self, features: int, num_resblocks: int, *,
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__(*(_ResnetBlock(features, dtype=dtype,
                                        generator=generator)
                           for _ in range(num_resblocks)))


@register("net")
class RBPNet(nn.Module):
    """MISR: a window ``(N, T, C, h, w)`` -> the SR centre frame ``(N, C,
    H, W)``. ``dtype``, ``device``, ``generator``: as ``DRFNet``."""

    serving_mode = "window"

    def __init__(self, in_channels: int, out_channels: int, base_filter: int,
                 feat: int, num_stages: int, num_resblocks: int,
                 num_frames: int, upscale_factor: int,
                 dtype: torch.dtype | str | None = None,
                 subpixel_deconv: bool = False, *,
                 device: torch.device | str | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        check_upscale_factor(upscale_factor)
        k, s, p = PROJECTION_PARAMS[upscale_factor]
        self.dtype = resolve_dtype(dtype)
        self.num_frames = num_frames
        g = dict(dtype=self.dtype, generator=generator)
        bf = base_filter
        # In flax creation order: _ConvP_0, _ConvP_1, DBPNet_0, _ResChain_0,
        # _DeconvP_0, _ResChain_1, _ConvP_2, _ResChain_2, _ConvP_3, _ConvP_4.
        self.feat0 = _ConvP(in_channels, bf, 3, 1, 1, **g)
        self.feat1 = _ConvP(2 * in_channels, bf, 3, 1, 1, **g)
        self.dbpn = DBPNet(bf, feat, num_stages, upscale_factor,
                           subpixel_deconv=subpixel_deconv, **g)
        self.res1_chain = _ResChain(bf, num_resblocks, **g)
        self.res1_up = _DeconvP(bf, feat, k, s, p, subpixel=subpixel_deconv,
                                **g)
        self.res2_chain = _ResChain(feat, num_resblocks, **g)
        self.res2_conv = _ConvP(feat, feat, 3, 1, 1, **g)
        self.res3_chain = _ResChain(feat, num_resblocks, **g)
        self.res3_down = _ConvP(feat, bf, k, s, p, **g)
        self.output = _ConvP((num_frames - 1) * feat, out_channels, 3, 1, 1,
                             act=False, **g)
        self.to(device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = x.shape[1]
        if t != self.num_frames:
            raise ValueError(f"RBPNet was built for windows of "
                             f"{self.num_frames} frames, got {t}")
        c_idx = misr_target_index(t)
        center = x[:, c_idx]
        state = self.feat0(center)
        neighbours = [i for i in range(t) if i != c_idx]
        hidden = []
        for i in neighbours:
            pair = self.feat1(torch.cat([center, x[:, i]], dim=1))
            h0 = self.dbpn(state)
            h1 = self.res1_up(self.res1_chain(pair))
            h = h0 + self.res2_conv(self.res2_chain(h0 - h1))
            hidden.append(h)
            if i != neighbours[-1]:  # the last state feeds nothing
                state = self.res3_down(self.res3_chain(h))
        return self.output(torch.cat(hidden, dim=1))
