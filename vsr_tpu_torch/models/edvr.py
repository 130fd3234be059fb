"""EDVR: enhanced deformable video restoration, MISR x4 (port of
``vsr_tpu/models/edvr.py``), NCHW.

Optional pre-deblur pyramid, a 3-level feature pyramid, PCD alignment
(cascaded modulated deformable convs whose offsets are predicted from the
concatenated features, L3 -> L2 -> L1, then a cascading DCN), TSA fusion
(temporal dot-product attention and a spatial attention pyramid),
reconstruction resblocks, two x2 pixel shuffles and a bilinear global
residual. The deformable convs are ``ops/deform_conv.deform_conv2d``; their
offset / mask convs start at zero, as in the reference.

The offset conv of a DCN pack keeps the JAX pack's stored channel order,
``(dy | dx | mask) x deformable group x tap``, so ``load_jax_params`` copies
its weights plainly: the first ``2 * dg * k*k`` output channels reshape into
the ``(N, 2, dg, k*k, Ho, Wo)`` offsets and the rest into the mask. (The JAX
pack permutes its kernel at apply time into an interleaved order its TPU
sampler wants; the stored order is what a checkpoint holds.)

Submodules keep flax's creation order (``interop.py`` relies on it). With
``fused_tail`` the HR conv and the last conv fold through the second pixel
shuffle (``ops/fused_tail.py``), as in the JAX net; same parameters.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from vsr_tpu_torch.models.common import (Conv, FoldableConv, PlainConv2d,
                                         compute_dtype, resolve_dtype,
                                         torch_default_init_)
from vsr_tpu_torch.models.toflow import crop, pad_to_multiple
from vsr_tpu_torch.ops.deform_conv import deform_conv2d
from vsr_tpu_torch.ops.upsample import upsample_bilinear
from vsr_tpu_torch.registry import register


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


class ResidualBlockNoBN(nn.Module):
    """conv-relu-conv + identity; kaiming-normal (fan_in, relu) weights
    scaled by 0.1, zero bias."""

    def __init__(self, nf: int = 64, *, dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.convs = nn.ModuleList(PlainConv2d(nf, nf, 3, padding=1,
                                               dtype=dtype)
                                   for _ in range(2))
        std = math.sqrt(2.0 / (9 * nf)) * 0.1
        with torch.no_grad():
            for conv in self.convs:
                conv.weight.normal_(0.0, std, generator=generator)
                conv.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.convs[1](F.relu(self.convs[0](x)))


class DeformConvPack(nn.Module):
    """DCNv1 (``modulated=False``) or DCNv2 with its offsets (and mask)
    predicted by a zero-initialized conv of ``extra`` (of ``x`` when no
    ``extra`` is given). The DCN weight is U(+-1/sqrt(fan_in)), its bias 0.
    ``dtype``: the offset conv's compute dtype (the policy of
    ``models/common.py``); the DCN computes in ``x``'s dtype, its weight,
    bias, offsets and mask cast to it, as in the JAX pack. The offset conv
    is a plain ``nn.Conv2d`` (a subclass of ``nn.Conv`` in JAX: W8A8 leaves
    it alone)."""

    modulated = False

    def __init__(self, in_channels: int, out_channels: int,
                 deformable_groups: int = 1, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, dilation: int = 1,
                 extra_channels: int | None = None, *,
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        k2 = kernel_size * kernel_size
        self.dg, self.k2 = deformable_groups, k2
        self.stride, self.padding, self.dilation = stride, padding, dilation
        chunks = 3 if self.modulated else 2
        self.offset_conv = nn.Conv2d(
            extra_channels or in_channels, chunks * deformable_groups * k2,
            kernel_size, stride, padding)
        nn.init.zeros_(self.offset_conv.weight)
        nn.init.zeros_(self.offset_conv.bias)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        torch_default_init_(self.weight, None, k2 * in_channels, generator)

    def forward(self, x: torch.Tensor,
                extra: torch.Tensor | None = None) -> torch.Tensor:
        src = x if extra is None else extra
        conv = self.offset_conv
        dt = compute_dtype(self.dtype, src, conv.weight)
        raw = conv._conv_forward(src.to(dt), conv.weight.to(dt),
                                 conv.bias.to(dt))
        n, _, ho, wo = raw.shape
        m = 2 * self.dg * self.k2
        offsets = raw[:, :m].reshape(n, 2, self.dg, self.k2, ho, wo)
        mask = None
        if self.modulated:
            mask = torch.sigmoid(raw[:, m:]).reshape(n, self.dg, self.k2,
                                                     ho, wo)
        xd = x.dtype
        return deform_conv2d(x, offsets.to(xd), self.weight.to(xd),
                             self.bias.to(xd),
                             None if mask is None else mask.to(xd),
                             self.stride, self.padding, self.dilation)


class ModulatedDeformConvPack(DeformConvPack):
    """DCNv2: offsets and a sigmoid mask (EDVR's deformable groups: 8)."""

    modulated = True

    def __init__(self, in_channels: int, out_channels: int,
                 deformable_groups: int = 8, **kwargs):
        super().__init__(in_channels, out_channels, deformable_groups,
                         **kwargs)


class PCDAlign(nn.Module):
    """Pyramid, cascading and deformable alignment of one neighbour's
    features (``forward(nbr_levels, ref_levels)``, 3 levels each)."""

    # Input channel multiples of nf of the 12 convs, in flax creation order.
    _CONV_IN = (2, 1, 2, 2, 1, 2, 2, 2, 1, 2, 2, 1)

    def __init__(self, nf: int = 64, groups: int = 8, *,
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = dict(dtype=dtype, generator=generator)
        self.convs = nn.ModuleList(Conv(m * nf, nf, 3, padding=1, **g)
                                   for m in self._CONV_IN)
        self.dcns = nn.ModuleList(ModulatedDeformConvPack(nf, nf, groups, **g)
                                  for _ in range(4))

    def forward(self, nbr_l: list, ref_l: list) -> torch.Tensor:
        c, d = self.convs, self.dcns

        def up(t):
            return upsample_bilinear(t, scale=2, align_corners=False)

        # L3
        l3_off = _lrelu(c[0](torch.cat([nbr_l[2], ref_l[2]], 1)))
        l3_off = _lrelu(c[1](l3_off))
        l3_fea = _lrelu(d[0](nbr_l[2], l3_off))
        # L2
        l2_off = _lrelu(c[2](torch.cat([nbr_l[1], ref_l[1]], 1)))
        l2_off = _lrelu(c[3](torch.cat([l2_off, up(l3_off) * 2], 1)))
        l2_off = _lrelu(c[4](l2_off))
        l2_fea = d[1](nbr_l[1], l2_off)
        l2_fea = _lrelu(c[5](torch.cat([l2_fea, up(l3_fea)], 1)))
        # L1
        l1_off = _lrelu(c[6](torch.cat([nbr_l[0], ref_l[0]], 1)))
        l1_off = _lrelu(c[7](torch.cat([l1_off, up(l2_off) * 2], 1)))
        l1_off = _lrelu(c[8](l1_off))
        l1_fea = d[2](nbr_l[0], l1_off)
        l1_fea = c[9](torch.cat([l1_fea, up(l2_fea)], 1))
        # Cascading
        off = _lrelu(c[10](torch.cat([l1_fea, ref_l[0]], 1)))
        off = _lrelu(c[11](off))
        return _lrelu(d[3](l1_fea, off))


def _pools(x: torch.Tensor) -> torch.Tensor:
    """torch MaxPool2d / AvgPool2d(3, stride=2, padding=1) (the average
    counts the padded zeros), concatenated."""
    return torch.cat([F.max_pool2d(x, 3, 2, 1), F.avg_pool2d(x, 3, 2, 1)], 1)


class TSAFusion(nn.Module):
    """Temporal and spatial attention fusion of the aligned ``(N, T, nf, H,
    W)`` features."""

    # (input channel multiple of nf, kernel) of the 13 convs, flax order;
    # 2 and 3 take the T frames' features, hence m = 0 (resolved below).
    _CONVS = ((1, 3), (1, 3), (0, 1), (0, 1), (2, 1), (1, 1), (2, 3), (1, 3),
              (1, 3), (1, 1), (1, 3), (1, 1), (1, 1))

    def __init__(self, nf: int = 64, nframes: int = 5, center: int = 2, *,
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.center = center
        self.convs = nn.ModuleList(
            Conv((m or nframes) * nf, nf, k, padding=k // 2, dtype=dtype,
                 generator=generator)
            for m, k in self._CONVS)

    def forward(self, aligned: torch.Tensor) -> torch.Tensor:
        n, t, nf, h, w = aligned.shape
        c = self.convs
        emb_ref = c[0](aligned[:, self.center])
        emb = c[1](aligned.reshape(n * t, nf, h, w)).reshape(n, t, nf, h, w)
        cor_prob = torch.sigmoid((emb * emb_ref[:, None]).sum(2))[:, :, None]
        weighted = (aligned * cor_prob).reshape(n, t * nf, h, w)
        fea = _lrelu(c[2](weighted))
        att = _lrelu(c[3](weighted))
        att = _lrelu(c[4](_pools(att)))
        att_l = _lrelu(c[5](att))
        att_l = _lrelu(c[6](_pools(att_l)))
        att_l = _lrelu(c[7](att_l))
        att_l = upsample_bilinear(att_l, scale=2, align_corners=False)
        att = _lrelu(c[8](att)) + att_l
        att = _lrelu(c[9](att))
        att = c[10](upsample_bilinear(att, scale=2, align_corners=False))
        # flax builds the outer 1 x 1 conv (11) before the inner one (12).
        att_add = c[11](_lrelu(c[12](att)))
        return fea * torch.sigmoid(att) * 2 + att_add


class PredeblurPyramid(nn.Module):
    """Pre-deblur resblock pyramid."""

    def __init__(self, in_channels: int, nf: int = 128, hr_in: bool = False,
                 *, dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = dict(dtype=dtype, generator=generator)
        self.hr_in = hr_in
        strides = (1, 2, 2, 2, 2) if hr_in else (1, 2, 2)
        self.convs = nn.ModuleList(
            Conv(in_channels if i == 0 else nf, nf, 3, s, 1, **g)
            for i, s in enumerate(strides))
        self.blocks = nn.ModuleList(ResidualBlockNoBN(nf, **g)
                                    for _ in range(8))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        convs, b = iter(self.convs), self.blocks
        l1 = _lrelu(next(convs)(x))
        for _ in range(len(self.convs) - 3):  # hr_in: two stride-2 convs
            l1 = _lrelu(next(convs)(l1))
        l2 = _lrelu(next(convs)(l1))
        l3 = _lrelu(next(convs)(l2))

        def up(t):
            return upsample_bilinear(t, scale=2, align_corners=False)

        # flax builds an outer resblock before the ones nested in its
        # argument: l1 = b3(b4(l1)), out = b5(b6(b7(l1))).
        l3 = up(b[0](l3))
        l2 = up(b[2](b[1](l2) + l3))
        l1 = b[3](b[4](l1)) + l2
        return b[5](b[6](b[7](l1)))


@register("net")
class EDVRNet(nn.Module):
    """MISR x4: a window ``(N, T, C, h, w)`` -> ``(N, C, 4h, 4w)`` (with
    ``HR_in``: ``(N, C, h, w)``). ``dtype``, ``device``, ``generator``: as
    ``DRFNet``."""

    serving_mode = "window"

    def __init__(self, in_channels: int, out_channels: int, nf: int = 64,
                 nframes: int = 5, groups: int = 8, front_RBs: int = 5,
                 back_RBs: int = 10, center: int | None = None,
                 predeblur: bool = False, HR_in: bool = False,
                 w_TSA: bool = True, fused_tail: bool = False,
                 dtype: torch.dtype | str | None = None, *,
                 device: torch.device | str | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        g = dict(dtype=self.dtype, generator=generator)
        self.nframes = nframes
        self.center = nframes // 2 if center is None else center
        self.hr_in, self.w_tsa, self.fused_tail = HR_in, w_TSA, fused_tail
        self.predeblur = (PredeblurPyramid(in_channels, nf, HR_in, **g)
                          if predeblur else None)
        # Top-level convs in flax creation order: the first-level head, the
        # L2 / L3 pyramid, [the TSA-less fusion], the two up-convs.
        if predeblur:
            head = [Conv(nf, nf, 1, padding=0, **g)]
        else:
            head = [Conv(in_channels, nf, 3, padding=1, **g)]
            if HR_in:
                head += [Conv(nf, nf, 3, 2, 1, **g) for _ in range(2)]
        pyramid = [Conv(nf, nf, 3, s, 1, **g) for s in (2, 1, 2, 1)]
        fusion = [] if w_TSA else [Conv(nframes * nf, nf, 1, padding=0, **g)]
        ups = [Conv(nf, nf * 4, 3, padding=1, **g),
               Conv(nf, 64 * 4, 3, padding=1, **g)]
        self.num_head = len(head)
        self.convs = nn.ModuleList([*head, *pyramid, *fusion, *ups])
        self.front = nn.ModuleList(ResidualBlockNoBN(nf, **g)
                                   for _ in range(front_RBs))
        self.pcd = PCDAlign(nf, groups, **g)
        self.tsa = TSAFusion(nf, nframes, self.center, **g) if w_TSA else None
        self.back = nn.ModuleList(ResidualBlockNoBN(nf, **g)
                                  for _ in range(back_RBs))
        self.hr_conv = FoldableConv(64, 64, 3, factor=2, **g)
        self.last_conv = FoldableConv(64, out_channels, 3, factor=2, **g)
        self.to(device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, t, c, h, w = x.shape
        if t != self.nframes:
            raise ValueError(f"EDVRNet was built for windows of "
                             f"{self.nframes} frames, got {t}")
        x, pads = pad_to_multiple(x, 4)
        h, w = x.shape[-2:]
        x_center = x[:, self.center]
        convs = iter(self.convs)
        flat = x.reshape(n * t, c, h, w)
        if self.predeblur is not None:
            l1 = next(convs)(self.predeblur(flat))
        else:
            l1 = _lrelu(next(convs)(flat))
            for _ in range(self.num_head - 1):  # HR_in: two stride-2 convs
                l1 = _lrelu(next(convs)(l1))
        for block in self.front:
            l1 = block(l1)
        l2 = l1
        for _ in range(2):  # stride 2, then 1
            l2 = _lrelu(next(convs)(l2))
        l3 = l2
        for _ in range(2):
            l3 = _lrelu(next(convs)(l3))
        levels = [lv.reshape(n, t, *lv.shape[1:]) for lv in (l1, l2, l3)]
        ref = [lv[:, self.center] for lv in levels]
        aligned = torch.stack(
            [self.pcd([lv[:, i] for lv in levels], ref) for i in range(t)], 1)
        if self.tsa is not None:
            out = self.tsa(aligned)
        else:
            out = next(convs)(aligned.reshape(n, -1, *aligned.shape[-2:]))
        for block in self.back:
            out = block(out)
        out = _lrelu(F.pixel_shuffle(next(convs)(out), 2))
        up2 = next(convs)(out)
        if self.fused_tail:
            y = _lrelu(self.hr_conv(_lrelu(up2), folded=True))
            out = F.pixel_shuffle(self.last_conv(y, folded=True), 2)
        else:
            out = self.last_conv(_lrelu(self.hr_conv(
                _lrelu(F.pixel_shuffle(up2, 2)))))
        base = x_center if self.hr_in else upsample_bilinear(
            x_center, scale=4, align_corners=False)
        # The JAX net crops 4 pixels a padded pixel, with HR_in too.
        return crop(out + base, pads, 4)
