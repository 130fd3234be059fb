"""DUF — video SR with dynamic upsampling filters (MISR; port of
``vsr_tpu/models/duf.py``).

Shared 2D head per frame -> dense 3D backbone (16/28/52-layer variants; the
temporal extent shrinks by 2 in each of the last three dense blocks through
unpadded t-convs, with the running concat trimmed to match) -> two 1x1x1
Conv3D branches: per-pixel upsampling filters (softmax over k^2) applied to
the raw centre frame, plus a pixel-shuffled residual.

Layout is NCDHW with T as depth (the JAX net is NDHWC). BatchNorm is the
port's ``models.common.BatchNorm``: flax's statistics and update, in train
mode as in eval mode.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vsr_tpu_torch.data.datasets import misr_target_index
from vsr_tpu_torch.models.common import (BatchNorm, Conv, Conv3D,
                                         resolve_dtype)
from vsr_tpu_torch.ops.duf_filter import duf_dynamic_filter
from vsr_tpu_torch.ops.dynamic_filter import apply_dynamic_filters
from vsr_tpu_torch.registry import register

# name -> (padded blocks, unpadded blocks, growth, channels into the tail)
_BACKBONES = {
    "_DenseLayer16": (3, 3, 32, 256),
    "_DenseLayer28": (9, 3, 16, 256),
    "_DenseLayer52": (21, 3, 16, 448),
}


def _batch_norm(channels: int) -> BatchNorm:
    # flax's momentum 0.9 is the complement of the port's 0.1.
    return BatchNorm(channels, eps=1e-5, momentum=0.1)


class _DenseBlock(nn.Module):
    """BN-ReLU-1x1x1 conv - BN-ReLU-3x3x3 conv; ``pad_t=0`` shrinks T by 2."""

    def __init__(self, in_channels: int, growth: int, pad_t: int, *,
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        f = in_channels
        self.norms = nn.ModuleList([_batch_norm(f), _batch_norm(f)])
        self.convs = nn.ModuleList([
            Conv3D(f, f, (1, 1, 1), padding=(0, 0, 0), dtype=dtype,
                   generator=generator),
            Conv3D(f, growth, (3, 3, 3), padding=(pad_t, 1, 1), dtype=dtype,
                   generator=generator)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.convs[0](F.relu(self.norms[0](x)))
        return self.convs[1](F.relu(self.norms[1](y)))


class _DenseBackbone(nn.Module):
    def __init__(self, backbone: str, in_channels: int = 64, *,
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        n1, n2, growth, tail_in = _BACKBONES[backbone]
        self.num_padded = n1
        channels = in_channels
        self.blocks = nn.ModuleList()
        for i in range(n1 + n2):
            self.blocks.append(_DenseBlock(channels, growth,
                                           pad_t=1 if i < n1 else 0,
                                           dtype=dtype, generator=generator))
            channels += growth
        if channels != tail_in:
            raise ValueError(f"{backbone}: {channels} channels reach the "
                             f"tail, expected {tail_in}")
        self.norm = _batch_norm(tail_in)
        self.conv = Conv3D(tail_in, 256, (1, 3, 3), padding=(0, 1, 1),
                           dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        concat = x
        for i, block in enumerate(self.blocks):
            y = block(concat)
            if i >= self.num_padded:
                # Trim the running concat's temporal extent to match the
                # shrunken block output.
                concat = concat[:, :, 1:-1]
            concat = torch.cat([concat, y], dim=1)
        return self.conv(F.relu(self.norm(concat)))


@register("net")
class DUFNet(nn.Module):
    """MISR: a window ``(N, T, C, h, w)`` of ``num_frames`` LR frames ->
    the SR target frame ``(N, C, H, W)``.

    ``use_pallas_filter`` keeps the JAX field's name so configs carry over:
    with it (and one input channel) the filters are applied by
    ``ops.duf_filter.duf_dynamic_filter``, the hand-written CUDA kernel on a
    CUDA tensor; without it by the plain softmax +
    ``apply_dynamic_filters``. ``dtype``, ``device``, ``generator``: as
    ``DRFNet``. The JAX net's ``train`` flag is the module's own mode here:
    ``train()`` normalizes with the batch statistics and updates the running
    ones, ``eval()`` serves with the running statistics (the pipeline sets
    it).

    The filter's route is picked once per call, in the open: when autograd
    records the call (grad mode on, and a parameter or the input requires a
    gradient) the plain softmax + ``apply_dynamic_filters`` runs, as the
    JAX package trains DUF through XLA; otherwise, with
    ``use_pallas_filter``, ``duf_dynamic_filter`` (on a CUDA tensor, K2).
    The TPU kernel has no backward, so none is owed, and the wrapper keeps
    refusing a CUDA call that needs one.
    """

    serving_mode = "window"

    def __init__(self, in_channels: int, out_channels: int, num_frames: int,
                 size_filter: int, upscale_factor: int,
                 backbone: str = "_DenseLayer16",
                 use_pallas_filter: bool = False,
                 dtype: torch.dtype | str | None = None, *,
                 device: torch.device | str | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if backbone not in _BACKBONES:
            raise ValueError(f"Unknown backbone {backbone}")
        self.dtype = dt = resolve_dtype(dtype)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.num_frames = num_frames
        self.size_filter = size_filter
        self.upscale_factor = upscale_factor
        self.use_pallas_filter = use_pallas_filter
        k2, r2 = size_filter ** 2, upscale_factor ** 2
        one = dict(kernel_size=(1, 1, 1), padding=(0, 0, 0), dtype=dt,
                   generator=generator)
        self.head = Conv(in_channels, 64, 3, padding=1, dtype=dt,
                         generator=generator)
        self.backbone = _DenseBackbone(backbone, dtype=dt,
                                       generator=generator)
        # In flax creation order: filter branch, then residual branch.
        self.filter_convs = nn.ModuleList([Conv3D(256, 512, **one),
                                           Conv3D(512, k2 * r2, **one)])
        self.residual_convs = nn.ModuleList([
            Conv3D(256, 256, **one), Conv3D(256, in_channels * r2, **one)])
        self.to(device=device)

    def _records_gradients(self, x: torch.Tensor) -> bool:
        return torch.is_grad_enabled() and (x.requires_grad or any(
            p.requires_grad for p in self.parameters()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, t, c, h, w = x.shape
        if t != self.num_frames:
            raise ValueError(f"DUFNet was built for windows of "
                             f"{self.num_frames} frames, got {t}")
        target = x[:, misr_target_index(t)]  # raw centre frame (N, C, h, w)

        feats = self.head(x.reshape(n * t, c, h, w))
        feats = feats.reshape(n, t, 64, h, w).transpose(1, 2)  # NCDHW
        feats = F.relu(self.backbone(feats))  # (N, 256, T - 6, h, w)

        f = self.filter_convs[1](F.relu(self.filter_convs[0](feats)))
        # (N, k2*r2, T', h, w) -> temporal slice 0; channel = tap * r2 + s.
        filter_logits = f[:, :, 0]
        res = self.residual_convs[1](F.relu(self.residual_convs[0](feats)))
        residual = F.pixel_shuffle(res[:, :, 0], self.upscale_factor)

        if self.use_pallas_filter and self.in_channels == 1 and not (
                self._records_gradients(x)):
            out = duf_dynamic_filter(target[:, 0], filter_logits,
                                     self.size_filter,
                                     self.upscale_factor)[:, None]
        else:
            k2, r2 = self.size_filter ** 2, self.upscale_factor ** 2
            filters = filter_logits.reshape(n, k2, r2, h, w).softmax(dim=1)
            # The raw frame and the compute-dtype filters meet in their
            # promotion, as jnp.einsum promotes them.
            dt = torch.promote_types(target.dtype, filters.dtype)
            out = apply_dynamic_filters(target.to(dt), filters.to(dt),
                                        self.upscale_factor)
        return out + residual
