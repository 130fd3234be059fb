"""Dynamic (per-pixel) upsampling filters, the plain path (port of
``vsr_tpu/ops/dynamic_filter.py``), channel-first.

``apply_dynamic_filters(x, filters, upscale)`` applies, at every LR pixel, a
k x k filter per output sub-pixel to the pixel's zero-padded neighbourhood:

    out[n, c, y*r+dy, x*r+dx] = sum_tap f[n, tap, dy*r+dx, y, x]
                                * x[n, c, y+ky-p, x+kx-p]

with ``tap = ky*k + kx`` and ``p = k // 2``. The JAX op is channels-last
(``x (N, H, W, C)``, ``filters (N, H, W, k^2, r^2)``); here both are
channel-first, the layout the port's convs produce.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def extract_patches(x: torch.Tensor, size: int) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, size^2, H, W) patches, zero-padded SAME (tap
    order ``ky*size + kx``)."""
    n, c, h, w = x.shape
    patches = F.unfold(x, size, padding=size // 2)  # (N, C*size^2, H*W)
    return patches.reshape(n, c, size * size, h, w)


def apply_dynamic_filters(x: torch.Tensor, filters: torch.Tensor,
                          upscale: int) -> torch.Tensor:
    """x: (N, C, H, W); filters: (N, k^2, r^2, H, W), already softmaxed.
    Returns (N, C, H*r, W*r)."""
    n, c, h, w = x.shape
    k2, r2 = filters.shape[1], filters.shape[2]
    size = int(round(k2 ** 0.5))
    if size * size != k2 or size % 2 == 0:
        raise ValueError(f"filters need an odd square tap count, got {k2}")
    if r2 != upscale * upscale or filters.shape != (n, k2, r2, h, w):
        raise ValueError(f"filters must be ({n}, k^2, {upscale * upscale}, "
                         f"{h}, {w}), got {tuple(filters.shape)}")
    patches = extract_patches(x, size)
    out = torch.einsum("nckhw,nkrhw->ncrhw", patches, filters)
    return F.pixel_shuffle(out.reshape(n, c * r2, h, w), upscale)
