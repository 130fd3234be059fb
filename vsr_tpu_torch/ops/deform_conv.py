"""Deformable convolution v1 and modulated v2, the port of
``vsr_tpu/ops/deform_conv.py``, channel-first.

Offset-driven bilinear sampling of every kernel tap (the warp's four-corner
gather in pixel coordinates, zero padding, ``ops/warp.py``), an optional
modulation mask, then one contraction of the sampled taps with the weight.
Autograd differentiates the gather into the scatter-adds that the reference
CUDA extension hand-codes as col2im / col2im_coord, with the warp's
gradient conventions. The JAX op is XLA, not Pallas: this is plain PyTorch.

Layouts (the JAX op's, with the channel axis moved forward):

- ``offsets`` ``(N, 2, dg, k*k, Ho, Wo)``: ``[:, 0]`` = dy, ``[:, 1]`` = dx,
  taps in ``ky*k + kx`` order. An offset conv whose output channels are
  ordered ``(dy | dx | mask) x dg x k*k`` (the JAX packs' stored order)
  reshapes into it with no copy;
- ``mask`` ``(N, dg, k*k, Ho, Wo)``, already through its sigmoid;
- ``weight`` ``(C_out, C_in, k, k)``, the ``nn.Conv2d`` layout;
- channels of a deformable group are contiguous and share its offsets.

``method`` (``"matmul"``: the JAX hat-matmul sampler, a TPU workaround;
``"gather"``) names one implementation here. ``scan_major=True`` is a TPU
layout of the JAX sampler's output and is refused.

The sampled taps of one call are ``N * C * k*k * Ho * Wo`` values; the batch
is taken in chunks that keep them under ``COL_BUDGET_BYTES``.
"""

from __future__ import annotations

import torch

from vsr_tpu_torch.ops.warp import grid_sample_bilinear

COL_BUDGET_BYTES = 256 << 20


def offset_coords(offsets: torch.Tensor, kernel: tuple[int, int],
                  stride: int, padding: int,
                  dilation: int) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 absolute sample coordinates ``(gy, gx)``, each ``(N, dg,
    k*k, Ho, Wo)``: ``base + tap + offset``, summed in the JAX op's order."""
    kh, kw = kernel
    n, two, dg, k2, ho, wo = offsets.shape
    if two != 2 or k2 != kh * kw:
        raise ValueError(f"offsets must be (N, 2, dg, {kh * kw}, Ho, Wo), "
                         f"got {tuple(offsets.shape)}")
    off = offsets.float()
    dev = offsets.device
    base_y = (torch.arange(ho, dtype=torch.float32, device=dev) * stride
              - padding).reshape(1, 1, 1, ho, 1)
    base_x = (torch.arange(wo, dtype=torch.float32, device=dev) * stride
              - padding).reshape(1, 1, 1, 1, wo)
    taps = torch.arange(kh * kw, device=dev)
    tap_y = ((taps // kw) * dilation).float().reshape(1, 1, k2, 1, 1)
    tap_x = ((taps % kw) * dilation).float().reshape(1, 1, k2, 1, 1)
    return base_y + tap_y + off[:, 0], base_x + tap_x + off[:, 1]


def sample_taps(x: torch.Tensor, offsets: torch.Tensor,
                kernel: tuple[int, int], stride: int = 1, padding: int = 1,
                dilation: int = 1) -> torch.Tensor:
    """Offset-driven bilinear im2col: ``x`` ``(N, C, H, W)`` -> ``(N, C,
    k*k, Ho, Wo)`` sampled taps, zero outside the image."""
    n, c, h, w = x.shape
    dg, k2, ho, wo = offsets.shape[2:]
    if c % dg:
        raise ValueError(f"{c} channels do not split into {dg} groups")
    gy, gx = offset_coords(offsets, kernel, stride, padding, dilation)
    # One image of C/dg channels per (sample, group); the taps stack as rows.
    taps = grid_sample_bilinear(x.reshape(n * dg, c // dg, h, w),
                                gy.reshape(n * dg, k2 * ho, wo),
                                gx.reshape(n * dg, k2 * ho, wo))
    return taps.reshape(n, c, k2, ho, wo)


def deform_conv2d(x: torch.Tensor, offsets: torch.Tensor,
                  weight: torch.Tensor, bias: torch.Tensor | None = None,
                  mask: torch.Tensor | None = None, stride: int = 1,
                  padding: int = 1, dilation: int = 1,
                  method: str = "matmul",
                  scan_major: bool = False) -> torch.Tensor:
    """Deformable conv: v1 when ``mask`` is None, modulated v2 otherwise.
    ``x`` ``(N, C_in, H, W)`` -> ``(N, C_out, Ho, Wo)``."""
    if scan_major:
        raise NotImplementedError(
            "deform_conv2d scan_major (a TPU layout of the JAX sampler) is "
            "not ported to vsr_tpu_torch")
    if method not in ("matmul", "gather"):
        raise ValueError(f"Unknown method {method!r}; legal: "
                         "('matmul', 'gather')")
    cout, cin, kh, kw = weight.shape
    n, c = x.shape[:2]
    dg, k2, ho, wo = offsets.shape[2:]
    if c != cin or offsets.shape[0] != n:
        raise ValueError(f"x {tuple(x.shape)}, offsets {tuple(offsets.shape)}"
                         f" and weight {tuple(weight.shape)} disagree")
    if mask is not None and tuple(mask.shape) != (n, dg, k2, ho, wo):
        raise ValueError(f"mask must be {(n, dg, k2, ho, wo)}, got "
                         f"{tuple(mask.shape)}")
    w2 = weight.reshape(cout, cin * k2)  # column index: c * k*k + tap
    per_sample = 8 * c * k2 * ho * wo * x.element_size()  # taps + corners
    chunk = max(1, COL_BUDGET_BYTES // per_sample)
    outs = []
    for s in range(0, n, chunk):
        col = sample_taps(x[s:s + chunk], offsets[s:s + chunk], (kh, kw),
                          stride, padding, dilation)  # (b, C, k2, Ho, Wo)
        b = col.shape[0]
        if mask is not None:
            col = (col.reshape(b, dg, c // dg, k2, ho, wo)
                   * mask[s:s + chunk, :, None].to(col.dtype))
        out = torch.matmul(w2, col.reshape(b, c * k2, ho * wo))
        outs.append(out.reshape(b, cout, ho, wo))
    out = outs[0] if len(outs) == 1 else torch.cat(outs)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out
