"""Backward warping (optical-flow sampling), the port of
``vsr_tpu/ops/warp.py``, channel-first.

torch ``grid_sample`` semantics: bilinear, ``align_corners=True``, ``zeros``
or ``border`` padding. The sampler is the four-corner gather in pixel
coordinates (the JAX op's ``method="gather"`` body), so a sample at an
integer coordinate stays integer: no normalize / unnormalize round trip can
land it one ulp below and flip its gradient.

The gradient with respect to a coordinate is the JAX package's, whose hat
sampler (``relu(1 - |g - i|)`` over the rows ``i``) has a custom JVP: the
hat's slope is +1 on ``[-1, 0)`` and -1 on ``[0, 1)`` of the float32
difference ``g - i``, and 0 elsewhere. So at an integer coordinate the
gradient is the one-sided *forward* difference, and where ``g - i`` rounds
onto -1 (a coordinate half an ulp below an integer under 1, as a normalized
grid's round trip can leave it) the row below counts as well. The backward
here sums those slopes over the three candidate rows (and columns) of each
sample, so it matches the JAX gradient where ``floor``-based autograd would
not. In ``border`` mode the coordinate clamp passes a gradient of 1 on the
exact border and 0 outside (torch's ``clip_coordinates``), and the virtual
row past the edge folds into the last one, so the difference there is 0.

The JAX ``method="matmul"`` hat-matmul sampler is a TPU workaround (TPU
gathers of narrow rows are slow); both names are accepted and take the one
sampler here. The JAX op is XLA, not Pallas: this is plain PyTorch.
"""

from __future__ import annotations

import torch

_METHODS = ("matmul", "gather")
_PADDINGS = ("zeros", "border")


def _clip_coord(g: torch.Tensor, hi: float) -> torch.Tensor:
    """``clamp(g, 0, hi)`` whose gradient is 1 inside *including* the
    bounds and 0 outside (``torch.clamp`` passes the bounds too; spelled out
    so the convention does not hang on it)."""
    inside = (g >= 0.0) & (g <= hi)
    return torch.where(inside, g, g.detach().clamp(0.0, hi))


def _sample(img: torch.Tensor, gy: torch.Tensor, gx: torch.Tensor,
            zeros: bool) -> torch.Tensor:
    """The four-corner gather: ``(N, C, H, W)`` at float32 ``(N, Ho, Wo)``
    pixel coordinates."""
    y0, x0 = torch.floor(gy), torch.floor(gx)
    wy = (gy - y0).to(img.dtype)[:, None]
    wx = (gx - x0).to(img.dtype)[:, None]
    tap = _tapper(img, y0.long(), x0.long(), zeros)
    top = tap(0, 0) * (1 - wx) + tap(0, 1) * wx
    bot = tap(1, 0) * (1 - wx) + tap(1, 1) * wx
    return top * (1 - wy) + bot * wy


def _tapper(img: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
            zeros: bool):
    """``tap(a, b)``: the pixels at rows ``y0 + a``, columns ``x0 + b``,
    ``(N, C, Ho, Wo)``; 0 off the image with ``zeros``, else the nearest
    edge pixel."""
    n, c, h, w = img.shape
    flat = img.reshape(n, c, h * w)

    def tap(a: int, b: int) -> torch.Tensor:
        yi, xi = y0 + a, x0 + b
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(n, 1, -1)
        val = torch.gather(flat, 2, idx.expand(n, c, idx.shape[-1]))
        val = val.reshape(n, c, *y0.shape[1:])
        if zeros:
            inb = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
            val = val * inb[:, None].to(img.dtype)
        return val

    return tap


def _hat_slope(d: torch.Tensor) -> torch.Tensor:
    """The JAX hat's custom derivative at the float32 difference ``d``."""
    one = torch.ones_like(d)
    return torch.where((d >= -1.0) & (d < 0.0), one,
                       torch.where((d >= 0.0) & (d < 1.0), -one, 0 * one))


class _Bilinear(torch.autograd.Function):
    """The sampler, with the JAX hat's coordinate gradient."""

    @staticmethod
    def forward(ctx, img, gy, gx, zeros: bool):
        ctx.save_for_backward(img, gy, gx)
        ctx.zeros = zeros
        return _sample(img, gy, gx, zeros)

    @staticmethod
    def backward(ctx, grad):
        img, gy, gx = ctx.saved_tensors
        d_img = d_gy = d_gx = None
        if ctx.needs_input_grad[0]:
            with torch.enable_grad():
                leaf = img.detach().requires_grad_(True)
                d_img, = torch.autograd.grad(
                    _sample(leaf, gy, gx, ctx.zeros), leaf, grad)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            # Rows y0 .. y0 + 2 and columns x0 .. x0 + 2 can have a slope.
            y0, x0 = torch.floor(gy), torch.floor(gx)
            wy = (gy - y0).to(img.dtype)[:, None]
            wx = (gx - x0).to(img.dtype)[:, None]
            tap = _tapper(img, y0.long(), x0.long(), ctx.zeros)
            v = [[tap(a, b) for b in range(3)] for a in range(3)]
            g = grad.to(img.dtype)
            d_gy = sum((g * (_hat_slope(gy - (y0 + a)).to(img.dtype)[:, None]
                             * (v[a][0] * (1 - wx) + v[a][1] * wx))).sum(1)
                       for a in range(3)).float()
            d_gx = sum((g * (_hat_slope(gx - (x0 + b)).to(img.dtype)[:, None]
                             * (v[0][b] * (1 - wy) + v[1][b] * wy))).sum(1)
                       for b in range(3)).float()
        return d_img, d_gy, d_gx, None


def grid_sample_bilinear(img: torch.Tensor, grid_y: torch.Tensor,
                         grid_x: torch.Tensor, padding_mode: str = "zeros",
                         method: str = "matmul") -> torch.Tensor:
    """Sample ``img`` ``(N, C, H, W)`` at fractional pixel coordinates
    ``grid_y`` / ``grid_x`` ``(N, Ho, Wo)``; returns ``(N, C, Ho, Wo)``.

    ``padding_mode="zeros"``: taps outside the image contribute 0;
    ``"border"``: coordinates clamp to the edge. ``method``: ``"matmul"``
    or ``"gather"``, one implementation."""
    if method not in _METHODS:
        raise ValueError(f"Unknown method {method!r}; legal: {_METHODS}")
    if padding_mode not in _PADDINGS:
        raise ValueError(f"Unknown padding_mode {padding_mode!r}; legal: "
                         f"{_PADDINGS}")
    h, w = img.shape[-2:]
    gy, gx = grid_y.float(), grid_x.float()
    if padding_mode == "border":
        gy, gx = _clip_coord(gy, float(h - 1)), _clip_coord(gx, float(w - 1))
    return _Bilinear.apply(img, gy, gx, padding_mode == "zeros")


def flow_warp(img: torch.Tensor, flow: torch.Tensor,
              padding_mode: str = "zeros") -> torch.Tensor:
    """Backward-warp ``img`` ``(N, C, H, W)`` by the pixel displacement
    ``flow`` ``(N, 2, H, W)``: channel 0 along W (x), channel 1 along H (y),
    the convention of both reference nets. ``out[y, x] = img[y + flow_y,
    x + flow_x]``, bilinear."""
    n, _, h, w = flow.shape
    ys = torch.arange(h, dtype=flow.dtype, device=flow.device).reshape(1, h, 1)
    xs = torch.arange(w, dtype=flow.dtype, device=flow.device).reshape(1, 1, w)
    return grid_sample_bilinear(img, ys + flow[:, 1], xs + flow[:, 0],
                                padding_mode=padding_mode)


def linspace(start: float, stop: float, num: int, *,
             device: torch.device | str | None = None) -> torch.Tensor:
    """float32 ``jnp.linspace(start, stop, num)`` value for value, as the
    JAX nets compute it under ``jit``: ``start * (1 - s) + stop * s`` with
    ``s = i * (1 / (num - 1))`` (XLA turns the division by the count into a
    multiplication by its reciprocal), and ``stop`` itself last.
    (``torch.linspace`` rounds some interior points the other way, and a
    normalized grid built on it would then land one ulp off an integer
    pixel where the JAX one lands on it: the warp's gradient there flips
    from a forward to a backward difference.)"""
    if num == 1:
        return torch.full((1,), start, dtype=torch.float32, device=device)
    div = num - 1
    step = torch.arange(div, dtype=torch.float32, device=device) * (
        torch.ones((), dtype=torch.float32, device=device) / div)
    out = start * (1 - step) + stop * step
    return torch.cat([out, torch.full((1,), stop, dtype=torch.float32,
                                      device=device)])


def grid_sample_normalized(img: torch.Tensor, grid: torch.Tensor,
                           padding_mode: str = "zeros") -> torch.Tensor:
    """``torch.grid_sample(align_corners=True)`` on a normalized grid
    ``(N, Ho, Wo, 2)`` in [-1, 1] (``grid[..., 0]`` = x, ``[..., 1]`` = y),
    with the JAX op's arithmetic: ``(g + 1) * (size - 1) / 2``."""
    h, w = img.shape[-2:]
    gx = (grid[..., 0] + 1.0) * (w - 1) / 2.0
    gy = (grid[..., 1] + 1.0) * (h - 1) / 2.0
    return grid_sample_bilinear(img, gy, gx, padding_mode=padding_mode)
