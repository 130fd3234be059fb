"""Fold a SAME conv THROUGH a preceding pixel-shuffle (weight transform).

Port of ``vsr_tpu/ops/fused_tail.py``'s ``fuse_conv_through_shuffle`` and
``fuse_conv3d_through_shuffle2d`` in torch's layout. Because pixel-shuffle
is a fixed permutation, the final conv of a sub-pixel tail can run on the
PRE-shuffle array:

    out(r*y+py, r*x+px, o)
      = b_o + sum_{dy,dx,c} W[o,c,dy,dx] * shuffled(r*y+py+dy, r*x+px+dx, c)
      = b_o + sum_{qy,qx,u} K[o*r^2+py*r+px, u, qy, qx] * pre(u, y+qy, x+qx)

with (qy, ry) = divmod(py+dy, r) and u = c*r^2 + ry*r + rx: one conv on the
pre-shuffle array producing r^2 phase channels per output channel, then a
pixel-shuffle of the small result. The packing is ``F.pixel_shuffle``'s.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def fused_extent(kernel_size: int, factor: int) -> int:
    """Coarse-grid kernel extent of the folded conv (odd, symmetric)."""
    half = kernel_size // 2
    qmax = max(abs((0 - half) // factor), (factor - 1 + half) // factor)
    return 2 * qmax + 1


@functools.lru_cache(maxsize=16)
def _fold_taps(kernel_size: int, factor: int) -> np.ndarray:
    """For each (py, px, ry, rx, qy, qx) slot of the folded kernel, the
    index dy*k+dx of the tap that lands there, or k*k (a zero column) for
    none. Each slot takes at most one tap (divmod is injective in dy), so
    the fold is a gather: exact in any dtype."""
    k, r = kernel_size, factor
    half = k // 2
    kq = fused_extent(k, r)
    qhalf = kq // 2
    idx = np.full((r, r, r, r, kq, kq), k * k, np.int64)
    for py in range(r):
        for px in range(r):
            for dy in range(-half, half + 1):
                for dx in range(-half, half + 1):
                    qy, ry = divmod(py + dy, r)
                    qx, rx = divmod(px + dx, r)
                    idx[py, px, ry, rx, qy + qhalf, qx + qhalf] = (
                        (dy + half) * k + dx + half)
    idx = idx.reshape(-1)
    idx.setflags(write=False)
    return idx


@functools.lru_cache(maxsize=16)
def _fold_index(kernel_size: int, factor: int,
                device: torch.device) -> torch.Tensor:
    """``_fold_taps`` on ``device``, copied there once: serving folds the
    tail weight every frame, and a fresh host-to-device copy would stall
    the card's queue each time. Made outside inference mode, whatever the
    caller's mode: the cached tensor also serves folds that autograd records
    (a fused tail trained in a process that served one before)."""
    with torch.inference_mode(False):
        return torch.tensor(_fold_taps(kernel_size, factor), device=device)


def _fold_index_for(weight: torch.Tensor, kernel_size: int,
                    factor: int) -> torch.Tensor:
    """The cached index for a plain tensor or parameter; a fresh one for a
    tensor subclass, which is what ``torch.export`` traces with (its fake
    tensors: one made then is fake too, a constant of the traced program,
    and must not be cached)."""
    if type(weight) in (torch.Tensor, torch.nn.Parameter):
        return _fold_index(kernel_size, factor, weight.device)
    return _fold_index.__wrapped__(kernel_size, factor, weight.device)


def fuse_conv_through_shuffle(weight: torch.Tensor, bias: torch.Tensor | None,
                              factor: int):
    """Rearrange a (Cout, Cin, k, k) SAME-conv weight that runs AFTER
    ``pixel_shuffle(factor)`` into a (Cout*r^2, Cin*r^2, kq, kq) weight that
    runs BEFORE it. Returns (K, B); apply as
    ``F.pixel_shuffle(F.conv2d(pre, K, B, padding=kq // 2), factor)``."""
    cout, cin, k, _ = weight.shape
    r = factor
    kq = fused_extent(k, r)
    idx = _fold_index_for(weight, k, r)
    taps = torch.cat([weight.reshape(cout * cin, k * k),
                      weight.new_zeros(cout * cin, 1)], dim=1)
    folded = taps[:, idx].reshape(cout, cin, r, r, r, r, kq, kq)
    # (o, c, py, px, ry, rx, qy, qx) -> (o, py, px, c, ry, rx, qy, qx)
    K = folded.permute(0, 2, 3, 1, 4, 5, 6, 7).reshape(
        cout * r * r, cin * r * r, kq, kq)
    B = None if bias is None else bias.repeat_interleave(r * r)
    return K, B


def fuse_conv3d_through_shuffle2d(weight: torch.Tensor,
                                  bias: torch.Tensor | None, factor: int):
    """3D variant for the volumetric tails: rearrange a (Cout, Cin, kd, k, k)
    SAME-conv weight that runs AFTER ``pixel_shuffle_2d_in_3d(factor)`` (H
    and W shuffled, depth untouched; ``models/vol3d.py``) into a
    (Cout*r^2, Cin*r^2, kd, kq, kq) weight that runs BEFORE it. The depth
    taps pass through: the H/W fold is the 2D fold applied to each depth
    tap, with the same channel packing. Returns (K, B); apply as
    ``pixel_shuffle_2d_in_3d(F.conv3d(pre, K, B, padding=(pd, kq // 2,
    kq // 2)), factor)``."""
    K = torch.stack([fuse_conv_through_shuffle(weight[:, :, d], None,
                                               factor)[0]
                     for d in range(weight.shape[2])], dim=2)
    B = None if bias is None else bias.repeat_interleave(factor * factor)
    return K, B
