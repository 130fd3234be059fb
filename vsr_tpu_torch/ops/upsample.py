"""Deterministic up/down-sampling as two small matrix products (bicubic and
bilinear), the port of ``vsr_tpu/ops/upsample.py``.

Both align-corner conventions are supported:

- ``align_corners=False``: pixel-center mapping, cv2 / ``F.interpolate``
  compatible (shares the kernel construction with the preprocessing resize);
- ``align_corners=True``: endpoint mapping ``src = dst * (in - 1) / (out -
  1)``, what ``nn.Upsample(align_corners=True)`` uses (the ``Bicubic``
  baseline net).

``_resize_matrix_1d`` is a numpy copy of the JAX package's, pinned bit-equal
by a test. The matrices are applied in float32 with TF32 off, to NCHW.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vsr_tpu_torch.preprocess.resize import _cubic_coeffs


@functools.lru_cache(maxsize=256)
def _resize_matrix_1d(in_size: int, out_size: int, mode: str,
                      align_corners: bool) -> np.ndarray:
    if align_corners and out_size > 1:
        src = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    else:
        scale = in_size / out_size
        src = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    base = np.floor(src).astype(np.int64)
    frac = src - base

    matrix = np.zeros((out_size, in_size), dtype=np.float64)
    rows = np.arange(out_size)
    if mode == "bicubic":
        weights = _cubic_coeffs(frac)  # taps at -1..2
        for tap in range(4):
            idx = np.clip(base + tap - 1, 0, in_size - 1)
            np.add.at(matrix, (rows, idx), weights[:, tap])
    elif mode == "bilinear":
        for tap, wgt in ((0, 1.0 - frac), (1, frac)):
            idx = np.clip(base + tap, 0, in_size - 1)
            np.add.at(matrix, (rows, idx), wgt)
    else:
        raise ValueError(f"Unknown mode {mode!r}")
    matrix.setflags(write=False)
    return matrix


@functools.lru_cache(maxsize=64)
def _matrix_on(in_size: int, out_size: int, mode: str, align_corners: bool,
               device: torch.device) -> torch.Tensor:
    return torch.tensor(_resize_matrix_1d(in_size, out_size, mode,
                                          align_corners),
                        dtype=torch.float32, device=device)


def _matrix_for(x: torch.Tensor, in_size: int, out_size: int, mode: str,
                align_corners: bool) -> torch.Tensor:
    """The cached matrix for a plain tensor; a fresh one for a tensor
    subclass, which is what ``torch.export`` traces with (its fake tensors:
    one made then is fake too and must not be cached)."""
    if type(x) in (torch.Tensor, torch.nn.Parameter):
        return _matrix_on(in_size, out_size, mode, align_corners, x.device)
    return _matrix_on.__wrapped__(in_size, out_size, mode, align_corners,
                                  x.device)


def _resize(x: torch.Tensor, mode: str, scale, size,
            align_corners: bool) -> torch.Tensor:
    in_h, in_w = x.shape[-2], x.shape[-1]
    if size is not None:
        out_h, out_w = size
    elif scale is not None:
        out_h, out_w = in_h * scale, in_w * scale
    else:
        raise ValueError("Provide scale or size")
    r_h = _matrix_for(x, in_h, out_h, mode, align_corners)
    r_w = _matrix_for(x, in_w, out_w, mode, align_corners)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        # (..., H, W): rows first (h -> o), then columns (w -> p).
        y = torch.matmul(torch.matmul(r_h, x.float()), r_w.t())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return y.to(x.dtype)


def upsample_bicubic(x: torch.Tensor, scale: int | None = None,
                     size: tuple[int, int] | None = None,
                     align_corners: bool = False) -> torch.Tensor:
    """Bicubic resize of ``(..., H, W)`` to ``scale`` or an explicit
    ``(H, W)`` size."""
    return _resize(x, "bicubic", scale, size, align_corners)


def upsample_bilinear(x: torch.Tensor, scale: int | None = None,
                      size: tuple[int, int] | None = None,
                      align_corners: bool = False) -> torch.Tensor:
    return _resize(x, "bilinear", scale, size, align_corners)
