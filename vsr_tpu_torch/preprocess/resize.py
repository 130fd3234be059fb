"""Bicubic resampling compatible with ``cv2.resize(..., INTER_CUBIC)``.

The weight construction is a copy of ``vsr_tpu/preprocess/resize.py``
(Keys kernel a = -0.75, pixel-center alignment, clamped borders, no
antialiasing): the separable resize is ``out = R_h @ img @ R_w.T`` with two
small dense matrices. ``resize_bicubic_torch`` runs it as two f32 matmuls.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_A = -0.75  # Keys kernel free parameter, OpenCV's choice.


def _cubic_coeffs(frac: np.ndarray) -> np.ndarray:
    """The 4 interpolation weights for fractional offsets ``frac`` in [0,1).

    Returns shape ``frac.shape + (4,)`` for taps at offsets [-1, 0, 1, 2].
    """
    x = frac.astype(np.float64)
    a = _A
    w0 = ((a * (x + 1) - 5 * a) * (x + 1) + 8 * a) * (x + 1) - 4 * a
    w1 = ((a + 2) * x - (a + 3)) * x * x + 1
    w2 = ((a + 2) * (1 - x) - (a + 3)) * (1 - x) * (1 - x) + 1
    w3 = 1.0 - w0 - w1 - w2
    return np.stack([w0, w1, w2, w3], axis=-1)


@functools.lru_cache(maxsize=256)
def bicubic_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense (out_size, in_size) float64 matrix applying 1-D bicubic resize."""
    scale = in_size / out_size
    dst = np.arange(out_size, dtype=np.float64)
    src = (dst + 0.5) * scale - 0.5
    base = np.floor(src).astype(np.int64)
    frac = src - base
    weights = _cubic_coeffs(frac)  # (out, 4)

    matrix = np.zeros((out_size, in_size), dtype=np.float64)
    for tap in range(4):
        idx = np.clip(base + tap - 1, 0, in_size - 1)
        np.add.at(matrix, (dst.astype(np.int64), idx), weights[:, tap])
    matrix.setflags(write=False)
    return matrix


def resize_bicubic(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """cv2.INTER_CUBIC-compatible resize of a (H, W) or (H, W, C) numpy
    array (the ``Resize`` transform's kernel), in float64."""
    img = np.asarray(img)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    in_h, in_w, _ = img.shape
    r_h = bicubic_resize_matrix(in_h, out_h)
    r_w = bicubic_resize_matrix(in_w, out_w)
    out = np.einsum("hi,iwc,wj->hjc", r_h, img.astype(np.float64), r_w.T)
    out = out.astype(np.result_type(img.dtype, np.float32))
    return out[..., 0] if squeeze else out


def resize_bicubic_torch(img: torch.Tensor, out_h: int,
                         out_w: int) -> torch.Tensor:
    """(..., H, W) -> (..., out_h, out_w) as two f32 matmuls.

    Full f32 precision needs ``torch.backends.cuda.matmul.allow_tf32`` off
    on the card (PyTorch's default; the serving pipeline sets it)."""
    in_h, in_w = img.shape[-2], img.shape[-1]
    r_h = torch.tensor(bicubic_resize_matrix(in_h, out_h),
                       dtype=torch.float32, device=img.device)
    r_w = torch.tensor(bicubic_resize_matrix(in_w, out_w),
                       dtype=torch.float32, device=img.device)
    return torch.matmul(torch.matmul(r_h, img.float()), r_w.T)
