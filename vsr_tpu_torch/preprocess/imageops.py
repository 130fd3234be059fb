"""Small image operations with OpenCV-compatible semantics, in numpy/scipy
(copy of ``vsr_tpu/preprocess/imageops.py``: the port imports nothing of
``vsr_tpu``; ``tests/test_torch_offline.py`` pins every output bit-equal).

The cardiac ROI finder (``preprocess/cropping.py``) chains cv2's
GaussianBlur / Otsu threshold / morphological close + open; each op here
replicates the cv2 convention it relies on:

- ``GaussianBlur(ksize=(5,5), sigma=0)``: OpenCV substitutes its fixed
  small-kernel table ``[1,4,6,4,1]/16`` for sigma<=0 and ksize<=7, border
  BORDER_REFLECT_101 (scipy's ``mirror``).
- Otsu: maximize between-class variance over a 256-bin histogram, keeping the
  *first* maximizer (cv2 keeps the first strict maximum); binary output is
  ``pixel > threshold``.
- Morphology: 5x5 rectangular SE; cv2 pads dilation with 0 and erosion with 1
  for binary masks (constant border with the op's neutral element).
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

_SMALL_GAUSSIAN_5 = np.array([0.0625, 0.25, 0.375, 0.25, 0.0625], dtype=np.float64)


def gaussian_blur5(img: np.ndarray) -> np.ndarray:
    """cv2.GaussianBlur(img, (5,5), 0) for float input."""
    out = ndimage.correlate1d(img.astype(np.float64), _SMALL_GAUSSIAN_5, axis=0, mode="mirror")
    out = ndimage.correlate1d(out, _SMALL_GAUSSIAN_5, axis=1, mode="mirror")
    return out.astype(img.dtype) if np.issubdtype(img.dtype, np.floating) else out


def otsu_threshold(img_u8: np.ndarray) -> int:
    """Otsu's threshold of a uint8 image, cv2-compatible tie-breaking."""
    hist = np.bincount(img_u8.ravel(), minlength=256).astype(np.float64)
    total = hist.sum()
    bins = np.arange(256, dtype=np.float64)
    w0 = np.cumsum(hist)
    w1 = total - w0
    cum_mean = np.cumsum(hist * bins)
    mean_total = cum_mean[-1]
    with np.errstate(divide="ignore", invalid="ignore"):
        mu0 = cum_mean / w0
        mu1 = (mean_total - cum_mean) / w1
        sigma_between = w0 * w1 * (mu0 - mu1) ** 2
    sigma_between = np.nan_to_num(sigma_between, nan=-1.0)
    return int(np.argmax(sigma_between))


def binary_close(mask: np.ndarray, size: int = 5) -> np.ndarray:
    se = np.ones((size, size), dtype=bool)
    dilated = ndimage.binary_dilation(mask.astype(bool), structure=se, border_value=0)
    return ndimage.binary_erosion(dilated, structure=se, border_value=1)


def binary_open(mask: np.ndarray, size: int = 5) -> np.ndarray:
    se = np.ones((size, size), dtype=bool)
    eroded = ndimage.binary_erosion(mask.astype(bool), structure=se, border_value=1)
    return ndimage.binary_dilation(eroded, structure=se, border_value=0)
