"""Intensity preprocessing: outlier clip + min-max, and /12 center-crop.

Copies of ``vsr_tpu/preprocess/intensity.py``'s helpers (the port imports
nothing of ``vsr_tpu``): the two serving ones, which
``tests/test_torch_port_pipeline.py`` pins bit-equal to the originals, and
the offline pipeline's dataset moments, which ``tests/test_torch_offline.py``
pins.
"""

from __future__ import annotations

import numpy as np


def clip_outliers_minmax(data: np.ndarray) -> np.ndarray:
    """For int16 volumes: clip above the 99.5%-CDF bin, then min-max to
    [0, 255] with rounding. Other dtypes pass through. Always returns
    float32."""
    if data.dtype == np.int16:
        data = data.copy()
        # Degenerate volumes (max <= 1, e.g. all-zero masks) have no CDF to
        # clip and would make np.histogram raise; pass them straight to the
        # min-max step.
        if int(data.max()) > 1:
            hist, _ = np.histogram(
                data.ravel(), bins=range(int(data.max()) + 1), density=True
            )
            cdf = np.cumsum(hist)
            idx = int(np.abs(cdf - 0.995).argmin())
            data[data > idx] = idx
        spread = data.max() - data.min()
        if spread > 0:
            data = ((data - data.min()) / spread * 255.0).round()
        else:
            data = np.zeros_like(data, dtype=np.float32)
    return data.astype(np.float32)


def center_crop_multiple(shape_hw: tuple[int, int], multiple: int = 12) -> tuple[int, int, int, int]:
    """Crop bounds (h0, hn, w0, wn) making H and W divisible by ``multiple``,
    with the reference's asymmetric split: the extra pixel goes to the top/left
    trim when the remainder is odd."""
    h, w = shape_hw
    r = multiple
    h0, hn = (h % r) // 2, h - ((h % r) - (h % r) // 2)
    w0, wn = (w % r) // 2, w - ((w % r) - (w % r) // 2)
    return h0, hn, w0, wn


class RunningMoments:
    """Accumulates dataset mean/std the way the reference does
    (sum / sum-of-squares over all cropped voxels)."""

    def __init__(self) -> None:
        self.sum = 0.0
        self.square_sum = 0.0
        self.count = 0

    def update(self, data: np.ndarray) -> None:
        self.sum += float(data.sum())
        self.square_sum += float((data.astype(np.float64) ** 2).sum())
        self.count += int(np.prod(data.shape))

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    @property
    def std(self) -> float:
        if not self.count:
            return 0.0
        return float(np.sqrt(self.square_sum / self.count - self.mean**2))
