"""PSNR / SSIM metrics as on-device reductions (port of
``vsr_tpu/metrics.py``), channels-first: (N, C, H, W) for dim=2 and
(N, C, D, H, W) for dim=3.

- PSNR: per-sample MSE over all non-batch dims, ``10*log10(max^2 /
  (mse + 1e-10))``.
- SSIM: depthwise **valid** (unpadded) convolution with an 11-tap kernel and
  the project's own Gaussian ``exp(-((x - 5) / (2*1.5))^2)`` (an effective
  sigma of 2.12, not 1.5). Kept exactly; changing it would shift SSIM parity.

Metrics compute in float32 with TF32 off, whatever the global flag says.
``SliceSSIM`` averages the 2D SSIM over depth; the ``Cardiac*`` metrics crop
to a per-patient box (the last two axes) and take the patient's name.
"""

from __future__ import annotations

import contextlib
import math
import pickle

import numpy as np
import torch
import torch.nn.functional as F

from vsr_tpu_torch.registry import register


@contextlib.contextmanager
def _cudnn_full_float32():
    """cuDNN convolutions in full float32 inside the block, whatever the
    global flag says. (``torch.backends.cudnn.flags`` is not used: called
    with ``allow_tf32`` alone it also switches cuDNN off.)"""
    previous = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = previous


class Metric:
    def __call__(self, output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    @property
    def name(self) -> str:
        return self.__class__.__name__

    def __repr__(self) -> str:
        return self.__class__.__name__


@register("metric")
class PSNR(Metric):
    def __init__(self, size_average: bool = True, max_value: float = 255):
        self.size_average = size_average
        self.max_value = float(max_value)

    def __call__(self, output, target):
        output, target = output.float(), target.float()
        reduced = tuple(range(1, output.dim()))
        mse = torch.mean(torch.square(output - target), dim=reduced)
        psnr = 10.0 * torch.log10(self.max_value ** 2 / (mse + 1e-10))
        return torch.mean(psnr) if self.size_average else psnr


def _reference_gaussian_kernel(dim: int, size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """The separable kernel: product over axes of
    ``(1/(sigma*sqrt(2*pi))) * exp(-((x - size//2) / (2*sigma))^2)``,
    normalized to sum 1. (Note the missing square in the denominator: a
    quirk kept for parity.)"""
    x = np.arange(size, dtype=np.float64)
    mean = size // 2
    g1 = (1.0 / (sigma * math.sqrt(2 * math.pi))) * np.exp(-(((x - mean) / (2 * sigma)) ** 2))
    kernel = g1
    for _ in range(dim - 1):
        kernel = np.multiply.outer(kernel, g1)
    kernel /= kernel.sum()
    return kernel.astype(np.float32)


@register("metric")
class SSIM(Metric):
    def __init__(self, dim: int = 2, channels: int = 1,
                 size_average: bool = True, value_range: float = 255):
        if dim not in (2, 3):
            raise ValueError(f"Only dim=2, 3 are supported. Received dim={dim}.")
        self.dim = dim
        self.channels = channels
        self.size_average = size_average
        self.value_range = float(value_range)
        self.c1 = (0.01 * value_range) ** 2
        self.c2 = (0.03 * value_range) ** 2
        # Depthwise kernel (channels, 1, *spatial).
        k = torch.from_numpy(_reference_gaussian_kernel(dim))
        self.kernel = k.expand(channels, 1, *k.shape).contiguous()
        self._conv = F.conv2d if dim == 2 else F.conv3d

    def _filter(self, x: torch.Tensor) -> torch.Tensor:
        if self.kernel.device != x.device:
            self.kernel = self.kernel.to(x.device)
        return self._conv(x, self.kernel, groups=self.channels)

    def __call__(self, output, target):
        spatial = tuple(output.shape[2:])
        if any(s < 11 for s in spatial):
            raise ValueError(
                f"SSIM needs every spatial dim >= 11 (valid 11-tap window); "
                f"got spatial shape {spatial}. For thin volumes use dim=2 "
                f"SSIM per slice instead."
            )
        output, target = output.float(), target.float()
        with _cudnn_full_float32():
            mu1 = self._filter(output)
            mu2 = self._filter(target)
            sigma1_sq = self._filter(output * output) - mu1 * mu1
            sigma2_sq = self._filter(target * target) - mu2 * mu2
            sigma12 = self._filter(output * target) - mu1 * mu2
        ssim_map = ((2 * mu1 * mu2 + self.c1) * (2.0 * sigma12 + self.c2)) / (
            (mu1 * mu1 + mu2 * mu2 + self.c1) * (sigma1_sq + sigma2_sq + self.c2)
        )
        if self.size_average:
            return torch.mean(ssim_map)
        return torch.mean(ssim_map, dim=tuple(range(1, ssim_map.dim())))


@register("metric")
class SliceSSIM(Metric):
    """2D SSIM averaged over the depth axis of ``(N, C, D, H, W)`` volumes
    (cardiac stacks are thinner than the 11-tap window of the 3D SSIM)."""

    def __init__(self, channels: int = 1, size_average: bool = True,
                 value_range: float = 255):
        self.size_average = size_average
        self.ssim = SSIM(dim=2, channels=channels, size_average=size_average,
                         value_range=value_range)

    def __call__(self, output, target):
        per_slice = torch.stack([self.ssim(output[:, :, d], target[:, :, d])
                                 for d in range(output.shape[2])])
        return torch.mean(per_slice) if self.size_average else torch.mean(
            per_slice, dim=0)  # (N,) per sample, like PSNR


class _CardiacMixin:
    """Crop output and target to the patient's heart box before scoring.

    ``host_only`` and ``needs_name`` are the JAX package's flags: the
    predictors pass such a metric the patient's name. The coordinates pickle
    (``{patient: (h0, hn, w0, wn)}``) is read at the first call, so a config
    builds before the preprocessing has written it."""

    host_only = True
    needs_name = True

    def __init__(self, coordinates_path: str):
        self.coordinates_path = coordinates_path
        self._coordinates = None

    @property
    def coordinates(self) -> dict:
        if self._coordinates is None:
            with open(self.coordinates_path, "rb") as f:
                self._coordinates = pickle.load(f)
        return self._coordinates

    def _crop(self, output, target, name: str):
        h0, hn, w0, wn = self.coordinates[name]
        # Channels-first: the spatial dims are the last two.
        return output[..., h0:hn, w0:wn], target[..., h0:hn, w0:wn]


@register("metric")
class CardiacPSNR(_CardiacMixin, Metric):
    def __init__(self, coordinates_path: str, **kwargs):
        _CardiacMixin.__init__(self, coordinates_path)
        self.psnr = PSNR(**kwargs)

    def __call__(self, output, target, name: str):
        return self.psnr(*self._crop(output, target, name))


@register("metric")
class CardiacSSIM(_CardiacMixin, Metric):
    def __init__(self, coordinates_path: str, **kwargs):
        _CardiacMixin.__init__(self, coordinates_path)
        self.ssim = SSIM(**kwargs)

    def __call__(self, output, target, name: str):
        return self.ssim(*self._crop(output, target, name))
