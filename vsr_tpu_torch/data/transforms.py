"""Functional, variadic image transforms over tuples of channels-last numpy
arrays (a numpy copy of ``vsr_tpu/data/transforms.py``; the tests pin every
transform to its original on the same draws).

``compose``, ``Compose``, ``ToTensor``, ``Normalize``, ``RandomCrop``,
``RandomHorizontalFlip``, ``RandomVerticalFlip``, ``RandomCropPatch``,
``RandomElasticDeformation`` (numpy + scipy) and ``Resize``. Every random
transform draws from the ``numpy.random.Generator`` passed as the ``rng``
keyword (threaded through ``Compose``), so a sample's augmentation does not
depend on worker count or call order. ``ToTensor`` casts to float32 numpy:
arrays stay channels-last (H, W, C) / (H, W, D, C) up to the trainer, which
moves a batch to the device and permutes it to the nets' NCHW layout.

Quirks kept on purpose: ``Normalize`` divides by ``std + 1e-10``;
``RandomCropPatch`` does not scale the depth dim for 4D inputs; flips use
axis 1 / axis 0 for horizontal / vertical.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np

from vsr_tpu_torch.preprocess.resize import resize_bicubic
from vsr_tpu_torch.registry import build, register


def _check_ndarrays(imgs: tuple) -> None:
    if not all(isinstance(img, np.ndarray) for img in imgs):
        raise TypeError("All of the images should be numpy.ndarray.")


def _check_dims(imgs: tuple) -> int:
    if not all(img.ndim == 3 for img in imgs) and not all(img.ndim == 4 for img in imgs):
        raise ValueError(
            "All of the images' dimensions should be 3 (2D images) or 4 (3D images)."
        )
    return imgs[0].ndim


def compose(transforms: Sequence[Mapping[str, Any]] | None = None) -> "Compose":
    """Build a :class:`Compose` from config specs; defaults to [ToTensor]."""
    if transforms is None:
        return Compose([ToTensor()])
    return Compose([build("transform", spec) for spec in transforms])


class BaseTransform:
    def __call__(self, *imgs: np.ndarray, **kwargs: Any):
        raise NotImplementedError

    def __repr__(self) -> str:
        return self.__class__.__name__


class Compose(BaseTransform):
    def __init__(self, transforms: Sequence[BaseTransform]):
        self.transforms = list(transforms)

    def __call__(self, *imgs: np.ndarray, **kwargs: Any):
        for transform in self.transforms:
            imgs = transform(*imgs, **kwargs)
        if len(imgs) == 1:
            return imgs[0]
        return imgs

    def __repr__(self) -> str:
        inner = "\n".join(f"    {t!r}" for t in self.transforms)
        return f"{self.__class__.__name__}(\n{inner}\n)"


@register("transform")
class ToTensor(BaseTransform):
    """Cast to arrays ready for device transfer (float32 by default)."""

    def __call__(self, *imgs: np.ndarray, dtypes: Sequence | None = None, **kwargs: Any):
        _check_ndarrays(imgs)
        if dtypes:
            if len(dtypes) != len(imgs):
                raise ValueError("The number of the dtypes should be the same as the images.")
            return tuple(
                np.ascontiguousarray(img, dtype=np.dtype(dt)) for img, dt in zip(imgs, dtypes)
            )
        return tuple(np.ascontiguousarray(img, dtype=np.float32) for img in imgs)


@register("transform")
class Normalize(BaseTransform):
    """Per-channel z-score; image-level statistics when means/stds are None."""

    def __init__(self, means: Sequence[float] | None = None, stds: Sequence[float] | None = None):
        if (means is None) != (stds is None):
            raise ValueError("Both the means and the standard deviations should have values or None.")
        if means is not None and len(means) != len(stds):
            raise ValueError("The number of the means should be the same as the standard deviations.")
        self.means = means
        self.stds = stds

    def __call__(self, *imgs: np.ndarray, normalize_tags: Sequence[bool] | None = None, **kwargs: Any):
        _check_ndarrays(imgs)
        if normalize_tags:
            if len(normalize_tags) != len(imgs):
                raise ValueError("The number of the tags should be the same as the images.")
            if not all(tag in (True, False) for tag in normalize_tags):
                raise ValueError("All of the tags should be either True or False.")
        else:
            normalize_tags = [None] * len(imgs)

        out = []
        for img, tag in zip(imgs, normalize_tags):
            if tag is False:
                out.append(img)
                continue
            if self.means is None:
                axis = tuple(range(img.ndim - 1))
                means = img.mean(axis=axis)
                stds = img.std(axis=axis)
            else:
                means, stds = self.means, self.stds
            img = img.astype(np.float32, copy=True)
            for c, mean, std in zip(range(img.shape[-1]), means, stds):
                img[..., c] = (img[..., c] - mean) / (std + 1e-10)
            out.append(img)
        return tuple(out)


def _rand_start(rng: np.random.Generator | None, upper: int) -> int:
    """Uniform int in [0, upper] (inclusive, like random.randint)."""
    if upper <= 0:
        return 0
    if rng is None:
        raise ValueError("Random transforms need an rng= keyword (numpy Generator).")
    return int(rng.integers(0, upper + 1))


@register("transform")
class RandomCrop(BaseTransform):
    def __init__(self, size: Sequence[int]):
        self.size = list(size)

    def __call__(self, *imgs: np.ndarray, rng: np.random.Generator | None = None, **kwargs: Any):
        _check_ndarrays(imgs)
        ndim = _check_dims(imgs)
        if ndim - 1 != len(self.size):
            raise ValueError(
                f"The dimensions of the cropped size should be the same as the image ({ndim - 1}). "
                f"Got {len(self.size)}"
            )
        shape = imgs[0].shape[:-1]
        if any(i < j for i, j in zip(shape, self.size)):
            raise ValueError(
                f"The image ({imgs[0].shape}) is smaller than the cropped size ({self.size})."
            )
        starts = [_rand_start(rng, i - j) for i, j in zip(shape, self.size)]
        slices = tuple(slice(s, s + t) for s, t in zip(starts, self.size))
        return tuple(img[slices] for img in imgs)


@register("transform")
class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob: float = 0.5):
        self.prob = max(0.0, min(float(prob), 1.0))

    def __call__(self, *imgs: np.ndarray, rng: np.random.Generator | None = None, **kwargs: Any):
        _check_ndarrays(imgs)
        _check_dims(imgs)
        if rng is not None and rng.random() < self.prob:
            imgs = tuple(np.flip(img, 1) for img in imgs)
        return imgs


@register("transform")
class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob: float = 0.5):
        self.prob = max(0.0, min(float(prob), 1.0))

    def __call__(self, *imgs: np.ndarray, rng: np.random.Generator | None = None, **kwargs: Any):
        _check_ndarrays(imgs)
        _check_dims(imgs)
        if rng is not None and rng.random() < self.prob:
            imgs = tuple(np.flip(img, 0) for img in imgs)
        return imgs


@register("transform")
class RandomCropPatch(BaseTransform):
    """Paired LR/HR crop: first half of the images are LR, second half HR;
    the HR window is the LR window scaled by ``ratio`` (depth unscaled for
    4D, matching the reference)."""

    def __init__(self, size: Sequence[int], ratio: int):
        self.size = list(size)
        self.ratio = int(ratio)

    def __call__(self, *imgs: np.ndarray, rng: np.random.Generator | None = None, **kwargs: Any):
        _check_ndarrays(imgs)
        ndim = _check_dims(imgs)
        if ndim - 1 != len(self.size):
            raise ValueError(
                f"The dimensions of the cropped size should be the same as the image ({ndim - 1}). "
                f"Got {len(self.size)}"
            )
        if len(imgs) % 2 == 1:
            raise ValueError("The number of the LR images should be the same as the HR images")
        half = len(imgs) // 2
        lr_imgs, hr_imgs = imgs[:half], imgs[half:]
        for lr_img, hr_img in zip(lr_imgs, hr_imgs):
            # In-plane (H, W) ratio check only: the dims the crop scales.
            if not all(
                j // i == self.ratio
                for i, j in zip(lr_img.shape[:2], hr_img.shape[:2])
            ):
                raise ValueError(
                    f"The ratio between the HR images and the LR images should be {self.ratio}."
                )

        shape = lr_imgs[0].shape[:-1]
        if any(i < j for i, j in zip(shape, self.size)):
            raise ValueError(
                f"The image ({lr_imgs[0].shape}) is smaller than the cropped size ({self.size})."
            )
        starts = [_rand_start(rng, i - j) for i, j in zip(shape, self.size)]
        ends = [s + t for s, t in zip(starts, self.size)]

        if ndim == 3:
            lr_sl = (slice(starts[0], ends[0]), slice(starts[1], ends[1]))
            hr_sl = tuple(slice(s * self.ratio, e * self.ratio) for s, e in zip(starts, ends))
        else:
            lr_sl = tuple(slice(s, e) for s, e in zip(starts, ends))
            # Depth (3rd spatial dim) intentionally NOT scaled by ratio.
            hr_sl = (
                slice(starts[0] * self.ratio, ends[0] * self.ratio),
                slice(starts[1] * self.ratio, ends[1] * self.ratio),
                slice(starts[2], ends[2]),
            )
        return tuple([img[lr_sl] for img in lr_imgs] + [img[hr_sl] for img in hr_imgs])


@register("transform")
class RandomElasticDeformation(BaseTransform):
    """Random B-spline-style elastic deformation.

    A coarse ``num_ctrl_points``-per-axis grid of
    Gaussian displacements (scale ``sigma``) is upsampled to a dense field
    with cubic spline interpolation and applied with
    ``scipy.ndimage.map_coordinates``. ``do_z_deformation`` gates the first
    axis of 3D volumes like the reference.
    """

    def __init__(self, do_z_deformation: bool = False, num_ctrl_points: int = 4,
                 sigma: float = 15, prob: float = 0.5):
        self.do_z_deformation = do_z_deformation
        self.num_ctrl_points = max(int(num_ctrl_points), 2)
        self.sigma = max(float(sigma), 1.0)
        self.prob = max(0.0, min(float(prob), 1.0))

    def __call__(self, *imgs: np.ndarray, rng: np.random.Generator | None = None,
                 elastic_deformation_orders: Sequence[int] | None = None, **kwargs: Any):
        _check_ndarrays(imgs)
        _check_dims(imgs)
        if rng is None or rng.random() >= self.prob:
            return imgs
        if any(img.shape[:-1] != imgs[0].shape[:-1] for img in imgs):
            # One field is built from imgs[0] and applied to every image:
            # mixed-size LR/HR tuples would be corrupted; fail loudly.
            raise ValueError(
                "RandomElasticDeformation requires all images to share one "
                f"spatial shape, got {[img.shape for img in imgs]} — apply "
                "it before any resolution-changing step, or to same-size "
                "tuples only.")

        from scipy import ndimage

        spatial = imgs[0].shape[:-1]
        ndim_s = len(spatial)
        coarse = rng.standard_normal((ndim_s, *([self.num_ctrl_points] * ndim_s))) * self.sigma
        if ndim_s == 3 and not self.do_z_deformation:
            coarse[0] = 0.0
        fields = []
        for d in range(ndim_s):
            zoom = [s / self.num_ctrl_points for s in spatial]
            fields.append(ndimage.zoom(coarse[d], zoom, order=3))
        grid = np.meshgrid(*[np.arange(s, dtype=np.float64) for s in spatial], indexing="ij")
        coords = [g + f for g, f in zip(grid, fields)]

        orders = list(elastic_deformation_orders or [3] * len(imgs))
        out = []
        for img, order in zip(imgs, orders):
            if order not in (0, 1, 3):
                raise ValueError(f"The interpolation order should be 0, 1 or 3. Got {order}.")
            warped = np.stack(
                [
                    ndimage.map_coordinates(img[..., c], coords, order=order, mode="constant", cval=0.0)
                    for c in range(img.shape[-1])
                ],
                axis=-1,
            )
            out.append(warped.astype(img.dtype, copy=False))
        return tuple(out)


@register("transform")
class Resize(BaseTransform):
    """Deterministic bicubic resize of all images to ``size`` (H, W).

    Uses the cv2-compatible bicubic kernel.
    """

    def __init__(self, size: Sequence[int]):
        if len(size) != 2:
            raise ValueError(f"Resize expects a (H, W) size, got {size}")
        self.size = tuple(int(s) for s in size)

    def __call__(self, *imgs: np.ndarray, **kwargs: Any):
        _check_ndarrays(imgs)
        out = []
        for img in imgs:
            if img.ndim == 3:
                out.append(resize_bicubic(img, *self.size).astype(img.dtype, copy=False))
            elif img.ndim == 4:
                resized = np.stack(
                    [resize_bicubic(img[:, :, d], *self.size) for d in range(img.shape[2])],
                    axis=2,
                )
                out.append(resized.astype(img.dtype, copy=False))
            else:
                raise ValueError("Resize supports 3D (H,W,C) or 4D (H,W,D,C) arrays.")
        return tuple(out)
