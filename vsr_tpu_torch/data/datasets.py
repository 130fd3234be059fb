"""ACDC / DSB15 datasets for the SISR / MISR / VSR task regimes (port of
``vsr_tpu/data/datasets.py``; the tests pin every sample to the original's).

- SISR pairs per-frame ``imgs`` NIfTIs,
- MISR/VSR window ``videos`` sequences with circular wrap-around at the
  cardiac-cycle boundary,
- VSR valid/test yields whole variable-length sequences.

Arrays stay channels-last numpy, (H, W, C) frames and (T, H, W, C) windows;
``__getitem__(index, rng=...)`` takes an explicit numpy Generator for
augmentation, so samples are reproducible without global seeding. The Dsb15
classes only change the registry name. The volume datasets are not ported
yet, and ``native_decode`` (the C++ NIfTI decoder) is refused.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Sequence

import numpy as np

from vsr_tpu_torch.data.transforms import compose
from vsr_tpu_torch.io.nifti import _parse_header, load_nifti
from vsr_tpu_torch.registry import register


class BaseDataset:
    """Stores data_dir and split type."""

    def __init__(self, data_dir: str | Path, type: str, **kwargs: Any):
        self.data_dir = Path(data_dir)
        if type not in ("train", "valid", "test"):
            raise ValueError(f"type should be 'train', 'valid' or 'test', got {type!r}")
        self.type = type

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, index: int, rng: np.random.Generator | None = None) -> dict:
        raise NotImplementedError


def _nifti_shape(path: Path) -> tuple[int, ...]:
    """Read just the header to get the data shape (cheap: 352 bytes)."""
    import gzip

    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read(352)
    header, _, _ = _parse_header(raw)
    return header.shape


def parse_sample_name(path: Path) -> tuple[str, str, str | None]:
    """(patient, slice/sequence id, frame id or None) from a filename like
    ``patient001_2d_slice01_frame02.nii.gz`` or
    ``patient001_2d+1d_sequence01.nii.gz``."""
    name = path.name
    patient = name.split("_")[0]
    slice_m = re.search(r"(?:slice|sequence)(\d+)", name)
    frame_m = re.search(r"frame(\d+)", name)
    return patient, slice_m.group(1) if slice_m else "", frame_m.group(1) if frame_m else None


def _window_bounds(t: int, num_frames: int, temporal_order: str) -> tuple[int, int]:
    n = num_frames
    if temporal_order == "last":
        return t - n + 1, t + 1
    return t - (n - 1) // 2, t + ((n - 1) - (n - 1) // 2) + 1


def extract_window(seq: np.ndarray, t: int, num_frames: int, temporal_order: str) -> np.ndarray:
    """Slice an (H, W, C, T) sequence into an ``num_frames`` window around t
    with circular wrap at the boundaries (cine loops are periodic)."""
    T = seq.shape[-1]
    start, end = _window_bounds(t, num_frames, temporal_order)
    if start < 0:
        return np.concatenate((seq[..., start:], seq[..., :end]), axis=-1)
    if end > T:
        end %= T
        return np.concatenate((seq[..., start:], seq[..., :end]), axis=-1)
    return seq[..., start:end]


def misr_target_index(num_frames: int) -> int:
    """The frame of a MISR window that the net super-resolves: the middle
    one (the earlier of the two middles for an even window)."""
    return num_frames // 2 if num_frames % 2 == 1 else num_frames // 2 - 1


class _SRDatasetMixin(BaseDataset):
    def __init__(
        self,
        downscale_factor: int,
        transforms: Sequence | None,
        augments: Sequence | None = None,
        native_decode: bool = False,
        cache_decoded: bool = False,
        **kwargs: Any,
    ):
        super().__init__(**kwargs)
        if downscale_factor not in (2, 3, 4):
            raise ValueError(f"The downscale factor should be 2, 3, 4. Got {downscale_factor}.")
        self.downscale_factor = downscale_factor
        self.transforms = compose(transforms)
        self.augments = compose(augments)
        if native_decode:
            raise NotImplementedError(
                "native_decode (the C++ NIfTI decoder) is not yet ported to "
                "vsr_tpu_torch")
        loader = load_nifti
        if cache_decoded:
            # Host-RAM decode cache: sequence datasets re-read the same
            # NIfTI for every window of it; cache the decoded array (the
            # processed splits are small enough to live in RAM).
            import functools

            cached = functools.lru_cache(maxsize=4096)(
                lambda path_str: loader(path_str)
            )
            self._load = lambda path: cached(str(path))
        else:
            self._load = loader


@register("dataset")
class AcdcSISRDataset(_SRDatasetMixin):
    """Single-image SR over per-frame 2D NIfTIs."""

    def __init__(self, **kwargs: Any):
        super().__init__(**kwargs)
        lr_root = self.data_dir / self.type / "LR" / f"X{self.downscale_factor}"
        hr_root = self.data_dir / self.type / "HR"
        self.lr_paths = sorted(lr_root.glob("**/*2d*.nii.gz"))
        self.hr_paths = sorted(hr_root.glob("**/*2d*.nii.gz"))
        if len(self.lr_paths) != len(self.hr_paths):
            raise ValueError(
                f"LR/HR count mismatch: {len(self.lr_paths)} vs {len(self.hr_paths)}"
            )

    def __len__(self) -> int:
        return len(self.lr_paths)

    def sample_name(self, index: int) -> tuple[str, str, str | None]:
        return parse_sample_name(self.lr_paths[index])

    def __getitem__(self, index: int, rng: np.random.Generator | None = None) -> dict:
        lr_img = self._load(self.lr_paths[index])  # (h, w, C)
        hr_img = self._load(self.hr_paths[index])  # (H, W, C)
        imgs = (lr_img, hr_img)
        if self.type == "train":
            imgs = self.augments(*imgs, rng=rng)
            if not isinstance(imgs, tuple):
                imgs = (imgs,)
        lr_img, hr_img = self.transforms(*imgs)
        return {"lr_img": lr_img, "hr_img": hr_img, "index": index}


class _SequenceDataset(_SRDatasetMixin):
    """Shared sequence indexing for MISR/VSR over the ``videos`` tree."""

    default_temporal_order = "middle"

    def __init__(self, num_frames: int = 5, temporal_order: str | None = None, **kwargs: Any):
        super().__init__(**kwargs)
        self.num_frames = num_frames
        temporal_order = temporal_order or self.default_temporal_order
        if temporal_order not in ("last", "middle"):
            raise ValueError(
                f"The temporal order should be 'last' or 'middle'. Got {temporal_order}."
            )
        self.temporal_order = temporal_order
        lr_root = self.data_dir / self.type / "LR" / f"X{self.downscale_factor}"
        hr_root = self.data_dir / self.type / "HR"
        self.lr_paths = sorted(lr_root.glob("**/*2d+1d*.nii.gz"))
        self.hr_paths = sorted(hr_root.glob("**/*2d+1d*.nii.gz"))
        if len(self.lr_paths) != len(self.hr_paths):
            raise ValueError(
                f"LR/HR count mismatch: {len(self.lr_paths)} vs {len(self.hr_paths)}"
            )

    def _index_windows(self) -> list[tuple[int, int]]:
        """(sequence index, frame t) pairs over all sequences."""
        out = []
        for i, lr_path in enumerate(self.lr_paths):
            T = _nifti_shape(lr_path)[-1]
            if self.num_frames > T + 1:
                # The circular wrap covers at most one extra lap; beyond that numpy slice
                # clamping silently yields SHORT windows that crash collate
                # mid-epoch — reject up front with the offending file.
                raise ValueError(
                    f"num_frames={self.num_frames} exceeds sequence length "
                    f"{T}+1 of {lr_path.name}")
            out.extend((i, t) for t in range(T))
        return out

    def _load_window(
        self, seq_index: int, t: int, rng: np.random.Generator | None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Returns (lr_window, hr_window) as (T, H, W, C) stacks after
        augmentation/transforms."""
        lr_seq = self._load(self.lr_paths[seq_index])  # (h, w, C, T)
        hr_seq = self._load(self.hr_paths[seq_index])
        lr_win = extract_window(lr_seq, t, self.num_frames, self.temporal_order)
        hr_win = extract_window(hr_seq, t, self.num_frames, self.temporal_order)
        return self._augment_and_stack(lr_win, hr_win, rng)

    def _augment_and_stack(
        self, lr_seq: np.ndarray, hr_seq: np.ndarray, rng: np.random.Generator | None
    ) -> tuple[np.ndarray, np.ndarray]:
        n = lr_seq.shape[-1]
        imgs = tuple(lr_seq[..., t] for t in range(n)) + tuple(hr_seq[..., t] for t in range(n))
        if self.type == "train":
            imgs = self.augments(*imgs, rng=rng)
        imgs = self.transforms(*imgs)
        lr = np.stack(imgs[: len(imgs) // 2], axis=0)  # (T, h, w, C)
        hr = np.stack(imgs[len(imgs) // 2 :], axis=0)  # (T, H, W, C)
        return lr, hr


@register("dataset")
class AcdcMISRDataset(_SequenceDataset):
    """Multi-image SR: window of N LR frames -> center/last HR frame."""

    default_temporal_order = "middle"

    def __init__(self, **kwargs: Any):
        super().__init__(**kwargs)
        self.data = self._index_windows()

    def __len__(self) -> int:
        return len(self.data)

    def sample_name(self, index: int):
        seq_index, t = self.data[index]
        patient, slice_id, _ = parse_sample_name(self.lr_paths[seq_index])
        return patient, slice_id, f"{t + 1:0>2d}"

    def __getitem__(self, index: int, rng: np.random.Generator | None = None) -> dict:
        seq_index, t = self.data[index]
        lr, hr = self._load_window(seq_index, t, rng)
        hr_img = hr[misr_target_index(self.num_frames)]
        return {"lr_imgs": lr, "hr_img": hr_img, "index": index}


@register("dataset")
class AcdcVSRDataset(_SequenceDataset):
    """Video SR: train on windows, validate/test on whole sequences."""

    default_temporal_order = "last"

    def __init__(self, **kwargs: Any):
        super().__init__(**kwargs)
        if self.type == "train":
            self.data = self._index_windows()
        else:
            self.data = list(range(len(self.lr_paths)))

    def __len__(self) -> int:
        return len(self.data)

    def sample_name(self, index: int):
        seq_index = self.data[index][0] if self.type == "train" else self.data[index]
        patient, slice_id, _ = parse_sample_name(self.lr_paths[seq_index])
        return patient, slice_id, None

    def __getitem__(self, index: int, rng: np.random.Generator | None = None) -> dict:
        if self.type == "train":
            seq_index, t = self.data[index]
            lr, hr = self._load_window(seq_index, t, rng)
        else:
            seq_index = self.data[index]
            lr_seq = self._load(self.lr_paths[seq_index])
            hr_seq = self._load(self.hr_paths[seq_index])
            lr, hr = self._augment_and_stack(lr_seq, hr_seq, rng)
        return {"lr_imgs": lr, "hr_imgs": hr, "index": index}


# DSB15 variants: identical behavior, distinct registry names.
@register("dataset")
class Dsb15SISRDataset(AcdcSISRDataset):
    pass


@register("dataset")
class Dsb15MISRDataset(AcdcMISRDataset):
    pass


@register("dataset")
class Dsb15VSRDataset(AcdcVSRDataset):
    pass
