"""ACDC / DSB15 datasets for the SISR / MISR / VSR / 3D / 4D task regimes
(port of ``vsr_tpu/data/datasets.py``; the tests pin every sample to the
original's).

- SISR pairs per-frame ``imgs`` NIfTIs,
- MISR/VSR window ``videos`` sequences with circular wrap-around at the
  cardiac-cycle boundary,
- VSR valid/test yields whole variable-length sequences,
- the volume datasets stack a patient's slice sequences of the ``videos``
  tree into (H, W, D, C) volumes, one per frame (3D), or into windows of
  volumes (4D; whole sequences for valid/test).

Arrays stay channels-last numpy, (H, W, C) frames, (T, H, W, C) windows,
(H, W, D, C) volumes and (T, H, W, D, C) volume windows;
``__getitem__(index, rng=...)`` takes an explicit numpy Generator for
augmentation, so samples are reproducible without global seeding. The Dsb15
classes only change the registry name. ``native_decode`` (the C++ NIfTI
decoder) is refused.
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


@register("dataset")
class AcdcVolumeDataset(_SRDatasetMixin):
    """3D volumetric SR: one sample per (patient, frame), all depth slices
    of that frame stacked into an (H, W, D, C) volume, from the ``videos``
    tree (each patient's per-slice sequences give the depth axis). The
    layout is the 4D transform convention, so ``RandomCropPatch`` crops it
    in-plane-scaled and depth-unscaled."""

    def __init__(self, **kwargs: Any):
        super().__init__(**kwargs)
        lr_root = self.data_dir / self.type / "LR" / f"X{self.downscale_factor}"
        hr_root = self.data_dir / self.type / "HR"
        # patient -> sorted per-slice sequence paths.
        self.patients: list[str] = sorted(
            p.name for p in hr_root.iterdir() if p.is_dir()
        ) if hr_root.is_dir() else []
        self.lr_seqs = {
            p: sorted((lr_root / p).glob("*2d+1d*.nii.gz")) for p in self.patients
        }
        self.hr_seqs = {
            p: sorted((hr_root / p).glob("*2d+1d*.nii.gz")) for p in self.patients
        }
        self.data: list[tuple[str, int]] = []
        for p in self.patients:
            if not self.lr_seqs[p]:
                continue
            # Stacking needs every slice sequence of a patient to share
            # (H, W, T): refuse a heterogeneous series up front.
            shapes = {_nifti_shape(q) for q in self.lr_seqs[p]}
            if len(shapes) > 1:
                raise ValueError(
                    f"Patient {p} has heterogeneous slice sequences "
                    f"{sorted(shapes)}; the volumetric datasets require "
                    f"uniform (H, W, T) per patient — exclude or resample "
                    f"this patient")
            T = _nifti_shape(self.lr_seqs[p][0])[-1]
            self.data.extend((p, t) for t in range(T))

    def __len__(self) -> int:
        return len(self.data)

    def sample_name(self, index: int):
        patient, t = self.data[index]
        return patient, "", f"{t + 1:0>2d}"

    def _stack_volume(self, paths, t: int) -> np.ndarray:
        slices = [self._load(p)[..., t] for p in paths]  # each (H, W, C)
        return np.stack(slices, axis=2)  # (H, W, D, C)

    def __getitem__(self, index: int, rng: np.random.Generator | None = None) -> dict:
        patient, t = self.data[index]
        lr_vol = self._stack_volume(self.lr_seqs[patient], t)
        hr_vol = self._stack_volume(self.hr_seqs[patient], t)
        imgs = (lr_vol, hr_vol)
        if self.type == "train":
            imgs = self.augments(*imgs, rng=rng)
        lr_vol, hr_vol = self.transforms(*imgs)
        return {"lr_vol": lr_vol, "hr_vol": hr_vol, "index": index}


@register("dataset")
class AcdcVolumeVSRDataset(AcdcVolumeDataset):
    """4D spatio-temporal SR: circular windows of ``num_frames`` volumetric
    frames for training; valid/test yields each patient's whole sequence.
    Sample = {'lr_vols': (T, h, w, D, C), 'hr_vols': (T, H, W, D, C)}."""

    def __init__(self, num_frames: int = 5, temporal_order: str = "last",
                 **kwargs: Any):
        super().__init__(**kwargs)
        if temporal_order not in ("last", "middle"):
            raise ValueError(
                f"The temporal order should be 'last' or 'middle'. Got {temporal_order}."
            )
        self.num_frames = num_frames
        self.temporal_order = temporal_order
        if self.type != "train":
            # Whole sequences: one sample per patient.
            self.data = [(p, 0) for p in self.patients if self.lr_seqs[p]]

    def _load_4d(self, seqs) -> np.ndarray:
        """Stack per-slice (H, W, 1, T) sequences -> (H, W, D, T)."""
        slices = [self._load(p)[:, :, 0, :] for p in seqs]  # (H, W, T)
        return np.stack(slices, axis=2)

    def __getitem__(self, index: int, rng: np.random.Generator | None = None) -> dict:
        patient, t = self.data[index]
        lr_4d = self._load_4d(self.lr_seqs[patient])
        hr_4d = self._load_4d(self.hr_seqs[patient])
        if self.type == "train":
            lr_4d = extract_window(lr_4d, t, self.num_frames, self.temporal_order)
            hr_4d = extract_window(hr_4d, t, self.num_frames, self.temporal_order)
        n = lr_4d.shape[-1]
        imgs = tuple(lr_4d[..., i][..., None] for i in range(n)) + tuple(
            hr_4d[..., i][..., None] for i in range(n)
        )  # 2n arrays of (H, W, D, 1)
        if self.type == "train":
            imgs = self.augments(*imgs, rng=rng)
        imgs = self.transforms(*imgs)
        lr = np.stack(imgs[: len(imgs) // 2], axis=0)  # (T, h, w, D, C)
        hr = np.stack(imgs[len(imgs) // 2 :], axis=0)
        return {"lr_vols": lr, "hr_vols": hr, "index": index}


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


@register("dataset")
class Dsb15VolumeDataset(AcdcVolumeDataset):
    pass


@register("dataset")
class Dsb15VolumeVSRDataset(AcdcVolumeVSRDataset):
    pass
