"""Shared offline-preprocessing pipeline for ACDC and DSB15 (port of
``vsr_tpu/preprocess/pipeline.py``).

Produces the exact on-disk tree of the JAX package (and of the reference
it reproduces), with the same file names::

    <out>/imgs/<type>/HR/<patient>/<patient>_2d_sliceSS_frameFF.nii.gz
    <out>/imgs/<type>/LR/X<f>/<patient>/...
    <out>/videos/<type>/HR/<patient>/<patient>_2d+1d_sequenceSS.nii.gz
    <out>/videos/<type>/LR/X<f>/<patient>/...

Two degradation backends:

- ``torch``, the default: the counterpart of the JAX package's ``jax``
  backend (whose default is ``numpy``; the port's entry points run on the
  card unless the caller asks otherwise). All T
  frames of a sequence go to the device in one ``kspace_downscale_torch``
  call per factor (float32 matmuls, TF32 off for the call), on ``cuda``
  unless the caller passes ``device="cpu"``; without a card it raises,
  it never falls back to numpy. Differences from numpy are confined to
  values on a .5 rounding boundary.
- ``numpy``: float64, reference parity, asked for by name; its files are
  byte-equal to the JAX package's numpy backend.

Files are written through :class:`SequenceWriter`, a ``NiftiWriter`` thread
pool that also records where a run's wall time went.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from vsr_tpu_torch.io.nifti import NiftiWriter
from vsr_tpu_torch.preprocess.intensity import (
    RunningMoments,
    center_crop_multiple,
    clip_outliers_minmax,
)
from vsr_tpu_torch.preprocess.kspace import (kspace_downscale,
                                             kspace_downscale_torch)

DOWNSCALE_FACTORS = (2, 3, 4)
BACKENDS = ("numpy", "torch")


@dataclass
class PreprocessStats:
    moments: RunningMoments = field(default_factory=RunningMoments)

    @property
    def mean(self) -> float:
        return self.moments.mean

    @property
    def std(self) -> float:
        return self.moments.std


class SequenceWriter(NiftiWriter):
    """The preprocessing runs' :class:`NiftiWriter`: it also counts the HR
    frames written and the seconds in the downscale calls (the device's
    result copied back included). Its ``wait_seconds`` is what the NIfTI
    writes added to the wall time: the pool writes while the next sequence
    is read and downscaled."""

    def __init__(self):
        super().__init__()
        self.hr_frames = 0
        self.downscale_seconds = 0.0

    def timings(self, wall_seconds: float) -> dict:
        return {"hr_frames": self.hr_frames, "wall_seconds": wall_seconds,
                "downscale_seconds": self.downscale_seconds,
                "write_wait_seconds": self.wait_seconds,
                "hr_frames_per_sec": self.hr_frames / wall_seconds
                if wall_seconds else 0.0}


def _downscale_sequence_numpy(hr_video: np.ndarray, factor: int) -> np.ndarray:
    """(H, W, C, T) -> (H/f, W/f, C, T), reference-parity float64 path."""
    frames = [kspace_downscale(hr_video[..., t], factor) for t in range(hr_video.shape[-1])]
    return np.stack(frames, axis=-1)


def _require_device(device: str | torch.device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the torch backend runs on the card and no CUDA device is "
            "present: pass device='cpu' (--device cpu) or use the numpy "
            "backend")
    return device


def _downscale_sequence_torch(hr_video: np.ndarray, factor: int,
                              device: str | torch.device) -> np.ndarray:
    """Batched on-device path: the T frames in one call."""
    device = _require_device(device)
    frames = np.ascontiguousarray(np.moveaxis(hr_video[:, :, 0, :], -1, 0),
                                  dtype=np.float32)  # (T, H, W)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        lr = kspace_downscale_torch(torch.from_numpy(frames).to(device),
                                    factor).cpu().numpy()  # (T, H/f, W/f)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return np.moveaxis(lr, 0, -1)[:, :, None, :].astype(np.float32)


def downscale_sequence(hr_video: np.ndarray, factor: int, backend: str = "torch",
                       device: str | torch.device = "cuda") -> np.ndarray:
    """``device``: where the torch backend runs (the numpy one ignores it)."""
    if backend == "numpy":
        return _downscale_sequence_numpy(hr_video, factor).astype(np.float32)
    if backend == "torch":
        return _downscale_sequence_torch(hr_video, factor, device)
    raise ValueError(f"Unknown backend {backend!r} (use 'numpy' or 'torch')")


def prepare_volume(data: np.ndarray) -> np.ndarray:
    """Outlier clip + min-max (int16 only) and /12 center crop, float32."""
    data = clip_outliers_minmax(data)
    h0, hn, w0, wn = center_crop_multiple(data.shape[:2])
    return data[h0:hn, w0:wn]


def write_sequence(
    output_dir: Path,
    type_: str,
    patient_name: str,
    seq_index: int,
    hr_video: np.ndarray,
    backend: str = "torch",
    factors: tuple[int, ...] = DOWNSCALE_FACTORS,
    device: str | torch.device = "cuda",
    writer: SequenceWriter | None = None,
) -> None:
    """Emit HR + all LR factors for one (H, W, 1, T) sequence (through
    ``writer``; a writer of its own without one)."""
    if writer is None:
        with SequenceWriter() as inline:
            return write_sequence(output_dir, type_, patient_name, seq_index,
                                  hr_video, backend, factors, device, inline)
    seq_tag = f"{seq_index:0>2d}"
    hr_imgs_dir = output_dir / "imgs" / type_ / "HR" / patient_name
    hr_videos_dir = output_dir / "videos" / type_ / "HR" / patient_name
    writer.save(hr_video, hr_videos_dir / f"{patient_name}_2d+1d_sequence{seq_tag}.nii.gz")
    for t in range(hr_video.shape[-1]):
        writer.save(
            hr_video[..., t],
            hr_imgs_dir / f"{patient_name}_2d_slice{seq_tag}_frame{t + 1:0>2d}.nii.gz",
        )
    writer.hr_frames += hr_video.shape[-1]

    for factor in factors:
        lr_imgs_dir = output_dir / "imgs" / type_ / "LR" / f"X{factor}" / patient_name
        lr_videos_dir = output_dir / "videos" / type_ / "LR" / f"X{factor}" / patient_name
        t0 = time.perf_counter()
        lr_video = downscale_sequence(hr_video, factor, backend=backend,
                                      device=device)
        writer.downscale_seconds += time.perf_counter() - t0
        writer.save(lr_video, lr_videos_dir / f"{patient_name}_2d+1d_sequence{seq_tag}.nii.gz")
        for t in range(lr_video.shape[-1]):
            writer.save(
                lr_video[..., t],
                lr_imgs_dir / f"{patient_name}_2d_slice{seq_tag}_frame{t + 1:0>2d}.nii.gz",
            )


def process_acdc_volume(
    output_dir: Path,
    type_: str,
    patient_name: str,
    data: np.ndarray,
    stats: PreprocessStats,
    backend: str = "torch",
    device: str | torch.device = "cuda",
    writer: SequenceWriter | None = None,
) -> None:
    """One ACDC 4D volume (H, W, D, T): every depth slice becomes a sequence."""
    data = prepare_volume(data)
    stats.moments.update(data)
    for s in range(data.shape[2]):
        hr_video = data[:, :, s : s + 1, :]  # (H, W, 1, T)
        write_sequence(output_dir, type_, patient_name, s + 1, hr_video,
                       backend=backend, device=device, writer=writer)


def process_dsb15_sequence(
    output_dir: Path,
    type_: str,
    patient_name: str,
    seq_index: int,
    data: np.ndarray,
    stats: PreprocessStats,
    backend: str = "torch",
    device: str | torch.device = "cuda",
    writer: SequenceWriter | None = None,
) -> bool:
    """One DSB15 sequence NIfTI (H, W, 1, T). Returns False when skipped
    (malformed series: wrong layout or <30 frames, as the reference's
    ``dsb15_preprocess.py`` skips them)."""
    if data.ndim != 4 or data.shape[2] != 1 or data.shape[-1] < 30:
        return False
    data = prepare_volume(data)
    stats.moments.update(data)
    write_sequence(output_dir, type_, patient_name, seq_index, data,
                   backend=backend, device=device, writer=writer)
    return True


def log_stats(type_: str, stats: PreprocessStats) -> None:
    logging.info(
        f"The mean and the standard deviation of the {type_} data is "
        f"{stats.mean:.4f} and {stats.std:.4f}."
    )


def add_cli_arguments(parser) -> None:
    """The CLIs' backend and device flags. ``--backend jax`` parses and is
    refused by :func:`check_backend` with the reason."""
    parser.add_argument("--backend", choices=[*BACKENDS, "jax"],
                        default="torch",
                        help="torch (default: the k-space downscale on the "
                             "device) or numpy (float64, byte-equal to the "
                             "JAX package's numpy backend)")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="where the torch backend runs (default: cuda)")


def check_backend(backend: str, device: str | torch.device) -> None:
    """Refuses ``jax`` by name, and the torch backend on a card that is
    not there, before a run writes anything."""
    if backend == "jax":
        raise SystemExit(
            "--backend jax is the JAX package's device path and is refused "
            "by vsr_tpu_torch: use --backend torch (the same batched k-space "
            "downscale on the card)")
    if backend == "torch":
        _require_device(device)


def log_timings(writer: SequenceWriter, wall_seconds: float) -> None:
    """The run's timings as one JSON line (``Timings: {...}``)."""
    import json

    logging.info(f"Timings: {json.dumps(writer.timings(wall_seconds))}")
