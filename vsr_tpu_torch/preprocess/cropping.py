"""Cardiac ROI detection and cropping (port of
``vsr_tpu/preprocess/cropping.py``).

A motion-based heart bounding box found from the difference of the first
and the middle frame of the first sequence of each patient, then a cropped
GIF per sequence and a pickled ``{patient: (h0, hn, w0, wn)}`` map, which
the Cardiac* metrics read (``coordinates_path`` in the test configs). The
GIFs go through the port's own writer (``utils/gif.write_gif``); they
decode to the same frames as the JAX package's imageio GIFs.

Usage: ``python -m vsr_tpu_torch.preprocess.cropping <videos/<type>/HR>
<output_dir>``; run it once per split into one output directory and the
map holds every patient.
"""

from __future__ import annotations

import argparse
import logging
import pickle
from pathlib import Path

import numpy as np

from vsr_tpu_torch.io.nifti import load_nifti
from vsr_tpu_torch.preprocess.imageops import (
    binary_close,
    binary_open,
    gaussian_blur5,
    otsu_threshold,
)
from vsr_tpu_torch.utils.gif import write_gif


def find_bbox(data: np.ndarray) -> tuple[int, int, int, int]:
    """Heart bbox of a (H, W, C, T) sequence.

    The reference's chain: blur frame 0 and frame T//2, absdiff, Otsu,
    close+open (5x5 rect), positional 5%-95% trim of the active coordinates
    *in row-major order* (a reference quirk kept on purpose: the column
    coordinates are trimmed by position, not by value), bbox = mean +/-
    2.5*std of the surviving coordinates.
    """
    hmax, wmax, _, num_frames = data.shape
    img1 = data[..., 0].squeeze()
    img2 = data[..., num_frames // 2].squeeze()

    diff = np.abs(gaussian_blur5(img1) - gaussian_blur5(img2)).astype(np.uint8)
    thresh = otsu_threshold(diff)
    mask = (diff > thresh).astype(np.uint8)
    opened = binary_open(binary_close(mask))

    xsets, ysets = np.where(opened)
    xsets = xsets[int(len(xsets) * 0.05) : int(len(xsets) * 0.95)]
    ysets = ysets[int(len(ysets) * 0.05) : int(len(ysets) * 0.95)]
    if len(xsets) == 0 or len(ysets) == 0:
        # No motion detected (e.g. identical frames): fall back to the full
        # frame instead of propagating NaN statistics.
        return 0, hmax, 0, wmax

    height = int(np.std(xsets).round() * 5)
    width = int(np.std(ysets).round() * 5)
    hc, wc = int(np.mean(xsets).round()), int(np.mean(ysets).round())
    h0, hn = max(0, hc - height // 2), min(hc + (height - height // 2), hmax)
    w0, wn = max(0, wc - width // 2), min(wc + (width - width // 2), wmax)
    return h0, hn, w0, wn


def dump_video(path: Path, imgs: list[np.ndarray]) -> None:
    write_gif(path, imgs)


def run(data_dir: Path, output_dir: Path) -> dict[str, tuple[int, int, int, int]]:
    """Process every patient directory under ``data_dir`` (a ``videos/<type>/HR``
    tree) and write cropped GIFs + ``coordinates.pkl`` under ``output_dir``.

    An existing ``coordinates.pkl`` in ``output_dir`` is MERGED into (run the
    CLI once per split — valid, test — into one output dir and the Cardiac
    metrics see every patient)."""
    coordinates: dict[str, tuple[int, int, int, int]] = {}
    existing = Path(output_dir) / "coordinates.pkl"
    if existing.exists():
        with open(existing, "rb") as f:
            coordinates.update(pickle.load(f))
    patient_dirs = sorted(d for d in data_dir.iterdir() if d.is_dir())
    for patient_dir in patient_dirs:
        patient_name = patient_dir.parts[-1]
        logging.info(f"Process {patient_name}.")
        videos_dir = output_dir / patient_name
        videos_dir.mkdir(parents=True, exist_ok=True)

        data_paths = sorted(patient_dir.glob("**/*2d+1d*.nii.gz"))
        data = load_nifti(data_paths[0])
        h0, hn, w0, wn = find_bbox(data)
        coordinates[patient_name] = (h0, hn, w0, wn)
        for data_path in data_paths:
            seq = load_nifti(data_path).squeeze().transpose([2, 0, 1]).astype(np.uint8)
            imgs = [img[h0:hn, w0:wn] for img in seq]
            dump_video(videos_dir / data_path.parts[-1].replace(".nii.gz", ".gif"), imgs)

    with open(output_dir / "coordinates.pkl", "wb") as f:
        pickle.dump(coordinates, f)
    return coordinates


def main(argv: list[str] | None = None) -> None:
    logging.basicConfig(
        format="%(asctime)s | %(levelname)s | %(message)s",
        level=logging.INFO,
        datefmt="%Y-%m-%d %H:%M:%S",
    )
    parser = argparse.ArgumentParser(description="Cardiac ROI cropping.")
    parser.add_argument("data_dir", type=Path, help="HR videos directory (videos/<type>/HR).")
    parser.add_argument("output_dir", type=Path, help="Output directory.")
    args = parser.parse_args(argv)
    args.output_dir.mkdir(parents=True, exist_ok=True)
    run(args.data_dir, args.output_dir)


if __name__ == "__main__":
    main()
