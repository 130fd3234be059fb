"""ACDC offline preprocessing CLI (port of ``vsr_tpu/preprocess/acdc.py``).

8:2 train/valid split of ``training/**/*4d.nii.gz`` with the
Mersenne-Twister shuffle seeded by the string ``'vsr'`` (stdlib ``random``:
the JAX package's and the reference's split exactly), ``testing/**`` as
test, then per-volume intensity prep and k-space LR simulation at x2/x3/x4
(``preprocess/pipeline.py``).

Usage: ``python -m vsr_tpu_torch.preprocess.acdc <data_dir> <output_dir>
[--backend torch|numpy] [--device cuda|cpu]``
"""

from __future__ import annotations

import argparse
import logging
import random
import time
from pathlib import Path

from vsr_tpu_torch.io.nifti import load_nifti
from vsr_tpu_torch.preprocess.pipeline import (
    PreprocessStats,
    SequenceWriter,
    add_cli_arguments,
    check_backend,
    log_stats,
    log_timings,
    process_acdc_volume,
)


def split_paths(data_dir: Path) -> dict[str, list[Path]]:
    paths = sorted((data_dir / "training").glob("**/*4d.nii.gz"))
    random.seed("vsr")  # The reference's split (its acdc_preprocess.py).
    shuffled = list(paths)
    random.shuffle(shuffled)
    train_paths = sorted(shuffled[: int(len(shuffled) * 0.8)])
    valid_paths = sorted(set(paths) - set(train_paths))
    test_paths = sorted((data_dir / "testing").glob("**/*4d.nii.gz"))
    return {"train": train_paths, "valid": valid_paths, "test": test_paths}


def run(data_dir: Path, output_dir: Path, backend: str = "torch",
        device: str = "cuda", writer: SequenceWriter | None = None
        ) -> dict[str, PreprocessStats]:
    """Process every split; returns each split's statistics (which it also
    logs). ``writer`` writes the files and records where the time went
    (a new one when not given); the run closes it."""
    check_backend(backend, device)
    all_stats = {}
    with writer or SequenceWriter() as writer:
        for type_, paths in split_paths(data_dir).items():
            logging.info(f"Process the {type_} data.")
            stats = PreprocessStats()
            for path in paths:
                patient_name = path.parts[-2]
                logging.info(f"Process {patient_name}.")
                data = load_nifti(path)  # (H, W, D, T)
                process_acdc_volume(output_dir, type_, patient_name, data,
                                    stats, backend=backend, device=device,
                                    writer=writer)
            log_stats(type_, stats)
            all_stats[type_] = stats
    return all_stats


def main(argv: list[str] | None = None) -> None:
    logging.basicConfig(
        format="%(asctime)s | %(levelname)s | %(message)s",
        level=logging.INFO,
        datefmt="%Y-%m-%d %H:%M:%S",
    )
    parser = argparse.ArgumentParser(description="ACDC data preprocessing.")
    parser.add_argument("data_dir", type=Path)
    parser.add_argument("output_dir", type=Path)
    add_cli_arguments(parser)
    args = parser.parse_args(argv)
    writer, t0 = SequenceWriter(), time.perf_counter()
    run(args.data_dir, args.output_dir, backend=args.backend,
        device=args.device, writer=writer)
    log_timings(writer, time.perf_counter() - t0)


if __name__ == "__main__":
    main()
