"""DSB15 offline preprocessing CLI (port of ``vsr_tpu/preprocess/dsb15.py``).

Walks the already-split ``train/valid/test`` trees of converted NIfTI
sequences (``python -m vsr_tpu_torch.io.dicom`` writes them), skips
malformed series (not (H, W, 1, T >= 30)), and emits the same HR/LR
imgs + videos trees as the ACDC CLI (``preprocess/pipeline.py``).

Usage: ``python -m vsr_tpu_torch.preprocess.dsb15 <data_dir> <output_dir>
[--backend torch|numpy] [--device cuda|cpu]``
"""

from __future__ import annotations

import argparse
import logging
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
    process_dsb15_sequence,
)


def run(data_dir: Path, output_dir: Path, backend: str = "torch",
        device: str = "cuda", writer: SequenceWriter | None = None
        ) -> dict[str, PreprocessStats]:
    """Process every split; returns each split's statistics (which it also
    logs). A skipped series keeps its place in the sequence numbering.
    ``writer`` writes the files and records where the time went (a new
    one when not given); the run closes it."""
    check_backend(backend, device)
    all_stats = {}
    with writer or SequenceWriter() as writer:
        for type_ in ["train", "valid", "test"]:
            paths = sorted(d for d in (data_dir / type_).iterdir() if d.is_dir())
            logging.info(f"Process the {type_} data.")
            stats = PreprocessStats()
            for path in paths:
                patient_name = path.parts[-1]
                logging.info(f"Process {patient_name}.")
                sequence_paths = sorted(path.glob("*/*.nii.gz"))
                for j, sequence_path in enumerate(sequence_paths):
                    data = load_nifti(sequence_path)  # (H, W, 1, T)
                    process_dsb15_sequence(
                        output_dir, type_, patient_name, j + 1, data, stats,
                        backend=backend, device=device, writer=writer)
            log_stats(type_, stats)
            all_stats[type_] = stats
    return all_stats


def main(argv: list[str] | None = None) -> None:
    logging.basicConfig(
        format="%(asctime)s | %(levelname)s | %(message)s",
        level=logging.INFO,
        datefmt="%Y-%m-%d %H:%M:%S",
    )
    parser = argparse.ArgumentParser(description="DSB15 data preprocessing.")
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
