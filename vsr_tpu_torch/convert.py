"""Checkpoint conversion (port of ``vsr_tpu/convert.py``): its
``--consolidate`` mode.

    python -m vsr_tpu_torch.convert --consolidate SHARDED_CKPT OUT_CKPT

stitches a sharded checkpoint (its main file and every ``<main>.shard<k>``)
into one plain file. A sharded-v1 checkpoint that ``vsr_tpu`` wrote
(``trainer.kwargs.sharded_ckpt``) gives the flax msgpack file that
``python -m vsr_tpu.convert --consolidate`` writes, byte for byte; the
port's own sharded checkpoint gives a ``vsr_tpu_torch-v1`` file. Either
result serves through ``infer`` / ``export`` / ``serve --checkpoint`` (which
also take the sharded main files directly) and main ``--test``.

The other mode of ``vsr_tpu.convert``, importing a ``.pth`` of the
reference's own code, needs that code's net classes and is not ported: its
arguments are refused by name.
"""

from __future__ import annotations

import argparse
import logging
import sys

from vsr_tpu_torch.utils.checkpoint import consolidate_sharded_checkpoint

#: ``vsr_tpu.convert``'s arguments of the ``.pth`` import.
REFUSED = ("--config", "--torch-ckpt", "--out", "--ref-root",
           "--with-opt-template", "--import-opt")


def main(argv: list[str] | None = None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    args_in = sys.argv[1:] if argv is None else list(argv)
    for arg in args_in:
        if arg.split("=")[0] in REFUSED:
            raise NotImplementedError(
                f"convert {arg.split('=')[0]}: the import of a reference .pth "
                "is not ported to vsr_tpu_torch (it needs the reference's own "
                "net classes); only --consolidate is")
    ap = argparse.ArgumentParser(
        description="Consolidate a sharded checkpoint into a plain one.")
    ap.add_argument("--consolidate", nargs=2, required=True,
                    metavar=("SHARDED_CKPT", "OUT_CKPT"))
    a = ap.parse_args(args_in)
    consolidate_sharded_checkpoint(*a.consolidate)
    logging.info(f"Consolidated {a.consolidate[0]} -> {a.consolidate[1]}")


if __name__ == "__main__":
    main()
