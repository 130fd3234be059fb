"""Checkpoints of the port: ``torch.save`` of plain dicts.

A file holds ``{"format": "vsr_tpu_torch-v1", "net": state_dict,
"optimizer": state_dict, "aux": {...}}``: tensors, numbers, strings, lists
and dicts only, so it loads with ``weights_only=True``. It is written to a
``.tmp`` beside the target and renamed, so a reader never sees half a file.
The trainer's ``aux`` carries ``epoch``, ``monitor``, ``lr_scheduler``,
``random_seed`` and, after a preemption, ``mid_epoch``; file names are the
JAX package's (``model_{epoch}.ckpt``, ``model_best.ckpt``,
``model_preempt.ckpt``). A flax msgpack checkpoint is not read.
"""

from __future__ import annotations

import os
import pickle
from pathlib import Path
from typing import Any, Mapping

import torch

FORMAT = "vsr_tpu_torch-v1"


def save_checkpoint(path: str | Path, state: Mapping[str, Any],
                    aux: Mapping[str, Any] | None = None) -> None:
    """``state``: ``{"net": state_dict, "optimizer": state_dict or None}``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {"format": FORMAT, "net": state["net"],
               "optimizer": state.get("optimizer"), "aux": dict(aux or {})}
    tmp = path.with_name(path.name + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str | Path,
                    map_location: torch.device | str = "cpu"
                    ) -> tuple[dict[str, Any], dict[str, Any]]:
    """Returns ``(state, aux)`` of a checkpoint of the port's own format;
    raises ``ValueError`` for any other file, naming what was met."""
    path = Path(path)
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic != b"PK\x03\x04":  # torch.save writes a zip archive
        raise ValueError(
            f"{path} is not a checkpoint of the port's format ({FORMAT}): it "
            "is no torch file. It looks like a flax msgpack checkpoint of "
            "vsr_tpu, which vsr_tpu_torch does not read")
    try:
        payload = torch.load(path, map_location=map_location, weights_only=True)
    except (pickle.UnpicklingError, RuntimeError) as err:
        raise ValueError(
            f"{path} is a zip archive but not a {FORMAT} checkpoint "
            f"({type(err).__name__}: {err})") from err
    if not isinstance(payload, dict) or payload.get("format") != FORMAT:
        raise ValueError(f"{path} is a torch file but not a {FORMAT} "
                         "checkpoint")
    return ({"net": payload["net"], "optimizer": payload["optimizer"]},
            payload["aux"])
