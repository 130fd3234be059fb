"""Checkpoints of the port: ``torch.save`` of plain dicts.

A file holds ``{"format": "vsr_tpu_torch-v1", "net": state_dict,
"optimizer": state_dict, "aux": {...}}`` and, when the trainer ran a
gradient chain with a knob set, ``"chain"``: the accumulator and its
micro-step, and the parameter EMA keyed by parameter name
(``optim.GradientChain.state_dict``). Tensors, numbers, strings, lists
and dicts only, so it loads with ``weights_only=True``. It is written to a
``.tmp`` beside the target and renamed, so a reader never sees half a file.
The trainer's ``aux`` carries ``epoch``, ``monitor``, ``lr_scheduler``,
``random_seed`` and, after a preemption, ``mid_epoch``; file names are the
JAX package's (``model_{epoch}.ckpt``, ``model_best.ckpt``,
``model_preempt.ckpt``).

A checkpoint of ``vsr_tpu`` (one flax msgpack file, ``{"state": {"params":
variables, "opt_state": ...}, "aux": {...}}``) is read by
:func:`load_flax_checkpoint`. Serving and testing take either kind through
:func:`load_net_weights`, which tells them apart by their first bytes.
Resuming training reads the port's own format only: optax's state tree is
not the port's optimizer state. Either kind serves its parameter EMA
(``load_net_weights(..., ema=True)``, ``infer --ema``): the port's from
``"chain"``, a flax one from the ``{inner_opt_state, ema}`` tree of its
``opt_state`` (``optim.find_ema``).
"""

from __future__ import annotations

import os
import pickle
import struct
from pathlib import Path
from typing import Any, Mapping

import torch
from torch import nn

from vsr_tpu_torch.utils import msgpack as flax_msgpack

FORMAT = "vsr_tpu_torch-v1"
_ZIP_MAGIC = b"PK\x03\x04"  # torch.save writes a zip archive


def save_checkpoint(path: str | Path, state: Mapping[str, Any],
                    aux: Mapping[str, Any] | None = None) -> None:
    """``state``: ``{"net": state_dict, "optimizer": state_dict or None,
    "chain": the gradient chain's state or None}``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {"format": FORMAT, "net": state["net"],
               "optimizer": state.get("optimizer"), "aux": dict(aux or {})}
    if state.get("chain") is not None:
        payload["chain"] = state["chain"]
    tmp = path.with_name(path.name + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str | Path,
                    map_location: torch.device | str = "cpu"
                    ) -> tuple[dict[str, Any], dict[str, Any]]:
    """Returns ``(state, aux)`` of a checkpoint of the port's own format;
    raises ``ValueError`` for any other file, naming what was met."""
    path = Path(path)
    if not is_port_checkpoint(path):
        raise ValueError(
            f"{path} is not a checkpoint of the port's format ({FORMAT}): it "
            "is no torch file. It looks like a flax msgpack checkpoint of "
            "vsr_tpu: serving and --test read it (load_net_weights), resuming "
            "training from it is refused (optax's state is not the port's "
            "optimizer state)")
    try:
        payload = torch.load(path, map_location=map_location, weights_only=True)
    except (pickle.UnpicklingError, RuntimeError) as err:
        raise ValueError(
            f"{path} is a zip archive but not a {FORMAT} checkpoint "
            f"({type(err).__name__}: {err})") from err
    if not isinstance(payload, dict) or payload.get("format") != FORMAT:
        raise ValueError(f"{path} is a torch file but not a {FORMAT} "
                         "checkpoint")
    return ({"net": payload["net"], "optimizer": payload["optimizer"],
             "chain": payload.get("chain")}, payload["aux"])


def is_port_checkpoint(path: str | Path) -> bool:
    """True for a file that starts as ``torch.save`` writes (a zip)."""
    with open(path, "rb") as f:
        return f.read(4) == _ZIP_MAGIC


def load_flax_checkpoint(path: str | Path) -> tuple[dict[str, Any],
                                                      dict[str, Any]]:
    """``(state, aux)`` of a checkpoint that ``vsr_tpu.utils.checkpoint.
    save_checkpoint`` wrote (the counterpart of its ``load_checkpoint``
    without a template): ``state["params"]`` is the net's flax variables
    (``params`` and, for the BatchNorm nets, ``batch_stats``), leaves as
    numpy arrays (bfloat16 ones as ``torch.bfloat16`` tensors). A sharded
    checkpoint is refused."""
    path = Path(path)
    try:
        payload = flax_msgpack.restore(path.read_bytes())
    except (ValueError, struct.error, UnicodeDecodeError) as err:
        raise ValueError(f"{path} is neither a {FORMAT} checkpoint nor a "
                         f"flax msgpack checkpoint ({err})") from err
    if isinstance(payload, dict) and payload.get("format") == "sharded-v1":
        raise ValueError(
            f"{path} is a sharded flax checkpoint (per-process shard files), "
            "which vsr_tpu_torch does not read: consolidate it first with "
            "python -m vsr_tpu.convert --consolidate <ckpt> <out.ckpt>")
    if not (isinstance(payload, dict) and isinstance(payload.get("state"), dict)
            and isinstance(payload["state"].get("params"), dict)):
        raise ValueError(f"{path} is a flax msgpack file but not a vsr_tpu "
                         "checkpoint: it holds no state['params']")
    return payload["state"], payload.get("aux", {})


def load_net_weights(net: nn.Module, path: str | Path,
                     map_location: torch.device | str = "cpu",
                     ema: bool = False) -> dict[str, Any]:
    """Fill ``net`` from a checkpoint of either kind (strict) and return its
    ``aux``: the port's own through ``load_state_dict``, a flax one through
    ``interop.load_jax_params``. ``ema``: the parameters are the EMA the
    trainer tracked (the buffers, BatchNorm's statistics, are the
    checkpoint's); a checkpoint without one raises."""
    from vsr_tpu_torch.optim import find_ema

    missing = (f"--ema: {path} carries no EMA params — train with "
               "trainer.kwargs.ema_decay to track one")
    if is_port_checkpoint(path):
        state, aux = load_checkpoint(path, map_location=map_location)
        weights = dict(state["net"])
        if ema:
            if not (state["chain"] or {}).get("ema"):
                raise ValueError(missing)
            weights.update(state["chain"]["ema"])
        net.load_state_dict(weights, strict=True)
        return aux
    from vsr_tpu_torch.interop import load_jax_params

    state, aux = load_flax_checkpoint(path)
    variables = state["params"]
    if ema:
        tree = find_ema(state.get("opt_state"))
        if tree is None:
            raise ValueError(missing)
        variables = {**variables, "params": tree}
    load_jax_params(net, variables)
    return aux
