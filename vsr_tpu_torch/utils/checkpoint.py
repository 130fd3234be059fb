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

:class:`AsyncCheckpointWriter` takes the write off the train loop
(``trainer.kwargs.async_ckpt``): an on-device snapshot now, the host copy
and the file write on a writer thread; its files equal synchronous saves.
"""

from __future__ import annotations

import copy
import os
import pickle
import queue
import struct
import threading
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


def _map_tensors(fn, obj: Any) -> Any:
    """A copy of a state nest with ``fn`` applied to every tensor: dicts
    (an ``OrderedDict``'s ``_metadata`` kept), lists and tuples rebuilt,
    anything else deep-copied."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        out = type(obj)((k, _map_tensors(fn, v)) for k, v in obj.items())
        if hasattr(obj, "_metadata"):
            out._metadata = copy.deepcopy(obj._metadata)
        return out
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(fn, v) for v in obj)
    return copy.deepcopy(obj)


class AsyncCheckpointWriter:
    """Checkpoint writes that overlap training (port of ``vsr_tpu``'s).

    ``submit()`` snapshots the state without waiting for a device-to-host
    copy: every tensor is cloned on its own device, on the current stream,
    so the snapshot is ordered before the next step's in-place optimizer
    update or graph replay (torch optimizers update parameters in place),
    and a CUDA event is recorded after the clones; ``aux`` is deep-copied.
    One writer thread waits for that event, copies the snapshot to the host
    and writes it through :func:`save_checkpoint`'s atomic tmp + rename, so
    writes land in submit order and a later ``model_best.ckpt`` always
    wins. At most 2 jobs wait in the queue (each pins a full snapshot in
    device memory): ``submit`` blocks beyond that. A worker's error is
    raised again at the next ``submit()`` / ``wait()``. Call ``wait()``
    before reading a just-submitted file or exiting the process. A
    snapshot inside a CUDA graph capture is refused: the clones would be
    recorded into the graph, not run."""

    def __init__(self) -> None:
        self._queue: queue.Queue = queue.Queue(maxsize=2)
        self._errors: list[BaseException] = []
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None

    def submit(self, path: str | Path, state: Mapping[str, Any],
               aux: Mapping[str, Any] | None = None) -> None:
        """Snapshot ``state`` (on-device copies) and queue its write;
        raises any error of an earlier write."""
        self._raise_pending()
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("an async checkpoint snapshot cannot be taken "
                               "inside a CUDA graph capture")
        snapshot = _map_tensors(lambda t: t.detach().clone(), state)
        event = None
        if torch.cuda.is_initialized():  # orders the clones for the writer
            event = torch.cuda.Event()
            event.record()
        self._ensure_thread()
        self._queue.put((Path(path), snapshot, copy.deepcopy(dict(aux or {})),
                         event))

    def wait(self) -> None:
        """Block until every submitted write has landed; re-raise errors."""
        self._queue.join()
        self._raise_pending()

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._worker, name="vsr-ckpt-writer", daemon=True)
            self._thread.start()

    def _worker(self) -> None:
        while True:
            path, snapshot, aux, event = self._queue.get()
            try:
                if event is not None:
                    event.synchronize()
                save_checkpoint(path, _map_tensors(torch.Tensor.cpu,
                                                   snapshot), aux)
            except BaseException as e:  # surfaced at the next submit / wait
                with self._lock:
                    self._errors.append(e)
            finally:
                del snapshot
                self._queue.task_done()

    def _raise_pending(self) -> None:
        with self._lock:
            if self._errors:
                err = self._errors[0]
                self._errors.clear()
                raise RuntimeError(
                    "async checkpoint write failed (earlier submit)") from err


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
