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
:func:`load_flax_checkpoint`, and so is the main file of its sharded
checkpoint (``format: sharded-v1``: the main file plus one ``.shard<k>`` per
process), stitched in memory by the same code as
:func:`consolidate_sharded_checkpoint` (``python -m vsr_tpu_torch.convert
--consolidate``), which writes the flax file that ``vsr_tpu``'s
consolidation writes, byte for byte (``utils/msgpack.serialize``). Serving
and testing take either kind through :func:`load_net_weights`, which tells
them apart by their first bytes.

The port's own sharded checkpoint (``trainer.kwargs.sharded_ckpt``,
:func:`save_checkpoint_sharded`) is ``torch.save`` files too: every rank
writes only what it holds (``<path>.shard<k>``: its slices of the FSDP
leaves, the ZeRO-1 optimizer states it owns), rank 0 also the main file
(``format: vsr_tpu_torch-sharded-v1``: the replicated leaves, a manifest of
the sliced ones, the owner of each ZeRO state, ``aux``). Every file of one
save carries the same ``save_id``. :func:`load_checkpoint_sharded` restores
it at the same world size, :func:`consolidate_sharded_checkpoint` turns it
into a plain ``vsr_tpu_torch-v1`` file, and :func:`load_net_weights` serves
its main file directly.
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
import hashlib
import json
import os
import pickle
import queue
import struct
import threading
from pathlib import Path
from typing import Any, Callable, Mapping

import numpy as np
import torch
from torch import nn

from vsr_tpu_torch.utils import msgpack as flax_msgpack

FORMAT = "vsr_tpu_torch-v1"
SHARDED_FORMAT = "vsr_tpu_torch-sharded-v1"
FLAX_SHARDED_FORMAT = "sharded-v1"  # vsr_tpu's save_checkpoint_sharded
_EMPTY_NODE = "__vsr_empty_node__"  # vsr_tpu's marker of an empty dict
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
    recorded into the graph, not run. ``write_fn(path, host_state, aux)``
    replaces :func:`save_checkpoint` as the writer (a sharded trainer
    passes :func:`save_checkpoint_sharded` with its rank, as the JAX
    trainer passes its sharded writer)."""

    def __init__(self, write_fn: Callable | None = None) -> None:
        self._write_fn = write_fn or save_checkpoint
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
                self._write_fn(path, _map_tensors(torch.Tensor.cpu,
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
    if isinstance(payload, dict) and payload.get("format") == SHARDED_FORMAT:
        raise ValueError(
            f"{path} is a sharded checkpoint (per-process shard files). "
            "Restore it through a trainer with the same mesh topology, or "
            "consolidate it into a plain checkpoint first: "
            "python -m vsr_tpu_torch.convert --consolidate <ckpt> <out.ckpt>")
    if not isinstance(payload, dict) or payload.get("format") != FORMAT:
        raise ValueError(f"{path} is a torch file but not a {FORMAT} "
                         "checkpoint")
    return _state_of(payload), payload["aux"]


def _state_of(payload: dict) -> dict[str, Any]:
    return {"net": payload["net"], "optimizer": payload["optimizer"],
            "chain": payload.get("chain")}


def _torch_load(path: Path, map_location) -> Any:
    return torch.load(path, map_location=map_location, weights_only=True)


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
    numpy arrays (bfloat16 ones as ``torch.bfloat16`` tensors). The main
    file of a sharded-v1 checkpoint is stitched with its shard files in
    memory (:func:`consolidate_flax_sharded`)."""
    path = Path(path)
    try:
        payload = flax_msgpack.restore(path.read_bytes())
    except (ValueError, struct.error, UnicodeDecodeError) as err:
        raise ValueError(f"{path} is neither a {FORMAT} checkpoint nor a "
                         f"flax msgpack checkpoint ({err})") from err
    if isinstance(payload, dict) and payload.get("format") == \
            FLAX_SHARDED_FORMAT:
        state, aux = consolidate_flax_sharded(path, payload)
        payload = {"state": state, "aux": aux}
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
        state, aux = read_port_checkpoint(path, map_location)
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


# ------------------------------------------------------ sharded checkpoints


def _shard_path(path: Path, process: int) -> Path:
    return path.with_name(path.name + f".shard{process}")


def _write_atomic(path: Path, write: Callable[[Path], None]) -> None:
    """``write(tmp)`` beside ``path``, then the rename: a reader never
    sees half a file."""
    tmp = path.with_suffix(path.suffix + ".tmp")
    write(tmp)
    os.replace(tmp, path)


def _decode_index(e: dict) -> list:
    """A shard entry's ``[[start, stop], ...]`` (msgpack may restore the
    list of pairs as a dict keyed by position, as in ``vsr_tpu``)."""
    idx = e["index"]
    if isinstance(idx, dict):
        idx = [idx[k] for k in sorted(idx, key=int)]
    return [[int(a), int(b)] for a, b in idx]


def _entries(entries) -> list:
    return list(entries.values()) if isinstance(entries, dict) else entries


def _zeros(shape: tuple, dtype_name: str):
    """An empty leaf to stitch into: numpy, or a ``torch.bfloat16`` tensor
    (numpy has no bf16), as the msgpack decoder gives them."""
    if dtype_name == "bfloat16":
        return torch.zeros(shape, dtype=torch.bfloat16)
    return np.zeros(shape, dtype=np.dtype(dtype_name))


def _unflatten_flax(flat: dict) -> dict:
    """``vsr_tpu``'s ``_unflatten_state``: ``"a/b"`` keys -> nested dicts,
    the empty-node marker -> ``{}``."""
    out: dict = {}
    for key, value in flat.items():
        if isinstance(value, str) and value == _EMPTY_NODE:
            value = {}
        *parents, last = key.split("/")
        cursor = out
        for part in parents:
            cursor = cursor.setdefault(part, {})
        cursor[last] = value
    return out


def consolidate_flax_sharded(path: str | Path, payload: dict | None = None
                             ) -> tuple[dict, dict]:
    """``(state, aux)`` of a sharded-v1 checkpoint that ``vsr_tpu`` wrote
    (its main file and every ``.shard<k>``), stitched as its
    ``consolidate_sharded_checkpoint`` stitches them, with its refusals: a
    missing shard file, a shard of another save, an incomplete leaf."""
    path = Path(path)
    if payload is None:
        payload = flax_msgpack.restore(path.read_bytes())
    if payload.get("format") != FLAX_SHARDED_FORMAT:
        raise ValueError(f"{path} is not a sharded-v1 checkpoint")
    flat = dict(payload["replicated"])
    filled = {key: _zeros(tuple(meta["shape"]), meta["dtype"])
              for key, meta in payload["sharded"].items()}
    seen = {key: np.zeros(tuple(meta["shape"]), dtype=bool)
            for key, meta in payload["sharded"].items()}
    save_id = payload.get("save_id")  # absent in pre-nonce checkpoints
    for proc in range(payload["num_processes"]):
        shard_path = _shard_path(path, proc)
        if not shard_path.exists():
            raise FileNotFoundError(
                f"missing {shard_path} — consolidation needs every "
                "process's shard file")
        shard = flax_msgpack.restore(shard_path.read_bytes())
        if save_id is not None and shard.get("save_id") != save_id:
            raise ValueError(
                f"{shard_path} is from a different save than {path} "
                f"(save_id {shard.get('save_id')} != {save_id}) — a crash "
                "mid-save left mixed-epoch shard files")
        for key, entries in shard["leaves"].items():
            for e in _entries(entries):
                sl = tuple(slice(a, b) for a, b in _decode_index(e))
                filled[key][sl] = e["data"]
                seen[key][sl] = True
    for key, mask in seen.items():
        if not mask.all():
            raise ValueError(
                f"{key!r}: shard files do not cover the full array "
                f"({int(mask.sum())}/{mask.size} elements) — checkpoint "
                "is incomplete")
    flat.update(filled)
    return _unflatten_flax(flat), payload.get("aux", {})


def _flatten_flax(tree: Mapping, prefix: str = "") -> dict[str, Any]:
    """``vsr_tpu``'s ``_flatten_state``: nested dicts -> ``"a/b"`` keys, an
    empty dict -> the empty-node marker."""
    flat: dict[str, Any] = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping) and value:
            flat.update(_flatten_flax(value, name + "/"))
        else:
            flat[name] = _EMPTY_NODE if isinstance(value, Mapping) else value
    return flat


def save_flax_checkpoint_sharded(path: str | Path, state: Mapping[str, Any],
                                 aux: Mapping[str, Any] | None,
                                 blocks: Mapping[str, int], *,
                                 process: int = 0,
                                 num_processes: int = 1) -> None:
    """Write one process's part of a sharded-v1 checkpoint in ``vsr_tpu``'s
    layout (``save_checkpoint_sharded``), bytes and ``save_id`` included:
    ``state`` is a flax state nest (numpy leaves, bfloat16 ones as
    ``torch.bfloat16`` tensors); ``blocks`` maps a leaf's ``"a/b"`` key to
    the number of equal blocks its last axis is cut into, as a
    ``NamedSharding`` of that axis over a mesh of that many devices, ordered
    by process, cuts it (block ``b`` belongs to process ``b *
    num_processes // n``); every other leaf is replicated into the main
    file, which process 0 writes after its shard file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    aux = dict(aux or {})
    replicated, manifest, mine = {}, {}, {}
    for key, leaf in _flatten_flax(state).items():
        if key not in blocks:
            replicated[key] = leaf
            continue
        n, shape = blocks[key], tuple(leaf.shape)
        if shape[-1] % n:
            raise ValueError(f"{key}: last axis {shape[-1]} does not split "
                             f"into {n} blocks")
        dtype = ("bfloat16" if isinstance(leaf, torch.Tensor)
                 else leaf.dtype.name)
        manifest[key] = {"shape": list(shape), "dtype": dtype}
        size = shape[-1] // n
        mine[key] = [{"index": [[0, d] for d in shape[:-1]]
                      + [[b * size, (b + 1) * size]],
                      "data": leaf[..., b * size:(b + 1) * size]}
                     for b in range(n) if b * num_processes // n == process]
    save_id = hashlib.sha256(flax_msgpack.serialize(
        {"aux": aux, "manifest": manifest})).hexdigest()[:16]
    shard = flax_msgpack.serialize({"process": process, "save_id": save_id,
                                    "leaves": mine})
    _write_atomic(_shard_path(path, process), lambda tmp: tmp.write_bytes(shard))
    if process == 0:
        main = flax_msgpack.serialize({
            "format": FLAX_SHARDED_FORMAT, "save_id": save_id,
            "replicated": replicated, "sharded": manifest,
            "num_processes": num_processes, "aux": aux})
        _write_atomic(path, lambda tmp: tmp.write_bytes(main))


def flatten_state(state: Mapping, prefix: tuple = ()) -> dict[tuple, Any]:
    """A nest of dicts -> ``{key path tuple: leaf}``; an empty dict and any
    non-dict value are leaves."""
    flat: dict[tuple, Any] = {}
    for key, value in state.items():
        if isinstance(value, Mapping) and value:
            flat.update(flatten_state(value, prefix + (key,)))
        else:
            flat[prefix + (key,)] = value
    return flat


def unflatten_state(flat: Mapping[tuple, Any]) -> dict:
    out: dict = {}
    for key, value in flat.items():
        cursor = out
        for part in key[:-1]:
            cursor = cursor.setdefault(part, {})
        cursor[key[-1]] = value
    return out


def _derive_save_id(aux: Mapping, manifest: Mapping, owners: Mapping) -> str:
    """A nonce equal on every rank of one save and distinct between saves
    that could reuse a path (``vsr_tpu``'s ``_derive_save_id``: aux and the
    manifest are the same on every rank; the trainer writes a path at most
    once an epoch). No collective: the async writer's thread computes it."""
    blob = json.dumps({"aux": aux, "manifest": sorted(
        (list(k), v) for k, v in manifest.items()), "owners": sorted(
        (list(k), v) for k, v in owners.items())}, sort_keys=True,
        default=repr)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def save_checkpoint_sharded(path: str | Path, state: Mapping[str, Any],
                            aux: Mapping[str, Any] | None = None, *,
                            rank: int, world: int) -> None:
    """Write this rank's part of a sharded checkpoint. ``state`` is what
    ``parallel.data_parallel.DataParallel.sharded_state`` gives: the
    ``replicated`` leaves (``{key path: value}``, the same on every rank),
    the ``manifest`` of the sliced leaves (``{key path: {"shape",
    "dtype"}}``), the ``owners`` of whole subtrees (``{key path: rank}``,
    ZeRO-1's optimizer states), this rank's ``leaves`` (``{key path:
    [{"index": [[start, stop], ...], "data": tensor}]}``) and ``subtrees``
    (``{key path: the subtree it owns}``). The rank's shard file comes
    first, rank 0's main file last."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    aux = dict(aux or {})
    save_id = _derive_save_id(aux, state["manifest"], state["owners"])
    _write_atomic(_shard_path(path, rank), lambda tmp: torch.save(
        {"format": SHARDED_FORMAT + "-shard", "process": rank,
         "save_id": save_id, "leaves": state["leaves"],
         "subtrees": state["subtrees"]}, tmp))
    if rank == 0:
        _write_atomic(path, lambda tmp: torch.save(
            {"format": SHARDED_FORMAT, "save_id": save_id,
             "num_processes": world, "replicated": state["replicated"],
             "sharded": state["manifest"], "owners": state["owners"],
             "aux": aux}, tmp))


def _read_port_sharded(path: Path, payload: dict, map_location
                       ) -> tuple[dict, dict]:
    """The full state of the port's sharded checkpoint (its main file's
    ``payload`` and every shard file), with ``vsr_tpu``'s refusals."""
    save_id = payload["save_id"]
    flat = dict(payload["replicated"])
    filled = {key: torch.zeros(meta["shape"],
                               dtype=getattr(torch, meta["dtype"].split(".")[-1]))
              for key, meta in payload["sharded"].items()}
    seen = {key: torch.zeros(meta["shape"], dtype=torch.bool)
            for key, meta in payload["sharded"].items()}
    for proc in range(payload["num_processes"]):
        shard_path = _shard_path(path, proc)
        if not shard_path.exists():
            raise FileNotFoundError(
                f"missing {shard_path} — every process's shard file must be "
                "on a filesystem this process can read")
        shard = _torch_load(shard_path, "cpu")
        if shard.get("save_id") != save_id:
            raise ValueError(
                f"{shard_path} is from a different save than {path} (save_id "
                f"{shard.get('save_id')} != {save_id}) — a crash mid-save "
                "left mixed-epoch shard files; restore from an older intact "
                "checkpoint")
        for key, entries in shard["leaves"].items():
            for e in entries:
                sl = tuple(slice(a, b) for a, b in e["index"])
                filled[key][sl] = e["data"]
                seen[key][sl] = True
        for key, subtree in shard["subtrees"].items():
            if payload["owners"].get(key) != proc:
                raise ValueError(f"{shard_path} holds {key!r}, which the main "
                                 "file gives to another process")
            flat.update(flatten_state(subtree, key) if subtree
                        else {key: subtree})
    for key, mask in seen.items():
        if not bool(mask.all()):
            raise ValueError(
                f"{key!r}: shard files do not cover the full array "
                f"({int(mask.sum())}/{mask.numel()} elements) — checkpoint "
                "is incomplete")
    missing = [k for k in payload["owners"]
               if not any(f[:len(k)] == k for f in flat)]
    if missing:
        raise ValueError(f"no shard file holds {missing[0]!r} — checkpoint "
                         "is incomplete")
    flat.update(filled)
    state = unflatten_state(flat)
    if map_location is not None:
        state = _map_tensors(lambda t: t.to(map_location), state)
    return ({"net": state["net"], "optimizer": state.get("optimizer"),
             "chain": state.get("chain")}, payload["aux"])


def is_sharded_checkpoint(path: str | Path) -> bool:
    """True for the main file of a sharded checkpoint, the port's or
    ``vsr_tpu``'s."""
    path = Path(path)
    if is_port_checkpoint(path):
        payload = _torch_load(path, "cpu")
        return isinstance(payload, dict) and payload.get(
            "format") == SHARDED_FORMAT
    payload = flax_msgpack.restore(path.read_bytes())
    return isinstance(payload, dict) and payload.get(
        "format") == FLAX_SHARDED_FORMAT


def load_checkpoint_sharded(path: str | Path, world: int,
                            map_location: torch.device | str = "cpu"
                            ) -> tuple[dict[str, Any], dict[str, Any]]:
    """``(state, aux)`` of the port's sharded checkpoint, as
    :func:`load_checkpoint` gives a plain one, for a run of ``world``
    ranks: a checkpoint of another world size is refused in
    ``vsr_tpu``'s words (restore needs the same topology). Each rank reads
    every shard file and places the full state as its mesh rule says."""
    path = Path(path)
    payload = _torch_load(path, "cpu")
    if not isinstance(payload, dict) or payload.get("format") != \
            SHARDED_FORMAT:
        raise ValueError(f"{path} is not a sharded-v1 checkpoint")
    if payload["num_processes"] != world:
        raise ValueError(
            f"sharded checkpoint was written by {payload['num_processes']} "
            f"process(es) but this run has {world} — restore needs the same "
            "topology (or a gathered checkpoint)")
    return _read_port_sharded(path, payload, map_location)


def read_port_checkpoint(path: str | Path,
                         map_location: torch.device | str = "cpu"
                         ) -> tuple[dict[str, Any], dict[str, Any]]:
    """``(state, aux)`` of either of the port's formats: a plain file, or
    the main file of a sharded checkpoint stitched with its shards at any
    world size (serving and consolidation read it whole)."""
    path = Path(path)
    payload = _torch_load(path, "cpu")
    if isinstance(payload, dict) and payload.get("format") == SHARDED_FORMAT:
        return _read_port_sharded(path, payload, map_location)
    return load_checkpoint(path, map_location=map_location)


def consolidate_sharded_checkpoint(path: str | Path,
                                   out_path: str | Path) -> None:
    """Stitch a sharded checkpoint into a plain one. ``vsr_tpu``'s
    sharded-v1 files give the flax msgpack file its consolidation writes,
    byte for byte; the port's sharded files give a ``vsr_tpu_torch-v1``
    file. Anything else is refused."""
    path, out_path = Path(path), Path(out_path)
    if is_port_checkpoint(path):
        payload = _torch_load(path, "cpu")
        if not isinstance(payload, dict) or payload.get(
                "format") != SHARDED_FORMAT:
            raise ValueError(f"{path} is not a sharded-v1 checkpoint")
        state, aux = _read_port_sharded(path, payload, None)
        save_checkpoint(out_path, state, aux)
        return
    try:
        payload = flax_msgpack.restore(path.read_bytes())
    except (ValueError, struct.error, UnicodeDecodeError) as err:
        raise ValueError(f"{path} is not a sharded-v1 checkpoint "
                         f"({err})") from err
    if not isinstance(payload, dict):
        raise ValueError(f"{path} is not a sharded-v1 checkpoint")
    state, aux = consolidate_flax_sharded(path, payload)
    data = flax_msgpack.serialize({"state": state, "aux": aux or {}})
    out_path.parent.mkdir(parents=True, exist_ok=True)
    _write_atomic(out_path, lambda tmp: tmp.write_bytes(data))
