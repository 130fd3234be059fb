"""Multi-process training over ``torch.distributed`` (port of
``vsr_tpu/parallel/distributed.py``).

Each process is one rank and owns one device: ``cuda:{local_rank %
device_count}`` on the card, the CPU otherwise. The pieces:

- :func:`initialize_from_config`: called by ``vsr_tpu_torch.main`` before
  anything touches the device; reads the ``main.distributed`` config
  section with ``VSR_COORDINATOR_ADDRESS`` / ``VSR_NUM_PROCESSES`` /
  ``VSR_PROCESS_ID`` environment overrides (one YAML for every process, the
  identity from the environment). ``main.distributed: auto`` (or ``{}``)
  reads the variables that ``torchrun`` sets (``MASTER_ADDR``,
  ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``).
- The backend is a rule, never a fallback: NCCL when every rank of the host
  has a card of its own, gloo when ranks share a card (NCCL cannot run two
  ranks on one GPU), gloo on the CPU. A rank asked for the card never moves
  to the CPU: without a card it raises. Each rank logs its backend and
  device.
- :func:`process_shard` / :func:`host_shard_len` and the loader's
  ``host_shard=True``: each rank reads only its block of every global
  batch. :func:`mesh_process_blocks` is this rank's block along each axis.
- :func:`gather_sharded`: the full tensors of a state whose leaves may be
  sharded (FSDP's ``DTensor``); a collective every rank calls.

Without an initialized process group every helper is the single-process
identity, as in the JAX package.
"""

from __future__ import annotations

import datetime
import logging
import os
import sys
from typing import Any

import torch
import torch.distributed as dist

#: Seconds a rank waits for the others at initialization and in a
#: collective before it raises.
DEFAULT_TIMEOUT_S = 600

_device: torch.device | None = None  # the rank's device, set by initialize


def _env_int(name: str) -> int | None:
    value = os.environ.get(name)
    return int(value) if value is not None else None


def choose_backend(device_type: str, local_world: int,
                   device_count: int) -> str:
    """NCCL when each of the host's ``local_world`` ranks has a card of its
    own, gloo when they share the ``device_count`` cards, gloo on the CPU."""
    if device_type != "cuda":
        return "gloo"
    return "nccl" if local_world <= device_count else "gloo"


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, device: str = "cuda",
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the process group. With no argument the identity comes from
    ``torchrun``'s variables (none set: a single-process run, with a
    warning). ``coordinator_address`` is ``host:port`` of rank 0. An
    explicit identity that fails to connect raises: a silently
    single-process run would train on a fraction of the data. A
    ``num_processes`` of 1 without an address is the single-process run;
    with one, a group of one rank (so that DDP and NCCL run). ``device``:
    the type the run asked for (``cuda`` or ``cpu``)."""
    global _device
    if dist.is_initialized():  # joined already (a caller of main())
        return
    env = os.environ
    explicit = (coordinator_address is not None or process_id is not None
                or num_processes is not None)
    if num_processes is not None and num_processes <= 1 \
            and coordinator_address is None:
        return
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    if None in (coordinator_address, num_processes, process_id):
        if explicit:
            raise RuntimeError(
                "torch.distributed needs a coordinator address, a process "
                "count and a process id; got "
                f"{(coordinator_address, num_processes, process_id)} "
                "(set VSR_COORDINATOR_ADDRESS / VSR_NUM_PROCESSES / "
                "VSR_PROCESS_ID, main.distributed, or launch with torchrun)")
        logging.warning("main.distributed: auto found no torchrun variables "
                        "(RANK, WORLD_SIZE, MASTER_ADDR); single-process mode")
        return
    local_rank = _env_int("LOCAL_RANK")
    local_rank = process_id if local_rank is None else local_rank
    local_world = _env_int("LOCAL_WORLD_SIZE") or num_processes
    device_type = torch.device(device).type
    if device_type == "cuda":
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError(
                f"rank {process_id} was asked for the card (device {device!r}) "
                "but torch sees no CUDA device; it does not move to the CPU")
        chosen = torch.device("cuda", local_rank % count)
        torch.cuda.set_device(chosen)
    else:
        count, chosen = 0, torch.device("cpu")
    backend = choose_backend(device_type, local_world, count)
    address = coordinator_address
    if "://" not in address:
        address = f"tcp://{address}"
    try:
        dist.init_process_group(
            backend, init_method=address, world_size=num_processes,
            rank=process_id, timeout=datetime.timedelta(seconds=timeout_s),
            **({"device_id": chosen} if backend == "nccl" else {}))
    except Exception as exc:
        if explicit:
            raise RuntimeError(
                f"torch.distributed initialization failed for explicit "
                f"coordinator {coordinator_address!r}: {exc}") from exc
        logging.warning(f"torch.distributed auto-initialize failed ({exc}); "
                        "single-process mode")
        return
    _device = chosen
    shared = (" (ranks share a card: NCCL cannot run two ranks on one GPU)"
              if device_type == "cuda" and backend == "gloo" else "")
    logging.info(f"torch.distributed: rank {process_id}/{num_processes}, "
                 f"backend {backend}, device {chosen}{shared}")


def initialize_from_config(dist_cfg, device: str = "cuda") -> None:
    """Wire ``main.distributed`` (and the ``VSR_*`` overrides) into
    :func:`initialize`. Enabled when the section exists or
    ``VSR_NUM_PROCESSES`` is set; ``auto`` (or ``{}``) defers to
    ``torchrun``'s variables. The section may also give ``timeout``
    (seconds)."""
    env = os.environ
    if dist_cfg is None and "VSR_NUM_PROCESSES" not in env:
        return
    cfg = dict(dist_cfg) if isinstance(dist_cfg, dict) else {}
    coord = env.get("VSR_COORDINATOR_ADDRESS", cfg.get("coordinator_address"))
    nproc = env.get("VSR_NUM_PROCESSES", cfg.get("num_processes"))
    pid = env.get("VSR_PROCESS_ID", cfg.get("process_id"))
    initialize(coordinator_address=coord,
               num_processes=int(nproc) if nproc is not None else None,
               process_id=int(pid) if pid is not None else None,
               device=device,
               timeout_s=float(cfg.get("timeout", DEFAULT_TIMEOUT_S)))


def rank_device(requested: str | torch.device) -> torch.device:
    """The device this rank trains on: the one :func:`initialize` chose
    when the run asked for that type, else ``requested``."""
    requested = torch.device(requested)
    if (_device is not None and dist.is_initialized()
            and requested.type == _device.type and requested.index is None):
        return _device
    return requested


def backend() -> str | None:
    return dist.get_backend() if dist.is_initialized() else None


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_multiprocess() -> bool:
    return process_count() > 1


def is_primary() -> bool:
    """True on the rank that owns file writes (checkpoints, logs)."""
    return process_index() == 0


def process_shard(n_items: int) -> slice:
    """This rank's contiguous shard of a dataset (host-sharded input)."""
    per = n_items // process_count()
    start = process_index() * per
    end = start + per if process_index() < process_count() - 1 else n_items
    return slice(start, end)


def host_shard_len(n_items: int, local_batch: int) -> int:
    """Batches a host-sharded loader yields on each rank: global batches
    are ``local_batch * process_count`` samples; the ragged tail is dropped
    (it cannot be split evenly across ranks)."""
    return n_items // (local_batch * process_count())


def mesh_process_blocks(mesh) -> dict[str, tuple[int, int]]:
    """Per mesh axis, ``(block_index, block_count)`` of this rank: each rank
    owns one device, so it is the rank's coordinate and the axis size."""
    return {name: (mesh.coord(name), mesh.size(name))
            for name in mesh.axis_names}


def _is_dtensor(t: Any) -> bool:
    # No DTensor exists before FSDP imports its module (importing it
    # registers its operators: seconds), so a plain run never imports it.
    module = sys.modules.get("torch.distributed.tensor")
    return module is not None and isinstance(t, module.DTensor)


def local_index(t) -> list[list[int]]:
    """``[[start, stop], ...]`` of this rank's block of a ``DTensor`` on a
    one-axis mesh, sharded along one dim as ``torch.chunk`` cuts it (FSDP's
    ``Shard(0)``) or replicated; any other layout raises."""
    from torch.distributed.tensor import Replicate, Shard

    index = [[0, int(d)] for d in t.shape]
    if t.device_mesh.ndim != 1:
        raise NotImplementedError("local_index takes a one-axis mesh")
    (placement,) = t.placements
    if isinstance(placement, Shard):
        n, world = t.shape[placement.dim], t.device_mesh.size()
        chunk = -(-n // world)
        start = min(t.device_mesh.get_local_rank() * chunk, n)
        index[placement.dim] = [start, min(start + chunk, n)]
    elif not isinstance(placement, Replicate):
        raise NotImplementedError(f"local_index: placement {placement}")
    local = tuple(t.to_local().shape)
    if local != tuple(b - a for a, b in index):
        raise ValueError(f"local block {local} is not the chunk {index}")
    return index


def assign_full(dst: torch.Tensor, full: torch.Tensor) -> None:
    """Copy a full tensor into ``dst`` in place: its whole, or this rank's
    block of it when ``dst`` is a ``DTensor``."""
    if _is_dtensor(dst):
        sl = tuple(slice(a, b) for a, b in local_index(dst))
        dst.to_local().copy_(full[sl])
    else:
        dst.copy_(full)


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's block of a ``DTensor`` (a view), any other tensor as it
    is."""
    return t.to_local() if _is_dtensor(t) else t


def full_tensor(t) -> torch.Tensor:
    """A ``DTensor`` of :func:`local_index`'s layouts gathered whole, by
    ``all_gather_into_tensor`` of the blocks padded to the chunk size (the
    collective FSDP itself runs; ``DTensor.full_tensor``'s functional
    collective crashed over gloo on CUDA tensors on torch 2.11)."""
    from torch.distributed.tensor import Shard

    (placement,) = t.placements
    block = t.to_local()
    if not isinstance(placement, Shard):
        local_index(t)  # raises for a layout it does not know
        return block.clone()
    dim, world = placement.dim, t.device_mesh.size()
    n = t.shape[dim]
    chunk = -(-n // world)
    block = block.movedim(dim, 0)
    padded = block.new_zeros((chunk, *block.shape[1:]))
    padded[:block.shape[0]] = block
    out = block.new_empty((world * chunk, *block.shape[1:]))
    dist.all_gather_into_tensor(out, padded,
                                group=t.device_mesh.get_group())
    return out[:n].movedim(0, dim).contiguous()


def gather_sharded(tree: Any) -> Any:
    """The nest with every ``DTensor`` leaf gathered into a full tensor
    (others pass through): a collective, every rank calls it in the same
    tree order. Identity without one."""
    if isinstance(tree, torch.Tensor):
        return full_tensor(tree) if _is_dtensor(tree) else tree
    if isinstance(tree, dict):
        out = type(tree)((k, gather_sharded(v)) for k, v in tree.items())
        if hasattr(tree, "_metadata"):
            out._metadata = tree._metadata
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_sharded(v) for v in tree)
    return tree
