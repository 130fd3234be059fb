"""The placement rules of the GSPMD train step (port of
``vsr_tpu/parallel/gspmd.py:43-153``) for meshes with a ``model`` or an
``expert`` axis.

The JAX step jits the trainer's step with in-shardings that split the
parameters and their optimizer moments by one rule: ``model`` (each leaf's
trailing output-feature dim, ``parallel/tp.py``), ZeRO-1, FSDP or
``expert`` (the expert stacks' leading dim, ``parallel/ep.py``); the four
are mutually exclusive (:func:`check_exclusive`). The port's ZeRO-1 and
FSDP stay ``parallel/data_parallel.py``'s, as does the ``data``-only mesh
(DDP). With a ``model`` or an ``expert`` axis, :class:`Placement` runs the
step:

- the net's split leaves are cut to this rank's blocks before the
  optimizer exists, so the moments follow their parameter
  (``tp.shard_model_params`` / ``ep.shard_expert_params``); the forward
  runs each rank's blocks (the collectives of ``parallel/mesh.py``);
- the gradient sync is an all-reduce mean over the ``data`` group for
  every leaf (a split leaf's block with the ranks that hold the same
  block); the BatchNorm statistics likewise after each step;
- the gradient clip's norm sums the split leaves' blocks over the axis;
- the replicated leaves come out equal on every rank of the axis (the
  forward's gathered activations are the same everywhere);
- checkpoints: :meth:`Placement.full_state` gathers the split leaves (a
  collective; rank 0 writes a file of full shapes, as a run without a mesh
  does), :meth:`Placement.sharded_state` gives each rank's blocks to
  ``utils/checkpoint.save_checkpoint_sharded`` (the ranks of ``data``
  coordinate 0 write them), :meth:`Placement.load_full_state` cuts a full
  state to this rank's blocks.

The logged scalars and the preemption vote reduce over the whole world
(``DataParallel.reduce_log`` / ``agreed``): the ranks of one ``data`` block
hold the same values, so the weighted means are the ``data`` axis's.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from vsr_tpu_torch.parallel.data_parallel import (DataParallel,
                                                  all_reduce_mean,
                                                  step_buffers)
from vsr_tpu_torch.parallel.distributed import process_count
from vsr_tpu_torch.parallel.mesh import all_gather_cat
from vsr_tpu_torch.parallel.tp import block
from vsr_tpu_torch.utils.checkpoint import flatten_state


def check_exclusive(mesh_shape, zero_optim: bool = False,
                    fsdp: bool = False) -> None:
    """``model``, ZeRO-1, FSDP and ``expert`` are mutually exclusive
    parameter / optimizer placement rules (``make_gspmd_step``)."""
    rules = (mesh_shape.get("model", 1) > 1,
             bool(zero_optim) and mesh_shape.get("data", 1) > 1,
             bool(fsdp) and mesh_shape.get("data", 1) > 1,
             mesh_shape.get("expert", 1) > 1)
    if sum(rules) > 1:
        raise NotImplementedError(
            "model_axis / zero_axis / fsdp_axis / expert_axis are mutually "
            "exclusive parameter/optimizer placement rules")


def uses_placement(mesh_shape) -> bool:
    """Whether a mesh takes this module's step (a ``model`` or an
    ``expert`` axis) rather than ``DataParallel``'s."""
    return any(mesh_shape.get(a, 1) > 1 for a in ("model", "expert"))


class Placement(DataParallel):
    """One trainer's state over a mesh with a ``model`` or an ``expert``
    axis (the module docstring). :meth:`wrap` places the net before
    :meth:`make_optimizer`."""

    def __init__(self, mesh):
        self.mesh, self.mode, self.explicit = mesh, "ddp", True
        self.axis = "model" if mesh.size("model") > 1 else "expert"
        self.rank = mesh.rank
        # reduce_log / agreed / all_reduce_mean over the world: the mean
        # over every rank is the data axis's (see the module docstring).
        self.world = process_count()
        self.data_size, self.data_group = mesh.size("data"), mesh.group("data")
        self.split: dict[str, int] = {}
        self.module: nn.Module | None = None
        self._buffers: list[torch.Tensor] = []

    # ----------------------------------------------------------- placement
    def wrap(self, net: nn.Module, device: torch.device) -> nn.Module:
        """Cut ``net``'s split leaves to this rank's blocks and hook its
        layers; the net itself is the step's module."""
        from vsr_tpu_torch.parallel import ep, tp

        if self.axis == "model":
            self.split = tp.shard_model_params(net, self.mesh)
        else:
            ep.validate_expert_mesh(
                self.mesh, net, context=type(net).__name__,
                dispatch_impl=ep.resolve_dispatch_impl(net))
            self.split = ep.shard_expert_params(net, self.mesh)
        self.module = net
        self._buffers = step_buffers(net)
        return net

    @property
    def chain_split(self):
        """``GradientChain.split``: the axis's group and the split
        parameters' names."""
        return (self.mesh.group(self.axis), set(self.split)) \
            if self.split else None

    # ---------------------------------------------------------------- steps
    def grad_sync(self, chain):
        return contextlib.nullcontext()

    def preloads(self, chain) -> bool:
        return False

    def reduce_gradients(self, params: list[torch.Tensor]) -> None:
        """``pmean`` of the gradients over the ``data`` group."""
        if self.data_size < 2:
            return
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        all_reduce_mean([p.grad for p in params], self.data_size,
                        self.data_group)

    def sync_buffers(self) -> None:
        if self._buffers and self.data_size > 1:
            with torch.no_grad():
                all_reduce_mean(self._buffers, self.data_size,
                                self.data_group)

    # ---------------------------------------------------------- checkpoints
    def _split_keys(self, trainer, state: dict) -> dict[tuple, int]:
        """``{key path of flatten_state(state): dim}`` of every split leaf
        of a trainer state: the net's, the optimizer moments shaped like
        their parameter, the chain's accumulator and EMA."""
        names = [n for n, _ in trainer.net.named_parameters()]
        shapes = dict((n, tuple(p.shape))
                      for n, p in trainer.net.named_parameters())
        keys = {("net", n): d for n, d in self.split.items()}
        for key, value in flatten_state(state).items():
            if key[:2] == ("optimizer", "state") and torch.is_tensor(value):
                name = names[key[2]]
                if name in self.split and value.dim() == len(shapes[name]):
                    keys[key] = self.split[name]
            elif key[0] == "chain" and len(key) == 3 and key[2] in self.split:
                keys[key] = self.split[key[2]]
        return keys

    def _state(self, trainer) -> dict:
        return {"net": trainer.net.state_dict(),
                "optimizer": trainer._optimizer_state(),
                "chain": trainer.chain.state_dict()}

    def full_state(self, trainer) -> dict:
        """The trainer's state with every split leaf gathered (a collective
        every rank calls, in one order)."""
        state = self._state(trainer)
        flat = flatten_state(state)
        for key, dim in sorted(self._split_keys(trainer, state).items(),
                               key=lambda kv: str(kv[0])):
            flat[key] = all_gather_cat(flat[key], dim,
                                       self.mesh.group(self.axis))
        return _unflatten_like(state, flat)

    def sharded_state(self, trainer) -> dict:
        """This rank's part of a sharded checkpoint: the replicated leaves,
        and the blocks of the split ones (written by the ranks of ``data``
        coordinate 0; the others hold the same blocks)."""
        state = self._state(trainer)
        keys = self._split_keys(trainer, state)
        index, count = self.mesh.coord(self.axis), self.mesh.size(self.axis)
        writes = self.mesh.coord("data") == 0
        replicated, manifest, leaves = {}, {}, {}
        for key, value in flatten_state(state).items():
            if key not in keys:
                replicated[key] = value
                continue
            dim = keys[key]
            shape = list(value.shape)
            shape[dim] *= count
            manifest[key] = {"shape": shape, "dtype": str(value.dtype)}
            if writes:
                span = [[0, s] for s in value.shape]
                span[dim] = [index * value.shape[dim],
                             (index + 1) * value.shape[dim]]
                leaves[key] = [{"index": span, "data": value}]
        return {"replicated": replicated, "manifest": manifest,
                "owners": {}, "leaves": leaves, "subtrees": {}}

    def load_full_state(self, trainer, state: dict) -> None:
        """Cut a full state (a gathered or stitched checkpoint) to this
        rank's blocks and load it."""
        index, count = self.mesh.coord(self.axis), self.mesh.size(self.axis)
        full = {"net": state["net"], "optimizer": state["optimizer"],
                "chain": state.get("chain")}
        flat = flatten_state(full)
        for key, dim in self._split_keys(trainer, full).items():
            if key in flat:
                flat[key] = block(flat[key], dim, index, count).contiguous()
        full = _unflatten_like(full, flat)
        trainer.net.load_state_dict(full["net"], strict=True)
        trainer._load_optimizer_state(full["optimizer"])
        trainer.chain.load_state_dict(full["chain"])


def _unflatten_like(state, flat: dict, prefix: tuple = ()):
    """``state`` with the leaves of ``flatten_state(state)`` replaced by
    ``flat``'s (nest types and ``state_dict`` metadata kept)."""
    if isinstance(state, dict) and state:
        out = type(state)((k, _unflatten_like(v, flat, prefix + (k,)))
                          for k, v in state.items())
        if hasattr(state, "_metadata"):
            out._metadata = state._metadata
        return out
    return flat.get(prefix, state)
