"""The ``data`` axis of the trainers (port of
``vsr_tpu/parallel/data_parallel.py`` and of the ZeRO-1 / FSDP placement of
``vsr_tpu/runner/trainers.py``), in PyTorch's idiom.

The JAX step runs per device on its batch shard under ``shard_map`` and
``pmean``s three things over ``'data'`` (``trainers.py:498-537``): the
gradients, the new BatchNorm state and the logged scalars. Here each rank
is one device:

- the gradients: ``DistributedDataParallel`` (DDP), or FSDP's
  reduce-scatter;
- the BatchNorm running statistics: an all-reduce mean of the net's
  floating buffers after every train step (:meth:`DataParallel.sync_buffers`),
  with DDP's ``broadcast_buffers=False`` (DDP's default copies rank 0's
  buffers instead, which is not the JAX result);
- the logged scalars: the epoch's weighted sums and counts, summed over
  the ranks once at the end of the epoch (:meth:`DataParallel.reduce_log`).

``zero_optim`` (ZeRO-1) is ``ZeroRedundancyOptimizer`` over the
optimizer's ``torch.optim`` class under DDP: each rank updates the moments
of its share of the parameters and broadcasts them. ``fsdp`` is
``torch.distributed.fsdp.fully_shard`` on the net: parameters, gradients and
moments stay sharded (``DTensor``) between steps. Both give the plain
``data`` run's update.

``grad_accumulation`` (``optim.GradientChain``): the micro-steps run under
DDP's ``no_sync``, each folding this rank's gradient into the chain's
running mean; before the applying micro-step's backward the chain loads
the sum of the earlier micro-gradients into ``.grad`` (:meth:`preloads`),
so DDP all-reduces the sum of the whole cycle and the chain divides it by
k: the mean over ranks and micro-steps, as a ``pmean`` of each micro-step
gives it. Under FSDP every micro-step reduce-scatters (FSDP keeps an
unsynchronized gradient unsharded inside its own state, out of the
chain's reach), and the chain's accumulator is sharded like the
parameters.

The device trainers capture their step in a CUDA graph, where DDP's hooks
do not belong: with ``explicit`` the gradients are averaged by one
all-reduce of their flattened concatenation after the backward
(:meth:`DataParallel.reduce_gradients`), which a capture records on NCCL;
their micro-steps all-reduce too.

Checkpoints: :meth:`full_state` gathers the state (a collective; rank 0
writes it), :meth:`sharded_state` gives each rank's part for
``utils/checkpoint.save_checkpoint_sharded``, and :meth:`load_full_state`
places a full state by the mesh's rule.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch import nn

from vsr_tpu_torch.optim import OptimizerFactory
from vsr_tpu_torch.parallel.distributed import (_is_dtensor, gather_sharded,
                                                local_index)
from vsr_tpu_torch.utils.checkpoint import flatten_state

MODES = ("ddp", "zero", "fsdp")


def all_reduce_mean(tensors: list[torch.Tensor], world: int,
                    group=None) -> None:
    """Average ``tensors`` over the ranks (of ``group``: ``world`` of them)
    in place, one collective for each dtype (their flattened
    concatenation)."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for tensors_of in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in tensors_of])
        dist.all_reduce(flat, group=group)
        flat.div_(world)
        offset = 0
        for t in tensors_of:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def step_buffers(net: nn.Module) -> list[torch.Tensor]:
    """The buffers a train step moves: the floating ones (BatchNorm's
    running statistics)."""
    return [b for b in net.buffers() if b.is_floating_point() and b.numel()]


class DataParallel:
    """One trainer's ``data`` axis over the world's ranks (``mesh``), in
    ``mode`` ``ddp`` (the plain axis), ``zero`` (ZeRO-1) or ``fsdp``;
    ``explicit``: the gradients' all-reduce by hand, not DDP's (``ddp``
    only). :meth:`wrap` the net before :meth:`make_optimizer` (FSDP
    replaces the parameters)."""

    def __init__(self, mesh, mode: str = "ddp", explicit: bool = False):
        if mode not in MODES:
            raise ValueError(f"data-parallel mode {mode!r}, not in {MODES}")
        self.mesh, self.mode, self.explicit = mesh, mode, explicit
        self.world, self.rank = mesh.shape["data"], mesh.rank
        self.module: nn.Module | None = None
        self._buffers: list[torch.Tensor] = []

    # ----------------------------------------------------------- placement
    def wrap(self, net: nn.Module, device: torch.device) -> nn.Module:
        """Place ``net`` and return the module the train step calls."""
        if self.explicit:
            self.module = net
        elif self.mode == "fsdp":
            from torch.distributed.device_mesh import init_device_mesh
            from torch.distributed.fsdp import fully_shard

            mesh = init_device_mesh(device.type, (self.world,))
            self.module = fully_shard(net, mesh=mesh)
        else:
            import inspect

            from torch.nn.parallel import DistributedDataParallel

            # No buffer broadcast at each forward (newer torch names the
            # switch forward_sync_buffers; its init-time sync copies rank
            # 0's buffers, which every rank built from one seed anyway).
            params = inspect.signature(DistributedDataParallel).parameters
            no_sync = ({"forward_sync_buffers": False}
                       if "forward_sync_buffers" in params
                       else {"broadcast_buffers": False})
            self.module = DistributedDataParallel(
                net, device_ids=[device] if device.type == "cuda" else None,
                **no_sync)
        self._buffers = step_buffers(net)
        return self.module

    def make_optimizer(self, optimizer: OptimizerFactory | torch.optim.Optimizer,
                       net: nn.Module) -> torch.optim.Optimizer:
        """The optimizer over the placed net's parameters: the config's
        class under ``ZeroRedundancyOptimizer`` for ``zero``."""
        if isinstance(optimizer, OptimizerFactory):
            cls, kwargs = optimizer.optimizer_class(), optimizer.bind_kwargs()
        else:
            cls, kwargs = type(optimizer), dict(optimizer.defaults)
        if self.mode == "zero":
            from torch.distributed.optim import ZeroRedundancyOptimizer

            return ZeroRedundancyOptimizer(net.parameters(),
                                           optimizer_class=cls, **kwargs)
        return cls(net.parameters(), **kwargs)

    # ---------------------------------------------------------------- steps
    def grad_sync(self, chain):
        """The context of a train step's forward and backward: DDP's
        ``no_sync`` on a micro-step that only accumulates."""
        if (not self.explicit and self.mode != "fsdp" and chain.every_k > 1
                and not chain.graph_key()):
            return self.module.no_sync()
        return contextlib.nullcontext()

    def preloads(self, chain) -> bool:
        """Whether the next step is an applying micro-step whose backward
        adds to the cycle's gradient sum (``chain.preload``)."""
        return (not self.explicit and self.mode != "fsdp"
                and chain.every_k > 1 and chain.graph_key())

    def reduce_gradients(self, params: list[torch.Tensor]) -> None:
        """With ``explicit``: ``pmean`` of the gradients, one all-reduce of
        their flattened concatenation (a parameter the loss does not reach
        counts with zeros)."""
        if not self.explicit:
            return
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        all_reduce_mean([p.grad for p in params], self.world)

    def sync_buffers(self) -> None:
        """``pmean`` of the new BatchNorm state."""
        if self._buffers:
            with torch.no_grad():
                all_reduce_mean(self._buffers, self.world)

    def reduce_log(self, acc: torch.Tensor | None, count: float, n: int,
                   device: torch.device) -> tuple[torch.Tensor, float]:
        """An epoch's weighted scalar sums and weight, summed over the
        ranks: every rank reports the global mean."""
        vec = torch.zeros(n + 1, dtype=torch.float32, device=device)
        if acc is not None:
            vec[:n] = acc
        vec[n] = count
        dist.all_reduce(vec)
        return vec[:n], float(vec[n])

    def agreed(self, flag: bool, device: torch.device) -> bool:
        """The OR of a flag over the ranks."""
        vec = torch.tensor([1.0 if flag else 0.0], device=device)
        dist.all_reduce(vec)
        return bool(vec.item() > 0)

    # ---------------------------------------------------------- checkpoints
    def _chain_state(self, chain) -> dict | None:
        """The chain's state with a DDP accumulator (this rank's running
        mean of its micro-gradients) averaged over the ranks: the
        accumulator a ``pmean`` of each micro-step gives."""
        state = chain.state_dict()
        if (state and state["acc"] is not None and self.mode != "fsdp"
                and not self.explicit):
            acc = {k: v.clone() for k, v in state["acc"].items()}
            all_reduce_mean(list(acc.values()), self.world)
            state = {**state, "acc": acc}
        return state

    def full_state(self, trainer) -> dict | None:
        """The trainer's state gathered in full (a collective every rank
        calls); ``None`` on a rank other than 0 under ZeRO."""
        net = gather_sharded(trainer.net.state_dict())
        if self.mode == "zero":
            trainer.optimizer.consolidate_state_dict(to=0)
            opt = trainer.optimizer.state_dict() if self.rank == 0 else None
        elif self.mode == "fsdp":
            opt = gather_sharded(trainer.optimizer.state_dict())
        else:
            opt = trainer._optimizer_state()
        chain = gather_sharded(self._chain_state(trainer.chain))
        if opt is None:
            return None
        return {"net": net, "optimizer": opt, "chain": chain}

    def sharded_state(self, trainer) -> dict:
        """This rank's part of a sharded checkpoint: the replicated leaves,
        the manifest and this rank's blocks of the ``DTensor`` leaves, and
        under ZeRO the optimizer states it owns
        (``utils/checkpoint.save_checkpoint_sharded``)."""
        owners: dict = {}
        subtrees: dict = {}
        if self.mode == "zero":
            zero = trainer.optimizer
            params = [p for g in zero.param_groups for p in g["params"]]
            # ZeRO's parameter groups with global parameter indices.
            opt = {"param_groups": torch.optim.Optimizer.state_dict(zero)[
                "param_groups"]}
            for i, p in enumerate(params):
                owner = zero._param_to_rank[p]
                owners[("optimizer", "state", i)] = owner
                if owner == self.rank:
                    subtrees[("optimizer", "state", i)] = dict(
                        zero.optim.state.get(p, {}))
        elif self.mode == "fsdp":
            opt = trainer.optimizer.state_dict()
        else:
            opt = trainer._optimizer_state()
        flat = flatten_state({"net": trainer.net.state_dict(),
                              "optimizer": opt,
                              "chain": self._chain_state(trainer.chain)})
        replicated, manifest, leaves = {}, {}, {}
        for key, value in flat.items():
            if _is_dtensor(value):
                manifest[key] = {"shape": list(value.shape),
                                 "dtype": str(value.dtype)}
                leaves[key] = [{"index": local_index(value),
                                "data": value.to_local()}]
            else:
                replicated[key] = value
        return {"replicated": replicated, "manifest": manifest,
                "owners": owners, "leaves": leaves, "subtrees": subtrees}

    def load_full_state(self, trainer, state: dict) -> None:
        """Place a full state (a gathered or stitched checkpoint) by the
        mesh's rule: ZeRO keeps the moments of this rank's share, FSDP this
        rank's block of every sharded leaf."""
        from vsr_tpu_torch.parallel.distributed import assign_full

        if self.mode == "fsdp":
            current = trainer.net.state_dict()
            if set(current) != set(state["net"]):
                raise ValueError("the checkpoint's net state does not match "
                                 "the net's")
            with torch.no_grad():
                for key, value in state["net"].items():
                    assign_full(current[key], value)
            trainer.optimizer.load_state_dict(
                self._sharded_optimizer_state(trainer.optimizer,
                                              state["optimizer"]))
        else:
            trainer.net.load_state_dict(state["net"], strict=True)
            if self.mode == "zero":
                trainer.optimizer.load_state_dict(state["optimizer"])
            else:
                trainer._load_optimizer_state(state["optimizer"])
        trainer.chain.load_state_dict(state.get("chain"))

    @staticmethod
    def _sharded_optimizer_state(optimizer, state: dict) -> dict:
        """A full optimizer state with each moment of a ``DTensor``
        parameter cut to this rank's block, as a ``DTensor`` like it."""
        from torch.distributed.tensor import DTensor

        params = [p for g in optimizer.param_groups for p in g["params"]]
        per_param: dict = {}
        for idx, st in state["state"].items():
            p = params[idx]
            out = {}
            for name, v in st.items():
                if (_is_dtensor(p) and torch.is_tensor(v)
                        and tuple(v.shape) == tuple(p.shape)):
                    sl = tuple(slice(a, b) for a, b in local_index(p))
                    v = DTensor.from_local(
                        v[sl].to(p.device).contiguous(), p.device_mesh,
                        p.placements, shape=p.shape, stride=p.stride())
                out[name] = v
            per_param[idx] = out
        return {"state": per_param, "param_groups": state["param_groups"]}

