"""Device mesh construction (port of ``vsr_tpu/parallel/mesh.py``), the
process group of each mesh axis, and the collectives the ``model`` and
``expert`` axes run inside a forward.

The devices are the world's ranks (each rank owns one device,
``parallel/distributed.py``), so a mesh is the axis names and sizes over
them, laid out as the JAX mesh lays its devices: ``np.array(devices[:total])
.reshape(sizes)``, row-major, so rank ``r`` sits at ``np.unravel_index(r,
sizes)``. ``make_mesh`` keeps the JAX package's checks: one ``-1`` axis at
most, the divisibility of ``-1``, and "Mesh needs N devices, have M". The
``data``, ``model`` and ``expert`` axes are ported; ``spatial``, ``seq`` and
``pipe`` raise by name (ROADMAP.md, queue 1, item 6).

Each axis of size 2 or more gets a process group: the ranks that differ
from this one only along that axis. ``torch.distributed.new_group`` is
called by every rank for every group in the same order, as it must be; a
world of one builds none.

The collectives (autograd functions, each over one axis's group):

- :func:`copy_to` — identity in the forward, all-reduce sum of the gradient
  in the backward: the input of a layer whose ranks each compute a part of
  the output (a column slice, a share of the experts), whose input gradient
  is the sum of the ranks' parts;
- :func:`gather_from` — all-gather along ``dim`` in the forward, this
  rank's slice of the gradient in the backward (every rank holds the same
  full upstream gradient; ``torch.distributed.nn``'s all-gather would
  return the sum of the ranks' copies, the axis size times too much);
- :func:`reduce_from` — all-reduce sum in the forward, identity in the
  backward (the experts' combine).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from vsr_tpu_torch.parallel.distributed import process_count, process_index

#: The axes a mesh of the port may hold.
PORTED_AXES = ("data", "model", "expert")


@dataclass(frozen=True)
class Mesh:
    """Axis names and sizes over the world's ranks (``shape`` as the JAX
    mesh's: ``{name: size}``), this rank, and the process group of each
    axis of size 2 or more (``None`` for the others)."""

    axis_names: tuple[str, ...]
    shape: dict
    rank: int
    groups: dict = field(default_factory=dict, compare=False, repr=False)

    def size(self, axis: str) -> int:
        return int(self.shape.get(axis, 1))

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 for an axis the mesh lacks)."""
        if axis not in self.shape:
            return 0
        coords = np.unravel_index(self.rank, [self.shape[a]
                                              for a in self.axis_names])
        return int(coords[self.axis_names.index(axis)])

    def group(self, axis: str) -> Any:
        """The process group of ``axis`` (``None``: a size-1 axis, or no
        process group)."""
        return self.groups.get(axis)


def device_count() -> int:
    """The devices a mesh can span: one a rank."""
    return process_count()


def _axis_groups(names: list[str], sizes: list[int], rank: int) -> dict:
    """``{axis: this rank's group}`` for every axis of size 2 or more; every
    rank creates every group, in one order."""
    if not dist.is_initialized() or int(np.prod(sizes)) < 2:
        return {}
    grid = np.arange(int(np.prod(sizes))).reshape(sizes)
    groups = {}
    for i, name in enumerate(names):
        if sizes[i] < 2:
            continue
        lines = np.moveaxis(grid, i, -1).reshape(-1, sizes[i])
        for line in lines:
            group = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[name] = group
    return groups


def resolve_axes(axes: dict[str, int], n: int) -> dict[str, int]:
    """``axes`` with its ``-1`` axis (one at most) resolved over ``n``
    devices."""
    sizes = list(axes.values())
    if sizes.count(-1) > 1:
        raise ValueError("Only one mesh axis may be -1")
    known = int(np.prod([s for s in sizes if s != -1]))
    if -1 in sizes:
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes[sizes.index(-1)] = n // known
    return dict(zip(axes, sizes))


def make_mesh(axes: dict[str, int] | None = None,
              devices: int | None = None) -> Mesh:
    """A mesh from ``{'data': n, 'model': m, 'expert': e}`` over ``devices``
    ranks (default: the world). ``-1`` for one axis means "all remaining
    devices"; the default is a pure data-parallel mesh over every rank. A
    mesh must span every rank (a rank outside it would have nothing to
    run)."""
    n = device_count() if devices is None else int(devices)
    axes = resolve_axes({"data": n} if axes is None else axes, n)
    names, sizes = list(axes), list(axes.values())
    for name in names:
        if name not in PORTED_AXES:
            raise NotImplementedError(
                f"mesh axis {name!r} is not yet ported to vsr_tpu_torch "
                "(ROADMAP.md, queue 1, item 6): the port's meshes have the "
                f"{', '.join(repr(a) for a in PORTED_AXES)} axes")
    total = int(np.prod(sizes))
    if total > n:
        raise ValueError(f"Mesh needs {total} devices, have {n}")
    if total < n:
        raise ValueError(
            f"Mesh spans {total} of the {n} ranks: every rank owns one "
            "device, and a rank outside the mesh would have nothing to run")
    rank = process_index()
    return Mesh(tuple(names), dict(zip(names, sizes)), rank,
                _axis_groups(names, sizes, rank))


# ------------------------------------------------------------ collectives


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_gather_cat(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The blocks of ``group``'s ranks concatenated along ``dim`` in rank
    order (no gradient: :func:`gather_from` is the autograd form)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.rank, ctx.size = dim, dist.get_rank(group), x.shape[dim]
        return all_gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.rank * ctx.size,
                           ctx.size).contiguous(), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity; the gradient all-reduced (summed) over ``group``."""
    if group is None or not x.requires_grad:
        return x
    return _CopyTo.apply(x, group)


def gather_from(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' blocks of ``group`` concatenated along ``dim`` in rank
    order; the gradient's block of this rank."""
    if group is None:
        return x
    return _GatherFrom.apply(x, dim, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group``; the gradient passed through."""
    if group is None:
        return x
    return _ReduceFrom.apply(x, group)
