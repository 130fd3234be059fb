"""Device mesh construction (port of ``vsr_tpu/parallel/mesh.py``).

The devices are the world's ranks (each rank owns one device,
``parallel/distributed.py``), so a mesh is the axis names and sizes over
them. ``make_mesh`` keeps the JAX package's checks: one ``-1`` axis at most,
the divisibility of ``-1``, and "Mesh needs N devices, have M". Only the
``data`` axis is ported: ``spatial``, ``seq``, ``model``, ``pipe`` and
``expert`` raise by name (ROADMAP.md, queue 1, items 4-6).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from vsr_tpu_torch.parallel.distributed import process_count, process_index

@dataclass(frozen=True)
class Mesh:
    """Axis names and sizes over the world's ranks (``shape`` as the JAX
    mesh's: ``{name: size}``), and this rank."""

    axis_names: tuple[str, ...]
    shape: dict
    rank: int


def device_count() -> int:
    """The devices a mesh can span: one a rank."""
    return process_count()


def make_mesh(axes: dict[str, int] | None = None,
              devices: int | None = None) -> Mesh:
    """A mesh from ``{'data': n}`` over ``devices`` ranks (default: the
    world). ``-1`` for one axis means "all remaining devices"; the default
    is a pure data-parallel mesh over every rank. A mesh must span every
    rank (a rank outside it would have nothing to run)."""
    n = device_count() if devices is None else int(devices)
    if axes is None:
        axes = {"data": n}
    names = list(axes.keys())
    sizes = list(axes.values())
    if sizes.count(-1) > 1:
        raise ValueError("Only one mesh axis may be -1")
    known = int(np.prod([s for s in sizes if s != -1]))
    if -1 in sizes:
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes[sizes.index(-1)] = n // known
    for name in names:
        if name != "data":
            raise NotImplementedError(
                f"mesh axis {name!r} is not yet ported to vsr_tpu_torch "
                "(ROADMAP.md, queue 1): the port's meshes have the 'data' "
                "axis only")
    total = int(np.prod(sizes))
    if total > n:
        raise ValueError(f"Mesh needs {total} devices, have {n}")
    if total < n:
        raise ValueError(
            f"Mesh spans {total} of the {n} ranks: every rank owns one "
            "device, and a rank outside the mesh would have nothing to run")
    return Mesh(tuple(names), dict(zip(names, sizes)), process_index())
