"""Mesh-sharded serving (port of ``vsr_tpu/parallel/serving.py``): the
frame batch split over the ``'data'`` axis, the parameters over ``'model'``
or ``'expert'`` (``infer.make_pipeline`` places them, ``parallel/tp.py`` and
``parallel/ep.py``), across the world's ranks.

Every rank calls the wrapped pipeline with the same frames. The batch is
padded by repeating its last frame (its last whole sequence for
``--video``) up to a multiple of the ``data`` axis, each ``data`` rank runs
its block (the ranks of one block run it together, each with its share of
the parameters), and the blocks are all-gathered over the ``data`` group
and sliced back: every rank returns the exact unpadded result. The JAX
package finds which outputs carry the batch by tracing the pipeline
(``eval_shape``); the port's pipeline returns ``(lr, sr)``, both batched,
so both are gathered and sliced.

``shard_volume_pipeline`` (the volumetric nets over ``seq`` / ``data`` /
``spatial``) waits for the ``seq`` and ``spatial`` axes (ROADMAP.md, queue
1, item 6) and raises by name.
"""

from __future__ import annotations

import torch

from vsr_tpu_torch.parallel.mesh import all_gather_cat

#: Axis names the serving / training meshes know about: 'data' shards the
#: frame batch, 'spatial' each frame's H axis, 'seq' the volume depth,
#: 'model' the parameters' output-feature dims (parallel/tp.py), 'expert'
#: the MoE expert stacks' leading num_experts dim (parallel/ep.py).
KNOWN_AXES = ("data", "spatial", "seq", "model", "expert")


def parse_mesh_axes(spec: str) -> dict[str, int]:
    """``"data=2,model=2"`` -> ``{"data": 2, "model": 2}``.

    ``-1`` means "all remaining devices" and must be written explicitly
    (``data=-1``); a bare axis name without ``=size`` is rejected so typos
    fail here instead of silently becoming a replicated no-op axis. Axis
    names are validated against :data:`KNOWN_AXES` for the same reason.
    """
    axes: dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, size = part.partition("=")
        name = name.strip()
        if name not in KNOWN_AXES:
            raise ValueError(
                f"Unknown mesh axis {name!r} in {spec!r}; known axes: "
                f"{', '.join(KNOWN_AXES)}")
        if not sep or not size.strip():
            raise ValueError(
                f"Mesh axis {name!r} needs an explicit size, e.g. "
                f"'{name}=2' (or '{name}=-1' for all remaining devices)")
        axes[name] = int(size)
    if not axes:
        raise ValueError(f"Empty mesh spec: {spec!r}")
    return axes


#: Why the volumetric nets are not served under a mesh yet.
VOLUME_MESH_REFUSAL = (
    "volumetric serving under --mesh (the 'seq' / 'spatial' axes and "
    "shard_volume_pipeline) is not yet ported to vsr_tpu_torch "
    "(ROADMAP.md, queue 1, item 6)")


def shard_volume_pipeline(*args, **kwargs):
    """Volumetric serving over a mesh: not yet ported."""
    raise NotImplementedError(VOLUME_MESH_REFUSAL)


def shard_pipeline(pipeline_fn, mesh, batch_axis: str = "data",
                   seq_len: int | None = None):
    """Wrap ``pipeline_fn(hr_frames: (N, H, W)) -> (lr, sr)`` for the mesh
    (the module docstring). ``seq_len``: for whole-sequence (``--video``)
    and window pipelines, which regroup N = D*T internally — padding and
    the blocks then come in whole T-frame sequences."""
    dp = mesh.size(batch_axis)
    index, group = mesh.coord(batch_axis), mesh.group(batch_axis)
    unit = seq_len or 1

    def wrapped(hr_frames: torch.Tensor):
        n = hr_frames.shape[0]
        if n % unit:
            raise ValueError(f"N={n} is not whole sequences of T={unit}")
        pad = ((-(n // unit)) % dp) * unit
        if pad:
            hr_frames = torch.cat([hr_frames, hr_frames[-unit:].repeat(
                pad // unit, *[1] * (hr_frames.dim() - 1))])
        per = hr_frames.shape[0] // dp
        out = pipeline_fn(hr_frames[index * per:(index + 1) * per])
        if dp > 1:
            out = tuple(all_gather_cat(o, 0, group) for o in out)
        return tuple(o[:n] for o in out)

    wrapped.module = getattr(pipeline_fn, "module", None)
    return wrapped
