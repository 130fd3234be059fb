"""Expert parallelism: Mixture-of-Experts weights split over an
``'expert'`` mesh axis (port of ``vsr_tpu/parallel/ep.py``).

Every expert-stacked leaf (shape ``(E, ...)``, named ``expert_*``) splits
its leading expert dim over the axis, and an optimizer built afterwards
holds its moments in the blocks' shapes; every other leaf is replicated.
Identification is by name, as in the JAX package, so the rule stays
orthogonal to the ``model`` axis's positional one.

The JAX package leaves the schedule to GSPMD, pinned by
``constrain_expert_dim`` under ``use_mesh``: tokens stay replicated over the
axis, each device computes the router and the FFN of its experts, and the
combined ``(G, gs, d)`` output is all-reduced. The port runs that schedule
by hand: :func:`shard_expert_params` tells each MoE layer its slice of the
experts (``ExpertChoiceMoE.expert_shard``: the first local expert, their
count and the axis's group), and the layer ranks, dispatches and runs only
those experts and all-reduces its combine (``models/moe.py``). The slice
lives on the module rather than in a context (``use_mesh``) so that a
recompute in the backward, which runs on another thread on the card, sees
it too.

The refusals are the JAX package's, in its words
(:func:`validate_expert_composition`, :func:`validate_expert_mesh`).
"""

from __future__ import annotations

from torch import nn

#: The reserved mesh-axis name for expert (MoE) sharding.
EXPERT_AXIS = "expert"

#: Parameter-name prefix marking expert-stacked leaves (leading dim = E).
EXPERT_PREFIX = "expert_"


def expert_spec(leaf_name: str, shape, axis_size: int) -> int | None:
    """The dim of one leaf that splits over the axis: the leading one when
    the leaf is an expert stack (``expert_*`` name) divisible by the axis,
    else ``None`` (replicated)."""
    if (axis_size > 1 and leaf_name.startswith(EXPERT_PREFIX)
            and len(shape) >= 1 and shape[0] >= axis_size
            and shape[0] % axis_size == 0):
        return 0
    return None


def expert_leaves(net: nn.Module) -> list[tuple[str, str, tuple]]:
    """``(flax path, port name, shape)`` of every expert-stacked leaf of
    ``net`` (``expert_*``, rank >= 1)."""
    from vsr_tpu_torch.interop import module_slots

    names = {id(t): n for n, t in net.named_parameters()}
    return [("/".join(path), names[id(tensor)], tuple(tensor.shape))
            for path, tensor, _ in module_slots(net)
            if path[-1].startswith(EXPERT_PREFIX) and tensor.dim() >= 1]


def validate_expert_composition(mesh_shape, *, context: str,
                                exc=NotImplementedError) -> None:
    """The 'expert' axis's mesh-composition rule (shared by the trainer's
    constructor and :func:`validate_expert_mesh`): composes with ``'data'``
    only."""
    if mesh_shape.get(EXPERT_AXIS, 1) <= 1:
        return
    for other in ("model", "pipe", "spatial", "seq"):
        if mesh_shape.get(other, 1) > 1:
            raise exc(
                f"'expert' composes with 'data' only; a '{other}' axis "
                f"cannot join an expert mesh ({context})")


def resolve_dispatch_impl(net) -> str | None:
    """The ONE accessor for a net's MoE dispatch implementation: a
    top-level MoE net's ``dispatch_impl``, or the property of a net that
    embeds ``ExpertChoiceMoE`` blocks (DRFNet / DRFSISRNet). A net with
    expert leaves and no such attribute gives ``None``, which
    :func:`validate_expert_mesh` refuses."""
    return getattr(net, "dispatch_impl", None)


def validate_expert_mesh(mesh, net: nn.Module, *, context: str,
                         exc=NotImplementedError,
                         dispatch_impl: str | None = None) -> None:
    """The 'expert' axis's composition and shardability rules (used by the
    trainers' placement AND serving's ``make_pipeline``): composes with
    ``'data'`` only; the net must hold expert stacks, whose leading
    ``num_experts`` the axis divides; ``dense_nhwc`` and an undetermined
    dispatch are refused."""
    size = mesh.shape.get(EXPERT_AXIS, 1)
    if size <= 1:
        return
    validate_expert_composition(mesh.shape, context=context, exc=exc)
    stacks = expert_leaves(net)
    if not stacks:
        raise exc(
            "no expert-stacked params (expert_* leaves) — the 'expert' "
            f"mesh axis applies to MoE nets (e.g. MoEEDSRNet) ({context})")
    if dispatch_impl == "dense_nhwc":
        raise exc(
            "dispatch_impl='dense_nhwc' folds all experts into replicated "
            "conv kernels and cannot run expert-parallel — use 'sparse' or "
            f"'dense' under an 'expert' mesh axis ({context})")
    if dispatch_impl is None:
        raise exc(
            f"{context}: the net carries expert-stacked params but does "
            "not expose 'dispatch_impl' — nets embedding MoE blocks must "
            "surface the knob (a property is enough; see DRFNet) so the "
            "'expert' axis can refuse folded dispatch implementations")
    # The JAX tree's order (keys sorted at every level), so that the first
    # stack named is the same.
    for path, _, shape in sorted(stacks, key=lambda s: s[0].split("/")):
        if shape[0] < size or shape[0] % size:
            raise exc(
                f"expert stack {path.rsplit('/', 1)[-1]!r} has num_experts="
                f"{shape[0]}, not divisible by the 'expert' axis "
                f"({size}) — the axis would silently replicate "
                f"({context})")


def shard_expert_params(net: nn.Module, mesh, axis: str = EXPERT_AXIS
                        ) -> dict[str, int]:
    """Cut every expert stack of ``net`` to this rank's experts (in place,
    the same ``Parameter`` objects) and give each MoE layer its
    ``expert_shard``. Returns ``{port name: 0}`` of the split leaves; empty
    (and ``net`` untouched) on an axis of size 1. Run
    :func:`validate_expert_mesh` first."""
    import torch

    from vsr_tpu_torch.models.moe import ExpertChoiceMoE
    from vsr_tpu_torch.parallel.tp import block

    size = mesh.size(axis)
    if size < 2:
        return {}
    index, group = mesh.coord(axis), mesh.group(axis)
    split = {}
    for prefix, module in net.named_modules():
        if not isinstance(module, ExpertChoiceMoE):
            continue
        local = module.num_experts // size
        with torch.no_grad():
            for name, param in module.named_parameters(recurse=False):
                if expert_spec(name, param.shape, size) is not None:
                    param.data = block(param.data, 0, index, size).clone()
                    split[f"{prefix}.{name}" if prefix else name] = 0
        module.expert_shard = (index * local, local, group)
    return split
