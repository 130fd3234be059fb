"""Tensor (model) parallelism: parameters split over a ``'model'`` axis
(port of ``vsr_tpu/parallel/tp.py``).

The rule is the JAX package's, positional on **flax's** layout: a leaf
whose trailing dimension divides the axis size splits that dimension, every
other leaf is replicated. Flax convs store kernels ``(kh, kw, cin, cout)``
and biases ``(c,)``, so the rule splits the output features of every layer
wide enough, and replicates the narrow head / tail convs (``cout`` 1) and
the single PReLU alpha. The port decides it on each leaf's flax shape
(``interop.module_slots``' layouts) and applies it to the torch dim that
holds flax's trailing one: dim 0 of a conv's and of K1's ``(F, K)`` weight,
dim 1 of a transposed conv's ``(in, out, k, k)``, dim 0 of a bias or a
BatchNorm leaf, the last dim of the MoE leaves. So the same leaves split
as in JAX, and an optimizer built afterwards holds its moments in the
blocks' shapes.

Where GSPMD partitions the program, the port runs each rank's layers on
its local blocks (``shard_model_params``):

- a module that owns a split kernel (a conv, a transposed conv, K1's fused
  squeeze, a deformable conv) computes its slice of output channels from
  the full input, then the ranks' slices are all-gathered along the
  channels (``mesh.gather_from``); its inputs pass through
  ``mesh.copy_to``, whose backward sums the ranks' partial input
  gradients (Megatron's column-parallel pair);
- a BatchNorm whose leaves split normalizes this rank's channels of its
  input (its statistics are per channel, so this is exact) and gathers
  them the same way;
- any other module with split leaves (the MoE layer's router and expert
  stacks under ``model``) gathers its leaves at each call and computes in
  full (its gradient keeps this rank's block).

The gathered activations are the same on every rank, so every replicated
leaf gets the same gradient on every rank of the group.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from vsr_tpu_torch.parallel.mesh import copy_to, gather_from

#: The reserved mesh-axis name for parameter (tensor) sharding.
MODEL_AXIS = "model"


def reject_spatial_x_model(mesh, spatial_axis: str = "spatial",
                           axis: str = MODEL_AXIS) -> None:
    """Refuse meshes that combine activation-H ('spatial') and parameter
    ('model') sharding, in the JAX package's words (its SPMD partitioner
    miscompiles the pair; the JAX package refuses it, and so does the
    port, whose ``spatial`` and ``seq`` axes are not ported yet either).
    ``mesh``: a mesh or its ``{axis: size}`` shape."""
    shape = getattr(mesh, "shape", mesh)
    if shape.get(axis, 1) > 1:
        for act_axis in (spatial_axis, "seq"):
            if shape.get(act_axis, 1) > 1:
                raise NotImplementedError(
                    f"A mesh with both '{act_axis}' and '{axis}' axes is "
                    "rejected: the XLA SPMD partitioner (jax 0.9.0) "
                    "returns wrong numerics for activation-partitioned "
                    "convs with feature-sharded kernels (see "
                    "scripts/repro_spmd_spatial_model_conv.py). Use "
                    f"'data' x '{axis}' or 'data' x '{act_axis}' instead.")


def model_spec(shape, axis_size: int) -> int | None:
    """The flax dim of one leaf that splits over the axis (its trailing
    dim, when it divides ``axis_size``), or ``None`` (replicated)."""
    if (axis_size > 1 and len(shape) >= 1 and shape[-1] >= axis_size
            and shape[-1] % axis_size == 0):
        return len(shape) - 1
    return None


def model_leaves(net: nn.Module, axis_size: int) -> list[tuple[str, str, int]]:
    """``(flax path, port name, torch dim)`` of every parameter and buffer
    of ``net`` that splits over a ``model`` axis of ``axis_size``."""
    from vsr_tpu_torch.interop import _KERNEL_LAYOUTS, module_slots

    names = {id(t): n for n, t in
             [*net.named_parameters(), *net.named_buffers()]}
    out = []
    for path, tensor, transform in module_slots(net):
        shape = tuple(tensor.shape)
        dim = len(shape) - 1
        if transform in _KERNEL_LAYOUTS:
            dim, to_flax = _KERNEL_LAYOUTS[transform]
            shape = to_flax(shape)
        if model_spec(shape, axis_size) is not None:
            out.append(("/".join(path), names[id(tensor)], dim))
    return out


def block(full: torch.Tensor, dim: int, index: int, count: int
          ) -> torch.Tensor:
    """Block ``index`` of ``count`` equal blocks of ``full`` along ``dim``."""
    size = full.shape[dim] // count
    return full.narrow(dim, index * size, size)


def _map_tensors(fn: Callable, obj):
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(fn, v) for v in obj)
    return obj


def _column(module: nn.Module, group, channels: Callable | None) -> None:
    """Hooks making ``module`` column-parallel: inputs through ``copy_to``
    (then ``channels`` of the first, a BatchNorm's), the output gathered
    along the channels."""
    def pre(mod, args, kwargs):
        args = _map_tensors(lambda t: copy_to(t, group), args)
        kwargs = {k: _map_tensors(lambda t: copy_to(t, group), v)
                  for k, v in kwargs.items()}
        if channels is not None:
            args = (channels(args[0]), *args[1:])
        return args, kwargs

    module.register_forward_pre_hook(pre, with_kwargs=True)
    module.register_forward_hook(
        lambda mod, args, out: gather_from(out, 1, group))


def _gather_at_use(module: nn.Module, leaves: dict[str, int], group) -> None:
    """``module`` computes with its split leaves gathered whole."""
    forward = module.forward

    def gathered(*args, **kwargs):
        saved = {}
        for name, dim in leaves.items():
            store = (module._parameters if name in module._parameters
                     else module._buffers)
            saved[name] = (store, store[name])
            store[name] = gather_from(store[name], dim, group)
        try:
            return forward(*args, **kwargs)
        finally:
            for name, (store, value) in saved.items():
                store[name] = value

    module.forward = gathered


def shard_model_params(net: nn.Module, mesh, axis: str = MODEL_AXIS
                       ) -> dict[str, int]:
    """Cut every split leaf of ``net`` to this rank's block (in place, the
    same ``Parameter`` objects) and hook its modules as the module
    docstring says. Returns ``{port name: torch dim}`` of the split leaves;
    empty (and ``net`` untouched) on an axis of size 1."""
    from vsr_tpu_torch.interop import _KERNEL_LAYOUTS, module_slots
    from vsr_tpu_torch.models.common import BatchNorm

    size = mesh.size(axis)
    if size < 2:
        return {}
    index, group = mesh.coord(axis), mesh.group(axis)
    split = {name: dim for _, name, dim in model_leaves(net, size)}
    kernels = {id(t) for _, t, transform in module_slots(net)
               if transform in _KERNEL_LAYOUTS}
    with torch.no_grad():
        for name, dim in split.items():
            owner, leaf = net, name
            if "." in name:
                prefix, leaf = name.rsplit(".", 1)
                owner = net.get_submodule(prefix)
            tensor = getattr(owner, leaf)
            tensor.data = block(tensor.data, dim, index, size).clone()
    for prefix, module in net.named_modules():
        own = {n: split[f"{prefix}.{n}" if prefix else n]
               for n, _ in [*module.named_parameters(recurse=False),
                            *module.named_buffers(recurse=False)]
               if (f"{prefix}.{n}" if prefix else n) in split}
        if not own:
            continue
        if isinstance(module, BatchNorm):
            width = module.weight.shape[0]
            _column(module, group,
                    lambda x, w=width: x.narrow(1, index * w, w))
        elif id(getattr(module, "weight", None)) in kernels \
                and "weight" in own:
            _column(module, group, None)
        else:
            _gather_at_use(module, own, group)
    return split
