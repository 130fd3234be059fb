"""int8 serving: weight-only int8 and W8A8 convolutions (port of
``vsr_tpu/quantize.py``, its serving half).

Weight-only int8: every kernel leaf of the net's flax counterpart (flax
``kernel`` / DCN ``weight`` of rank >= 2, ``interop.kernel_leaves``) becomes
int8 with a per-output-channel symmetric scale; biases, PReLU, BatchNorm and
the MoE's ``router`` / ``expert_*`` stay float32. ``make_quantized_apply``
keeps the int8 tensors and scales on the net's device in place of the dense
kernels, which it frees, and dequantizes them at each call in the compute
dtype (``torch.func.functional_call``: the counterpart of
``net.apply(dequantize_params(...), x)``).

W8A8: ``make_w8a8_apply`` serves the eligible convs as ``s8 x s8 -> s32``
through the hand-written kernel of ``ops/w8a8_conv.py`` (the body of the JAX
``_w8a8_conv``), by intercepting them (``models/common.intercept_convs``, the
counterpart of ``nn.intercept_methods``). Eligible, as in the JAX package,
is the exact type of a flax ``nn.Conv``: the port's ``Conv`` and
``PlainConv2d``, and ``Conv3D`` unless it folds a shuffle; not
``FoldableConv`` / ``ShuffleConv`` (raw parameters in JAX), not the fused
squeeze (a ``nn.Conv`` subclass in JAX, so K1 keeps serving it), not a DCN
pack, not ``ConvTranspose``; and only with ``min(C_in, C_out) >=
min_channels`` at call time. Activation scales are dynamic (per call) or a
``{flax module path: scale}`` dict from :func:`calibrate_w8a8`; a JSON file
of either package serves the other.

Not ported, refused by name: quantization-aware training and
``quantize_deconvs=True``.
"""

from __future__ import annotations

from typing import Callable, Iterable, Mapping

import torch
from torch import nn

from vsr_tpu_torch.interop import SCAN_BODIES, kernel_leaves, module_slots
from vsr_tpu_torch.models.common import (Conv, Conv3D, PlainConv2d,
                                         compute_dtype, intercept_convs)
from vsr_tpu_torch.ops.w8a8_conv import w8a8_conv


def quantize_params(net: nn.Module) -> tuple[dict, dict]:
    """``({parameter name: int8 tensor}, {parameter name: float32 scale})``
    for every kernel leaf: ``scale = where(amax > 0, amax / 127, 1)`` per
    output channel (flax's last axis, the port's axis 0, or 1 for a deconv),
    broadcastable against the tensor; ``q = clip(round(w / scale), -127,
    127)``. On the parameters' device."""
    qparams, scales = {}, {}
    with torch.no_grad():
        for leaf in kernel_leaves(net):
            w = leaf.tensor.detach().float()
            dims = tuple(d for d in range(w.dim()) if d != leaf.out_axis)
            amax = w.abs().amax(dim=dims, keepdim=True)
            scale = torch.where(amax > 0, amax / 127.0,
                                torch.ones_like(amax))
            qparams[leaf.name] = torch.clamp(torch.round(w / scale), -127,
                                             127).to(torch.int8)
            scales[leaf.name] = scale
    return qparams, scales


def dequantize_params(qparams: Mapping[str, torch.Tensor],
                      scales: Mapping[str, torch.Tensor],
                      dtype: torch.dtype = torch.float32) -> dict:
    """``{name: (q * s)}`` in ``dtype``: ``(q.to(dtype) * s.to(dtype))``."""
    return {name: (q.to(dtype) * scales[name].to(dtype)).to(dtype)
            for name, q in qparams.items()}


class QuantizedApply(nn.Module):
    """``apply(x)`` of a net whose kernels are held in int8: the int8
    tensors and scales are buffers of this module (an exported program
    keeps them), the net's dense kernels are freed, and each call runs the
    net on the kernels dequantized in ``compute_dtype``."""

    def __init__(self, net: nn.Module, qparams: Mapping[str, torch.Tensor],
                 scales: Mapping[str, torch.Tensor],
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.net = net
        self.names = list(qparams)
        self.compute_dtype = compute_dtype
        for i, name in enumerate(self.names):
            self.register_buffer(f"q{i}", qparams[name])
            self.register_buffer(f"s{i}", scales[name])
            param = net.get_parameter(name)
            param.data = param.data.new_empty(0)  # the dense kernel, freed

    def forward(self, *args, **kwargs):
        params = dequantize_params(
            {n: getattr(self, f"q{i}") for i, n in enumerate(self.names)},
            {n: getattr(self, f"s{i}") for i, n in enumerate(self.names)},
            self.compute_dtype)
        return torch.func.functional_call(self.net, params, args, kwargs)


def make_quantized_apply(net: nn.Module, qparams, scales,
                         compute_dtype: torch.dtype = torch.float32
                         ) -> QuantizedApply:
    """The weight-only int8 apply (see :class:`QuantizedApply`); ``net``
    serves through it from then on."""
    return QuantizedApply(net, qparams, scales, compute_dtype)


def kernel_shapes(net: nn.Module) -> dict:
    """``{flax module path: flax kernel shape}`` for every kernel leaf: the
    key space of :func:`calibrate_w8a8`'s dicts."""
    return {leaf.path: leaf.flax_shape for leaf in kernel_leaves(net)}


def quantized_nbytes(net: nn.Module, qparams: Mapping[str, torch.Tensor]
                     ) -> int:
    """Bytes of the flax tree the int8 apply holds: the int8 kernels and
    every other parameter and buffer of the net's flax counterpart."""
    names = {id(t): n for n, t in [*net.named_parameters(),
                                   *net.named_buffers()]}
    total = 0
    for _, tensor, _ in module_slots(net):
        q = qparams.get(names[id(tensor)])
        total += (q if q is not None else tensor).nbytes
    return total


def filter_scales_by_kernel(net: nn.Module, act_scales: Mapping[str, float],
                            sizes: Iterable[int]) -> dict:
    """Keep the scales of convs whose spatial kernel size (the flax shape's
    first entry) is in ``sizes``; unknown paths are dropped."""
    sizes = {int(s) for s in sizes}
    shapes = kernel_shapes(net)
    return {path: s for path, s in act_scales.items()
            if path in shapes and int(shapes[path][0]) in sizes}


def kernel_size_filter(sizes: Iterable[int]) -> Callable[[nn.Module], bool]:
    """``conv_filter`` keeping the convs whose first kernel size is in
    ``sizes`` (the interceptor's twin of :func:`filter_scales_by_kernel`)."""
    sizes = {int(s) for s in sizes}
    return lambda mod: int(mod.kernel_size[0]) in sizes


def _refuse_deconvs(quantize_deconvs: bool) -> None:
    if quantize_deconvs:
        raise NotImplementedError(
            "quantize_deconvs=True is not yet ported to vsr_tpu_torch (the "
            "transposed convs serve full precision)")


def _conv_eligible(mod: nn.Module, x: torch.Tensor, min_channels: int,
                   conv_filter: Callable | None = None) -> bool:
    """The JAX predicate: the exact type of a flax ``nn.Conv``, a floating
    batched input of the conv's rank, ``min(C_in, C_out) >= min_channels``
    and ``conv_filter``."""
    kind = type(mod)
    if kind is Conv3D:
        if mod.fold_shuffle2d:
            return False
    elif kind not in (Conv, PlainConv2d):
        return False
    if x.dim() != len(mod.kernel_size) + 2 or not x.is_floating_point():
        return False
    if min(int(x.shape[1]), int(mod.out_channels)) < min_channels:
        return False
    return conv_filter is None or bool(conv_filter(mod))


def _w8a8_conv(mod: nn.Module, x: torch.Tensor,
               act_scale: float | None) -> torch.Tensor:
    """The intercepted body: the module's geometry and dense parameters
    through ``ops.w8a8_conv``, out in ``canonicalize_dtype(x, kernel, bias,
    dtype=mod.dtype)`` (a ``carry_f32`` conv's ``out_dtype`` is not read, as
    in JAX)."""
    out_dtype = compute_dtype(getattr(mod, "dtype", None), x, mod.weight)
    return w8a8_conv(x, mod.weight, mod.bias, act_scale, mod.stride,
                     mod.padding, mod.groups, out_dtype)


def _conv_paths(net: nn.Module) -> dict[int, str]:
    return {id(leaf.module): leaf.path for leaf in kernel_leaves(net)}


def make_w8a8_apply(net: nn.Module, act_scales="dynamic",
                    min_channels: int = 16,
                    conv_filter: Callable | None = None,
                    quantize_deconvs: bool = False) -> Callable:
    """``apply(x)`` serving the eligible convs of ``net`` as W8A8.
    ``act_scales``: ``"dynamic"`` or ``{flax module path: scale}`` (a conv
    without a scale serves full precision)."""
    _refuse_deconvs(quantize_deconvs)
    paths = _conv_paths(net)
    static = None if act_scales == "dynamic" else dict(act_scales)

    def interceptor(mod, x, plain):
        path = paths.get(id(mod))
        if path is None or not _conv_eligible(mod, x, min_channels,
                                              conv_filter):
            return plain(x)
        scale = None
        if static is not None:
            scale = static.get(path)
            if scale is None:
                return plain(x)
        return _w8a8_conv(mod, x, scale)

    def apply(x, **kwargs):
        with intercept_convs(interceptor):
            return net(x, **kwargs)

    return apply


def calibrate_w8a8(net: nn.Module, sample_inputs: Iterable[torch.Tensor],
                   min_channels: int = 16, method: str = "outputs",
                   conv_filter: Callable | None = None,
                   quantize_deconvs: bool = False) -> dict:
    """Static activation scales ``{flax module path: max(amax, 1e-8) /
    127}`` of the eligible convs, the amax of ``|x|`` over every call and
    every sample. ``method="outputs"`` (any method but ``"callback"``, as
    in JAX) leaves out the convs flax runs inside a scan body
    (``interop.SCAN_BODIES``): they serve full precision; ``"callback"``
    includes them, the maximum over the loop's iterations.
    The maxima stay on the device and come to the host once per sample."""
    _refuse_deconvs(quantize_deconvs)
    paths = _conv_paths(net)
    scan_body = SCAN_BODIES.get(type(net)) if method == "outputs" else None
    merged: dict[str, float] = {}
    for x in sample_inputs:
        stats: dict[str, torch.Tensor] = {}

        def record(mod, xin, plain):
            path = paths.get(id(mod))
            if (path is not None
                    and not (scan_body and path.startswith(scan_body))
                    and _conv_eligible(mod, xin, min_channels, conv_filter)):
                amax = xin.detach().float().abs().amax()
                prev = stats.get(path)
                stats[path] = amax if prev is None else torch.maximum(prev,
                                                                      amax)
            return plain(xin)

        with torch.inference_mode(), intercept_convs(record):
            net(x)
        if stats:
            values = torch.stack(list(stats.values())).cpu().tolist()
            for path, value in zip(stats, values):
                merged[path] = max(merged.get(path, 0.0), value)
    return {k: max(v, 1e-8) / 127.0 for k, v in merged.items()}
