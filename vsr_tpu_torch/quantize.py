"""int8 serving, W8A8 convolutions and quantization-aware training (port of
``vsr_tpu/quantize.py``).

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
pack; and only with ``min(C_in, C_out) >= min_channels`` at call time.
With ``quantize_deconvs`` also the transposed convs that stand for a flax
``nn.ConvTranspose`` (``ConvTranspose`` without ``subpixel``, which stands
for JAX's ``_SubpixelConvTranspose``, and ``PlainConvTranspose2d``) whose
output is ``stride`` times the input: :func:`_w8a8_deconv` quantizes the
deconv's weights whole (one scale per output channel over every tap, as
JAX's ``_w8a8_conv``), slices the int8 sub-pixel bank of
``ops/subpixel.py`` from them and runs it through ``w8a8_conv`` and
``F.pixel_shuffle``: the same int32 sums as JAX's int8
``lax.conv_transpose``, in another order. Activation scales are dynamic
(per call) or a ``{flax module path: scale}`` dict from
:func:`calibrate_w8a8`; a JSON file of either package serves the other.

QAT (``make_qat_interceptor``, ``resolve_qat``, the trainers' ``qat``):
the same eligible convs run :func:`fake_quant_conv`, the differentiable
twin of the W8A8 body: the same scales (the activation's dynamic or
static, each output channel's weight scale, both without a gradient), a
float32 conv over the fake-quantized operands, the bias, a cast to the
module's dtype. :func:`fake_quant` passes the gradient straight through
``round`` and masks it where ``clip`` clips, with the JAX package's 0.5 on
a value that lands exactly on the clip bound (``jnp.clip``'s subgradient).
It is plain PyTorch (an elementwise pass and a cuDNN float32 conv): the
JAX package computes it in XLA, outside any Pallas kernel. With
``quantize_deconvs`` QAT also takes the transposed convs that W8A8 serving
takes.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Iterable, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vsr_tpu_torch.interop import SCAN_BODIES, kernel_leaves, module_slots
from vsr_tpu_torch.models.common import (Conv, Conv3D, ConvTranspose,
                                         PlainConv2d, PlainConvTranspose2d,
                                         compute_dtype, intercept_convs)
from vsr_tpu_torch.ops.subpixel import phase_padding, subpixel_bank
from vsr_tpu_torch.ops.w8a8_conv import quantize_weight, w8a8_conv


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
            scale = channel_scale(w, leaf.out_axis)
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


_DECONVS = (ConvTranspose, PlainConvTranspose2d)


def _deconv_eligible(mod: nn.Module) -> bool:
    """A transposed conv the sub-pixel bank computes: not a sub-pixel
    ``ConvTranspose`` (JAX's ``_SubpixelConvTranspose``, never
    intercepted), one group, no dilation, square geometry with an output
    ``stride`` times the input (every deconv of the zoo). The weight is
    ``(C_in, C_out, k, k)``, JAX's ``transpose_kernel=False`` layout."""
    if getattr(mod, "subpixel", False) or mod.groups != 1:
        return False
    if len({*mod.kernel_size}) != 1 or len({*mod.stride}) != 1 or len(
            {*mod.padding}) != 1 or len({*mod.output_padding}) != 1:
        return False
    if mod.dilation != (1, 1):
        return False
    k, s, p, op = (mod.kernel_size[0], mod.stride[0], mod.padding[0],
                   mod.output_padding[0])
    return k - 2 * p + op == s


def _conv_eligible(mod: nn.Module, x: torch.Tensor, min_channels: int,
                   conv_filter: Callable | None = None,
                   quantize_deconvs: bool = False) -> bool:
    """The JAX predicate: the exact type of a flax ``nn.Conv`` (or, with
    ``quantize_deconvs``, of a flax ``nn.ConvTranspose``), a floating
    batched input of the conv's rank, ``min(C_in, C_out) >= min_channels``
    and ``conv_filter``."""
    kind = type(mod)
    if kind is Conv3D:
        if mod.fold_shuffle2d:
            return False
    elif kind in _DECONVS:
        if not (quantize_deconvs and _deconv_eligible(mod)):
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


def deconv_bank(mod: nn.Module) -> dict:
    """The int8 sub-pixel bank of an eligible transposed conv: its ``(C_in,
    C_out, k, k)`` weights quantized whole, per output channel (the scale
    of JAX's ``_w8a8_conv``: the amax over every axis but ``out``), the
    bank sliced from the int8 weights (``ops/subpixel.subpixel_bank``), each
    channel's scale and bias repeated over its ``stride^2`` phases, and the
    bank conv's zero padding ``(before, after)`` and the shuffle's
    ``stride``."""
    k, s, p, op = (mod.kernel_size[0], mod.stride[0], mod.padding[0],
                   mod.output_padding[0])
    wq, ws = quantize_weight(mod.weight.transpose(0, 1))
    return {"weight": subpixel_bank(wq.transpose(0, 1), s, p,
                                    op).contiguous(),
            "weight_scale": ws.repeat_interleave(s * s),
            "bias": (None if mod.bias is None
                     else mod.bias.repeat_interleave(s * s)),
            "padding": phase_padding(k, s, p, op), "stride": s}


def _w8a8_deconv(mod: nn.Module, x: torch.Tensor, act_scale: float | None,
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The intercepted body of an eligible transposed conv: its bank
    (:func:`deconv_bank`) through ``w8a8_conv`` at stride 1, then
    ``F.pixel_shuffle``. Out in the module's compute dtype, as
    :func:`_w8a8_conv` (``out_dtype``: another, ``torch.int32`` for the
    accumulators)."""
    out_dtype = out_dtype or compute_dtype(getattr(mod, "dtype", None), x,
                                           mod.weight)
    bank = deconv_bank(mod)
    (before, after), pad = bank["padding"], bank["padding"][0]
    if before != after:  # zeros quantize to 0, as the conv's own padding
        x, pad = F.pad(x, (before, after, before, after)), 0
    out = w8a8_conv(x, bank["weight"], bank["bias"], act_scale, (1, 1),
                    (pad, pad), 1, out_dtype,
                    weight_scale=bank["weight_scale"])
    return F.pixel_shuffle(out, bank["stride"])


def _w8a8_body(mod: nn.Module, x: torch.Tensor,
               act_scale: float | None) -> torch.Tensor:
    return (_w8a8_deconv if isinstance(mod, _DECONVS) else _w8a8_conv)(
        mod, x, act_scale)


class _FakeQuant(torch.autograd.Function):
    """``s * (clip(x / s) + stop_grad(round(clip(x / s)) - clip(x / s)))``
    and its JAX gradient ``((g * s) * mask) / s``: ``mask`` is 1 inside the
    bounds, 0 outside and 0.5 exactly on one (``jnp.clip`` is ``minimum(
    maximum(x, lo), hi)``, whose tie takes half). ``s`` takes no gradient."""

    @staticmethod
    def forward(ctx, x, scale, qmax):
        xs = x / scale
        clipped = torch.clamp(xs, -qmax, qmax)
        ctx.save_for_backward(xs, scale)
        ctx.qmax = qmax
        return scale * (clipped + (torch.round(clipped) - clipped))

    @staticmethod
    def backward(ctx, grad):
        xs, scale = ctx.saved_tensors
        mag = xs.abs()
        mask = torch.where(mag < ctx.qmax, 1.0,
                           torch.where(mag == ctx.qmax, 0.5, 0.0))
        return (grad * scale * mask) / scale, None, None


def fake_quant(x: torch.Tensor, scale: torch.Tensor,
               qmax: float = 127.0) -> torch.Tensor:
    """``round(clip(x / s, +-qmax)) * s`` with straight-through gradients
    (``vsr_tpu.quantize.fake_quant``): 1 where ``|x / s| < qmax``, 0.5 where
    it equals ``qmax``, 0 where clipped. ``round`` is half to even."""
    return _FakeQuant.apply(x, torch.as_tensor(scale, dtype=x.dtype,
                                               device=x.device), float(qmax))


# QAT's scales are the jitted JAX step's: XLA computes ``amax / 127.0`` as
# ``amax * float32(1 / 127)``, which puts a channel's largest weight on
# either side of 127 where the division puts it on 127 (the tie's 0.5).
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def channel_scale(w: torch.Tensor, out_axis: int,
                  jitted: bool = False) -> torch.Tensor:
    """Per output channel ``where(amax > 0, amax / 127, 1)`` of ``|w|``
    (``jitted``: ``amax * float32(1 / 127)``), broadcastable against ``w``;
    no gradient."""
    w = w.detach().float()
    dims = tuple(d for d in range(w.dim()) if d != out_axis)
    amax = w.abs().amax(dim=dims, keepdim=True)
    return torch.where(amax > 0, amax * _INV_127 if jitted else amax / 127.0,
                       torch.ones_like(amax))


def fake_quant_conv(mod: nn.Module, x: torch.Tensor,
                    act_scale: float | None, out_axis: int) -> torch.Tensor:
    """The differentiable twin of the W8A8 body (``_fake_quant_conv``): the
    activation scale (``max(amax, 1e-8) / 127`` over the whole input, or the
    static ``act_scale``) and the weight's per-channel scale, both without
    a gradient and both as the jitted JAX step computes them (``_INV_127``);
    the module's conv in float32 over the fake-quantized operands, then the
    bias, then a cast to the module's dtype."""
    out_dtype = compute_dtype(getattr(mod, "dtype", None), x, mod.weight)
    x = x.float()
    if act_scale is None:
        xs = torch.clamp_min(x.detach().abs().amax(), 1e-8) * _INV_127
    else:
        xs = torch.tensor(act_scale, dtype=torch.float32, device=x.device)
    w = mod.weight.float()
    xq = fake_quant(x, xs)
    wq = fake_quant(w, channel_scale(w, out_axis, jitted=True))
    if isinstance(mod, _DECONVS):
        out = F.conv_transpose2d(xq, wq, None, mod.stride, mod.padding,
                                 mod.output_padding, mod.groups,
                                 mod.dilation)
    else:
        out = mod._conv_forward(xq, wq, None)
    if mod.bias is not None:
        out = out + mod.bias.float().reshape(-1, *[1] * (out.dim() - 2))
    return out.to(out_dtype)


def _conv_interceptor(net: nn.Module, body: Callable, act_scales,
                      min_channels: int, conv_filter: Callable | None,
                      quantize_deconvs: bool) -> Callable:
    """``interceptor(mod, x, plain)`` sending the eligible convs of ``net``
    to ``body(mod, x, act_scale, out_axis)`` (``out_axis``: the weight's
    output-channel axis); under static scales a conv without one runs its
    plain forward (the JAX interceptors' fallback)."""
    leaves = {id(leaf.module): leaf for leaf in kernel_leaves(net)}
    static = None if act_scales == "dynamic" else dict(act_scales)

    def interceptor(mod, x, plain):
        leaf = leaves.get(id(mod))
        if leaf is None or not _conv_eligible(mod, x, min_channels,
                                              conv_filter, quantize_deconvs):
            return plain(x)
        scale = None
        if static is not None:
            scale = static.get(leaf.path)
            if scale is None:
                return plain(x)
        return body(mod, x, scale, leaf.out_axis)

    return interceptor


def _conv_paths(net: nn.Module) -> dict[int, str]:
    return {id(leaf.module): leaf.path for leaf in kernel_leaves(net)}


def make_w8a8_apply(net: nn.Module, act_scales="dynamic",
                    min_channels: int = 16,
                    conv_filter: Callable | None = None,
                    quantize_deconvs: bool = False) -> Callable:
    """``apply(x)`` serving the eligible convs of ``net`` as W8A8.
    ``act_scales``: ``"dynamic"`` or ``{flax module path: scale}`` (a conv
    without a scale serves full precision); ``quantize_deconvs``: the
    transposed convs too (:func:`_w8a8_deconv`)."""
    interceptor = _conv_interceptor(
        net, lambda mod, x, scale, _: _w8a8_body(mod, x, scale), act_scales,
        min_channels, conv_filter, quantize_deconvs)

    def apply(x, **kwargs):
        with intercept_convs(interceptor):
            return net(x, **kwargs)

    return apply


def make_qat_interceptor(net: nn.Module, act_scales="dynamic",
                         min_channels: int = 16,
                         conv_filter: Callable | None = None,
                         quantize_deconvs: bool = False) -> Callable:
    """The interceptor (``models/common.intercept_convs``) that runs the
    eligible convs of ``net`` as :func:`fake_quant_conv`; the knobs are
    :func:`make_w8a8_apply`'s, and under static scales a conv without a
    scale runs full precision, as it serves. The net is an argument here,
    where flax's interceptor reads each module's path from the module."""
    return _conv_interceptor(
        net, lambda *args: fake_quant_conv(*args), act_scales, min_channels,
        conv_filter, quantize_deconvs)


def make_fake_quant_apply(net: nn.Module, act_scales="dynamic",
                          min_channels: int = 16,
                          conv_filter: Callable | None = None,
                          quantize_deconvs: bool = False) -> Callable:
    """``apply(x)`` running the fake-quant forward: the differentiable
    stand-in for :func:`make_w8a8_apply`."""
    interceptor = make_qat_interceptor(net, act_scales, min_channels,
                                       conv_filter, quantize_deconvs)

    def apply(x, **kwargs):
        with intercept_convs(interceptor):
            return net(x, **kwargs)

    return apply


def resolve_qat(qat, net: nn.Module) -> Callable:
    """A trainer's ``qat`` option as the interceptor for ``net``: ``True``
    (dynamic scales, the defaults) or a dict of ``act_scales``
    (``"dynamic"``, ``{flax module path: scale}`` or the path of such a
    JSON file), ``min_channels``, ``kernels`` (spatial sizes, as
    ``--w8a8-kernels``) and ``quantize_deconvs``. An unknown key raises."""
    qat = {} if qat is True else dict(qat)
    scales = qat.pop("act_scales", "dynamic")
    if isinstance(scales, str) and scales != "dynamic":
        scales = {k: float(v)
                  for k, v in json.loads(Path(scales).read_text()).items()}
    kernels = qat.pop("kernels", None)
    interceptor = make_qat_interceptor(
        net, act_scales=scales,
        min_channels=int(qat.pop("min_channels", 16)),
        conv_filter=kernel_size_filter(kernels) if kernels else None,
        quantize_deconvs=bool(qat.pop("quantize_deconvs", False)))
    if qat:
        raise ValueError(f"unknown qat option(s): {sorted(qat)} — valid "
                         "keys: act_scales, min_channels, kernels, "
                         "quantize_deconvs")
    return interceptor


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
    ``quantize_deconvs``: the eligible transposed convs' inputs too.
    The maxima stay on the device and come to the host once per sample."""
    paths = _conv_paths(net)
    scan_body = SCAN_BODIES.get(type(net)) if method == "outputs" else None
    merged: dict[str, float] = {}
    for x in sample_inputs:
        stats: dict[str, torch.Tensor] = {}

        def record(mod, xin, plain):
            path = paths.get(id(mod))
            if (path is not None
                    and not (scan_body and path.startswith(scan_body))
                    and _conv_eligible(mod, xin, min_channels, conv_filter,
                                       quantize_deconvs)):
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
