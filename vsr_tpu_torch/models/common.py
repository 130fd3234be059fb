"""Shared model building blocks (NCHW), the port of ``vsr_tpu/models/common.py``.

Initialization follows torch's conv defaults as the JAX package restates
them: weight U(+-sqrt(1/fan_in)), bias U(+-1/sqrt(fan_in)), with fan_in =
k*k*C_in, drawn from an explicit ``torch.Generator`` (``None``: the global
one). Parameters are created on the CPU; the net moves them to its device.

Precision policy (flax's ``dtype``): a module's ``dtype`` is its *compute*
dtype, never its parameters'. The input, weight and bias are cast to it at
use (``promote_dtype(x, kernel, bias, dtype=...)``); with ``dtype=None`` the
module computes in the promotion of the input's and the weight's dtypes. So
a bf16 net keeps float32 parameters (and float32 optimizer state), and a
step of the optimizer moves them by what flax's does. ``out_dtype``
(``Conv``, ``Conv3D``) is ``make_accum_conv``: the conv of the compute-dtype
operands accumulated in ``out_dtype`` and not rounded back, with the plain
compute-dtype conv backward (``accum_conv``).

Interception (flax's ``nn.intercept_methods``): ``Conv``, ``Conv3D``,
``ConvTranspose``, ``PlainConv2d`` and ``PlainConvTranspose2d`` consult
:func:`intercept_convs`'s interceptor, which only a quantized apply, a
calibration or a QAT step of ``vsr_tpu_torch/quantize.py`` sets, for the
length of its call; without one each forward is the plain forward below.
It is a context variable, read when a forward runs: a CUDA graph captured
inside the block holds the intercepted kernels, and a
``torch.utils.checkpoint`` recompute, which runs in the backward (on
another thread on the card), re-enters it through
:func:`recompute_contexts` (:func:`remat_step` passes it).
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from vsr_tpu_torch.ops.fused_squeeze import concat_conv1x1
from vsr_tpu_torch.ops.fused_tail import (fuse_conv3d_through_shuffle2d,
                                          fuse_conv_through_shuffle)
from vsr_tpu_torch.ops.subpixel import conv_transpose_subpixel, phase_geometry


def resolve_dtype(dtype: torch.dtype | str | None) -> torch.dtype:
    """A net's ``dtype`` argument (``None``: float32; a ``torch.dtype`` or
    its name, e.g. ``"bfloat16"``)."""
    return _as_dtype(dtype) or torch.float32


def _as_dtype(dtype: torch.dtype | str | None) -> torch.dtype | None:
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def compute_dtype(dtype: torch.dtype | None, x: torch.Tensor,
                  weight: torch.Tensor) -> torch.dtype:
    """flax's ``promote_dtype``: the module's ``dtype``, else the promotion
    of the input's and the weight's."""
    return dtype or torch.promote_types(x.dtype, weight.dtype)


def _cast(t: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor | None:
    return None if t is None else t.to(dtype)


class _AccumConv(torch.autograd.Function):
    """``make_accum_conv``'s custom VJP: the forward convolves the
    compute-dtype operands in ``out_dtype`` (for bf16 operands and a float32
    ``out_dtype`` that is the bf16 product accumulated in float32, exact
    products, one rounding per add, no rounding of the result; TF32 is
    switched off for the call), the backward is the plain compute-dtype
    conv backward with the cotangent cast down first."""

    @staticmethod
    def forward(ctx, x, weight, out_dtype, stride, padding):
        ctx.save_for_backward(x, weight)
        ctx.geometry = (stride, padding)
        conv = F.conv2d if x.dim() == 4 else F.conv3d
        cudnn, matmul = (torch.backends.cudnn.allow_tf32,
                         torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return conv(x.to(out_dtype), weight.to(out_dtype), None, stride,
                        padding)
        finally:
            torch.backends.cudnn.allow_tf32 = cudnn
            torch.backends.cuda.matmul.allow_tf32 = matmul

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        stride, padding = ctx.geometry
        nd = x.dim() - 2
        dx, dw, _ = torch.ops.aten.convolution_backward(
            grad.to(x.dtype), x, weight, None, list(stride), list(padding),
            [1] * nd, False, [0] * nd, 1,
            [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return dx, dw, None, None, None


def accum_conv(x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor | None, out_dtype: torch.dtype,
               stride, padding) -> torch.Tensor:
    """A 2D or 3D conv of compute-dtype ``x`` and ``weight`` emitted in
    ``out_dtype`` (``_AccumConv``); the compute-dtype ``bias`` is added in
    ``out_dtype`` outside it, as flax adds it after its conv, so its
    gradient is summed in ``out_dtype`` and rounded to the compute dtype."""
    y = _AccumConv.apply(x, weight, out_dtype, tuple(stride), tuple(padding))
    return y if bias is None else y + bias.to(out_dtype).reshape(
        -1, *[1] * (x.dim() - 2))


# ``interceptor(module, x, plain) -> output`` while one is active, where
# ``plain(x)`` is the module's own forward (a context variable: another
# thread's calls are not intercepted).
_INTERCEPTOR: contextvars.ContextVar[Callable | None] = contextvars.ContextVar(
    "conv_interceptor", default=None)


@contextlib.contextmanager
def intercept_convs(interceptor: Callable):
    """Route every forward of a ``Conv``, ``Conv3D``, ``ConvTranspose`` and
    ``PlainConv2d`` through ``interceptor(module, x, plain)`` inside the
    block."""
    token = _INTERCEPTOR.set(interceptor)
    try:
        yield
    finally:
        _INTERCEPTOR.reset(token)


def recompute_contexts():
    """``torch.utils.checkpoint``'s ``context_fn``: the recompute runs under
    the interceptor that the forward ran under."""
    interceptor = _INTERCEPTOR.get()
    return contextlib.nullcontext(), (
        contextlib.nullcontext() if interceptor is None
        else intercept_convs(interceptor))


def remat_step(remat: bool, step: Callable, *args):
    """A recurrent net's step, under ``torch.utils.checkpoint`` when
    ``remat`` is set and a gradient is recorded: its activations are
    recomputed in the backward, under the forward's interceptor. The steps
    draw no random numbers: no generator state is saved and restored (nor
    read inside a captured CUDA graph)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(step, *args, use_reentrant=False,
                          preserve_rng_state=False,
                          context_fn=recompute_contexts)
    return step(*args)


def _intercepted(module: nn.Module, x: torch.Tensor,
                 plain: Callable) -> torch.Tensor:
    interceptor = _INTERCEPTOR.get()
    return plain(x) if interceptor is None else interceptor(module, x, plain)


def torch_default_init_(weight: torch.Tensor, bias: torch.Tensor | None,
                        fan_in: int,
                        generator: torch.Generator | None) -> None:
    with torch.no_grad():
        weight.uniform_(-math.sqrt(1.0 / fan_in), math.sqrt(1.0 / fan_in),
                        generator=generator)
        if bias is not None:
            bound = 1.0 / math.sqrt(fan_in)
            bias.uniform_(-bound, bound, generator=generator)


class Conv(nn.Conv2d):
    """2D conv with torch-geometry padding (``kernel_size=3, padding=1``
    keeps the size). ``dtype`` / ``out_dtype``: the precision policy of the
    module docstring."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 1,
                 bias: bool = True, *, dtype: torch.dtype | str | None = None,
                 out_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, bias=bias)
        self.dtype = _as_dtype(dtype)
        self.out_dtype = out_dtype
        torch_default_init_(self.weight, self.bias,
                            kernel_size * kernel_size * in_channels, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _intercepted(self, x, self._plain)

    def _plain(self, x: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype(self.dtype, x, self.weight)
        x, w, b = x.to(dt), self.weight.to(dt), _cast(self.bias, dt)
        if self.out_dtype is not None:
            return accum_conv(x, w, b, self.out_dtype, self.stride,
                              self.padding)
        return self._conv_forward(x, w, b)


class Conv3D(nn.Conv3d):
    """3D conv, NCDHW (the JAX one is NDHWC), per-dim pixel padding,
    torch-default init.

    ``fold_shuffle2d=r`` (> 0): the conv consumes the PRE-shuffle array
    (``in_channels * r^2`` channels) of a ``pixel_shuffle_2d_in_3d(., r)``
    that would otherwise precede it and computes the conv folded through
    that shuffle (``ops/fused_tail.py``); it returns the pre-shuffle result
    (``out_channels * r^2`` channels) for the caller to shuffle. The weight
    and bias are the unfolded conv's, so checkpoints interchange. The weight
    and bias are cast to the compute dtype first, then folded (as the JAX
    module does). ``dtype`` / ``out_dtype``: the module docstring's policy;
    ``out_dtype`` with ``fold_shuffle2d`` is refused, as in the JAX module.

    With ``dtype=None`` the folded conv computes in the promotion of the
    input's and the weight's dtypes, like the unfolded one; the JAX module
    computes its folded conv in the input's dtype there
    (``vsr_tpu/models/common.py:318``), so a bf16 input to an f32 conv
    folds in bf16 in the JAX package and in float32 here."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: tuple[int, int, int] = (3, 3, 3),
                 strides: tuple[int, int, int] = (1, 1, 1),
                 padding: tuple[int, int, int] = (1, 1, 1),
                 bias: bool = True, *, fold_shuffle2d: int = 0,
                 dtype: torch.dtype | str | None = None,
                 out_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        k = tuple(kernel_size)
        if fold_shuffle2d:
            if out_dtype is not None:
                raise NotImplementedError(
                    "fold_shuffle2d ignores out_dtype (the folded conv has "
                    "no accumulation-dtype hook): the combination is refused")
            if tuple(strides) != (1, 1, 1) or not (k[1] % 2 and k[2] % 2):
                raise NotImplementedError(
                    "fold_shuffle2d supports stride-1, odd-H/W-kernel "
                    f"convs only (got strides={tuple(strides)}, kernel={k})")
            if tuple(padding[1:]) != (k[1] // 2, k[2] // 2):
                raise NotImplementedError(
                    f"fold_shuffle2d needs SAME H/W padding "
                    f"({k[1] // 2}, {k[2] // 2}); got {tuple(padding[1:])}")
        super().__init__(in_channels, out_channels, k, tuple(strides),
                         tuple(padding), bias=bias)
        self.fold_shuffle2d = fold_shuffle2d
        self.dtype = _as_dtype(dtype)
        self.out_dtype = out_dtype
        torch_default_init_(self.weight, self.bias,
                            math.prod(kernel_size) * in_channels, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _intercepted(self, x, self._plain)

    def _plain(self, x: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype(self.dtype, x, self.weight)
        x, w, b = x.to(dt), self.weight.to(dt), _cast(self.bias, dt)
        if self.out_dtype is not None:
            return accum_conv(x, w, b, self.out_dtype, self.stride,
                              self.padding)
        if not self.fold_shuffle2d:
            return self._conv_forward(x, w, b)
        K, B = fuse_conv3d_through_shuffle2d(w, b, self.fold_shuffle2d)
        return F.conv3d(x, K, B, padding=(self.padding[0], K.shape[-2] // 2,
                                          K.shape[-1] // 2))


def pixel_shuffle_2d_in_3d(x: torch.Tensor, r: int) -> torch.Tensor:
    """(N, C*r^2, D, H, W) -> (N, C, D, H*r, W*r): the in-plane shuffle of
    the volumetric tails, channels packed ``c*r^2 + i*r + j`` for row phase
    ``i`` and column phase ``j`` (the JAX function's and
    ``F.pixel_shuffle``'s packing); depth is untouched."""
    n, c, d, h, w = x.shape
    x = x.reshape(n, c // (r * r), r, r, d, h, w)
    x = x.permute(0, 1, 4, 5, 2, 6, 3)  # (n, c, d, h, i, w, j)
    return x.reshape(n, c // (r * r), d, h * r, w * r)


class ConvTranspose(nn.ConvTranspose2d):
    """torch.nn.ConvTranspose2d geometry: out = (in-1)*stride - 2*padding +
    kernel (x2 projection: k6 s2 p2). Weight (C_in, C_out, k, k).

    ``subpixel=True`` computes the same map as one stride-1 phase conv +
    ``F.pixel_shuffle`` (``ops/subpixel.py``), with the same parameters, so
    checkpoints interchange; it needs ``kernel - 2 * padding == stride``."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 4, stride: int = 2, padding: int = 1,
                 bias: bool = True, *, dtype: torch.dtype | str | None = None,
                 subpixel: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, bias=bias)
        if subpixel:
            phase_geometry(kernel_size, stride, padding)  # refuses early
        self.dtype = _as_dtype(dtype)
        self.subpixel = subpixel
        torch_default_init_(self.weight, self.bias,
                            kernel_size * kernel_size * in_channels, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _intercepted(self, x, self._plain)

    def _plain(self, x: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype(self.dtype, x, self.weight)
        if self.subpixel:
            return conv_transpose_subpixel(
                x.to(dt), self.weight.to(dt), _cast(self.bias, dt),
                self.stride[0], self.padding[0])
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt),
                                  _cast(self.bias, dt), self.stride,
                                  self.padding, self.output_padding,
                                  self.groups, self.dilation)


class PlainConv2d(nn.Conv2d):
    """``nn.Conv2d`` as it is (its init and its forward) where the JAX net
    uses a flax ``nn.Conv`` directly (EDVR's residual blocks, FRVSR), with
    the interception point of the module docstring. ``dtype`` /
    ``out_dtype`` (keywords; ``nn.Conv2d``'s own ``dtype`` would be the
    parameters'): the precision policy of the module docstring."""

    def __init__(self, *args, dtype: torch.dtype | str | None = None,
                 out_dtype: torch.dtype | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.dtype = _as_dtype(dtype)
        self.out_dtype = out_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _intercepted(self, x, self._plain)

    def _plain(self, x: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype(self.dtype, x, self.weight)
        x, w, b = x.to(dt), self.weight.to(dt), _cast(self.bias, dt)
        if self.out_dtype is not None:
            return accum_conv(x, w, b, self.out_dtype, self.stride,
                              self.padding)
        return self._conv_forward(x, w, b)


class PlainConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` as it is where the JAX net uses a flax
    ``nn.ConvTranspose`` directly (FRVSR), with the interception point;
    ``dtype``: the compute dtype, as :class:`PlainConv2d`'s."""

    def __init__(self, *args, dtype: torch.dtype | str | None = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.dtype = _as_dtype(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _intercepted(self, x, self._plain)

    def _plain(self, x: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype(self.dtype, x, self.weight)
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt),
                                  _cast(self.bias, dt), self.stride,
                                  self.padding, self.output_padding,
                                  self.groups, self.dilation)


class BatchNorm(nn.Module):
    """BatchNorm over every axis but the channel axis 1 (any rank), with
    flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` semantics.

    Train mode normalizes with the batch's biased statistics and updates
    the buffers as ``(1 - momentum) * running + momentum * batch`` with the
    *biased* batch variance (``nn.BatchNorm*d`` folds in the unbiased one,
    so its running variance drifts from flax's every step). Eval mode
    normalizes with the buffers. The buffers keep ``nn.BatchNorm*d``'s
    names, ``running_mean`` and ``running_var``; there is no
    ``num_batches_tracked`` (flax has no such counter)."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        with torch.no_grad():
            # The statistics of a low-precision input in float32, as flax
            # reduces them (the normalization itself runs in float32 and
            # rounds its output to the input's dtype either way).
            dims = [d for d in range(x.dim()) if d != 1]
            var, mean = torch.var_mean(
                x.to(torch.promote_types(x.dtype, torch.float32)), dim=dims,
                correction=0)
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(mean, alpha=m)
            self.running_var.mul_(1 - m).add_(var, alpha=m)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


class FoldableConv(Conv):
    """SAME conv that can alternatively run FOLDED through the
    ``pixel_shuffle(factor)`` that would otherwise precede it.

    ``forward(x)``: a plain SAME conv on the post-shuffle array.
    ``forward(pre, folded=True)``: consumes the PRE-shuffle array
    (``C_in * factor^2`` channels) and returns the PRE-shuffle result
    (``C_out * factor^2`` channels) through the folded weight
    (ops/fused_tail.py). One parameter set serves both modes. Both compute
    in ``dtype``, else in the input's dtype (the JAX module's rule); the
    weight is cast before it is folded."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, factor: int = 2, *,
                 dtype: torch.dtype | str | None = None,
                 generator: torch.Generator | None = None):
        if kernel_size % 2 == 0:
            raise ValueError(
                f"FoldableConv requires an odd kernel, got {kernel_size}")
        super().__init__(in_channels, out_channels, kernel_size,
                         padding=kernel_size // 2, dtype=dtype,
                         generator=generator)
        self.factor = factor

    def forward(self, x: torch.Tensor, folded: bool = False) -> torch.Tensor:
        dt = self.dtype or x.dtype
        x, w, b = x.to(dt), self.weight.to(dt), self.bias.to(dt)
        if not folded:
            return self._conv_forward(x, w, b)
        K, B = fuse_conv_through_shuffle(w, b, self.factor)
        return F.conv2d(x, K, B, padding=K.shape[-1] // 2)


class ShuffleConv(nn.Module):
    """``pixel_shuffle(factor)`` then a SAME conv — the sub-pixel tail —
    or, with ``fused``, the conv folded through the shuffle so the
    full-resolution intermediate never materializes. Same parameters."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, factor: int = 2, fused: bool = False,
                 *, dtype: torch.dtype | str | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.factor = factor
        self.fused = fused
        self.conv = FoldableConv(in_channels, out_channels, kernel_size,
                                 factor, dtype=dtype, generator=generator)

    def forward(self, pre: torch.Tensor) -> torch.Tensor:
        """pre: (N, C*factor^2, H, W) -> (N, out_channels, H*f, W*f)."""
        if self.fused:
            return F.pixel_shuffle(self.conv(pre, folded=True), self.factor)
        return self.conv(F.pixel_shuffle(pre, self.factor))


class FusedSqueezeConv(nn.Module):
    """1x1 conv over the channel concat of a LIST of inputs, computed by the
    fused concat + 1x1 kernel (``ops/fused_squeeze.py``): the concat never
    materializes. Weight ``(F, sum C)`` and bias ``(F,)``, initialized as
    the 1x1 conv it stands in for. ``forward(xs, prelu_weight)`` also
    applies the PReLU that follows the squeeze, in the kernel's epilogue.
    The inputs, weight and bias are cast to the compute dtype before the
    kernel, as flax's ``_FusedSqueezeConv`` promotes them, so in bf16 the
    kernel's ``dW`` / ``db`` (summed in float32) are rounded to bf16 before
    they reach the float32 parameters, as in the JAX backward."""

    def __init__(self, in_channels: int, out_channels: int, *,
                 dtype: torch.dtype | str | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.in_channels = in_channels
        self.dtype = _as_dtype(dtype)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels))
        self.bias = nn.Parameter(torch.empty(out_channels))
        torch_default_init_(self.weight, self.bias, in_channels, generator)

    def forward(self, xs: list[torch.Tensor],
                prelu_weight: torch.Tensor | None = None) -> torch.Tensor:
        dt = compute_dtype(self.dtype, xs[0], self.weight)
        return concat_conv1x1([x.to(dt) for x in xs], self.weight.to(dt),
                              self.bias.to(dt), prelu_weight)
