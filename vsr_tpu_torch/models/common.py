"""Shared model building blocks (NCHW), the port of ``vsr_tpu/models/common.py``.

Initialization follows torch's conv defaults as the JAX package restates
them: weight U(+-sqrt(1/fan_in)), bias U(+-1/sqrt(fan_in)), with fan_in =
k*k*C_in, drawn from an explicit ``torch.Generator`` (``None``: the global
one). Parameters are created on the CPU; the net moves them to its device.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from vsr_tpu_torch.ops.fused_squeeze import concat_conv1x1
from vsr_tpu_torch.ops.fused_tail import (fuse_conv3d_through_shuffle2d,
                                          fuse_conv_through_shuffle)


def resolve_dtype(dtype: torch.dtype | str | None) -> torch.dtype:
    """A net's ``dtype`` argument (``None``: float32; a ``torch.dtype`` or
    its name, e.g. ``"bfloat16"``)."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return dtype or torch.float32


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
    keeps the size)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 1,
                 bias: bool = True, *,
                 generator: torch.Generator | None = None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, bias=bias)
        torch_default_init_(self.weight, self.bias,
                            kernel_size * kernel_size * in_channels, generator)


class Conv3D(nn.Conv3d):
    """3D conv, NCDHW (the JAX one is NDHWC), per-dim pixel padding,
    torch-default init.

    ``fold_shuffle2d=r`` (> 0): the conv consumes the PRE-shuffle array
    (``in_channels * r^2`` channels) of a ``pixel_shuffle_2d_in_3d(., r)``
    that would otherwise precede it and computes the conv folded through
    that shuffle (``ops/fused_tail.py``); it returns the pre-shuffle result
    (``out_channels * r^2`` channels) for the caller to shuffle. The weight
    and bias are the unfolded conv's, so checkpoints interchange. The JAX
    module's ``out_dtype`` (an f32 output under bf16 compute) is refused."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: tuple[int, int, int] = (3, 3, 3),
                 strides: tuple[int, int, int] = (1, 1, 1),
                 padding: tuple[int, int, int] = (1, 1, 1),
                 bias: bool = True, *, fold_shuffle2d: int = 0,
                 out_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        if out_dtype:
            raise NotImplementedError(
                "Conv3D out_dtype is not yet ported to vsr_tpu_torch")
        k = tuple(kernel_size)
        if fold_shuffle2d:
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
        torch_default_init_(self.weight, self.bias,
                            math.prod(kernel_size) * in_channels, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fold_shuffle2d:
            return super().forward(x)
        K, B = fuse_conv3d_through_shuffle2d(self.weight, self.bias,
                                             self.fold_shuffle2d)
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
    kernel (x2 projection: k6 s2 p2). Weight (C_in, C_out, k, k)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 4, stride: int = 2, padding: int = 1,
                 bias: bool = True, *,
                 generator: torch.Generator | None = None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, bias=bias)
        torch_default_init_(self.weight, self.bias,
                            kernel_size * kernel_size * in_channels, generator)


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
            dims = [d for d in range(x.dim()) if d != 1]
            var, mean = torch.var_mean(x, dim=dims, correction=0)
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
    (ops/fused_tail.py). One parameter set serves both modes."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, factor: int = 2, *,
                 generator: torch.Generator | None = None):
        if kernel_size % 2 == 0:
            raise ValueError(
                f"FoldableConv requires an odd kernel, got {kernel_size}")
        super().__init__(in_channels, out_channels, kernel_size,
                         padding=kernel_size // 2, generator=generator)
        self.factor = factor

    def forward(self, x: torch.Tensor, folded: bool = False) -> torch.Tensor:
        if not folded:
            return super().forward(x)
        K, B = fuse_conv_through_shuffle(self.weight, self.bias, self.factor)
        return F.conv2d(x, K, B, padding=K.shape[-1] // 2)


class ShuffleConv(nn.Module):
    """``pixel_shuffle(factor)`` then a SAME conv — the sub-pixel tail —
    or, with ``fused``, the conv folded through the shuffle so the
    full-resolution intermediate never materializes. Same parameters."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, factor: int = 2, fused: bool = False,
                 *, generator: torch.Generator | None = None):
        super().__init__()
        self.factor = factor
        self.fused = fused
        self.conv = FoldableConv(in_channels, out_channels, kernel_size,
                                 factor, generator=generator)

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
    applies the PReLU that follows the squeeze, in the kernel's epilogue."""

    def __init__(self, in_channels: int, out_channels: int, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.in_channels = in_channels
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels))
        self.bias = nn.Parameter(torch.empty(out_channels))
        torch_default_init_(self.weight, self.bias, in_channels, generator)

    def forward(self, xs: list[torch.Tensor],
                prelu_weight: torch.Tensor | None = None) -> torch.Tensor:
        return concat_conv1x1(xs, self.weight, self.bias, prelu_weight)
