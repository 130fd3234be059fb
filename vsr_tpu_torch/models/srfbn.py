"""SRFBN — Super-Resolution Feedback Network (SISR, iterative), the port of
``vsr_tpu/models/srfbn.py``.

``num_steps`` feedback iterations over one LR input: the feedback block's
hidden state is reset to the extracted features at step 0 and carried
across steps; each step emits a bilinear-upsampled global residual output;
all step outputs are returned, stacked ``(num_steps, N, C, H, W)``. The JAX
``nn.scan`` becomes a Python loop with one shared parameter set. With
``fused_squeeze`` the feedback block's squeezes run the fused concat + 1x1
kernel (``ops/fused_squeeze.py``), forward and backward. ``subpixel_deconv``
runs every transposed conv (the ladder's and the reconstruction's) as a
sub-pixel phase conv (``ops/subpixel.py``); ``carry_f32`` is the hybrid
precision of ``models/feedback.py`` under a bf16 ``dtype``.
"""

from __future__ import annotations

import torch
from torch import nn

from vsr_tpu_torch.models.common import Conv, ConvTranspose, resolve_dtype
from vsr_tpu_torch.models.drf import check_carry_f32
from vsr_tpu_torch.models.feedback import (FBlock, InBlock, PROJECTION_PARAMS,
                                           PReLU, check_fused_carry,
                                           check_upscale_factor)
from vsr_tpu_torch.ops.upsample import upsample_bilinear
from vsr_tpu_torch.registry import register


class _RBlock(nn.Module):
    """Reconstruction: strided deconv -> PReLU -> 3x3 conv."""

    def __init__(self, num_features: int, out_channels: int,
                 upscale_factor: int, *, dtype: torch.dtype | None = None,
                 subpixel_deconv: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        k, s, p = PROJECTION_PARAMS[upscale_factor]
        self.deconvs = nn.ModuleList([ConvTranspose(
            num_features, num_features, k, s, p, dtype=dtype,
            subpixel=subpixel_deconv, generator=generator)])
        self.prelus = nn.ModuleList([PReLU()])
        self.convs = nn.ModuleList([Conv(num_features, out_channels, 3,
                                         padding=1, dtype=dtype,
                                         generator=generator)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.convs[0](self.prelus[0](self.deconvs[0](x)))


class _SRFBStep(nn.Module):
    """One feedback step: hidden' = FBlock(feat, hidden); the output is the
    upsampled input plus the reconstruction of hidden'."""

    def __init__(self, num_features: int, num_groups: int, out_channels: int,
                 upscale_factor: int, fused_squeeze: bool = False, *,
                 dtype: torch.dtype | None = None, carry_f32: bool = False,
                 subpixel_deconv: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.fblock = FBlock(num_features, num_groups, upscale_factor,
                             fused_squeeze, dtype=dtype, carry_f32=carry_f32,
                             subpixel_deconv=subpixel_deconv,
                             generator=generator)
        self.rblock = _RBlock(num_features, out_channels, upscale_factor,
                              dtype=dtype, subpixel_deconv=subpixel_deconv,
                              generator=generator)

    def forward(self, hidden: torch.Tensor, feat: torch.Tensor,
                upscaled_input: torch.Tensor):
        f = self.fblock(feat, hidden)
        return f, upscaled_input + self.rblock(f)


@register("net")
class SRFBNet(nn.Module):
    """``(N, C, h, w) -> (num_steps, N, C_out, H, W)``.

    ``dtype`` (the compute dtype; the parameters stay float32), ``device``,
    ``generator`` as for the other nets. The bilinear upsampling of the
    input, and so the global residual add, stay in the input's dtype, as in
    the JAX net (a float32 input gives float32 outputs).
    ``subpixel_deconv`` and ``carry_f32`` as the module docstring says;
    ``carry_f32`` under a low-precision ``dtype`` with ``fused_squeeze``
    raises ``NotImplementedError`` (in float32 the pair is a no-op), and so
    does the TPU ``lax.scan`` knob ``unroll`` at any value but 1.
    """

    serving_mode = "frame"

    def __init__(self, in_channels: int, out_channels: int, num_steps: int,
                 num_features: int, num_groups: int, upscale_factor: int,
                 dtype: torch.dtype | str | None = None,
                 subpixel_deconv: bool = False, fused_squeeze: bool = False,
                 unroll: int = 1, carry_f32: bool = False, *,
                 device: torch.device | str | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        check_upscale_factor(upscale_factor)
        if unroll != 1:
            raise NotImplementedError(
                "SRFBNet unroll is a TPU lax.scan knob; the port's feedback "
                "loop is a Python loop and has no such setting")
        self.dtype = resolve_dtype(dtype)
        self.num_steps = num_steps
        self.upscale_factor = upscale_factor
        self.carry_f32 = check_carry_f32(carry_f32, self.dtype)
        check_fused_carry(self.carry_f32, fused_squeeze)
        self.in_block = InBlock(in_channels, num_features, dtype=self.dtype,
                                out_f32=self.carry_f32, generator=generator)
        self.step = _SRFBStep(num_features, num_groups, out_channels,
                              upscale_factor, fused_squeeze, dtype=self.dtype,
                              carry_f32=self.carry_f32,
                              subpixel_deconv=subpixel_deconv,
                              generator=generator)
        self.to(device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # Contiguous NCHW for the fused squeeze: the library's convs hand
        # back channels-last features for a channels-last (or one-channel,
        # permuted) input.
        feat = self.in_block(x).contiguous()
        upscaled = upsample_bilinear(x, scale=self.upscale_factor,
                                     align_corners=False)
        hidden = feat  # reset to the features at step 0
        outs = []
        for _ in range(self.num_steps):
            hidden, out = self.step(hidden, feat, upscaled)
            outs.append(out)
        return torch.stack(outs, dim=0)
