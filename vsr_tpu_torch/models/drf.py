"""DRF — the project's Deep Recurrent Feedback nets (port of
``vsr_tpu/models/drf.py``).

- ``DRFNet`` iterates the feedback block over the *frames* of a sequence:
  the hidden state starts as frame 0's own input features and carries
  across frames, emitting one SR frame per input frame.
- ``DRFSISRNet`` iterates the same step ``num_steps`` times over one image
  (the hidden state starts as the image's features), emitting every
  step's SR image, stacked ``(num_steps, N, C, H, W)`` as ``SRFBNet``.

The JAX ``nn.scan`` becomes a Python loop with one shared parameter set.

``carry_f32`` (hybrid precision under a bf16 ``dtype``): the input
features, the hidden state carried across steps and the skip add
``in_feat + hidden`` stay float32, while every conv computes in bf16
(``models/feedback.py``). ``num_experts > 0`` inserts an
``ExpertChoiceMoE`` block (``models/moe.py``, its default ``rank`` router
and ``sparse`` dispatch) on the feedback block's output in every step.
``subpixel_deconv`` runs the ladder's transposed convs as sub-pixel phase
convs (``ops/subpixel.py``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from vsr_tpu_torch.models.common import (Conv, ShuffleConv, remat_step,
                                         resolve_dtype)
from vsr_tpu_torch.models.feedback import (FBlock, InBlock, check_fused_carry,
                                           check_upscale_factor)
from vsr_tpu_torch.models.moe import ExpertChoiceMoE
from vsr_tpu_torch.registry import register


class _OutBlock(nn.Module):
    """PixelShuffle ladder + final conv; the last shuffle + conv are a
    ShuffleConv so serving can fold the conv through the shuffle."""

    def __init__(self, num_features: int, out_channels: int,
                 upscale_factor: int, fused: bool = False, *,
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        c, f = num_features, upscale_factor
        if math.log2(f).is_integer():
            convs = [Conv(c, 4 * c, 3, padding=1, dtype=dtype,
                          generator=generator)
                     for _ in range(int(math.log2(f)))]
            last = 2
        elif f == 3:
            convs = [Conv(c, 9 * c, 3, padding=1, dtype=dtype,
                          generator=generator)]
            last = 3
        else:
            raise NotImplementedError(f"upscale_factor={f}")
        self.convs = nn.ModuleList(convs)
        self.tail = ShuffleConv(c, out_channels, 3, factor=last, fused=fused,
                                dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self.convs[:-1]:
            x = F.pixel_shuffle(conv(x), 2)
        return self.tail(self.convs[-1](x))


class _DRFStep(nn.Module):
    """One feedback step: hidden' = FBlock(in_feat, hidden), then (with
    ``num_experts``) the MoE block on it; the output from the additive skip
    ``in_feat + hidden'``."""

    def __init__(self, num_features: int, num_groups: int, out_channels: int,
                 upscale_factor: int, fused_tail: bool = False,
                 fused_squeeze: bool = False, *,
                 dtype: torch.dtype | None = None, carry_f32: bool = False,
                 subpixel_deconv: bool = False, num_experts: int = 0,
                 expert_group_size: int = 256,
                 expert_capacity_factor: float = 1.25,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.fblock = FBlock(num_features, num_groups, upscale_factor,
                             fused_squeeze, dtype=dtype, carry_f32=carry_f32,
                             subpixel_deconv=subpixel_deconv,
                             generator=generator)
        self.moe = (ExpertChoiceMoE(num_features, num_experts,
                                    expert_capacity_factor,
                                    group_size=expert_group_size,
                                    generator=generator)
                    if num_experts else None)
        self.out_block = _OutBlock(num_features, out_channels, upscale_factor,
                                   fused=fused_tail, dtype=dtype,
                                   generator=generator)

    def forward(self, hidden: torch.Tensor, in_feat: torch.Tensor):
        f = self.fblock(in_feat, hidden)
        if self.moe is not None:
            f = self.moe(f)
        return f, self.out_block(in_feat + f)


def check_carry_f32(carry_f32: bool, dtype: torch.dtype,
                    num_experts: int = 0) -> bool:
    """The effective ``carry_f32`` (``_check_carry_f32`` of the JAX
    package): a no-op without a low-precision compute dtype (a float32 net
    already carries float32), refused with the MoE blocks (they would round
    the hidden state back to the compute dtype)."""
    if not carry_f32 or dtype == torch.float32:
        return False
    if num_experts:
        raise NotImplementedError(
            "carry_f32 does not compose with num_experts>0: the MoE "
            "block on the hidden features emits the compute dtype")
    return True


class _DRFBase(nn.Module):
    """The knobs and blocks both DRF nets share: the InBlock and one
    ``_DRFStep``."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_features: int, num_groups: int, upscale_factor: int,
                 fused_tail: bool, dtype, subpixel_deconv: bool,
                 fused_squeeze: bool, num_experts: int,
                 expert_group_size: int, expert_capacity_factor: float,
                 carry_f32: bool, device, generator):
        super().__init__()
        check_upscale_factor(upscale_factor)
        self.dtype = resolve_dtype(dtype)
        self.upscale_factor = upscale_factor
        self.carry_f32 = check_carry_f32(carry_f32, self.dtype, num_experts)
        check_fused_carry(self.carry_f32, fused_squeeze)
        self.in_block = InBlock(in_channels, num_features, dtype=self.dtype,
                                out_f32=self.carry_f32, generator=generator)
        self.step = _DRFStep(num_features, num_groups, out_channels,
                             upscale_factor, fused_tail, fused_squeeze,
                             dtype=self.dtype, carry_f32=self.carry_f32,
                             subpixel_deconv=subpixel_deconv,
                             num_experts=num_experts,
                             expert_group_size=expert_group_size,
                             expert_capacity_factor=expert_capacity_factor,
                             generator=generator)
        self.to(device=device)

    @staticmethod
    def _refuse_scan_knobs(name: str, **knobs) -> None:
        for knob, value in knobs.items():
            if value:
                raise NotImplementedError(
                    f"{name} {knob} is a TPU lax.scan knob; the port's loop "
                    "is a Python loop and has no such setting")


@register("net")
class DRFNet(_DRFBase):
    """Whole-sequence video SR: ``(N, T, C, h, w) -> (N, T, C_out, H, W)``.

    ``dtype``: the compute dtype (``None``: float32; ``torch.bfloat16`` or
    ``"bfloat16"``); the parameters stay float32 (``models/common.py``).
    ``carry_f32``, ``num_experts`` (with ``expert_group_size`` and
    ``expert_capacity_factor``), ``subpixel_deconv``: the module docstring.
    ``remat``: each frame step runs under ``torch.utils.checkpoint`` while a
    gradient is recorded (its activations are recomputed in the backward,
    O(1) activation memory in T), the same parameters and gradients.
    ``device``: where the parameters live. ``generator``: the init RNG.

    The TPU-only scan knobs ``unroll`` and ``split_transpose`` raise
    ``NotImplementedError`` rather than being ignored.
    """

    serving_mode = "video"

    def __init__(self, in_channels: int, out_channels: int, num_features: int,
                 num_groups: int, upscale_factor: int, remat: bool = False,
                 fused_tail: bool = False, dtype: torch.dtype | str | None = None,
                 subpixel_deconv: bool = False, fused_squeeze: bool = False,
                 num_experts: int = 0, expert_group_size: int = 256,
                 expert_capacity_factor: float = 1.25,
                 carry_f32: bool = False,
                 unroll: int | None = None, split_transpose: bool | None = None,
                 *, device: torch.device | str | None = None,
                 generator: torch.Generator | None = None):
        self._refuse_scan_knobs("DRFNet", unroll=unroll is not None,
                                split_transpose=split_transpose is not None)
        super().__init__(in_channels, out_channels, num_features,
                         num_groups, upscale_factor, fused_tail, dtype,
                         subpixel_deconv, fused_squeeze, num_experts,
                         expert_group_size, expert_capacity_factor,
                         carry_f32, device, generator)
        self.remat = remat

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, t, c, h, w = x.shape
        feats = self.in_block(x.reshape(n * t, c, h, w))
        # (T, N, F, h, w): each frame's features contiguous for the kernel.
        feats = feats.reshape(n, t, -1, h, w).transpose(0, 1).contiguous()
        hidden = feats[0]  # the hidden state starts as frame 0's features
        outs = []
        for feat in feats:
            hidden, out = remat_step(self.remat, self.step, hidden, feat)
            outs.append(out)
        return torch.stack(outs, dim=1)


@register("net")
class DRFSISRNet(_DRFBase):
    """Single-image SR with feedback: ``(N, C, h, w) -> (num_steps, N,
    C_out, H, W)``, every step's output (the last is the served one). The
    knobs as ``DRFNet``'s; ``unroll`` is the TPU scan knob and raises at any
    value but 1."""

    serving_mode = "frame"

    def __init__(self, in_channels: int, out_channels: int, num_steps: int,
                 num_features: int, num_groups: int, upscale_factor: int,
                 fused_tail: bool = False,
                 dtype: torch.dtype | str | None = None,
                 subpixel_deconv: bool = False, fused_squeeze: bool = False,
                 num_experts: int = 0, expert_group_size: int = 256,
                 expert_capacity_factor: float = 1.25, unroll: int = 1,
                 carry_f32: bool = False, *,
                 device: torch.device | str | None = None,
                 generator: torch.Generator | None = None):
        self._refuse_scan_knobs("DRFSISRNet", unroll=unroll != 1)
        super().__init__(in_channels, out_channels, num_features,
                         num_groups, upscale_factor, fused_tail, dtype,
                         subpixel_deconv, fused_squeeze, num_experts,
                         expert_group_size, expert_capacity_factor,
                         carry_f32, device, generator)
        self.num_steps = num_steps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # Contiguous NCHW for the fused squeeze (see SRFBNet.forward).
        feat = self.in_block(x).contiguous()
        hidden = feat  # the hidden state starts as the image's features
        outs = []
        for _ in range(self.num_steps):
            hidden, out = self.step(hidden, feat)
            outs.append(out)
        return torch.stack(outs, dim=0)
