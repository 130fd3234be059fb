"""DRFNet — the project's Deep Recurrent Feedback video SR net (port of
``vsr_tpu/models/drf.py``).

Iterates the feedback block over the *frames* of a sequence: the hidden
state starts as frame 0's own input features and carries across frames,
emitting one SR frame per input frame. The JAX ``nn.scan`` becomes a Python
loop over T with one shared parameter set.

``carry_f32`` (hybrid precision under a bf16 ``dtype``): the input
features, the hidden state carried across frames and the skip add
``in_feat + hidden`` stay float32, while every conv computes in bf16
(``models/feedback.py``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from vsr_tpu_torch.models.common import Conv, ShuffleConv, resolve_dtype
from vsr_tpu_torch.models.feedback import FBlock, InBlock, check_upscale_factor
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
    """One frame step: hidden' = FBlock(in_feat, hidden); output from the
    additive skip ``in_feat + hidden'``."""

    def __init__(self, num_features: int, num_groups: int, out_channels: int,
                 upscale_factor: int, fused_tail: bool = False,
                 fused_squeeze: bool = False, *,
                 dtype: torch.dtype | None = None, carry_f32: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.fblock = FBlock(num_features, num_groups, upscale_factor,
                             fused_squeeze, dtype=dtype, carry_f32=carry_f32,
                             generator=generator)
        self.out_block = _OutBlock(num_features, out_channels, upscale_factor,
                                   fused=fused_tail, dtype=dtype,
                                   generator=generator)

    def forward(self, hidden: torch.Tensor, in_feat: torch.Tensor):
        f = self.fblock(in_feat, hidden)
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


@register("net")
class DRFNet(nn.Module):
    """Whole-sequence video SR: ``(N, T, C, h, w) -> (N, T, C_out, H, W)``.

    ``dtype``: the compute dtype (``None``: float32; ``torch.bfloat16`` or
    ``"bfloat16"``); the parameters stay float32 (``models/common.py``).
    ``carry_f32``: float32 carries under a bf16 ``dtype`` (module
    docstring). ``device``: where the parameters live. ``generator``: the
    init RNG.

    Knobs of the JAX net that this port has not carried yet
    (``remat``, ``subpixel_deconv``, ``num_experts``) raise
    ``NotImplementedError``; the TPU-only scan knobs ``unroll`` and
    ``split_transpose`` raise as well rather than being ignored.
    """

    serving_mode = "video"

    def __init__(self, in_channels: int, out_channels: int, num_features: int,
                 num_groups: int, upscale_factor: int, remat: bool = False,
                 fused_tail: bool = False, dtype: torch.dtype | str | None = None,
                 subpixel_deconv: bool = False, fused_squeeze: bool = False,
                 num_experts: int = 0, carry_f32: bool = False,
                 unroll: int | None = None, split_transpose: bool | None = None,
                 *, device: torch.device | str | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        check_upscale_factor(upscale_factor)
        if carry_f32 and fused_squeeze:
            raise NotImplementedError(
                "carry_f32 does not compose with fused_squeeze (the fused "
                "concat-matmul kernel emits the compute dtype)")
        self.dtype = resolve_dtype(dtype)
        self.upscale_factor = upscale_factor
        self.carry_f32 = check_carry_f32(carry_f32, self.dtype, num_experts)
        for name, value in (("remat", remat), ("subpixel_deconv", subpixel_deconv),
                            ("num_experts>0", num_experts)):
            if value:
                raise NotImplementedError(
                    f"DRFNet {name} is not yet ported to vsr_tpu_torch")
        for name, value in (("unroll", unroll),
                            ("split_transpose", split_transpose)):
            if value is not None:
                raise NotImplementedError(
                    f"DRFNet {name} is a TPU lax.scan knob; the port's frame "
                    "loop is a Python loop and has no such setting")
        self.in_block = InBlock(in_channels, num_features, dtype=self.dtype,
                                out_f32=self.carry_f32, generator=generator)
        self.step = _DRFStep(num_features, num_groups, out_channels,
                             upscale_factor, fused_tail, fused_squeeze,
                             dtype=self.dtype, carry_f32=self.carry_f32,
                             generator=generator)
        self.to(device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, t, c, h, w = x.shape
        feats = self.in_block(x.reshape(n * t, c, h, w))
        # (T, N, F, h, w): each frame's features contiguous for the kernel.
        feats = feats.reshape(n, t, -1, h, w).transpose(0, 1).contiguous()
        hidden = feats[0]  # the hidden state starts as frame 0's features
        outs = []
        for feat in feats:
            hidden, out = self.step(hidden, feat)
            outs.append(out)
        return torch.stack(outs, dim=1)
