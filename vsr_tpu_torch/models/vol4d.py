"""4D (3D + time) spatio-temporal super-resolution (port of
``vsr_tpu/models/vol4d.py``): the DRF recurrence over the frames of a
volumetric sequence. The hidden volume starts as frame 0's own input
features and carries across frames; each step runs 3D convs over that
frame's (D, h, w) volume and emits an in-plane upscaled volume. The JAX
``nn.scan`` becomes a Python loop over T with one shared step.

Input ``(N, T, C, D, h, w)`` (the port's window layout ``(N, T, C, H, W)``
with a depth axis) -> ``(N, T, C_out, D, h r, w r)``.
"""

from __future__ import annotations

import torch
from torch import nn

from vsr_tpu_torch.models.common import Conv3D, remat_step, resolve_dtype
from vsr_tpu_torch.models.vol3d import VolumeTail, _ResBlock3D
from vsr_tpu_torch.registry import register

_MODES = ("full", "recur", "tail")


class _Vol4DStep(nn.Module):
    """One frame step. ``mode``: ``"full"`` = recurrence + upsample tail,
    ``"recur"`` = recurrence only, returning ``(new_hidden, in_feat + x)``,
    ``"tail"`` = the upsample tail only, over ``hidden`` (a batch of
    skip-added features). Every mode uses the same parameters."""

    def __init__(self, num_features: int, num_resblocks: int,
                 out_channels: int, upscale_factor: int, res_scale: float,
                 fused_tail: bool = False, *,
                 dtype: torch.dtype | None = None, carry_f32: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        f = num_features
        # Under carry_f32 the float32 hidden volume and features are
        # consumed in float32: the squeeze computes in the promoted dtype.
        self.squeeze = Conv3D(2 * f, f, (1, 1, 1), padding=(0, 0, 0),
                              dtype=None if carry_f32 else dtype,
                              generator=generator)
        self.blocks = nn.ModuleList(
            _ResBlock3D(f, res_scale, carry_f32, dtype=dtype,
                        generator=generator)
            for _ in range(num_resblocks))
        self.tail = VolumeTail(f, out_channels, upscale_factor, fused_tail,
                               dtype=dtype, generator=generator)

    def forward(self, hidden: torch.Tensor, in_feat: torch.Tensor | None = None,
                mode: str = "full"):
        if mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
        if mode == "tail":
            return self.tail(hidden)
        # The squeeze: a 1x1x1 conv over the concat of the frame's features
        # and the hidden volume.
        x = self.squeeze(torch.cat([in_feat, hidden], dim=1))
        for block in self.blocks:
            x = block(x)
        y = in_feat + x  # the global feature skip
        if mode == "recur":
            return x, y
        return x, self.tail(y)


@register("net")
class Volume4DSRNet(nn.Module):
    """``(N, T, C, D, h, w) -> (N, T, C_out, D, h r, w r)``.

    ``remat``: each frame step (and the hoisted tail) runs under
    ``torch.utils.checkpoint`` when a gradient is recorded: its activations
    are recomputed in the backward instead of kept. ``hoist_tail``: the loop
    carries only the recurrence and the tail runs once over all N*T frames.
    ``fused_tail``: the final conv is folded through the last shuffle. All
    three keep the parameters, and so the checkpoints, of the plain net.
    ``unroll`` is the JAX scan's unroll factor, a TPU knob: only 1 (the
    Python loop) is accepted. ``dtype``: the compute dtype (the parameters
    stay float32). ``carry_f32`` (under a bf16 ``dtype``; a no-op without
    one): the head emits float32, the hidden volume, the resblocks'
    residual chain and the global skip stay float32, every conv computes
    in bf16 but the squeeze, which computes in float32."""

    serving_mode = "volume"

    def __init__(self, in_channels: int, out_channels: int,
                 num_features: int = 32, num_resblocks: int = 4,
                 upscale_factor: int = 2, res_scale: float = 0.1,
                 remat: bool = False, dtype: torch.dtype | str | None = None,
                 unroll: int = 1, carry_f32: bool = False,
                 hoist_tail: bool = False, fused_tail: bool = False, *,
                 device: torch.device | str | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if unroll != 1:
            raise NotImplementedError(
                f"Volume4DSRNet unroll={unroll}: unroll is a TPU lax.scan "
                "knob; the port's frame loop is a Python loop (unroll 1)")
        self.dtype = dt = resolve_dtype(dtype)
        self.carry_f32 = carry = carry_f32 and dt != torch.float32
        self.remat = remat
        self.hoist_tail = hoist_tail
        self.upscale_factor = upscale_factor
        self.head = Conv3D(in_channels, num_features, dtype=dt,
                           out_dtype=torch.float32 if carry else None,
                           generator=generator)
        self.step = _Vol4DStep(num_features, num_resblocks, out_channels,
                               upscale_factor, res_scale, fused_tail,
                               dtype=dt, carry_f32=carry, generator=generator)
        self.to(device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, t, c, d, h, w = x.shape
        feats = self.head(x.reshape(n * t, c, d, h, w))
        feats = feats.reshape(n, t, *feats.shape[1:]).transpose(0, 1)
        hidden = feats[0]  # the hidden state starts as frame 0's features
        mode = "recur" if self.hoist_tail else "full"
        outs = []
        for feat in feats:
            hidden, out = remat_step(self.remat, self.step, hidden, feat,
                                     mode)
            outs.append(out)
        out = torch.stack(outs, dim=1)
        if not self.hoist_tail:
            return out
        # (N, T, F, D, h, w) skip-added features -> one tail over N*T.
        out = remat_step(self.remat, self.step,
                         out.reshape(n * t, *out.shape[2:]), None, "tail")
        return out.reshape(n, t, *out.shape[1:])
