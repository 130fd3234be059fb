"""Shared blocks of the feedback-network family (port of
``vsr_tpu/models/feedback.py``).

The feedback block is a dense up/down projection ladder: each group consumes
the concat of all previous LR (resp. HR) features through a 1x1 squeeze,
projects up with a strided deconv and back down with a strided conv, and the
outputs of all groups concat into a 1x1 fuse. With ``fused_squeeze`` every
squeeze of more than one input runs the fused concat + 1x1 kernel, which
also applies the PReLU that follows the squeeze (the PReLU module stays in
its list; the kernel reads its weight).

Submodules are kept in lists in the JAX modules' creation order, so
``convs[i]`` is flax's ``Conv_i`` (likewise ``ConvTranspose_i``, ``PReLU_i``);
``interop.py`` relies on it.

``dtype`` is the compute dtype (``models/common.py``'s policy; parameters
stay float32). ``carry_f32`` is the JAX blocks' hybrid precision under a
low-precision ``dtype``: ``InBlock(out_f32)`` accumulates its squeeze in
float32 and returns float32 features (the skip the recurrence adds every
step's hidden state to); ``FBlock(carry_f32)`` consumes the float32 carry in
a float32 input squeeze, casts down once after its PReLU, and accumulates
its output squeeze in float32, so the hidden state it returns is float32.
``subpixel_deconv`` runs the ladder's transposed convs as sub-pixel phase
convs (``ops/subpixel.py``; the same parameters and map).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vsr_tpu_torch.models.common import Conv, ConvTranspose, FusedSqueezeConv

PROJECTION_PARAMS = {2: (6, 2, 2), 3: (7, 3, 2), 4: (8, 4, 2), 8: (12, 8, 2)}


def check_upscale_factor(factor: int) -> None:
    if factor not in PROJECTION_PARAMS:
        raise ValueError(f"The upscale factor should be 2, 3, 4 or 8. Got {factor}.")


def check_fused_carry(carry_f32: bool, fused_squeeze: bool) -> None:
    """The float32 carry cannot go through the fused squeeze."""
    if carry_f32 and fused_squeeze:
        raise NotImplementedError(
            "carry_f32 does not compose with fused_squeeze (the fused "
            "concat-matmul kernel emits the compute dtype)")


class PReLU(nn.PReLU):
    """One alpha, init 0.2 (torch ``nn.PReLU(1, 0.2)``). The alpha stays
    float32 and is cast to the input's dtype, so the activation computes in
    that dtype (the JAX PReLU's rule)."""

    def __init__(self, init: float = 0.2):
        super().__init__(num_parameters=1, init=init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.prelu(x, self.weight.to(x.dtype))


class InBlock(nn.Module):
    """3x3 expand (4F) -> PReLU -> 1x1 squeeze (F) -> PReLU; with
    ``out_f32`` the squeeze emits float32 (``Conv.out_dtype``)."""

    def __init__(self, in_channels: int, num_features: int, *,
                 dtype: torch.dtype | None = None, out_f32: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        f = num_features
        self.convs = nn.ModuleList([
            Conv(in_channels, 4 * f, 3, padding=1, dtype=dtype,
                 generator=generator),
            Conv(4 * f, f, 1, padding=0, dtype=dtype,
                 out_dtype=torch.float32 if out_f32 else None,
                 generator=generator),
        ])
        self.prelus = nn.ModuleList([PReLU(), PReLU()])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv, act in zip(self.convs, self.prelus):
            x = act(conv(x))
        return x


class FBlock(nn.Module):
    """The feedback block: ``forward(features, hidden) -> new hidden``."""

    def __init__(self, num_features: int, num_groups: int,
                 upscale_factor: int, fused_squeeze: bool = False, *,
                 dtype: torch.dtype | None = None, carry_f32: bool = False,
                 subpixel_deconv: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        check_upscale_factor(upscale_factor)
        check_fused_carry(carry_f32, fused_squeeze)
        f = num_features
        k, s, p = PROJECTION_PARAMS[upscale_factor]
        self.num_groups = num_groups
        self.dtype = dtype
        self.carry_f32 = carry_f32

        def squeeze(parts: int, dtype=dtype, out_dtype=None) -> nn.Module:
            if fused_squeeze and parts > 1:
                return FusedSqueezeConv(parts * f, f, dtype=dtype,
                                        generator=generator)
            return Conv(parts * f, f, 1, padding=0, dtype=dtype,
                        out_dtype=out_dtype, generator=generator)

        # [features, hidden]; the float32 carry is consumed at float32.
        convs = [squeeze(2, dtype=None if carry_f32 else dtype)]
        deconvs = []
        for i in range(num_groups):
            if i:
                convs.append(squeeze(i + 1))  # LR ladder
            deconvs.append(ConvTranspose(f, f, k, s, p, dtype=dtype,
                                         subpixel=subpixel_deconv,
                                         generator=generator))
            if i:
                convs.append(squeeze(i + 1))  # HR ladder
            convs.append(Conv(f, f, k, s, p, dtype=dtype, generator=generator))
        # The output fuse; under carry_f32 it emits the float32 hidden state.
        convs.append(squeeze(num_groups, out_dtype=torch.float32
                             if carry_f32 else None))
        self.convs = nn.ModuleList(convs)
        self.deconvs = nn.ModuleList(deconvs)
        self.prelus = nn.ModuleList(PReLU() for _ in range(4 * num_groups))

    @staticmethod
    def _squeeze(conv: nn.Module, parts: list[torch.Tensor],
                 prelu: nn.PReLU) -> torch.Tensor:
        """The squeeze of ``parts`` and the PReLU that follows it."""
        if isinstance(conv, FusedSqueezeConv):
            return conv(parts, prelu.weight)
        return prelu(
            conv(parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)))

    def forward(self, x: torch.Tensor, hidden: torch.Tensor) -> torch.Tensor:
        # Consume the lists in creation order (= flax's call order).
        convs, deconvs, prelus = (iter(self.convs), iter(self.deconvs),
                                  iter(self.prelus))

        def act(t: torch.Tensor) -> torch.Tensor:
            return next(prelus)(t)

        def squeeze(parts: list[torch.Tensor]) -> torch.Tensor:
            return self._squeeze(next(convs), parts, next(prelus))

        lr_list = [squeeze([x, hidden])]
        if self.carry_f32:
            lr_list = [lr_list[0].to(self.dtype)]
        hr_list: list[torch.Tensor] = []
        for i in range(self.num_groups):
            z = lr_list[0] if i == 0 else squeeze(lr_list)
            hr_list.append(act(next(deconvs)(z)))
            z = hr_list[0] if i == 0 else squeeze(hr_list)
            lr_list.append(act(next(convs)(z)))
        return squeeze(lr_list[1:])
