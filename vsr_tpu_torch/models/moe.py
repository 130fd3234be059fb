"""Mixture-of-Experts SR: expert-choice routed channel-FFN blocks on the
EDSR trunk (port of ``vsr_tpu/models/moe.py``), NCHW.

Expert-choice routing: within each group of ``group_size`` tokens (pixels)
of one image, every expert picks its top-``capacity`` tokens by affinity and
applies its 2-layer FFN to them; selected tokens receive the
affinity-weighted expert output as a residual update. Groups never span
images, so an image's output does not depend on its batch mates.

Ported: ``router_impl`` ``"rank"`` (the plain pairwise compare-and-sum, any
device) and ``"rank_pallas"`` (the name the configs use is kept; here it
means ``ops.rank.pairwise_rank``, the hand-written CUDA kernel on a CUDA
tensor), and ``dispatch_impl`` ``"sparse"`` (one-hot dispatch/combine
einsums over capacity slots) and ``"dense"`` (every expert on every token,
combined through the gated selection mask). ``"radix"``, ``"sort"`` and
``"dense_nhwc"`` are refused, as is the ``'expert'`` mesh axis (there is no
mesh here).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vsr_tpu_torch.models.common import Conv, ShuffleConv, resolve_dtype
from vsr_tpu_torch.models.edsr import _ResBlock, _UpBlock
from vsr_tpu_torch.ops.rank import pairwise_rank, pairwise_rank_reference
from vsr_tpu_torch.registry import register

_ROUTERS = ("rank", "rank_pallas")
_DISPATCHES = ("sparse", "dense")
_NOT_PORTED = {"router": ("radix", "sort"), "dispatch": ("dense_nhwc",)}


def _trunc_normal_(weight: torch.Tensor, fan_in: int,
                   generator: torch.Generator | None) -> None:
    """LeCun-normal as flax draws it: a normal truncated at +-2 sigma whose
    sigma is widened so that the truncated draw has variance 1 / fan_in."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                              generator=generator)


def route(af: torch.Tensor, router_impl: str) -> torch.Tensor:
    """(G, e, gs) float32 affinities -> int32 rank of every token within its
    (group, expert) row, descending, stable ties. The rank carries no
    gradient, so the affinities are detached."""
    af = af.detach()
    if router_impl == "rank_pallas":
        return pairwise_rank(af.contiguous())
    if router_impl == "rank":
        return pairwise_rank_reference(af)
    raise ValueError(f"Unknown router_impl {router_impl!r}; legal: {_ROUTERS}")


class ExpertChoiceMoE(nn.Module):
    """Expert-choice routed per-token (per-pixel) FFN, residual.

    ``x``: ``(N, C, H, W)`` feature map. Tokens are the pixels in row-major
    ``(h, w)`` order, as in the JAX layer, so the same pixels share a group.
    Token counts that do not divide ``group_size`` are padded with
    zero-affinity tokens: real tokens always win the top-``capacity``, and a
    padded token that is picked anyway contributes with gate 0.
    """

    def __init__(self, num_features: int, num_experts: int,
                 capacity_factor: float = 1.25, hidden_mult: int = 2,
                 group_size: int = 256, router_impl: str = "rank",
                 dispatch_impl: str = "sparse", *,
                 generator: torch.Generator | None = None):
        super().__init__()
        for knob, value, legal in (("router", router_impl, _ROUTERS),
                                   ("dispatch", dispatch_impl, _DISPATCHES)):
            if value in _NOT_PORTED[knob]:
                raise NotImplementedError(
                    f"{knob}_impl {value!r} is not yet ported to "
                    f"vsr_tpu_torch (ported: {legal})")
            if value not in legal:
                raise ValueError(
                    f"Unknown {knob}_impl {value!r}; legal: {legal} "
                    "(typos must fail here, not silently fall back)")
        d, e, hid = num_features, num_experts, hidden_mult * num_features
        self.num_experts = e
        self.capacity_factor = capacity_factor
        self.group_size = group_size
        self.router_impl = router_impl
        self.dispatch_impl = dispatch_impl
        self.router = nn.Parameter(torch.empty(d, e))
        self.expert_wi = nn.Parameter(torch.empty(e, d, hid))
        self.expert_bi = nn.Parameter(torch.zeros(e, hid))
        self.expert_wo = nn.Parameter(torch.empty(e, hid, d))
        self.expert_bo = nn.Parameter(torch.zeros(e, d))
        _trunc_normal_(self.router, d, generator)
        _trunc_normal_(self.expert_wi, d, generator)
        _trunc_normal_(self.expert_wo, hid, generator)

    def capacity(self, gs: int) -> int:
        cap = max(1, int(gs * self.capacity_factor / self.num_experts))
        return min(cap, gs)

    def affinities(self, x: torch.Tensor) -> tuple[torch.Tensor, int]:
        """(N, C, H, W) -> ((G, e, gs) float32 affinities, gs): the router
        contraction and its softmax in float32, padded to whole groups."""
        n, d, h, w = x.shape
        t = h * w
        gs = min(self.group_size, t)
        pad = (-t) % gs
        tokens = x.permute(0, 2, 3, 1).reshape(n, t, d)
        logits = tokens.float() @ self.router.float()  # (n, t, e)
        aff = logits.softmax(dim=-1)
        if pad:
            aff = torch.cat([aff, aff.new_zeros(n, pad, self.num_experts)], 1)
        af = aff.reshape(n * (t + pad) // gs, gs, self.num_experts)
        return af.transpose(1, 2).contiguous(), gs

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, d, h, w = x.shape
        t = h * w
        af, gs = self.affinities(x)  # (G, e, gs)
        pad = (-t) % gs
        cap = self.capacity(gs)
        rank = route(af, self.router_impl)  # (G, e, gs) int32

        # Params joined to the ACTIVATION dtype at use (a restored f32 leaf
        # must not promote a bf16 net's expert FFN).
        cd = x.dtype
        wi, bi, wo, bo = (p.to(cd) for p in (self.expert_wi, self.expert_bi,
                                             self.expert_wo, self.expert_bo))
        tokens = x.permute(0, 2, 3, 1).reshape(n, t, d)
        if pad:
            tokens = torch.cat([tokens, tokens.new_zeros(n, pad, d)], dim=1)
        tokens = tokens.reshape(n * (t + pad) // gs, gs, d)  # (G, gs, d)

        if self.dispatch_impl == "dense":
            gate_t = torch.where(rank < cap, af, 0.0).to(cd)  # (G, e, gs)
            hdn = torch.einsum("gtd,edh->geth", tokens, wi) + bi[:, None, :]
            out = (torch.einsum("geth,ehd->getd", F.relu(hdn), wo)
                   + bo[:, None, :])
            combined = torch.einsum("getd,get->gtd", out, gate_t)
        else:
            # One-hot of the rank over the capacity slots: rank >= cap
            # (unselected) gives an all-zero row.
            slots = torch.arange(cap, device=rank.device)
            dispatch = (rank[..., None] == slots).to(cd)  # (G, e, gs, cap)
            gate = torch.einsum("getc,get->gec", dispatch, af.to(cd))
            xin = torch.einsum("getc,gtd->gecd", dispatch, tokens)
            hdn = torch.einsum("gecd,edh->gech", xin, wi) + bi[None, :, None, :]
            out = (torch.einsum("gech,ehd->gecd", F.relu(hdn), wo)
                   + bo[None, :, None, :])
            out = out * gate[..., None]  # affinity-weighted
            combined = torch.einsum("getc,gecd->gtd", dispatch, out)
        combined = combined.reshape(n, t + pad, d)[:, :t]
        return x + combined.reshape(n, h, w, d).permute(0, 3, 1, 2).to(cd)


@register("net")
class MoEEDSRNet(nn.Module):
    """EDSR trunk with an :class:`ExpertChoiceMoE` block after every
    ``moe_every``-th residual block: ``(N, C, h, w) -> (N, C_out, H, W)``.
    Arguments as the JAX net; ``radix_bits`` belongs to the ``radix`` router
    and is refused with it. ``dtype``, ``device``, ``generator``: as
    ``DRFNet``."""

    serving_mode = "frame"

    def __init__(self, in_channels: int, out_channels: int, num_resblocks: int,
                 num_features: int, upscale_factor: int, res_scale: float = 0.1,
                 num_experts: int = 4, capacity_factor: float = 1.25,
                 hidden_mult: int = 2, group_size: int = 256,
                 moe_every: int = 2, router_impl: str = "rank",
                 dispatch_impl: str = "sparse", radix_bits: int | None = None,
                 fused_tail: bool = False,
                 dtype: torch.dtype | str | None = None, *,
                 device: torch.device | str | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if radix_bits is not None:
            raise NotImplementedError(
                "radix_bits belongs to router_impl='radix', which is not yet "
                "ported to vsr_tpu_torch")
        self.dtype = resolve_dtype(dtype)
        f = num_features
        self.head = Conv(in_channels, f, 3, padding=1, generator=generator)
        self.blocks = nn.ModuleList()
        self.moes = nn.ModuleDict()  # index of the resblock it follows -> MoE
        for i in range(num_resblocks):
            self.blocks.append(_ResBlock(f, res_scale, generator=generator))
            if (i + 1) % moe_every == 0:
                self.moes[str(i)] = ExpertChoiceMoE(
                    f, num_experts, capacity_factor, hidden_mult, group_size,
                    router_impl, dispatch_impl, generator=generator)
        self.body_end = Conv(f, f, 3, padding=1, generator=generator)
        self.up = _UpBlock(f, upscale_factor, generator=generator)
        self.tail = ShuffleConv(f, out_channels, 3,
                                factor=_UpBlock.split(upscale_factor),
                                fused=fused_tail, generator=generator)
        self.to(device=device, dtype=self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        head = self.head(x.to(self.dtype))
        body = head
        for i, block in enumerate(self.blocks):
            body = block(body)
            if str(i) in self.moes:
                body = self.moes[str(i)](body)
        body = self.body_end(body) + head
        return self.tail(self.up(body))
