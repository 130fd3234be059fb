"""Mixture-of-Experts SR: expert-choice routed channel-FFN blocks on the
EDSR trunk (port of ``vsr_tpu/models/moe.py``), NCHW.

Expert-choice routing: within each group of ``group_size`` tokens (pixels)
of one image, every expert picks its top-``capacity`` tokens by affinity and
applies its 2-layer FFN to them; selected tokens receive the
affinity-weighted expert output as a residual update. Groups never span
images, so an image's output does not depend on its batch mates.

Routers (``router_impl``), each reproducing ``lax.top_k``'s selection
(value descending, the earlier index first on ties):

- ``"rank"``: the plain pairwise compare-and-sum rank, any device;
- ``"rank_pallas"`` (the configs' name is kept): the same rank from
  ``ops.rank.pairwise_rank``, the hand-written CUDA kernel on a CUDA tensor;
- ``"radix"``: the selection mask alone, by ``ops.select.topk_mask``'s
  radix threshold search (``radix_bits`` a pass); mask dispatches only;
- ``"sort"``: ``torch.sort(stable=True)``'s top-``capacity`` values and
  indices as the capacity slots; the ``sparse`` dispatch only.

Dispatches (``dispatch_impl``): ``"sparse"`` (one-hot dispatch / combine
einsums over capacity slots), ``"dense"`` (every expert on every token of
its group, combined through the gated selection mask) and ``"dense_nhwc"``
(the same in image layout: a 1x1 conv to every expert's hidden channels and
a feature-grouped 1x1 conv back, one group an expert).

Under an ``'expert'`` mesh axis (``parallel/ep.py``) each rank holds the
stacks of ``num_experts / axis`` experts and the layer knows its slice
(``expert_shard``): the router's affinities are computed in full (the
router is replicated), the rows of this rank's experts are ranked (K3 on a
CUDA tensor under ``rank_pallas``), dispatched and run through their FFN,
and the combined ``(G, gs, d)`` output is all-reduced over the axis. The
tokens and the affinities enter through ``mesh.copy_to``, so their
gradients (and the router's) sum every rank's experts.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vsr_tpu_torch.models.common import Conv, ShuffleConv, resolve_dtype
from vsr_tpu_torch.models.edsr import _ResBlock, _UpBlock
from vsr_tpu_torch.ops.rank import pairwise_rank, pairwise_rank_reference
from vsr_tpu_torch.ops.select import topk_mask
from vsr_tpu_torch.parallel.mesh import copy_to, reduce_from
from vsr_tpu_torch.registry import register

_ROUTERS = ("rank", "rank_pallas", "radix", "sort")
_DISPATCHES = ("sparse", "dense", "dense_nhwc")


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
    (group, expert) row, descending, stable ties (the ``rank`` and
    ``rank_pallas`` routers). The rank carries no gradient, so the
    affinities are detached."""
    af = af.detach()
    if router_impl == "rank_pallas":
        return pairwise_rank(af.contiguous())
    if router_impl == "rank":
        return pairwise_rank_reference(af)
    raise ValueError(f"router_impl {router_impl!r} computes no rank; the "
                     f"rank routers are {_ROUTERS[:2]}")


class ExpertChoiceMoE(nn.Module):
    """Expert-choice routed per-token (per-pixel) FFN, residual.

    ``x``: ``(N, C, H, W)`` feature map. Tokens are the pixels in row-major
    ``(h, w)`` order, as in the JAX layer, so the same pixels share a group.
    Token counts that do not divide ``group_size`` are padded with
    zero-affinity tokens: real tokens always win the top-``capacity``, and a
    padded token that is picked anyway contributes with gate 0. The
    router / dispatch pairs the JAX layer refuses raise its ``ValueError``
    here, at construction.
    """

    def __init__(self, num_features: int, num_experts: int,
                 capacity_factor: float = 1.25, hidden_mult: int = 2,
                 group_size: int = 256, router_impl: str = "rank",
                 dispatch_impl: str = "sparse", radix_bits: int = 4, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        for knob, value, legal in (("router", router_impl, _ROUTERS),
                                   ("dispatch", dispatch_impl, _DISPATCHES)):
            if value not in legal:
                raise ValueError(
                    f"Unknown {knob}_impl {value!r}; legal: {legal} "
                    "(typos must fail here, not silently fall back)")
        if router_impl == "radix" and dispatch_impl == "sparse":
            raise ValueError(
                "router_impl='radix' produces a selection mask only (no "
                "rank, no capacity slots) — it requires "
                "dispatch_impl='dense'/'dense_nhwc'")
        if dispatch_impl == "dense_nhwc" and router_impl == "sort":
            raise ValueError(
                "dispatch_impl='dense_nhwc' routes by selection mask and "
                "needs router_impl='rank'/'rank_pallas'/'radix' (the sort "
                "router produces capacity slots, not per-token masks)")
        if dispatch_impl == "dense" and router_impl == "sort":
            raise ValueError(
                "dispatch_impl='dense' routes by selection mask and "
                "needs router_impl='rank'/'rank_pallas'/'radix' (the "
                "sort router produces capacity slots, not per-token "
                "ranks)")
        if router_impl == "radix" and not 1 <= radix_bits <= 8:
            raise ValueError(f"radix_bits={radix_bits} must be in [1, 8]")
        d, e, hid = num_features, num_experts, hidden_mult * num_features
        self.num_experts = e
        self.capacity_factor = capacity_factor
        self.group_size = group_size
        self.router_impl = router_impl
        self.dispatch_impl = dispatch_impl
        self.radix_bits = radix_bits
        # (first local expert, local experts, group) under an 'expert' mesh
        # axis (parallel/ep.shard_expert_params), else None.
        self.expert_shard = None
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

    @staticmethod
    def slots(af: torch.Tensor,
              cap: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The ``sort`` router's ``cap`` slots of every (G, e, gs) row: the
        values and token indices, ``lax.top_k``'s order (value descending,
        the earlier index first on ties: a stable sort, as ``torch.topk``
        promises no tie order). The gradient flows through the values."""
        vals, idx = torch.sort(af, dim=-1, descending=True, stable=True)
        return vals[..., :cap], idx[..., :cap]

    def selection(self, af: torch.Tensor, cap: int) -> torch.Tensor:
        """(G, e, gs) affinities -> the bool top-``cap`` mask of every row:
        the mask routers' (``rank``, ``rank_pallas``, ``radix``), or the
        tokens of the ``sort`` router's slots."""
        if self.router_impl == "radix":
            return topk_mask(af.detach(), cap, radix_bits=self.radix_bits)
        if self.router_impl == "sort":
            idx = self.slots(af.detach(), cap)[1]
            return torch.zeros(af.shape, dtype=torch.bool,
                               device=af.device).scatter_(-1, idx, True)
        return route(af, self.router_impl) < cap

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, d, h, w = x.shape
        t = h * w
        af, gs = self.affinities(x)  # (G, e, gs)
        pad = (-t) % gs
        cap = self.capacity(gs)
        group = None
        if self.expert_shard is not None:  # this rank's experts' rows
            lo, local, group = self.expert_shard
            af = copy_to(af, group)[:, lo:lo + local]

        # Params joined to the ACTIVATION dtype at use (a restored f32 leaf
        # must not promote a bf16 net's expert FFN).
        cd = x.dtype
        wi, bi, wo, bo = (p.to(cd) for p in (self.expert_wi, self.expert_bi,
                                             self.expert_wo, self.expert_bo))
        e, hid = wi.shape[0], wi.shape[2]
        if self.dispatch_impl == "dense_nhwc":
            # Image layout: the heavy tensors stay conv-shaped; only the
            # e-channel affinity crosses into groups for the mask.
            def pixels(a):  # (G, e, gs) -> (n, e, h, w), padding dropped
                a = a.transpose(1, 2).reshape(n, t + pad, e)[:, :t]
                return a.reshape(n, h, w, e).permute(0, 3, 1, 2)

            gate = torch.where(pixels(self.selection(af, cap)), pixels(af),
                               0.0).to(cd)
            # Channel g*hid + i contracts wi[g, :, i]; the grouped conv
            # maps hidden block g through wo[g] (channel g*d + j).
            k_in = wi.permute(0, 2, 1).reshape(e * hid, d, 1, 1)
            hdn = F.relu(F.conv2d(x, k_in, bi.reshape(e * hid)))
            k_out = wo.permute(0, 2, 1).reshape(e * d, hid, 1, 1)
            out = F.conv2d(hdn, k_out, bo.reshape(e * d), groups=e)
            combined = torch.einsum("nedhw,nehw->ndhw",
                                    out.reshape(n, e, d, h, w), gate)
            return x + combined.to(cd)

        tokens = x.permute(0, 2, 3, 1).reshape(n, t, d)
        if pad:
            tokens = torch.cat([tokens, tokens.new_zeros(n, pad, d)], dim=1)
        tokens = copy_to(tokens.reshape(n * (t + pad) // gs, gs, d),
                         group)  # (G, gs, d)

        if self.dispatch_impl == "dense":
            gate_t = torch.where(self.selection(af, cap), af,
                                 0.0).to(cd)  # (G, e, gs)
            hdn = torch.einsum("gtd,edh->geth", tokens, wi) + bi[:, None, :]
            out = (torch.einsum("geth,ehd->getd", F.relu(hdn), wo)
                   + bo[:, None, :])
            combined = torch.einsum("getd,get->gtd", out, gate_t)
        else:
            if self.router_impl == "sort":
                vals, idx = self.slots(af, cap)
                gate = vals.to(cd)  # (G, e, cap)
                dispatch = F.one_hot(idx, gs).transpose(
                    -1, -2).to(cd)  # (G, e, gs, cap)
            else:
                # One-hot of the rank over the capacity slots: rank >= cap
                # (unselected) gives an all-zero row.
                rank = route(af, self.router_impl)  # (G, e, gs) int32
                slots = torch.arange(cap, device=rank.device)
                dispatch = (rank[..., None] == slots).to(cd)
                gate = torch.einsum("getc,get->gec", dispatch, af.to(cd))
            xin = torch.einsum("getc,gtd->gecd", dispatch, tokens)
            hdn = torch.einsum("gecd,edh->gech", xin, wi) + bi[None, :, None, :]
            out = (torch.einsum("gech,ehd->gecd", F.relu(hdn), wo)
                   + bo[None, :, None, :])
            out = out * gate[..., None]  # affinity-weighted
            combined = torch.einsum("getc,gecd->gtd", dispatch, out)
        combined = reduce_from(combined, group)  # every rank's experts
        combined = combined.reshape(n, t + pad, d)[:, :t]
        return x + combined.reshape(n, h, w, d).permute(0, 3, 1, 2).to(cd)


@register("net")
class MoEEDSRNet(nn.Module):
    """EDSR trunk with an :class:`ExpertChoiceMoE` block after every
    ``moe_every``-th residual block: ``(N, C, h, w) -> (N, C_out, H, W)``.
    Arguments as the JAX net (``radix_bits``: the ``radix`` router's bits a
    pass). ``dtype`` (the compute dtype; the parameters stay float32: the
    experts' are cast to the activations' dtype at use, the router's
    affinities are float32), ``device``, ``generator``: as ``DRFNet``."""

    serving_mode = "frame"

    def __init__(self, in_channels: int, out_channels: int, num_resblocks: int,
                 num_features: int, upscale_factor: int, res_scale: float = 0.1,
                 num_experts: int = 4, capacity_factor: float = 1.25,
                 hidden_mult: int = 2, group_size: int = 256,
                 moe_every: int = 2, router_impl: str = "rank",
                 dispatch_impl: str = "sparse", radix_bits: int = 4,
                 fused_tail: bool = False,
                 dtype: torch.dtype | str | None = None, *,
                 device: torch.device | str | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dt = resolve_dtype(dtype)
        f = num_features
        self.head = Conv(in_channels, f, 3, padding=1, dtype=dt,
                         generator=generator)
        self.blocks = nn.ModuleList()
        self.moes = nn.ModuleDict()  # index of the resblock it follows -> MoE
        for i in range(num_resblocks):
            self.blocks.append(_ResBlock(f, res_scale, dtype=dt,
                                         generator=generator))
            if (i + 1) % moe_every == 0:
                self.moes[str(i)] = ExpertChoiceMoE(
                    f, num_experts, capacity_factor, hidden_mult, group_size,
                    router_impl, dispatch_impl, radix_bits,
                    generator=generator)
        self.body_end = Conv(f, f, 3, padding=1, dtype=dt,
                             generator=generator)
        self.up = _UpBlock(f, upscale_factor, dtype=dt, generator=generator)
        self.dispatch_impl = dispatch_impl
        self.tail = ShuffleConv(f, out_channels, 3,
                                factor=_UpBlock.split(upscale_factor),
                                fused=fused_tail, dtype=dt,
                                generator=generator)
        self.to(device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        head = self.head(x)
        body = head
        for i, block in enumerate(self.blocks):
            body = block(body)
            if str(i) in self.moes:
                body = self.moes[str(i)](body)
        body = self.body_end(body) + head
        return self.tail(self.up(body))
