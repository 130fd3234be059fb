"""Sort-free exact top-k selection mask by a radix threshold search (the
port of ``vsr_tpu/ops/select.py``).

The MoE expert-choice router (``models/moe.py``) selects, per ``(group,
expert)`` row of ``gs`` affinities, the ``k`` largest with stable ties (the
earlier index wins): ``lax.top_k``'s selection set, which is also ``rank <
k`` of the pairwise rank. When only that mask is needed (the ``dense`` and
``dense_nhwc`` dispatches), the ``k``-th largest value can be found without
any pairwise structure: a greedy most-significant-bits-first search over the
float32 bit pattern, ``radix_bits`` bits a pass, then one pass that breaks
the ties at the threshold by index.

Precondition: every element is a non-negative finite float (softmax
affinities). For such values the IEEE-754 bit pattern read as an int32 is
non-negative and orders as the float value does, which makes the bitwise
search exact.

Plain PyTorch (elementwise compares and sums), on any device.
"""

from __future__ import annotations

import torch


def _threshold_bits(bits: torch.Tensor, k: int,
                    radix_bits: int) -> torch.Tensor:
    """The largest int32 ``t`` of each row with ``count(bits >= t) >= k``.

    ``bits``: ``(..., gs)`` non-negative int32 keys. Pass ``s`` tries the
    ``2**radix_bits - 1`` nonzero extensions ``v`` of the prefix found so
    far at bits ``[s, s + radix_bits)``; ``count(bits >= prefix | v << s)``
    does not grow with ``v``, so the best extension is the number of
    extensions that still reach ``k``. The top pass never sets bit 31 (the
    sign: a candidate with it would compare below every key)."""
    cand = torch.zeros(bits.shape[:-1], dtype=torch.int32, device=bits.device)
    for s in reversed(range(0, 32, radix_bits)):
        nvals = min(1 << radix_bits, 1 << max(0, 31 - s)) - 1
        if nvals == 0:
            continue
        best = torch.zeros_like(cand)
        for v in range(1, nvals + 1):
            t = cand | (v << s)
            cnt = (bits >= t[..., None]).sum(dim=-1)
            best += (cnt >= k).to(torch.int32)
        cand = cand | (best << s)
    return cand


def topk_mask(af: torch.Tensor, k: int, radix_bits: int = 4) -> torch.Tensor:
    """Boolean mask of the ``k`` largest elements along the last axis:
    ``lax.top_k``'s selection (value descending, ties to the earlier index),
    that is ``pairwise rank < k``, without a sort and without the ``(gs,
    gs)`` pairwise compare.

    ``af``: ``(..., gs)`` non-negative finite floats (bf16 / f16 are
    compared through their exact float32 values). ``k``: ``1 <= k <= gs``.
    ``radix_bits``: bits searched a pass, in [1, 8]."""
    if not 1 <= k <= af.shape[-1]:
        raise ValueError(f"k={k} out of range for gs={af.shape[-1]}")
    if not 1 <= radix_bits <= 8:
        raise ValueError(f"radix_bits={radix_bits} must be in [1, 8]")
    af32 = af.float().contiguous()
    thr_bits = _threshold_bits(af32.view(torch.int32), k, radix_bits)
    thr = thr_bits.view(torch.float32)[..., None]
    gt = af32 > thr
    eq = af32 == thr
    # Of the ties at exactly the threshold, the first (k - #greater) by
    # index are selected: the stable tie-break.
    n_gt = gt.sum(dim=-1, keepdim=True)
    eq_i = eq.to(torch.int32)
    tie_pos = torch.cumsum(eq_i, dim=-1) - eq_i  # exclusive count
    return gt | (eq & (tie_pos < k - n_gt))
