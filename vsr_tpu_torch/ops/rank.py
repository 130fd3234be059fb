"""Stable descending rank within each row (the port of the Pallas kernel K3).

The expert-choice router of ``models/moe.py`` needs, per (group, expert) row
of ``gs`` affinities, each token's rank in descending order with stable ties
(the earlier index wins). ``pairwise_rank`` computes it: on a CUDA tensor it
launches the hand-written kernel of ``csrc/pairwise_rank.cu`` (which
replaces ``vsr_tpu/ops/rank.py``'s ``pairwise_rank``); on a CPU tensor it
runs the plain twin ``pairwise_rank_reference``. There is no fallback from
the kernel to the twin: a CUDA call that the kernel cannot take raises.

Both compare with the float ``>`` and ``==``, exactly as the Pallas body
does: ``-0.0`` ties with ``+0.0`` (a total-order sort would split them), and
a NaN compares false with everything, so a NaN element gets rank 0 and no
element counts it. MoE affinities are softmax outputs (>= 0, never NaN), so
neither case arises where the layer calls this.

The rank is an integer and carries no gradient: callers pass a detached
tensor. The call goes through the custom op
``torch.ops.vsr_tpu_torch.pairwise_rank`` (CPU: the twin, CUDA: the kernel,
fake: the output's shape), so ``torch.export`` records the op and a loaded
program launches the kernel and counts it on the wrapper.
"""

from __future__ import annotations

import torch

MAX_GS = 4096  # kMaxGs of csrc/pairwise_rank.cu: one row in shared memory
# Elements of the (rows, gs, gs) compare intermediate the twin makes at once.
_TWIN_CHUNK_ELEMENTS = 1 << 24


def pairwise_rank_reference(af: torch.Tensor) -> torch.Tensor:
    """Plain twin: ``af`` (..., gs) -> int32 (..., gs), element i's count of
    j with ``a_j > a_i`` or (``a_j == a_i`` and ``j < i``). The broadcast
    compare-and-sum runs over chunks of rows so that its ``(rows, gs, gs)``
    intermediate stays bounded."""
    gs = af.shape[-1]
    flat = af.reshape(-1, gs)
    rows = flat.shape[0]
    out = torch.empty((rows, gs), dtype=torch.int32, device=af.device)
    idx = torch.arange(gs, device=af.device)
    j_lt_i = idx[None, :] < idx[:, None]  # [i, j]: j < i
    step = max(1, _TWIN_CHUNK_ELEMENTS // (gs * gs))
    for start in range(0, rows, step):
        a = flat[start:start + step]
        a_i, a_j = a[:, :, None], a[:, None, :]
        out[start:start + step] = ((a_j > a_i) | ((a_j == a_i) & j_lt_i)).sum(
            dim=-1, dtype=torch.int32)
    return out.reshape(af.shape)


def pairwise_rank(af: torch.Tensor) -> torch.Tensor:
    """``af``: contiguous float32 ``(..., gs)`` scores, ``gs <= MAX_GS``.
    Returns int32 of the same shape: each element's stable descending rank
    within its trailing row. Any ``gs`` up to the limit is taken (no
    multiple-of-128 rule); a larger one raises.
    ``pairwise_rank.launches`` counts the kernel's launches."""
    if af.dtype != torch.float32:
        raise TypeError(f"pairwise_rank takes float32 scores, not {af.dtype}")
    if af.dim() < 1 or af.numel() == 0:
        raise ValueError(f"pairwise_rank got an empty input {tuple(af.shape)}")
    if not af.is_contiguous():
        raise ValueError("pairwise_rank input must be contiguous")
    gs = af.shape[-1]
    if gs > MAX_GS:
        raise ValueError(f"pairwise_rank takes rows of at most {MAX_GS} "
                         f"scores, got {gs}")
    if af.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("pairwise_rank has no gradient (integer output): "
                           "pass af.detach()")
    if af.device.type not in ("cpu", "cuda"):
        raise ValueError(f"pairwise_rank runs on cpu or cuda, not {af.device}")
    return torch.ops.vsr_tpu_torch.pairwise_rank(af)


pairwise_rank.launches = 0


@torch.library.custom_op("vsr_tpu_torch::pairwise_rank", mutates_args=(),
                         device_types="cpu")
def _pairwise_rank_op(af: torch.Tensor) -> torch.Tensor:
    """The op that the wrapper reaches: the twin on CPU tensors, the kernel
    on CUDA tensors."""
    return pairwise_rank_reference(af)


@_pairwise_rank_op.register_kernel("cuda")
def _pairwise_rank_cuda(af):
    if af.dtype != torch.float32 or not af.is_contiguous():
        raise ValueError("pairwise_rank's kernel takes contiguous float32 "
                         f"scores, got {af.dtype}")
    gs = af.shape[-1]
    if af.numel() == 0 or gs > MAX_GS:
        raise ValueError(f"pairwise_rank's kernel takes non-empty rows of at "
                         f"most {MAX_GS} scores, got {tuple(af.shape)}")

    from vsr_tpu_torch import _build

    lib = _build.load()
    out = torch.empty(af.shape, dtype=torch.int32, device=af.device)
    with torch.cuda.device(af.device):
        stream = torch.cuda.current_stream(af.device).cuda_stream
        rc = lib.vsr_pairwise_rank(af.data_ptr(), out.data_ptr(),
                                   af.numel() // gs, gs, stream)
    if rc != 0:
        raise RuntimeError(f"pairwise_rank kernel launch failed: "
                           f"cudaError_t {rc}")
    pairwise_rank.launches += 1
    return out


@_pairwise_rank_op.register_fake
def _pairwise_rank_fake(af):
    return torch.empty_like(af, dtype=torch.int32)
