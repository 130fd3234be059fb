#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port's serving paths on one CUDA card.

Drives ``vsr_tpu_torch`` (never JAX, never ``vsr_tpu``) through its three
serving paths, each at the full width of the repo's config for its net, with
random seeded weights:

- video mode: DRFNet x2 (F=64, G=6, ``configs/test/acdc_vsr_drf_x2.yaml``),
  whose squeezes run the fused concat + 1x1 kernel (K1);
- frame mode: MoEEDSRNet x2 (16 resblocks, 64 features, 4 experts, groups of
  256, ``configs/test/acdc_sisr_moe_x2.yaml``), whose router runs the
  pairwise-rank kernel (K3);
- window mode: DUFNet x2 (7 frames, 5x5 filters, ``_DenseLayer16``,
  ``configs/test/acdc_misr_duf_x2.yaml``) with ``--windows 7 --chunk 100``,
  whose dynamic filters run the fused filter kernel (K2).

Phases; any failure exits non-zero and prints no result:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles ``vsr_tpu_torch/csrc/*.cu`` with nvcc, prints the time;
3. kernel vs twin: every kernel against its plain PyTorch twin on the card
   at the shapes its path gives it (K1: every squeeze shape of a DRFNet
   frame step, f32 and bf16, without and with its PReLU epilogue, plus a
   ragged case off every tile and off 16-byte alignment; K3: 43 200 rows of
   256 affinities, bit-equal, plus many ties, a ragged row length and a row
   count off the rows per block; K2: one chunk of 100 windows at
   96 x 96 with 5 x 5 filters, plus an odd geometry), with max error, median
   CUDA-event times (device time: the host queues ahead of the card) of
   kernel, twin and (where one exists) the one PyTorch
   call that computes the same function, and the bound: the least time the
   card could take, from the bytes moved and the operations done;
4. paths: each path is served by the port's infer CLI on small NIfTI volumes
   (192 x 192, one slice, 30 frames) with its kernel on and off, and through
   the same pipeline without file I/O on full volumes (192 x 192 x 10 x 30).
   Every kernel's launch count is set to 0 before a run and read after it:
   a run with the kernel on must launch it the expected number of times, a
   run with it off never. Outputs with the kernel on and off must agree
   (MoE: identically; DRF, DUF: >= 99.9 % exact grey values, <= 1 grey);
5. card vs CPU: a small volume of each path served on the card (kernels)
   and on the CPU (plain twins) must agree at that same bar;
6. prints the kernels' JSON line, then the final JSON line.

``--profile`` adds one ``torch.profiler`` trace of a full volume per path
(f32, and bf16 for DRFNet: device time by kernel, idle share) to the
details.

Usage: python3 chip_smoke.py [--out details.json] [--profile]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch

FACTOR, HR, T_FRAMES = 2, 192, 30
LR = HR // FACTOR
FULL_SLICES, FULL_VOLUMES = 10, 3   # volumes through make_pipeline, no I/O
CLI_SLICES, CLI_VOLUMES = 1, 2      # volumes through the infer CLI
# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory
# bytes/s, float32 FLOP/s outside the tensor cores, dense bf16 FLOP/s.
PEAK_BYTES, PEAK_F32, PEAK_BF16 = 3.35e12, 67e12, 989e12

# --- DRFNet (video mode, K1) -------------------------------------------------
F_, G_ = 64, 6
DRF_KWARGS = dict(in_channels=1, out_channels=1, num_features=F_,
                  num_groups=G_, upscale_factor=FACTOR)
# Squeezes of one DRFNet frame step through the kernel: {(k inputs, side): count}.
# LR: the input squeeze (k=2), the LR ladder (k=2..6), the output fuse (k=6);
# HR: the HR ladder (k=2..6).
STEP_SQUEEZES = {(2, LR): 2, (3, LR): 1, (4, LR): 1, (5, LR): 1, (6, LR): 2,
                 (2, HR): 1, (3, HR): 1, (4, HR): 1, (5, HR): 1, (6, HR): 1}
SQUEEZES_PER_STEP = sum(STEP_SQUEEZES.values())  # 12
F32_TOL = dict(atol=1e-4, rtol=1e-4)
# bf16 kernel vs the f32 twin on the same bf16-rounded operands: one bf16
# rounding of the output (rtol), plus f32 summation-order noise near 0 (atol).
BF16_TOL = dict(atol=1e-4, rtol=8e-3)

# --- MoEEDSRNet (frame mode, K3) ---------------------------------------------
MOE_KWARGS = dict(in_channels=1, out_channels=1, num_resblocks=16,
                  num_features=64, upscale_factor=FACTOR, num_experts=4,
                  group_size=256, moe_every=2)
MOE_LAYERS = MOE_KWARGS["num_resblocks"] // MOE_KWARGS["moe_every"]  # 8
# Rows the router ranks for one full volume: frames x groups x experts.
RANK_ROWS = (FULL_SLICES * T_FRAMES * (LR * LR // MOE_KWARGS["group_size"])
             * MOE_KWARGS["num_experts"])  # 43 200

# --- DUFNet (window mode, K2) ------------------------------------------------
DUF_KWARGS = dict(in_channels=1, out_channels=1, num_frames=7, size_filter=5,
                  upscale_factor=FACTOR, backbone="_DenseLayer16")
DUF_CHUNK = 100
DUF_TOL = 1e-4  # f32 kernel vs twin, the bar of the JAX kernel's own test


def log(msg: str) -> None:
    print(msg, flush=True)


SPIN_CYCLES = 40_000_000  # ~20 ms of the card's clock


def median_ms(fn, reps: int = 20) -> float:
    """Median device time of one call of ``fn``. The calls are queued behind
    a spin of the card, so the host, which needs tens of microseconds to
    enqueue a call, runs ahead of it: a short kernel's time is then the
    card's and not the host's."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(SPIN_CYCLES)
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def within(got: torch.Tensor, ref: torch.Tensor, atol: float,
           rtol: float) -> bool:
    return bool(((got - ref).abs() <= atol + rtol * ref.abs()).all())


def bound(n_bytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    """(least ms the card could take, what bounds it): every input byte read
    once and every output byte written once at the memory rate, against the
    operations at the peak rate for their type."""
    by_bytes, by_ops = n_bytes / PEAK_BYTES * 1e3, ops / peak_ops * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


# ============================================================ kernel vs twin


def library_squeeze_prelu(xs, w4, b, alpha):
    """The library's form of a squeeze and its activation: ``torch.cat``, the
    1x1 conv, ``prelu`` (timed beside the kernel, used nowhere in the port)."""
    return torch.nn.functional.prelu(
        torch.nn.functional.conv2d(torch.cat(xs, dim=1), w4, b), alpha)


def squeeze_ragged_case(dev, gen) -> dict:
    """K1 off every tile and off 16-byte rows (9 x 13 pixels, channels 3, 17
    and 40, 70 output channels), with the epilogue: the kernel's
    element-wise load and store path against the twin."""
    from vsr_tpu_torch.ops.fused_squeeze import (concat_conv1x1,
                                                 concat_conv1x1_reference)

    channels, f_out = (3, 17, 40), 70
    xs = [torch.randn(2, c, 9, 13, generator=gen).to(dev) for c in channels]
    w = (torch.rand(f_out, sum(channels), generator=gen) - 0.5).to(dev)
    b = (torch.rand(f_out, generator=gen) - 0.5).to(dev)
    alpha = torch.full((1,), 0.2, device=dev)
    res = {}
    with torch.inference_mode():
        for name, dtype, tol in (("f32", torch.float32, F32_TOL),
                                 ("bf16", torch.bfloat16, BF16_TOL)):
            ops = [t.to(dtype) for t in (*xs, w, b, alpha)]
            got = concat_conv1x1(ops[:3], *ops[3:]).float()
            ref = concat_conv1x1_reference(
                [t.float() for t in ops[:3]], *(t.float() for t in ops[3:]))
            torch.cuda.synchronize()
            res[f"{name}_max_abs_err"] = (got - ref).abs().max().item()
            ok = got.shape == ref.shape and within(got, ref, **tol)
            log(f"  K1 ragged (9x13, channels {channels}, F={f_out}, PReLU) "
                f"{name}: err {res[f'{name}_max_abs_err']:.3g} "
                f"({'ok' if ok else 'FAIL'})")
            if not ok:
                raise SystemExit(f"K1 disagrees with its twin on the ragged "
                                 f"{name} case")
    return res


def phase_kernel_squeeze(dev) -> dict:
    from vsr_tpu_torch.ops.fused_squeeze import (concat_conv1x1,
                                                 concat_conv1x1_reference)

    n = FULL_SLICES
    gen = torch.Generator().manual_seed(1)
    prelu = torch.nn.functional.prelu
    alpha32 = torch.full((1,), 0.2, device=dev)
    alpha16 = alpha32.bfloat16()
    rows = []
    for (k, side) in sorted(STEP_SQUEEZES):
        xs32 = [torch.randn(n, F_, side, side, generator=gen).to(dev)
                for _ in range(k)]
        scale = (k * F_) ** -0.5
        w32 = ((torch.rand(F_, k * F_, generator=gen) * 2 - 1) * scale).to(dev)
        b32 = ((torch.rand(F_, generator=gen) * 2 - 1) * scale).to(dev)
        xs16 = [x.bfloat16() for x in xs32]
        w16, b16 = w32.bfloat16(), b32.bfloat16()
        elements = n * side * side * (k * F_ + F_) + F_ * k * F_ + F_
        flops = 2.0 * n * side * side * k * F_ * F_
        with torch.inference_mode():
            got32 = concat_conv1x1(xs32, w32, b32)
            ref32 = concat_conv1x1_reference(xs32, w32, b32)
            got16 = concat_conv1x1(xs16, w16, b16).float()
            ref16 = concat_conv1x1_reference(
                [x.float() for x in xs16], w16.float(), b16.float())
            # The PReLU epilogue: against twin-then-PReLU, and bit for bit
            # the separate PReLU on the kernel's own output.
            act32 = concat_conv1x1(xs32, w32, b32, alpha32)
            raw16 = concat_conv1x1(xs16, w16, b16)
            act16 = concat_conv1x1(xs16, w16, b16, alpha16)
            w4_32, w4_16 = w32[:, :, None, None], w16[:, :, None, None]
            torch.cuda.synchronize()
            row = {
                "k": k, "side": side, "count_per_step": STEP_SQUEEZES[k, side],
                "f32_max_abs_err": (got32 - ref32).abs().max().item(),
                "f32_ok": within(got32, ref32, **F32_TOL),
                "bf16_max_abs_err": (got16 - ref16).abs().max().item(),
                "bf16_ok": within(got16, ref16, **BF16_TOL),
                "f32_act_max_abs_err":
                    (act32 - prelu(ref32, alpha32)).abs().max().item(),
                "f32_act_ok": within(act32, prelu(ref32, alpha32), **F32_TOL)
                and torch.equal(act32, prelu(got32, alpha32)),
                "bf16_act_max_abs_err":
                    (act16.float() - prelu(ref16, alpha32)).abs().max().item(),
                "bf16_act_ok":
                    within(act16.float(), prelu(ref16, alpha32), **BF16_TOL)
                    and torch.equal(act16, prelu(raw16, alpha16)),
                "f32_act_ms": median_ms(
                    lambda: concat_conv1x1(xs32, w32, b32, alpha32)),
                "f32_act_library_ms": median_ms(
                    lambda: library_squeeze_prelu(xs32, w4_32, b32, alpha32)),
                "bf16_act_ms": median_ms(
                    lambda: concat_conv1x1(xs16, w16, b16, alpha16)),
                "bf16_act_library_ms": median_ms(
                    lambda: library_squeeze_prelu(xs16, w4_16, b16, alpha16)),
                "f32_ms": median_ms(lambda: concat_conv1x1(xs32, w32, b32)),
                "f32_plain_ms": median_ms(
                    lambda: concat_conv1x1_reference(xs32, w32, b32)),
                "bf16_ms": median_ms(lambda: concat_conv1x1(xs16, w16, b16)),
                "bf16_plain_ms": median_ms(
                    lambda: concat_conv1x1_reference(xs16, w16, b16)),
                "f32_bytes": 4 * elements, "bf16_bytes": 2 * elements,
                "flops": flops,
            }
        rows.append(row)
        log(f"  K1 k={k} {side}x{side} N={n}: f32 err "
            f"{row['f32_max_abs_err']:.3g} ({'ok' if row['f32_ok'] else 'FAIL'})"
            f" kernel {row['f32_ms']:.4f} ms twin {row['f32_plain_ms']:.4f} ms"
            f" | bf16 err {row['bf16_max_abs_err']:.3g} "
            f"({'ok' if row['bf16_ok'] else 'FAIL'}) kernel "
            f"{row['bf16_ms']:.4f} ms twin {row['bf16_plain_ms']:.4f} ms")
        log(f"     with PReLU: f32 err {row['f32_act_max_abs_err']:.3g} "
            f"({'ok' if row['f32_act_ok'] else 'FAIL'}) kernel "
            f"{row['f32_act_ms']:.4f} ms library conv + prelu "
            f"{row['f32_act_library_ms']:.4f} ms | bf16 err "
            f"{row['bf16_act_max_abs_err']:.3g} "
            f"({'ok' if row['bf16_act_ok'] else 'FAIL'}) kernel "
            f"{row['bf16_act_ms']:.4f} ms library "
            f"{row['bf16_act_library_ms']:.4f} ms")
    bad = [(r["k"], r["side"]) for r in rows
           if not (r["f32_ok"] and r["bf16_ok"] and r["f32_act_ok"]
                   and r["bf16_act_ok"])]
    if bad:
        raise SystemExit(f"K1 disagrees with its twin at {bad}")
    ragged = squeeze_ragged_case(dev, gen)

    def per_step(key):
        return sum(r[key] * r["count_per_step"] for r in rows)

    summary = {key: per_step(key) for key in
               ("f32_ms", "f32_plain_ms", "bf16_ms", "bf16_plain_ms",
                "f32_act_ms", "f32_act_library_ms", "bf16_act_ms",
                "bf16_act_library_ms", "f32_bytes", "bf16_bytes", "flops")}
    summary["f32_bound_ms"], summary["f32_bound_by"] = bound(
        summary["f32_bytes"], summary["flops"], PEAK_F32)
    summary["bf16_bound_ms"], summary["bf16_bound_by"] = bound(
        summary["bf16_bytes"], summary["flops"], PEAK_BF16)
    log(f"  K1, one frame step's {SQUEEZES_PER_STEP} squeezes (N={n}): f32 "
        f"kernel {summary['f32_ms']:.4f} ms vs twin (torch.cat + library 1x1 "
        f"conv) {summary['f32_plain_ms']:.4f} ms, bound "
        f"{summary['f32_bound_ms']:.4f} ms by {summary['f32_bound_by']}; bf16 "
        f"kernel {summary['bf16_ms']:.4f} ms vs twin "
        f"{summary['bf16_plain_ms']:.4f} ms, bound "
        f"{summary['bf16_bound_ms']:.4f} ms by {summary['bf16_bound_by']}")
    log(f"  K1 with its PReLU epilogue, same {SQUEEZES_PER_STEP} squeezes: f32 "
        f"kernel {summary['f32_act_ms']:.4f} ms vs torch.cat + library conv + "
        f"prelu {summary['f32_act_library_ms']:.4f} ms; bf16 kernel "
        f"{summary['bf16_act_ms']:.4f} ms vs {summary['bf16_act_library_ms']:.4f}"
        f" ms (bounds as above: the epilogue moves no further byte)")
    return {"rows": rows, "per_step": summary, "ragged": ragged,
            "f32_max_abs_err": max(
                max(r["f32_max_abs_err"], r["f32_act_max_abs_err"])
                for r in rows),
            "bf16_max_abs_err": max(
                max(r["bf16_max_abs_err"], r["bf16_act_max_abs_err"])
                for r in rows)}


def argsort_rank(af: torch.Tensor) -> torch.Tensor:
    """The one-call library form of the rank: the inverse permutation of a
    stable descending argsort (timed beside the kernel, used nowhere in the
    port)."""
    order = torch.argsort(af, dim=-1, descending=True, stable=True)
    rank = torch.empty_like(order)
    rank.scatter_(-1, order, torch.arange(
        af.shape[-1], device=af.device).expand_as(order))
    return rank.int()


def phase_kernel_rank(dev) -> dict:
    from vsr_tpu_torch.ops.rank import pairwise_rank, pairwise_rank_reference

    gen = torch.Generator().manual_seed(2)
    groups, e, gs = RANK_ROWS // 4, 4, 256
    # Softmax affinities in the router's (G, e, gs) layout.
    af = torch.randn(groups, gs, e, generator=gen).softmax(-1).transpose(
        1, 2).contiguous().to(dev)
    cases = {
        "affinities": af,
        # Many exact ties: 16 distinct values per row of 256.
        "ties": (af * 64).round().div(64).contiguous(),
        # A row length the TPU kernel refuses (not a multiple of 128).
        "ragged_gs200": torch.rand(1000, 4, 200, generator=gen).to(dev),
        # A row count that is no multiple of the 4 rows a block takes.
        "ragged_rows1001": torch.rand(1001, gs, generator=gen).to(dev),
    }
    res = {}
    for name, a in cases.items():
        got, ref = pairwise_rank(a), pairwise_rank_reference(a)
        torch.cuda.synchronize()
        mismatches = int((got != ref).sum())
        res[name] = {"shape": list(a.shape), "mismatches": mismatches}
        log(f"  K3 {name} {tuple(a.shape)}: {mismatches} ranks differ from "
            f"the twin ({'ok' if not mismatches else 'FAIL'})")
        if mismatches or got.dtype != torch.int32:
            raise SystemExit(f"K3 disagrees with its twin on {name}")
    if not torch.equal(pairwise_rank(af), argsort_rank(af)):
        raise SystemExit("K3 disagrees with the stable argsort's ranks")
    rows = af.numel() // gs
    res["ms"] = median_ms(lambda: pairwise_rank(af))
    res["plain_ms"] = median_ms(lambda: pairwise_rank_reference(af), reps=5)
    res["library_ms"] = median_ms(lambda: argsort_rank(af))
    # One compare per (i, j) pair, against the float32 rate.
    res["bytes"], res["ops"] = 2 * 4 * rows * gs, float(rows) * gs * gs
    res["bound_ms"], res["bound_by"] = bound(res["bytes"], res["ops"], PEAK_F32)
    res["max_abs_err"] = 0.0  # bit-equal int32 ranks, checked above
    log(f"  K3 {rows} rows x {gs}: kernel {res['ms']:.4f} ms, twin "
        f"{res['plain_ms']:.4f} ms, stable argsort + scatter "
        f"{res['library_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms by "
        f"{res['bound_by']}")
    return res


def phase_kernel_duf(dev) -> dict:
    from vsr_tpu_torch.ops.duf_filter import (duf_dynamic_filter,
                                              duf_dynamic_filter_reference)

    gen = torch.Generator().manual_seed(3)
    res, inputs = {}, {}
    # (N, H, W, size, upscale): one --chunk 100 call; an odd geometry.
    for name, (n, h, w, k, r) in {"chunk": (DUF_CHUNK, LR, LR, 5, FACTOR),
                                  "odd": (3, 9, 12, 3, 3)}.items():
        x = torch.randn(n, h, w, generator=gen).to(dev)
        logits = (2 * torch.randn(n, k * k * r * r, h, w, generator=gen)).to(dev)
        inputs[name] = (x, logits, k, r)
        with torch.inference_mode():
            got = duf_dynamic_filter(x, logits, k, r)
            ref = duf_dynamic_filter_reference(x, logits, k, r)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        ok = err <= DUF_TOL and got.shape == (n, h * r, w * r)
        res[name] = {"shape": [n, h, w, k, r], "max_abs_err": err}
        log(f"  K2 {name} x ({n}, {h}, {w}) k={k} r={r}: err {err:.3g} "
            f"({'ok' if ok else 'FAIL'})")
        if not ok:
            raise SystemExit(f"K2 disagrees with its twin on {name}")
    args = inputs["chunk"]
    n, h, w, k, r = res["chunk"]["shape"]
    with torch.inference_mode():
        res["ms"] = median_ms(lambda: duf_dynamic_filter(*args))
        res["plain_ms"] = median_ms(lambda: duf_dynamic_filter_reference(*args))
    # Logits and x read once, the output written once; per logit a compare,
    # a subtract, an exponential, an add and a multiply-add (5 operations).
    res["bytes"] = 4 * n * h * w * (k * k * r * r + 1 + r * r)
    res["ops"] = 5.0 * n * h * w * k * k * r * r
    res["bound_ms"], res["bound_by"] = bound(res["bytes"], res["ops"], PEAK_F32)
    res["max_abs_err"] = max(res["chunk"]["max_abs_err"],
                             res["odd"]["max_abs_err"])
    log(f"  K2 x ({n}, {h}, {w}) k={k} r={r}: kernel {res['ms']:.4f} ms, twin "
        f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms by "
        f"{res['bound_by']} (no single library call computes it)")
    return res


# ================================================================= the paths


def make_volume(seed: int, slices: int) -> np.ndarray:
    """(H, W, D, T) float32 volume of integer noise in [0, 255] (bench.py's
    synthetic data)."""
    rng = np.random.default_rng(seed)
    return np.round(rng.random((HR, HR, slices, T_FRAMES)) * 255).astype(
        np.float32)


def as_frames(vol: np.ndarray) -> np.ndarray:
    """(H, W, D, T) -> (D*T, H, W), as the infer CLI regroups a volume (no
    crop at 192: a multiple of 12; float input skips the outlier clip)."""
    h, w, d, t = vol.shape
    return np.ascontiguousarray(np.moveaxis(vol.reshape(h, w, d * t), -1, 0))


def agreement(a: np.ndarray, b: np.ndarray) -> tuple[float, float]:
    diff = np.abs(a.astype(np.float64) - b.astype(np.float64))
    return float((diff == 0).mean()), float(diff.max())


def check_sr(name: str, sr: np.ndarray, shape: tuple) -> None:
    if sr.shape != shape or not (np.isfinite(sr).all() and sr.min() >= 0
                                 and sr.max() <= 255):
        raise SystemExit(f"{name}: bad SR output, shape {sr.shape}")


def kernel_counters() -> dict:
    """Kernel name -> the wrapper that carries its launch count."""
    from vsr_tpu_torch.ops.duf_filter import duf_dynamic_filter
    from vsr_tpu_torch.ops.fused_squeeze import concat_conv1x1
    from vsr_tpu_torch.ops.rank import pairwise_rank

    return {"concat_conv1x1": concat_conv1x1,
            "duf_dynamic_filter": duf_dynamic_filter,
            "pairwise_rank": pairwise_rank}


def reset_launches() -> None:
    for fn in kernel_counters().values():
        fn.launches = 0


def check_launches(name: str, kernel: str, want: int) -> int:
    """The run just made launched ``kernel`` exactly ``want`` times and no
    other kernel of the port at all."""
    counts = {k: fn.launches for k, fn in kernel_counters().items()}
    expected = {k: (want if k == kernel else 0) for k in counts}
    if counts != expected:
        raise SystemExit(f"{name}: kernel launches {counts}, expected "
                         f"{expected}")
    return counts[kernel]


@dataclasses.dataclass
class Path_:
    """One serving path: its net, its kernel, the CLI flags and the
    ``make_pipeline`` arguments of its mode, the net's arguments with the
    kernel on and off, and how often one volume of ``slices`` slices
    launches the kernel."""

    key: str
    net: str
    kernel: str
    cli_flags: list
    on: dict
    off: dict
    pipe_kw: Callable[[int], dict]        # frames per slice -> arguments
    launches_per_volume: Callable[[int], int]
    identical: bool  # kernel on/off outputs must be identical


PATHS = [
    Path_("drf", "DRFNet", "concat_conv1x1", ["--video", "--fused-tail"],
          dict(DRF_KWARGS, fused_squeeze=True),
          dict(DRF_KWARGS, fused_squeeze=False),
          lambda t: dict(video_t=t),
          lambda slices: SQUEEZES_PER_STEP * T_FRAMES, identical=False),
    # One net call per volume (no --chunk): every MoE layer ranks once.
    Path_("moe", "MoEEDSRNet", "pairwise_rank", [],
          dict(MOE_KWARGS, router_impl="rank_pallas"),
          dict(MOE_KWARGS, router_impl="rank"),
          lambda t: dict(),
          lambda slices: MOE_LAYERS, identical=True),
    # One launch per chunk of windows (the last chunk is padded).
    Path_("duf", "DUFNet", "duf_dynamic_filter",
          ["--windows", str(DUF_KWARGS["num_frames"]), "--chunk",
           str(DUF_CHUNK)],
          dict(DUF_KWARGS, use_pallas_filter=True),
          dict(DUF_KWARGS, use_pallas_filter=False),
          lambda t: dict(window=(DUF_KWARGS["num_frames"], t, "middle"),
                         chunk=DUF_CHUNK),
          lambda slices: -(-slices * T_FRAMES // DUF_CHUNK), identical=False),
]


def serve_cli(path: Path_, src: Path, out: Path, kwargs: dict) -> dict:
    """The port's infer CLI (f32), as a user runs it."""
    from vsr_tpu_torch import infer

    return infer.main([str(src), str(out), "--psnr", *path.cli_flags,
                       "--net", path.net, "--net-kwargs", json.dumps(kwargs)])


def build_net(path: Path_, kwargs: dict, dev, bf16: bool = False):
    """The seeded net the CLI builds for these arguments."""
    from vsr_tpu_torch.registry import build

    kwargs = dict(kwargs)
    if bf16:
        kwargs["dtype"] = torch.bfloat16
    if "--fused-tail" in path.cli_flags:
        kwargs["fused_tail"] = True
    return build("net", {"name": path.net, "kwargs": kwargs}, device=dev,
                 generator=torch.Generator().manual_seed(0))


def run_pipeline(path: Path_, kwargs: dict, frames: list[np.ndarray], dev,
                 bf16: bool = False, t: int | None = None):
    """The CLI's pipeline without its NIfTI I/O: the same seeded net, the
    same host-to-device copy, pipeline and device-to-host copy per volume.
    Returns the SR frames and frames/s."""
    from vsr_tpu_torch.infer import make_pipeline

    pipe = make_pipeline(build_net(path, kwargs, dev, bf16), FACTOR, "acdc",
                         **path.pipe_kw(t or T_FRAMES))
    start = time.perf_counter()
    outs = [pipe(torch.from_numpy(f).to(dev))[1].cpu().numpy() for f in frames]
    return outs, sum(len(f) for f in frames) / (time.perf_counter() - start)


def compare_on_off(path: Path_, what: str, on: list, off: list) -> dict:
    stats = [agreement(a, b) for a, b in zip(on, off)]
    res = {"exact_fraction": min(e for e, _ in stats),
           "max_grey_diff": max(m for _, m in stats)}
    log(f"  {path.key} {what}, kernel on vs off: "
        f"{res['exact_fraction'] * 100:.4f}% exact, max "
        f"{res['max_grey_diff']:g} grey")
    if path.identical and res["max_grey_diff"] != 0:
        raise SystemExit(f"{path.key} {what}: the kernel's selection differs "
                         "from the plain router's (outputs not identical)")
    if res["exact_fraction"] < 0.999 or res["max_grey_diff"] > 1:
        raise SystemExit(f"{path.key} {what}: kernel-on and kernel-off SR "
                         "outputs disagree")
    return res


def phase_path_cli(path: Path_, tmp: Path, card: str) -> dict:
    """The path through the infer CLI, kernel on and off: small NIfTI
    volumes in, .nii.gz out (the level-9 gzip write of a full volume takes
    about a minute, so the CLI runs get one-slice volumes)."""
    from vsr_tpu_torch.io.nifti import load_nifti, save_nifti

    src = tmp / f"{path.key}_volumes"
    for i in range(CLI_VOLUMES):
        save_nifti(make_volume(10 + i, CLI_SLICES),
                   src / f"patient{i:03d}" / f"patient{i:03d}_4d.nii")
    runs, srs = {}, {}
    for mode, kwargs in (("on", path.on), ("off", path.off)):
        name = f"{path.key}_cli_{mode}"
        reset_launches()
        stats = serve_cli(path, src, tmp / name, kwargs)
        want = (path.launches_per_volume(CLI_SLICES) * CLI_VOLUMES
                if mode == "on" else 0)
        stats["launches"] = check_launches(name, path.kernel, want)
        if not np.isfinite(stats["psnr_mean"]):
            raise SystemExit(f"{name}: non-finite PSNR")
        srs[mode] = [load_nifti(tmp / name / f"patient{i:03d}"
                                / f"patient{i:03d}_4d_sr.nii.gz")
                     for i in range(CLI_VOLUMES)]
        for sr in srs[mode]:
            check_sr(name, sr, (HR, HR, CLI_SLICES, T_FRAMES))
        runs[mode] = stats
        log(f"  {name} (infer CLI, {CLI_VOLUMES} volumes of {HR}x{HR}x"
            f"{CLI_SLICES}x{T_FRAMES}): {stats['frames']} frames, end to end "
            f"{stats['frames_per_sec']:.2f} frames/s, pipeline "
            f"{stats['pipeline_frames_per_sec']:.2f} frames/s, PSNR "
            f"{stats['psnr_mean']:.3f} dB, {path.kernel} launches "
            f"{stats['launches']} [{card}]")
    return {"runs": runs,
            "on_vs_off": compare_on_off(path, "CLI", srs["on"], srs["off"])}


def phase_path_full(path: Path_, variants: dict, frames, warm, card: str,
                    dev) -> tuple[dict, dict]:
    """Full volumes through ``make_pipeline`` without file I/O. ``variants``:
    name -> (net kwargs, bf16, kernel on). Returns the runs' statistics and
    their SR frames, both by name."""
    runs, srs = {}, {}
    for name, (kwargs, bf16, kernel_on) in variants.items():
        run_pipeline(path, kwargs, warm, dev, bf16)  # library handles, caches
        reset_launches()
        srs[name], fps = run_pipeline(path, kwargs, frames, dev, bf16)
        want = (path.launches_per_volume(FULL_SLICES) * len(frames)
                if kernel_on else 0)
        runs[name] = {
            "frames": sum(len(f) for f in frames),
            "pipeline_frames_per_sec": fps,
            "launches": check_launches(f"{path.key} {name}", path.kernel, want)}
        for sr in srs[name]:
            check_sr(name, sr, (FULL_SLICES * T_FRAMES, HR, HR))
        log(f"  {path.key} {name} (pipeline, no file I/O, {len(frames)} "
            f"volumes of {HR}x{HR}x{FULL_SLICES}x{T_FRAMES}): pipeline "
            f"{fps:.2f} frames/s, {path.kernel} launches "
            f"{runs[name]['launches']} [{card}]")
    return runs, srs


def phase_paths(tmp: Path, card: str, dev) -> dict:
    frames = [as_frames(make_volume(20 + i, FULL_SLICES))
              for i in range(FULL_VOLUMES)]
    warm = [as_frames(make_volume(99, FULL_SLICES))]
    drf, moe, duf = PATHS
    res = {}

    log("phase 4a: DRFNet, video mode (K1 concat_conv1x1)")
    runs, srs = phase_path_full(drf, {
        "f32_fused": (drf.on, False, True),
        "f32_unfused": (drf.off, False, False),
        "bf16_fused": (drf.on, True, True),
        "bf16_unfused": (drf.off, True, False)}, frames, warm, card, dev)
    checks = {"f32": compare_on_off(drf, "full f32", srs["f32_fused"],
                                    srs["f32_unfused"])}
    exact, worst = zip(*(agreement(a, b) for a, b in
                         zip(srs["bf16_fused"], srs["bf16_unfused"])))
    checks["bf16"] = {"exact_fraction": min(exact), "max_grey_diff": max(worst)}
    log(f"  drf full bf16, kernel on vs off: {min(exact) * 100:.4f}% exact, "
        f"max {max(worst):g} grey (not gated: bf16 roundings compound over "
        f"{T_FRAMES} recurrent frames)")
    res["drf"] = {"full": runs, "full_on_vs_off": checks,
                  "cli": phase_path_cli(drf, tmp, card)}

    log("phase 4b: MoEEDSRNet, frame mode (K3 pairwise_rank)")
    runs, srs = phase_path_full(moe, {
        "rank_pallas_sparse": (moe.on, False, True),
        "rank_pallas_dense": (dict(moe.on, dispatch_impl="dense"), False, True),
        "rank_dense": (dict(moe.off, dispatch_impl="dense"), False, False)},
        frames, warm, card, dev)
    checks = {"dense": compare_on_off(moe, "full dense",
                                      srs["rank_pallas_dense"],
                                      srs["rank_dense"])}
    exact, worst = zip(*(agreement(a, b) for a, b in
                         zip(srs["rank_pallas_sparse"],
                             srs["rank_pallas_dense"])))
    checks["sparse_vs_dense"] = {"exact_fraction": min(exact),
                                 "max_grey_diff": max(worst)}
    # The two dispatches run their expert FFNs as products of other shapes,
    # so they differ in the last bits; a later layer's router can then flip
    # a token at a capacity boundary, which moves a few pixels by several
    # grey values. Gated on the share of exact pixels only, at 99.5 %: a
    # handful of flips among 33 million pixels, not a wrong dispatch.
    log(f"  moe full, sparse vs dense dispatch: {min(exact) * 100:.4f}% "
        f"exact, max {max(worst):g} grey (isolated router flips)")
    if min(exact) < 0.995:
        raise SystemExit("moe: sparse and dense dispatch outputs disagree")
    res["moe"] = {"full": runs, "full_on_vs_off": checks,
                  "cli": phase_path_cli(moe, tmp, card)}

    log("phase 4c: DUFNet, window mode (K2 duf_dynamic_filter)")
    runs, srs = phase_path_full(duf, {
        "kernel": (duf.on, False, True),
        "plain": (duf.off, False, False)}, frames, warm, card, dev)
    checks = {"f32": compare_on_off(duf, "full f32", srs["kernel"],
                                    srs["plain"])}
    res["duf"] = {"full": runs, "full_on_vs_off": checks,
                  "cli": phase_path_cli(duf, tmp, card)}
    return res


def phase_cpu_reference(dev) -> dict:
    """A small volume of each path through the same seeded net on the card
    (kernels) and on the CPU (plain twins).

    DRF and DUF go through the whole pipeline on both devices. The MoE net
    routes discretely: the two devices' k-space LR frames differ by one grey
    value in about one pixel of a thousand (they are rounded), and such a
    pixel flips tokens at capacity boundaries layer after layer, so its
    pipelines cannot be held to a per-pixel bar. Its net is therefore fed the
    CPU's normalized LR frames on both devices."""
    from vsr_tpu_torch.infer import make_prep
    from vsr_tpu_torch.utils.normalize import DATASET_STATS

    rng = np.random.default_rng(7)
    frames = np.round(rng.random((3, 48, 48)) * 255).astype(np.float32)
    mean, std = DATASET_STATS["acdc"]
    res = {}
    for path in PATHS:
        outs = {}
        for device in ("cpu", dev):
            reset_launches()
            if path.identical:
                z = make_prep(FACTOR, "acdc")(torch.from_numpy(frames))[1]
                with torch.inference_mode():
                    sr = build_net(path, path.on, device).eval()(z.to(device))
                sr = torch.clamp(torch.round(sr[:, 0].float() * std + mean),
                                 0.0, 255.0).cpu().numpy()
            else:
                (sr,), _ = run_pipeline(path, path.on, [frames], device, t=3)
            launched = kernel_counters()[path.kernel].launches
            if (launched > 0) != (device != "cpu"):
                raise SystemExit(f"{path.key} on {device}: {launched} launches")
            outs[str(device)] = sr
        exact, worst = agreement(outs[str(dev)], outs["cpu"])
        res[path.key] = {"exact_fraction": exact, "max_grey_diff": worst}
        log(f"  {path.key} card vs CPU, 48^2 x 3 frames"
            f"{' (net on shared LR frames)' if path.identical else ''}: SR "
            f"{exact * 100:.3f}% exact (max {worst:g})")
        if exact < 0.999 or worst > 1:
            raise SystemExit(f"{path.key}: card and CPU SR outputs disagree")
    return res


def phase_profile(dev) -> dict:
    """One ``torch.profiler`` trace per path (f32, and bf16 for DRFNet;
    kernel on, one full volume through ``make_pipeline``): self device time
    by kernel, and the idle share against the median wall time of 3
    unprofiled runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vsr_tpu_torch.infer import make_pipeline

    frames = torch.from_numpy(as_frames(make_volume(30, FULL_SLICES)))
    res = {}
    for path in PATHS:
        variants = {"on": (path.on, False)}
        if path.key == "moe":
            variants["on_dense"] = (dict(path.on, dispatch_impl="dense"), False)
        if path.key == "drf":
            variants["on_bf16"] = (path.on, True)
        for name, (kwargs, bf16) in variants.items():
            pipe = make_pipeline(build_net(path, kwargs, dev, bf16), FACTOR,
                                 "acdc", **path.pipe_kw(T_FRAMES))

            def once():
                out = pipe(frames.to(dev))[1].cpu()
                torch.cuda.synchronize()
                return out

            once()
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                once()
                walls.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.reset_peak_memory_stats()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                once()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            # Device kernels and copies only: the host-side operators carry
            # their kernels' device time a second time.
            rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                           for e in prof.key_averages()
                           if e.device_type == DeviceType.CUDA
                           and e.self_device_time_total > 0),
                          key=lambda r: -r[1])
            busy, wall = sum(r[1] for r in rows), statistics.median(walls)
            res[f"{path.key}_{name}"] = {
                "wall_ms": wall, "busy_ms": busy,
                "idle_share": 1 - busy / wall, "peak_memory_gb": peak_gb,
                "top": [{"kernel": k[:100], "ms": ms, "calls": c}
                        for k, ms, c in rows[:20]]}
            log(f"  profile {path.key} {name}: wall {wall:.1f} ms, busy "
                f"{busy:.1f} ms, idle share {1 - busy / wall:.3f}, peak "
                f"memory {peak_gb:.2f} GB")
            for k, ms, c in rows[:12]:
                log(f"    {ms:9.2f} ms {c:6d} x {k[:90]}")
    return res


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="",
                        help="also write the full results as JSON here")
    parser.add_argument("--profile", action="store_true",
                        help="add a torch.profiler trace of one full volume "
                             "per path")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from vsr_tpu_torch import _build

    started = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    log("phase 1: device")
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    log(smi)
    card = f"{torch.cuda.get_device_name(0)}, {smi.split(',')[-1].strip()} limit"
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")

    log("phase 2: build")
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    root = Path(__file__).resolve().parent
    log(f"  built {[str(p.relative_to(root)) for p in _build.sources()]} "
        f"-> {_build.library_path().name} in {build_s:.2f} s")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("phase 3: kernel vs twin")
    k1 = phase_kernel_squeeze(dev)
    k3 = phase_kernel_rank(dev)
    k2 = phase_kernel_duf(dev)

    with tempfile.TemporaryDirectory() as tmp:
        paths = phase_paths(Path(tmp), card, dev)
    log("phase 5: card vs CPU")
    cpu_ref = phase_cpu_reference(dev)
    results = {"card": smi, "build_seconds": build_s,
               "kernel": {"concat_conv1x1": k1, "pairwise_rank": k3,
                          "duf_dynamic_filter": k2},
               "paths": paths, "card_vs_cpu": cpu_ref}
    if args.profile:
        log("phase 6: torch.profiler traces")
        results["profile"] = phase_profile(dev)
    results["seconds"] = time.perf_counter() - started
    log(f"  chip_smoke took {results['seconds']:.1f} s [{card}]")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))

    per_step = k1["per_step"]

    def launches(key):
        return paths[key]["cli"]["runs"]["on"]["launches"]

    print(json.dumps({"kernels": [{
        # Per DRFNet frame step: its 12 squeezes at N = 10 slices. The twin
        # is torch.cat + the library's 1x1 conv, so it is the library call.
        "name": "concat_conv1x1", "route": "cuda",
        "source": "vsr_tpu_torch/csrc/fused_squeeze.cu",
        "replaces": "vsr_tpu/ops/fused_squeeze.py:81",
        "launches": launches("drf"),
        "max_abs_err": k1["f32_max_abs_err"],
        "ms": per_step["f32_ms"], "plain_ms": per_step["f32_plain_ms"],
        "bound_ms": per_step["f32_bound_ms"],
        "bound_by": per_step["f32_bound_by"],
        "library_ms": per_step["f32_plain_ms"],
        "bf16_max_abs_err": k1["bf16_max_abs_err"],
        "bf16_ms": per_step["bf16_ms"],
        "bf16_plain_ms": per_step["bf16_plain_ms"],
        "bf16_bound_ms": per_step["bf16_bound_ms"],
        "bf16_bound_by": per_step["bf16_bound_by"],
        # The same squeezes with the PReLU that follows each in the kernel's
        # epilogue, against torch.cat + the library's conv + prelu.
        "prelu_ms": per_step["f32_act_ms"],
        "prelu_library_ms": per_step["f32_act_library_ms"],
        "bf16_prelu_ms": per_step["bf16_act_ms"],
        "bf16_prelu_library_ms": per_step["bf16_act_library_ms"],
    }, {
        # One --chunk 100 call: x (100, 96, 96), 5x5 filters, x2.
        "name": "duf_dynamic_filter", "route": "cuda",
        "source": "vsr_tpu_torch/csrc/duf_filter.cu",
        "replaces": "vsr_tpu/ops/pallas_duf.py:72",
        "launches": launches("duf"),
        "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"], "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
        "library_ms": None,
    }, {
        # One MoE layer of a full volume: 43 200 rows of 256 affinities.
        "name": "pairwise_rank", "route": "cuda",
        "source": "vsr_tpu_torch/csrc/pairwise_rank.cu",
        "replaces": "vsr_tpu/ops/rank.py:68",
        "launches": launches("moe"),
        "max_abs_err": k3["max_abs_err"],
        "ms": k3["ms"], "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
        "library_ms": k3["library_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
