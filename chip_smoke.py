#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port's serving path on one CUDA card.

Drives ``vsr_tpu_torch`` (never JAX, never ``vsr_tpu``) through whole-sequence
DRFNet x2 serving at the config's full width (F=64, G=6,
``configs/test/acdc_vsr_drf_x2.yaml``) with random seeded weights, in phases;
any failure exits non-zero and prints no result:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles ``vsr_tpu_torch/csrc/*.cu`` with nvcc, prints the time;
3. kernel vs twin: the fused concat + 1x1 squeeze kernel against its plain
   PyTorch twin at every squeeze shape of a DRFNet frame step (k = 2..6
   inputs of 64 channels, N = 10 slices, LR 96^2 and HR 192^2), f32 and bf16,
   with max error and median CUDA-event times;
4. pipeline: three seeded synthetic NIfTI volumes (H = W = 192, D = 10,
   T = 30, bench.py's geometry) served by the port's infer CLI in f32
   (``--video --fused-tail --psnr``) with ``fused_squeeze`` on and off, and
   through the same pipeline without file I/O in bf16: the fused runs must
   launch the kernel 12 * T * volumes times, the f32 fused and unfused
   outputs must agree, and a small volume served on the card must agree
   with the same net served on the CPU;
5. prints the kernels' JSON line, then the final JSON line.

Usage: python3 chip_smoke.py [--out details.json]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

F_, G_, FACTOR = 64, 6, 2
N_SLICES, T_FRAMES, HR = 10, 30, 192
VOLUMES = 3
LR = HR // FACTOR
# Squeezes of one DRFNet frame step through the kernel: {(k inputs, side): count}.
# LR: the input squeeze (k=2), the LR ladder (k=2..6), the output fuse (k=6);
# HR: the HR ladder (k=2..6).
STEP_SQUEEZES = {(2, LR): 2, (3, LR): 1, (4, LR): 1, (5, LR): 1, (6, LR): 2,
                 (2, HR): 1, (3, HR): 1, (4, HR): 1, (5, HR): 1, (6, HR): 1}
F32_TOL = dict(atol=1e-4, rtol=1e-4)
# bf16 kernel vs the f32 twin on the same bf16-rounded operands: one bf16
# rounding of the output (rtol), plus f32 summation-order noise near 0 (atol).
BF16_TOL = dict(atol=1e-4, rtol=8e-3)
NET_KWARGS = dict(in_channels=1, out_channels=1, num_features=F_,
                  num_groups=G_, upscale_factor=FACTOR)


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def within(got: torch.Tensor, ref: torch.Tensor, atol: float,
           rtol: float) -> bool:
    return bool(((got - ref).abs() <= atol + rtol * ref.abs()).all())


def phase_kernel(dev) -> dict:
    from vsr_tpu_torch.ops.fused_squeeze import (concat_conv1x1,
                                                 concat_conv1x1_reference)

    gen = torch.Generator().manual_seed(1)
    rows = []
    for (k, side) in sorted(STEP_SQUEEZES):
        xs32 = [torch.randn(N_SLICES, F_, side, side, generator=gen).to(dev)
                for _ in range(k)]
        bound = (k * F_) ** -0.5
        w32 = ((torch.rand(F_, k * F_, generator=gen) * 2 - 1) * bound).to(dev)
        b32 = ((torch.rand(F_, generator=gen) * 2 - 1) * bound).to(dev)
        xs16 = [x.bfloat16() for x in xs32]
        w16, b16 = w32.bfloat16(), b32.bfloat16()
        with torch.inference_mode():
            got32 = concat_conv1x1(xs32, w32, b32)
            ref32 = concat_conv1x1_reference(xs32, w32, b32)
            got16 = concat_conv1x1(xs16, w16, b16).float()
            ref16 = concat_conv1x1_reference(
                [x.float() for x in xs16], w16.float(), b16.float())
            torch.cuda.synchronize()
            row = {
                "k": k, "side": side, "count_per_step": STEP_SQUEEZES[k, side],
                "f32_max_abs_err": (got32 - ref32).abs().max().item(),
                "f32_ok": within(got32, ref32, **F32_TOL),
                "bf16_max_abs_err": (got16 - ref16).abs().max().item(),
                "bf16_ok": within(got16, ref16, **BF16_TOL),
                "f32_ms": median_ms(lambda: concat_conv1x1(xs32, w32, b32)),
                "f32_plain_ms": median_ms(
                    lambda: concat_conv1x1_reference(xs32, w32, b32)),
                "bf16_ms": median_ms(lambda: concat_conv1x1(xs16, w16, b16)),
                "bf16_plain_ms": median_ms(
                    lambda: concat_conv1x1_reference(xs16, w16, b16)),
            }
        rows.append(row)
        log(f"  k={k} {side}x{side} N={N_SLICES}: f32 err "
            f"{row['f32_max_abs_err']:.3g} ({'ok' if row['f32_ok'] else 'FAIL'})"
            f" kernel {row['f32_ms']:.4f} ms twin {row['f32_plain_ms']:.4f} ms"
            f" | bf16 err {row['bf16_max_abs_err']:.3g} "
            f"({'ok' if row['bf16_ok'] else 'FAIL'}) kernel "
            f"{row['bf16_ms']:.4f} ms twin {row['bf16_plain_ms']:.4f} ms")
    bad = [(r["k"], r["side"]) for r in rows if not (r["f32_ok"] and r["bf16_ok"])]
    if bad:
        raise SystemExit(f"kernel disagrees with its twin at {bad}")

    def per_step(key):
        return sum(r[key] * r["count_per_step"] for r in rows)

    summary = {key: per_step(key) for key in
               ("f32_ms", "f32_plain_ms", "bf16_ms", "bf16_plain_ms")}
    log(f"  one frame step's 12 squeezes (N={N_SLICES}): f32 kernel "
        f"{summary['f32_ms']:.4f} ms vs twin {summary['f32_plain_ms']:.4f} ms;"
        f" bf16 kernel {summary['bf16_ms']:.4f} ms vs twin "
        f"{summary['bf16_plain_ms']:.4f} ms")
    return {"rows": rows, "per_step": summary,
            "f32_max_abs_err": max(r["f32_max_abs_err"] for r in rows),
            "bf16_max_abs_err": max(r["bf16_max_abs_err"] for r in rows)}


def make_volume(seed: int) -> np.ndarray:
    """(H, W, D, T) float32 volume of integer noise in [0, 255] (bench.py's
    synthetic data)."""
    rng = np.random.default_rng(seed)
    return np.round(rng.random((HR, HR, N_SLICES, T_FRAMES)) * 255).astype(
        np.float32)


def as_frames(vol: np.ndarray) -> np.ndarray:
    """(H, W, D, T) -> (D*T, H, W), as the infer CLI regroups a volume (no
    crop at 192: a multiple of 12; float input skips the outlier clip)."""
    return np.ascontiguousarray(
        np.moveaxis(vol.reshape(HR, HR, N_SLICES * T_FRAMES), -1, 0))


def agreement(a: np.ndarray, b: np.ndarray) -> tuple[float, float]:
    diff = np.abs(a.astype(np.float64) - b.astype(np.float64))
    return float((diff == 0).mean()), float(diff.max())


def check_sr(name: str, sr: np.ndarray, shape: tuple) -> None:
    if sr.shape != shape or not (np.isfinite(sr).all() and sr.min() >= 0
                                 and sr.max() <= 255):
        raise SystemExit(f"{name}: bad SR output, shape {sr.shape}")


def check_launches(name: str, launches: int, fused: bool) -> None:
    want = 12 * T_FRAMES * VOLUMES if fused else 0
    if launches != want:
        raise SystemExit(f"{name}: {launches} kernel launches, expected {want}")


def serve(src: Path, out: Path, fused: bool) -> dict:
    """The port's infer CLI (f32), as a user runs it."""
    from vsr_tpu_torch import infer

    return infer.main([
        str(src), str(out), "--video", "--fused-tail", "--psnr",
        "--net", "DRFNet",
        "--net-kwargs", json.dumps(dict(NET_KWARGS, fused_squeeze=fused))])


def run_pipeline(frames: list[np.ndarray], fused: bool, bf16: bool,
                 dev) -> tuple[list[np.ndarray], float]:
    """The CLI's pipeline without its NIfTI I/O: the same seeded net, the
    same host-to-device copy, pipeline and device-to-host copy per volume.
    Returns the SR frames and frames/s."""
    from vsr_tpu_torch.infer import make_pipeline
    from vsr_tpu_torch.models import DRFNet

    net = DRFNet(**NET_KWARGS, fused_squeeze=fused, fused_tail=True,
                 dtype=torch.bfloat16 if bf16 else None, device=dev,
                 generator=torch.Generator().manual_seed(0))
    pipe = make_pipeline(net, FACTOR, "acdc", video_t=T_FRAMES)
    start = time.perf_counter()
    outs = [pipe(torch.from_numpy(f).to(dev))[1].cpu().numpy() for f in frames]
    return outs, sum(len(f) for f in frames) / (time.perf_counter() - start)


def phase_pipeline(tmp: Path, card: str, dev) -> dict:
    """f32 through the infer CLI (3 NIfTI volumes in, .nii.gz out); bf16
    through the same pipeline without file I/O (the CLI's level-9 gzip
    write takes about a minute per volume of this data)."""
    from vsr_tpu_torch.io.nifti import load_nifti, save_nifti
    from vsr_tpu_torch.ops.fused_squeeze import concat_conv1x1

    vols = [make_volume(10 + i) for i in range(VOLUMES)]
    src = tmp / "volumes"
    for i, vol in enumerate(vols):
        save_nifti(vol, src / f"patient{i:03d}" / f"patient{i:03d}_4d.nii")
    frames = [as_frames(v) for v in vols]
    warm = [as_frames(make_volume(99))]
    for bf16 in (False, True):  # cuDNN/cuBLAS handles, kernel library
        for fused in (True, False):
            run_pipeline(warm, fused, bf16, dev)

    runs, srs = {}, {}
    for fused in (True, False):
        name = f"f32_{'fused' if fused else 'unfused'}"
        concat_conv1x1.launches = 0
        stats = serve(src, tmp / name, fused)
        stats["launches"] = concat_conv1x1.launches
        check_launches(name, stats["launches"], fused)
        if not np.isfinite(stats["psnr_mean"]):
            raise SystemExit(f"{name}: non-finite PSNR")
        srs[name] = [load_nifti(tmp / name / f"patient{i:03d}"
                                / f"patient{i:03d}_4d_sr.nii.gz")
                     for i in range(VOLUMES)]
        runs[name] = stats
        log(f"  {name} (infer CLI): {stats['frames']} frames, end to end "
            f"{stats['frames_per_sec']:.2f} frames/s, pipeline "
            f"{stats['pipeline_frames_per_sec']:.2f} frames/s, PSNR "
            f"{stats['psnr_mean']:.3f} dB, kernel launches "
            f"{stats['launches']} [{card}]")
    for fused in (True, False):
        name = f"bf16_{'fused' if fused else 'unfused'}"
        concat_conv1x1.launches = 0
        srs[name], fps = run_pipeline(frames, fused, True, dev)
        runs[name] = {"frames": sum(len(f) for f in frames),
                      "pipeline_frames_per_sec": fps,
                      "launches": concat_conv1x1.launches}
        check_launches(name, runs[name]["launches"], fused)
        log(f"  {name} (pipeline, no file I/O): pipeline {fps:.2f} frames/s, "
            f"kernel launches {runs[name]['launches']} [{card}]")

    checks = {}
    for mode, shape in (("f32", (HR, HR, N_SLICES, T_FRAMES)),
                        ("bf16", (N_SLICES * T_FRAMES, HR, HR))):
        pairs = list(zip(srs[f"{mode}_fused"], srs[f"{mode}_unfused"]))
        for a, b in pairs:
            check_sr(mode, a, shape)
            check_sr(mode, b, shape)
        stats = [agreement(a, b) for a, b in pairs]
        checks[mode] = {"exact_fraction": min(e for e, _ in stats),
                        "max_grey_diff": max(m for _, m in stats)}
        log(f"  {mode} fused vs unfused SR: "
            f"{checks[mode]['exact_fraction'] * 100:.4f}% exact, max "
            f"{checks[mode]['max_grey_diff']:g} grey")
    if checks["f32"]["exact_fraction"] < 0.999 or checks["f32"]["max_grey_diff"] > 1:
        raise SystemExit("f32 fused and unfused SR outputs disagree")
    return {"runs": runs, "fused_vs_unfused": checks}


def phase_cpu_reference(dev) -> dict:
    """A small volume through the same seeded net on the card (kernel) and
    on the CPU (plain twin)."""
    from vsr_tpu_torch.infer import make_pipeline
    from vsr_tpu_torch.models import DRFNet

    rng = np.random.default_rng(7)
    frames = np.round(rng.random((3, 48, 48)) * 255).astype(np.float32)
    outs = {}
    for device in ("cpu", dev):
        net = DRFNet(**NET_KWARGS, fused_squeeze=True, fused_tail=True,
                     device=device, generator=torch.Generator().manual_seed(0))
        lr, sr = make_pipeline(net, FACTOR, "acdc", video_t=3)(
            torch.from_numpy(frames).to(device))
        outs[str(device)] = (lr.cpu().numpy(), sr.cpu().numpy())
    (lr_c, sr_c), (lr_g, sr_g) = outs["cpu"], outs[str(dev)]
    res = {"lr": agreement(lr_g, lr_c), "sr": agreement(sr_g, sr_c)}
    log(f"  card vs CPU, 48^2 D=1 T=3: LR {res['lr'][0] * 100:.3f}% exact "
        f"(max {res['lr'][1]:g}), SR {res['sr'][0] * 100:.3f}% exact "
        f"(max {res['sr'][1]:g})")
    for key, (exact, worst) in res.items():
        if exact < 0.999 or worst > 1:
            raise SystemExit(f"card and CPU {key} outputs disagree")
    return res


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="",
                        help="also write the full results as JSON here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from vsr_tpu_torch import _build

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    log("phase 1: device")
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
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
    kernel = phase_kernel(dev)

    log("phase 4: pipeline")
    with tempfile.TemporaryDirectory() as tmp:
        pipeline = phase_pipeline(Path(tmp), card, dev)
    cpu_ref = phase_cpu_reference(dev)

    results = {"card": smi, "build_seconds": build_s, "kernel": kernel,
               "pipeline": pipeline, "card_vs_cpu": cpu_ref}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))
    per_step = kernel["per_step"]
    print(json.dumps({"kernels": [{
        "name": "concat_conv1x1",
        "route": "cuda",
        "source": "vsr_tpu_torch/csrc/fused_squeeze.cu",
        "replaces": "vsr_tpu/ops/fused_squeeze.py:51",
        "launches": pipeline["runs"]["f32_fused"]["launches"],
        "max_abs_err": kernel["f32_max_abs_err"],
        "ms": per_step["f32_ms"],
        "plain_ms": per_step["f32_plain_ms"],
        "bf16_max_abs_err": kernel["bf16_max_abs_err"],
        "bf16_ms": per_step["bf16_ms"],
        "bf16_plain_ms": per_step["bf16_plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
