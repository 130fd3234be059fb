"""Serving and training autotuner: measure the knobs on YOUR card (port of
``vsr_tpu/tune.py``).

The shipped presets (``vsr_tpu_torch/presets.py``) are one card's
measurements; another card, power limit, geometry or net config can have
other optima. The serving sweep times the exact-math serving knobs — the
``--chunk`` size, the fused sub-pixel tail and the MoE dispatch — through
``infer.make_pipeline`` on two seeded volumes of the serving geometry, kept
on the device; each row is one warm-up call, then the best of ``--repeats``
sweeps over both volumes, each sweep closed by one
``torch.cuda.synchronize()`` (nothing is read back inside it). It writes a
``--preset-file`` JSON that the serving CLIs take:

  python -m vsr_tpu_torch.tune --net DUFNet --net-kwargs '{...}' \\
      --shape 300,192,192 --windows 7 --seq-t 30 --out tuned.json
  python -m vsr_tpu_torch.infer IN OUT --net DUFNet ... \\
      --preset-file tuned.json

Only exact knobs are swept (outputs identical across the sweep up to float
reassociation); quantization (int8 / W8A8) changes numerics and stays an
explicit user decision. ``--train`` sweeps the training knobs instead
(:func:`run_train`). It runs on the card unless ``--device cpu`` is given;
the file records the backend (``cuda`` / ``cpu``) and, on a card, its name
and power limit.
"""

from __future__ import annotations

import argparse
import inspect
import json
import logging
import subprocess
import time
from typing import Any

import numpy as np
import torch


def _parse_grid(spec: str) -> list[int]:
    vals = sorted({int(s) for s in spec.split(",") if s.strip() != ""})
    if any(v < 0 for v in vals):
        raise SystemExit("--chunk-grid values must be >= 0 (0 = disabled)")
    return vals


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _card_fault(exc: Exception, device: torch.device) -> bool:
    """Whether a failed row is a fault of the card itself, which the sweep
    re-raises: a failed launch, a sticky CUDA error or an invalidated graph
    capture says nothing of the knobs, and a sweep that went on past it
    would pick a winner from the rows left. A refused knob (``ValueError``,
    ``NotImplementedError``) and a row that does not fit in memory stay
    error rows, as in JAX's sweep."""
    return (device.type == "cuda" and isinstance(exc, RuntimeError)
            and not isinstance(exc, (NotImplementedError,
                                     torch.cuda.OutOfMemoryError)))


def _time_pipeline(pipeline, bufs, repeats: int) -> float:
    """Seconds per sweep over all buffers (min of ``repeats``): one warm-up
    call, then each sweep queues every buffer and waits for the device
    once."""
    device = bufs[0].device
    pipeline(bufs[0])  # warm-up (and a lazy pipeline's first call)
    _sync(device)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for b in bufs:
            pipeline(b)
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def card_info(device: torch.device) -> str | None:
    """``nvidia-smi``'s name and power limit of the card (``None`` off a
    card, or where ``nvidia-smi`` does not answer)."""
    if device.type != "cuda":
        return None
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    try:
        return subprocess.run(
            ["nvidia-smi", f"--id={index}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
            check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(device)


def _constructor(net: str) -> dict:
    from vsr_tpu_torch.registry import get_class

    return inspect.signature(get_class("net", net)).parameters


def _stamp(out: dict, device: torch.device) -> dict:
    out["backend"] = device.type
    card = card_info(device)
    if card is not None:
        out["card"] = card
    out["created"] = time.strftime("%Y-%m-%d %H:%M:%S")
    return out


def run(args) -> dict:
    """The serving sweep: ``chunk`` x ``fused_tail`` x ``dispatch_impl``
    (each where the net and mode have it); a knob combination the net
    refuses at build is recorded as an error row at every chunk point."""
    from vsr_tpu_torch.infer import (build_serving_net, make_pipeline,
                                     resolve_volume)
    from vsr_tpu_torch.presets import SERVING_PRESETS

    device = torch.device(args.device)
    shape = tuple(int(s) for s in args.shape.split(","))
    if len(shape) != 3:
        raise SystemExit(f"--shape must be N,H,W, got {args.shape!r}")
    n, h, w = shape
    net_kwargs = json.loads(args.net_kwargs) if args.net_kwargs else {}
    if args.bf16:
        net_kwargs["dtype"] = "bfloat16"
    # Seed the un-swept shipped-preset net kwargs (hoist_tail, ...) so the
    # sweep measures the program that will be served; swept knobs and
    # explicit --net-kwargs still win.
    swept = {"fused_tail", "dispatch_impl"}
    for k, v in SERVING_PRESETS.get(args.net, {}).get(
            "net_kwargs", {}).items():
        if k not in net_kwargs and k not in swept:
            net_kwargs[k] = v
            logging.info(f"tune: seeding shipped preset net kwarg {k}={v} "
                         "(un-swept; override via --net-kwargs)")
    if args.windows and args.video_t:
        raise SystemExit("--windows and --video-t are mutually exclusive")
    if args.windows and not args.seq_t:
        raise SystemExit("--windows needs --seq-t (frames per slice)")
    volume = resolve_volume(args.net, video=bool(args.video_t),
                            windows=args.windows,
                            seq_t=int(args.seq_t or 0), chunk=0,
                            n_frames=n, exc=SystemExit)
    if args.video_t and n % args.video_t:
        raise SystemExit(f"frames dim {n} not a multiple of --video-t")
    if args.windows and n % args.seq_t:
        raise SystemExit(f"frames dim {n} is not a multiple of --seq-t "
                         f"{args.seq_t} (windows regroup N = D*T)")
    window = ((args.windows, args.seq_t, args.window_order)
              if args.windows else None)

    # Knob space: chunk applies to frame / window modes and 3D volume mode;
    # the fused tail and the MoE dispatch to the nets whose constructors
    # take them. A refused (router, dispatch) pair is recorded, not pruned:
    # its legality lives in models/moe.py only.
    chunk_grid = _parse_grid(args.chunk_grid)
    if args.video_t or (volume and volume[0] == "4d"):
        chunk_grid = [0]  # those modes have no chunk knob
    params = _constructor(args.net)
    tail_grid = ([False, True] if "fused_tail" in params
                 and "fused_tail" not in net_kwargs else [None])
    dispatch_grid = (["sparse", "dense"] if "dispatch_impl" in params
                     and "dispatch_impl" not in net_kwargs
                     and net_kwargs.get("router_impl") != "sort"
                     else [None])

    rng = np.random.default_rng(0)
    bufs = [torch.from_numpy(np.round(rng.random((n, h, w)) * 255).astype(
        np.float32)).to(device) for _ in range(2)]
    _sync(device)

    rows: list[dict[str, Any]] = []
    best = None
    for tail in tail_grid:
        for dispatch in dispatch_grid:
            kw = dict(net_kwargs)
            label = {k: v for k, v in (("fused_tail", tail),
                                       ("dispatch_impl", dispatch))
                     if v is not None}
            kw.update(label)
            try:
                net = build_serving_net(args.net, kw, args.checkpoint,
                                        device=device)
            except (ValueError, NotImplementedError) as exc:
                # A refused knob combination must not abort the sweep;
                # anything else (a bad checkpoint path, out of memory)
                # stays fatal.
                err = f"{type(exc).__name__}: {str(exc)[:160]}"
                logging.warning(f"{label} REFUSED to build: {err}")
                rows.extend({"chunk": chunk, **label, "error": err}
                            for chunk in chunk_grid)
                continue
            for chunk in chunk_grid:
                row_label = {"chunk": chunk, **label}
                try:
                    pipe = make_pipeline(
                        net, args.factor, args.dataset,
                        video_t=args.video_t or 0, window=window,
                        volume=volume, chunk=chunk)
                    dt = _time_pipeline(pipe, bufs, args.repeats)
                    vps = len(bufs) / dt
                    row = {**row_label, "volumes_per_sec": round(vps, 3)}
                    logging.info(f"{row_label} -> {vps:.3f} vol/s")
                except Exception as exc:
                    if _card_fault(exc, device):
                        raise
                    row = {**row_label, "error": f"{type(exc).__name__}: "
                                                 f"{str(exc)[:160]}"}
                    logging.warning(f"{row_label} FAILED: {row['error']}")
                    rows.append(row)
                    continue
                rows.append(row)
                if best is None or vps > best[0]:
                    best = (vps, row_label)
            del net

    if best is None:
        raise SystemExit("every knob combination failed — see the log")
    vps, knobs = best
    # EXPLICIT values for every swept knob (chunk 0 / fused_tail False
    # included): the --preset-file loader merges the entry over the
    # shipped one, so an omitted knob would silently resurrect the shipped
    # value this sweep just measured against.
    entry: dict[str, Any] = {"chunk": knobs["chunk"]}
    swept_kwargs = {k: knobs[k] for k in ("fused_tail", "dispatch_impl")
                    if k in knobs}
    if swept_kwargs:
        entry["net_kwargs"] = swept_kwargs
    if args.video_t:
        entry["video"] = True
    if args.windows:
        entry["windows"] = args.windows
    out = _stamp({
        "presets": {args.net: entry},
        "measured": rows,
        "best_volumes_per_sec": round(vps, 3),
        "geometry": list(shape),
        "factor": args.factor,
    }, device)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    logging.info(
        f"best {knobs} at {vps:.3f} vol/s -> {args.out} (use it with "
        f"--preset-file {args.out} on vsr_tpu_torch.infer/serve/export)")
    return out


def _train_buffers(net: str, shape: tuple, factor: int
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Seeded HR noise of ``--train-shape`` and its pixel-strided LR, in
    the port's channel-first buffer layout: ``(M, C, H, W)`` for frame
    nets, ``(M, T, C, H, W)`` for sequence nets, ``(M, C, D, H, W)`` for
    ``Volume3DSRNet`` and ``(M, T, C, D, H, W)`` for 4D nets."""
    rng = np.random.default_rng(0)
    hr = np.round(rng.random(shape) * 255).astype(np.float32)
    axis = 1 if len(shape) == 3 or net == "Volume3DSRNet" else 2
    hr = np.expand_dims(hr, axis)
    lr = hr[..., ::factor, ::factor]
    return np.ascontiguousarray(lr), hr


def run_train(args) -> dict:
    """``--train`` mode: sweep the training knobs on the device-epoch
    trainer (``runner/device_trainer.DeviceEpochTrainer``, a captured CUDA
    graph a step on the card): the compute ``dtype`` (float32 / bfloat16 /
    bfloat16 + ``carry_f32`` where the net has it), ``grad_accumulation``
    and the MoE ``dispatch_impl``. ``scan_unroll`` is always 1: the port's
    frame loops are Python loops. Timing: whole epochs (one read-back an
    epoch), the best of ``--repeats`` after one warm-up epoch.

    dtype / carry_f32 CHANGE NUMERICS: every row carries ``"exact"`` and the
    result reports both ``best`` (overall) and ``best_exact`` (float32
    math only).
    """
    from vsr_tpu_torch.losses import L1Loss
    from vsr_tpu_torch.registry import build
    from vsr_tpu_torch.runner.device_trainer import DeviceEpochTrainer

    device = torch.device(args.device)
    shape = tuple(int(s) for s in args.train_shape.split(","))
    if len(shape) not in (3, 4, 5):
        raise SystemExit(
            f"--train-shape must be M,H,W (frame nets), M,T,H,W "
            f"(sequence/3D-volume nets) or M,T,D,H,W (4D nets), got "
            f"{args.train_shape!r}")
    net_kwargs = json.loads(args.net_kwargs) if args.net_kwargs else {}
    if "dtype" in net_kwargs:
        raise SystemExit(
            "--train sweeps the compute dtype itself — drop 'dtype' from "
            "--net-kwargs (the sweep covers float32 / bfloat16 / "
            "bfloat16+carry_f32)")
    lrbuf, hrbuf = _train_buffers(args.net, shape, args.factor)

    params = _constructor(args.net)
    dtype_grid: list[tuple[str, str | None, bool]] = [
        ("float32", None, False), ("bfloat16", "bfloat16", False)]
    if "carry_f32" in params:
        dtype_grid.append(("bfloat16+carry_f32", "bfloat16", True))
    ga_grid = sorted({int(s) for s in args.ga_grid.split(",") if s.strip()})
    dispatch_grid = (["sparse", "dense"] if "dispatch_impl" in params
                     and "dispatch_impl" not in net_kwargs
                     and net_kwargs.get("router_impl") != "sort"
                     else [None])

    rows: list[dict[str, Any]] = []
    best = best_exact = None
    for dname, dtype, carry in dtype_grid:
        for ga in ga_grid:
            for dispatch in dispatch_grid:
                kw = dict(net_kwargs)
                if dtype is not None:
                    kw["dtype"] = dtype
                if carry:
                    kw["carry_f32"] = True
                if dispatch is not None:
                    kw["dispatch_impl"] = dispatch
                label = {"scan_unroll": 1, "dtype": dname,
                         "grad_accumulation": ga,
                         **({"dispatch_impl": dispatch} if dispatch else {})}
                exact = dtype is None
                try:
                    net = build("net", {"name": args.net, "kwargs": kw},
                                device=device,
                                generator=torch.Generator().manual_seed(0))
                    trainer = DeviceEpochTrainer(
                        net=net, loss_fns=[L1Loss()], loss_weights=[1.0],
                        metric_fns=[],
                        optimizer=torch.optim.Adam(net.parameters(),
                                                   lr=1e-4),
                        lr_data=lrbuf, hr_data=hrbuf,
                        batch_size=args.batch, patch=args.patch,
                        ratio=args.factor, steps_per_epoch=args.steps,
                        scan_unroll=1, device=device, grad_accumulation=ga)
                    t0 = time.perf_counter()
                    trainer.train_epoch()  # warm-up (and graph capture)
                    compile_s = time.perf_counter() - t0
                    rate = 0.0
                    for _ in range(args.repeats):
                        t0 = time.perf_counter()
                        trainer.train_epoch()  # ends with its read-back
                        rate = max(rate,
                                   args.steps / (time.perf_counter() - t0))
                    row = {**label, "steps_per_sec": round(rate, 2),
                           "exact": exact, "compile_s": round(compile_s, 1)}
                    logging.info(f"{label} -> {rate:.1f} steps/s")
                except Exception as exc:
                    if _card_fault(exc, device):
                        raise
                    row = {**label, "exact": exact,
                           "error": f"{type(exc).__name__}: "
                                    f"{str(exc)[:160]}"}
                    logging.warning(f"{label} FAILED: {row['error']}")
                    rows.append(row)
                    continue
                rows.append(row)
                if best is None or rate > best[0]:
                    best = (rate, label)
                if exact and (best_exact is None or rate > best_exact[0]):
                    best_exact = (rate, label)

    if best is None:
        raise SystemExit("every training knob combination failed — see log")

    def entry(knobs: dict) -> dict:
        e: dict[str, Any] = {"scan_unroll": knobs["scan_unroll"]}
        if knobs["grad_accumulation"] > 1:
            e["grad_accumulation"] = knobs["grad_accumulation"]
        nk: dict[str, Any] = {}
        if knobs["dtype"] != "float32":
            nk["dtype"] = "bfloat16"
        if "carry_f32" in knobs["dtype"]:
            nk["carry_f32"] = True
        if knobs.get("dispatch_impl"):
            nk["dispatch_impl"] = knobs["dispatch_impl"]
        if nk:
            e["net_kwargs"] = nk
        return e

    out = _stamp({
        "train_presets": {args.net: entry(best[1])},
        "train_presets_exact": {args.net: entry(best_exact[1])}
        if best_exact else {},
        "measured": rows,
        "best_steps_per_sec": round(best[0], 2),
        "geometry": list(shape),
        "batch": args.batch, "patch": args.patch, "factor": args.factor,
    }, device)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    logging.info(
        f"best {best[1]} at {best[0]:.1f} steps/s"
        + (f" (best exact-math: {best_exact[1]} at {best_exact[0]:.1f})"
           if best_exact else "")
        + f" -> {args.out} (merge train_presets[*] into "
        "trainer.kwargs / net.kwargs of your *_device.yaml)")
    return out


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Sweep exact serving knobs on this machine's card and "
                    "write a --preset-file JSON")
    p.add_argument("--net", required=True)
    p.add_argument("--net-kwargs", default="")
    p.add_argument("--checkpoint", default="")
    p.add_argument("--shape", default="",
                   help="HR frames geometry N,H,W to tune for "
                        "(serving mode; required unless --train)")
    p.add_argument("--factor", type=int, default=2)
    p.add_argument("--dataset", choices=["acdc", "dsb15"], default="acdc")
    p.add_argument("--video-t", dest="video_t", type=int, default=0)
    p.add_argument("--windows", type=int, default=0)
    p.add_argument("--seq-t", dest="seq_t", type=int, default=0)
    p.add_argument("--window-order", dest="window_order",
                   choices=["middle", "last"], default="middle")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--chunk-grid", dest="chunk_grid", default="0,30,60,100")
    p.add_argument("--repeats", type=int, default=2)
    p.add_argument("--out", default="tuned.json")
    p.add_argument("--device", default="cuda",
                   help="torch device to tune on (cuda, cuda:1, cpu)")
    p.add_argument("--train", action="store_true",
                   help="sweep TRAINING knobs (dtype + carry_f32 / "
                        "grad_accumulation / MoE dispatch) on the "
                        "device-epoch trainer instead of serving knobs. The "
                        "sweep's LR buffer is pixel-strided synthetic noise "
                        "(NOT the k-space degrade real training uses): "
                        "steps/s rankings are the product; ignore any loss "
                        "values printed during the sweep")
    p.add_argument("--train-shape", dest="train_shape", default="",
                   help="HR training buffer geometry: M,H,W (frame nets), "
                        "M,T,H,W (sequence / 3D-volume nets) or "
                        "M,T,D,H,W (4D nets)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--patch", type=int, default=32,
                   help="LR patch size sampled from the buffers")
    p.add_argument("--steps", type=int, default=50,
                   help="steps per timed device epoch")
    p.add_argument("--ga-grid", dest="ga_grid", default="1",
                   help="grad_accumulation grid, e.g. 1,2,4")
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    logging.basicConfig(format="%(asctime)s | %(levelname)s | %(message)s",
                        level=logging.INFO, datefmt="%Y-%m-%d %H:%M:%S")
    args = parse_args(argv)
    if args.train:
        if not args.train_shape:
            raise SystemExit("--train needs --train-shape M[,T],H,W")
        return run_train(args)
    if not args.shape:
        raise SystemExit("serving mode needs --shape N,H,W "
                         "(or pass --train)")
    return run(args)


if __name__ == "__main__":
    main()
