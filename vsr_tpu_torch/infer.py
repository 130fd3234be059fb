"""Batch inference CLI: raw volumes -> k-space LR -> SR (port of
``vsr_tpu/infer.py``, whole-sequence video mode).

Walks a directory of raw 4D NIfTI volumes; for each, simulates the k-space
LR input, normalizes it, runs the sequence net over every slice's whole time
series, denormalizes, and writes the SR sequence as NIfTI.

Usage:
  python -m vsr_tpu_torch.infer <input_dir> <output_dir> --video \
      --net DRFNet --net-kwargs '{"in_channels":1,"out_channels":1,
      "num_features":64,"num_groups":6,"upscale_factor":2,
      "fused_squeeze":true}' --fused-tail [--bf16] [--psnr] [--device cuda]

Weights come from a seeded init (generator seed 0); loading a flax
checkpoint is not ported yet.
"""

from __future__ import annotations

import argparse
import csv
import json
import logging
import time
from pathlib import Path

import numpy as np
import torch

from vsr_tpu_torch.io.nifti import load_nifti, save_nifti
from vsr_tpu_torch.preprocess.intensity import (center_crop_multiple,
                                                clip_outliers_minmax)
from vsr_tpu_torch.preprocess.kspace import kspace_downscale_torch
from vsr_tpu_torch.registry import build
from vsr_tpu_torch.utils.normalize import DATASET_STATS

# JAX CLI flags this port does not serve yet: dest -> flag.
_NOT_PORTED = {"checkpoint": "--checkpoint", "int8": "--int8",
               "w8a8": "--w8a8", "mesh": "--mesh", "windows": "--windows",
               "chunk": "--chunk", "preset": "--preset"}


def make_prep(factor: int, dataset: str, video_t: int):
    """HR float frames (N, H, W) -> (lr_frames, z): ``z`` is the net-input
    batch of ``N // video_t`` sequences, (D, T, 1, h, w)."""
    mean, std = DATASET_STATS[dataset]

    def prep(hr_frames: torch.Tensor):
        lr = kspace_downscale_torch(hr_frames, factor)
        z = (lr - mean) / (std + 1e-10)
        n, h, w = z.shape
        return lr, z.reshape(n // video_t, video_t, 1, h, w)

    return prep


def make_pipeline(net: torch.nn.Module, factor: int, dataset: str, *,
                  video_t: int):
    """HR float frames (N, H, W) -> (lr_frames, sr_frames), float32 tensors
    holding uint8 values, on the frames' device. The N frames are D
    slice-sequences of ``video_t`` frames; every SR frame is kept in order.

    Turns TF32 off for cuDNN convs and cuBLAS matmuls (process-wide): the
    k-space chain and the f32 net must run in full float32."""
    if not video_t:
        raise NotImplementedError("only whole-sequence (video_t) serving is "
                                  "ported to vsr_tpu_torch")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mean, std = DATASET_STATS[dataset]
    prep = make_prep(factor, dataset, video_t)
    net.eval()

    @torch.inference_mode()
    def pipeline(hr_frames: torch.Tensor):
        lr, z = prep(hr_frames)
        sr = net(z)  # (D, T, C, H, W)
        sr = sr[:, :, 0].float().reshape(-1, *sr.shape[-2:])
        return lr, torch.clamp(torch.round(sr * std + mean), 0.0, 255.0)

    return pipeline


def run(args) -> dict:
    for dest, flag in _NOT_PORTED.items():
        if getattr(args, dest, None):
            raise SystemExit(f"{flag} is not yet ported to vsr_tpu_torch "
                             "(serve it with python -m vsr_tpu.infer)")
    if not args.video:
        raise SystemExit("vsr_tpu_torch serves whole sequences only: pass "
                         "--video (frame and window modes are not ported)")
    device = torch.device(args.device)
    net_kwargs = json.loads(args.net_kwargs) if args.net_kwargs else {}
    if args.bf16:
        net_kwargs["dtype"] = torch.bfloat16
    if args.fused_tail:
        net_kwargs["fused_tail"] = True
    net = build("net", {"name": args.net, "kwargs": net_kwargs},
                device=device, generator=torch.Generator().manual_seed(0))

    paths = sorted(Path(args.input_dir).glob("**/*.nii*"))
    if not paths:
        raise SystemExit(f"No NIfTI volumes under {args.input_dir}")

    pipelines: dict = {}
    n_frames = 0
    pipeline_seconds = 0.0
    psnr_rows: list[tuple[str, float]] = []
    start = time.perf_counter()
    for path in paths:
        data = clip_outliers_minmax(load_nifti(path))
        if data.ndim == 3:
            data = data[..., None]  # (H, W, D) -> single-frame
        h0, hn, w0, wn = center_crop_multiple(data.shape[:2])
        data = data[h0:hn, w0:wn]  # (H, W, D, T)
        h, w, d, t = data.shape
        frames = np.moveaxis(data.reshape(h, w, d * t), -1, 0)  # (D*T, H, W)

        if t not in pipelines:
            pipelines[t] = make_pipeline(net, args.factor, args.dataset,
                                         video_t=t)
        t0 = time.perf_counter()
        lr, sr = pipelines[t](
            torch.from_numpy(np.ascontiguousarray(frames)).to(device))
        sr_np = sr.cpu().numpy()  # waits for the device
        pipeline_seconds += time.perf_counter() - t0
        n_frames += d * t

        rel = path.relative_to(args.input_dir)
        out_base = Path(args.output_dir) / rel.parent / rel.name.split(".")[0]
        sr_seq = np.moveaxis(sr_np, 0, -1).reshape(h, w, d, t)
        save_nifti(sr_seq.astype(np.float32), Path(str(out_base) + "_sr.nii.gz"))
        if args.psnr:
            # The input is the ground truth: it was degraded by --factor and
            # super-resolved back. Reference convention: max 255, 1e-10 eps.
            diff = sr_np.astype(np.float64) - frames.astype(np.float64)
            mse = np.mean(np.square(diff), axis=(1, 2))  # per frame
            val = float(np.mean(10.0 * np.log10(255.0 ** 2 / (mse + 1e-10))))
            psnr_rows.append((str(rel), val))
            logging.info(f"{path.name}: PSNR {val:.3f} dB")
        logging.info(f"{path.name}: {d * t} frames -> {out_base}_sr.nii.gz")

    elapsed = time.perf_counter() - start
    stats = {"volumes": len(paths), "frames": n_frames,
             "seconds": elapsed, "frames_per_sec": n_frames / elapsed,
             "pipeline_seconds": pipeline_seconds,
             "pipeline_frames_per_sec": n_frames / pipeline_seconds,
             "device": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else device.type)}
    if psnr_rows:
        csv_path = Path(args.output_dir) / "metrics.csv"
        with open(csv_path, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["volume", "PSNR"])
            writer.writerows(psnr_rows)
        stats["psnr_mean"] = sum(v for _, v in psnr_rows) / len(psnr_rows)
        logging.info(f"Mean PSNR {stats['psnr_mean']:.3f} dB -> {csv_path}")
    logging.info(f"Inference done: {stats}")
    return stats


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="SR inference over a volume tree (PyTorch port).")
    parser.add_argument("input_dir", type=Path)
    parser.add_argument("output_dir", type=Path)
    parser.add_argument("--net", default="DRFNet")
    parser.add_argument("--net-kwargs", default="")
    parser.add_argument("--factor", type=int, default=2)
    parser.add_argument("--dataset", choices=["acdc", "dsb15"], default="acdc")
    parser.add_argument("--video", action="store_true",
                        help="sequence (VSR) net: SR every slice's whole "
                             "time series as one sequence")
    parser.add_argument("--bf16", action="store_true",
                        help="serve the net in bfloat16")
    parser.add_argument("--fused-tail", dest="fused_tail", action="store_true",
                        help="fold the final conv through the pixel-shuffle")
    parser.add_argument("--psnr", action="store_true",
                        help="report PSNR of each SR volume vs its input; "
                             "writes <output_dir>/metrics.csv")
    parser.add_argument("--device", default="cuda",
                        help="torch device to serve on (cuda, cuda:1, cpu)")
    parser.add_argument("--checkpoint", default="", help="not yet ported")
    parser.add_argument("--int8", action="store_true", help="not yet ported")
    parser.add_argument("--w8a8", action="store_true", help="not yet ported")
    parser.add_argument("--mesh", default="", help="not yet ported")
    parser.add_argument("--windows", type=int, default=0,
                        help="not yet ported")
    parser.add_argument("--chunk", type=int, default=0, help="not yet ported")
    parser.add_argument("--preset", choices=["tuned", "fast"], default="",
                        help="not yet ported")
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    logging.basicConfig(
        format="%(asctime)s | %(levelname)s | %(message)s",
        level=logging.INFO,
        datefmt="%Y-%m-%d %H:%M:%S",
    )
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
