"""Batch inference CLI: raw volumes -> k-space LR -> SR (port of
``vsr_tpu/infer.py``: frame, whole-sequence video, MISR window and volume
modes).

Walks a directory of raw 4D NIfTI volumes; for each, simulates the k-space
LR input, normalizes it, runs the net, denormalizes, and writes the SR
sequence as NIfTI. The net sees single frames (SISR nets, the default), each
slice's whole time series (``--video``, VSR nets), one circular window of
``--windows`` frames per output frame (MISR nets) or, for the volumetric
nets and without a flag, the study's volumes: each time point one (D, h, w)
sample (``Volume3DSRNet``) or the whole scan one (T, D, h, w) sample
(``Volume4DSRNet``).

Usage:
  python -m vsr_tpu_torch.infer <input_dir> <output_dir> --video \
      --net DRFNet --net-kwargs '{"in_channels":1,"out_channels":1,
      "num_features":64,"num_groups":6,"upscale_factor":2,
      "fused_squeeze":true}' --fused-tail [--bf16] [--psnr] [--device cuda]
  python -m vsr_tpu_torch.infer <input_dir> <output_dir> \
      --net MoEEDSRNet --net-kwargs '{"in_channels":1,"out_channels":1,
      "num_resblocks":16,"num_features":64,"upscale_factor":2,
      "num_experts":4,"group_size":256,"moe_every":2,
      "router_impl":"rank_pallas","dispatch_impl":"dense"}' [--chunk 100]
  python -m vsr_tpu_torch.infer <input_dir> <output_dir> --windows 7 \
      --chunk 100 --net DUFNet --net-kwargs '{"in_channels":1,
      "out_channels":1,"num_frames":7,"size_filter":5,"upscale_factor":2,
      "use_pallas_filter":true}'
  python -m vsr_tpu_torch.infer <input_dir> <output_dir> --fused-tail \
      --net Volume4DSRNet --net-kwargs '{"in_channels":1,"out_channels":1,
      "num_features":32,"num_resblocks":4,"upscale_factor":2}'
  python -m vsr_tpu_torch.infer <input_dir> <output_dir> --net EDSRNet \
      --net-kwargs '{...}' [--int8 | --w8a8 | --w8a8-scales scales.json] \
      [--w8a8-kernels 3,6]

``--ema`` serves the parameter EMA a trainer with ``ema_decay`` kept in the
checkpoint; ``--gif`` also writes one animated GIF per slice.
``--preset tuned|fast`` applies the net's knobs measured on the card
(``presets.py``; explicit flags win), ``--preset-file`` a table of
``python -m vsr_tpu_torch.tune``.
``--int8`` serves the kernels held in int8 (``quantize.py``); ``--w8a8``
serves the wide convs as int8 x int8 -> int32 on the card's tensor cores,
with activation scales calibrated on the first batch, ``--w8a8-scales`` with
precomputed ones (a JSON of ``vsr_tpu`` or of the port), ``--w8a8-kernels``
only the convs of these kernel sizes.

Weights come from ``--checkpoint`` (a checkpoint of the port's own trainer,
``vsr_tpu_torch/utils/checkpoint.py``, or a flax msgpack checkpoint of
``vsr_tpu``) or, without it, from a seeded init (generator seed 0):
:func:`build_serving_net`, which the export CLI, the serving daemon and the
streams share.
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

from vsr_tpu_torch.data.datasets import misr_target_index
from vsr_tpu_torch.io.nifti import load_nifti, save_nifti
from vsr_tpu_torch.preprocess.intensity import (center_crop_multiple,
                                                clip_outliers_minmax)
from vsr_tpu_torch.presets import apply_cli_preset
from vsr_tpu_torch.preprocess.kspace import kspace_downscale_torch
from vsr_tpu_torch.registry import build, get_class
from vsr_tpu_torch.utils.checkpoint import load_net_weights
from vsr_tpu_torch.utils.gif import write_gif
from vsr_tpu_torch.utils.normalize import DATASET_STATS

# JAX CLI flags this port refuses by name: dest -> (flag, why).
_NOT_PORTED = {
    "mesh": ("--mesh", "it serves on one card"),
}
# ... and the ones it will never take: dest -> (flag, why).
_NEVER_PORTED = {
    "bucket_t": ("--bucket-t", "it rounds T up so that variable-T volumes "
                 "share compiled programs, and the port runs eagerly: it "
                 "compiles no program per shape"),
}
# A net class's ``serving_mode`` -> the flag that selects the mode.
_MODE_FLAGS = {"frame": "neither --video nor --windows", "video": "--video",
               "window": "--windows N"}
# The volumetric nets (``serving_mode = "volume"``), served without a mode
# flag: each time point one (D, h, w) sample ("3d") or the whole scan one
# (T, D, h, w) sample ("4d").
VOLUME_NETS = {"Volume3DSRNet": "3d", "Volume4DSRNet": "4d"}


def resolve_volume(net_name: str, *, video: bool = False, windows: int = 0,
                   seq_t: int | None = 0, chunk: int = 0,
                   n_frames: int | None = None,
                   exc=ValueError) -> tuple[str, int | None] | None:
    """``(mode, t)`` for a volumetric net (``None`` otherwise), after
    checking the flags it is served with; raises ``exc`` on misuse.
    ``seq_t=None`` checks the flags alone, before a volume is read."""
    vmode = VOLUME_NETS.get(net_name)
    if not vmode:
        return None
    if video or windows:
        raise exc("--video/--video-t/--windows do not apply to the "
                  "volumetric nets (volume mode is automatic)")
    if seq_t is not None and not seq_t:
        raise exc("volumetric nets need --seq-t (frames per slice, T of "
                  "the N = D*T frame dim)")
    if vmode == "4d" and chunk:
        raise exc("--chunk has no effect on 4D volume serving (the whole "
                  "scan is one sample)")
    if seq_t and n_frames is not None and n_frames % seq_t:
        raise exc(f"frames dim {n_frames} is not a multiple of the "
                  f"per-slice T {seq_t} (volume mode regroups N = D*T)")
    return (vmode, seq_t)


def build_serving_net(net_name: str, net_kwargs: dict, checkpoint: str = "",
                      *, device: torch.device | str = "cuda",
                      ema: bool = False) -> torch.nn.Module:
    """Registry-build a net for serving, in eval mode on ``device``: seeded
    init (generator seed 0) and, with ``checkpoint``, the weights of a
    checkpoint of the port or of ``vsr_tpu`` (``load_net_weights``). The
    block behind the infer CLI, ``export``, the daemon's live pipelines and
    its stream sessions (``vsr_tpu.infer.build_serving_net``).

    The JAX package passes ``train=False`` to the BatchNorm nets
    (``TRAIN_FLAG_NETS``); here every serving net is in eval mode, which
    serves BatchNorm from its running statistics. ``ema``: serve the
    parameter EMA that a trainer with ``ema_decay`` kept in the checkpoint
    (of either kind) in place of the parameters; BatchNorm's statistics
    stay the checkpoint's."""
    if ema and not checkpoint:
        raise ValueError("--ema needs --checkpoint")
    net = build("net", {"name": net_name, "kwargs": dict(net_kwargs)},
                device=device, generator=torch.Generator().manual_seed(0))
    if checkpoint:
        load_net_weights(net, checkpoint, map_location=device, ema=ema)
        logging.info(f'Loaded the {"EMA " if ema else ""}weights of '
                     f'"{checkpoint}".')
    return net.eval()


def net_device(net: torch.nn.Module) -> torch.device:
    """Where the net's tensors live: its parameters, else its buffers (a
    parameter-free net such as ``Bicubic`` holds one on the device it was
    built for). A net that holds neither is refused."""
    for tensor in (*net.parameters(), *net.buffers()):
        return tensor.device
    raise ValueError(f"{type(net).__name__} holds no parameter and no "
                     "buffer: its device is unknown")


def denormalize(sr: torch.Tensor, dataset: str) -> torch.Tensor:
    """Net output ``(N, C, H, W)`` -> float32 ``(N, H, W)`` of channel 0,
    denormalized, rounded and clipped to [0, 255]."""
    mean, std = DATASET_STATS[dataset]
    sr = sr[:, 0].float()
    return torch.clamp(torch.round(sr * std + mean), 0.0, 255.0)


def make_prep(factor: int, dataset: str, video_t: int = 0,
              window: tuple[int, int, str] | None = None,
              volume: tuple[str, int] | None = None):
    """HR float frames (N, H, W) -> (lr_frames, z). ``z`` is the net-input
    batch: the frames ``(N, 1, h, w)``; with ``video_t`` the ``N // video_t``
    sequences ``(D, T, 1, h, w)``; with ``window = (n_frames, seq_t, order)``
    one circular window per frame, ``(N, n_frames, 1, h, w)``; with
    ``volume = ("3d" | "4d", t)`` the N = D*t slice-major frames regrouped
    into t volumes of D slices, ``(T, 1, D, h, w)`` ("3d", each time point
    one sample) or ``(1, T, 1, D, h, w)`` ("4d", the scan one sample)."""
    mean, std = DATASET_STATS[dataset]

    def prep(hr_frames: torch.Tensor):
        lr = kspace_downscale_torch(hr_frames, factor)
        z = ((lr - mean) / (std + 1e-10))[:, None]
        n, _, h, w = z.shape
        if volume:
            vmode, vt = volume
            z = z.reshape(n // vt, vt, 1, h, w).permute(1, 2, 0, 3, 4)
            if vmode == "4d":
                z = z[None]
        elif video_t:
            z = z.reshape(n // video_t, video_t, 1, h, w)
        elif window:
            nf, seq_t, order = window
            seq = z.reshape(n // seq_t, seq_t, 1, h, w)
            # Output frame t sits at the net's target slot of its window:
            # misr_target_index(nf) for "middle", the last slot for "last".
            shift = misr_target_index(nf) if order == "middle" else nf - 1
            idx = (torch.arange(seq_t, device=z.device)[:, None]
                   + torch.arange(nf, device=z.device)[None, :] - shift) % seq_t
            z = seq[:, idx].reshape(n, nf, 1, h, w)
        return lr, z

    return prep


def _check_scales_match(net: torch.nn.Module, scales: dict,
                       w8a8_kernels=None) -> dict:
    """Apply the optional kernel-size filter and refuse a scales dict that
    quantizes no conv of ``net`` (calibrated for another net, stale paths,
    or filtered to nothing): it would serve full precision under the name
    of W8A8. Entries that match no conv are logged and ignored
    (``vsr_tpu.infer._check_scales_match``)."""
    from vsr_tpu_torch.quantize import filter_scales_by_kernel, kernel_shapes

    if w8a8_kernels is not None:
        scales = filter_scales_by_kernel(net, scales, w8a8_kernels)
        if not scales:
            raise ValueError(
                f"w8a8_kernels={sorted(w8a8_kernels)} filtered every "
                "calibrated conv out — no conv of these kernel sizes is "
                "calibrated for this net")
    matched = set(scales) & set(kernel_shapes(net))
    if not matched:
        raise ValueError(
            "W8A8 scales match no conv in this net (calibrated for a "
            "different net/config, or stale paths?) — serving would "
            "silently be full precision. Sample scale paths: "
            f"{sorted(scales)[:3]}")
    if len(matched) < len(scales):
        logging.warning(
            f"W8A8: {len(scales) - len(matched)} of {len(scales)} scale "
            "entries match no conv in this net and are ignored")
    return scales


def _quantized_apply(net: torch.nn.Module, int8: bool, w8a8, w8a8_kernels,
                     quantize_deconvs: bool = False):
    """The net's apply for ``make_pipeline``: the net itself, its int8 twin
    (a net already wrapped by ``make_quantized_apply`` is taken as it is),
    a W8A8 apply, or ``None`` for W8A8 calibrated at the first call."""
    if int8 and w8a8:
        raise ValueError("int8 (weight-only) and w8a8 (int8 tensor-core "
                         "compute) are separate paths; pick one")
    if w8a8_kernels is not None and (not w8a8 or w8a8 == "dynamic"):
        raise ValueError("w8a8_kernels filters static activation scales — "
                         "it needs w8a8=True (lazy calibration) or a "
                         "non-empty precomputed {path: scale} dict, not "
                         f"w8a8={w8a8!r}")
    if isinstance(w8a8, dict) and not w8a8:
        raise ValueError("w8a8={} is an empty scales dict — it would "
                         "silently serve full precision; pass False to "
                         "disable W8A8 explicitly")
    from vsr_tpu_torch import quantize

    if isinstance(w8a8, dict):
        return quantize.make_w8a8_apply(
            net, _check_scales_match(net, w8a8, w8a8_kernels),
            quantize_deconvs=quantize_deconvs)
    if w8a8 == "dynamic":
        return quantize.make_w8a8_apply(net, "dynamic",
                                        quantize_deconvs=quantize_deconvs)
    if w8a8:
        return None
    if int8 and not isinstance(net, quantize.QuantizedApply):
        return quantize.make_quantized_apply(net,
                                             *quantize.quantize_params(net))
    return net


def make_pipeline(net: torch.nn.Module, factor: int, dataset: str, *,
                  video_t: int = 0,
                  window: tuple[int, int, str] | None = None,
                  volume: tuple[str, int] | None = None,
                  chunk: int = 0, int8: bool = False, w8a8=False,
                  w8a8_kernels=None, quantize_deconvs: bool = False):
    """HR float frames (N, H, W) -> (lr_frames, sr_frames), float32 tensors
    holding uint8 values, on the frames' device.

    Frame mode (the default): the net sees ``(N, 1, h, w)``, every frame an
    item of the batch. ``video_t``: the N frames are D slice-sequences of
    ``video_t`` frames, the net sees ``(D, T, 1, h, w)`` and every SR frame
    is kept in order. ``window = (n_frames, seq_t, order)``: for MISR nets,
    every output frame gets one circular window of ``n_frames`` frames of
    its slice's ``seq_t``-frame sequence, gathered on the device;
    ``order='middle'`` centres the window on the output frame, ``'last'``
    ends it there. ``volume = ("3d" | "4d", t)``: for the volumetric nets,
    the frames are regrouped into volumes (``make_prep``) and the SR volumes
    back into slice-major frames.

    ``chunk``: feed the net the frames / windows / 3D volumes ``chunk`` at a
    time (not the video path, already sequence-batched, nor 4D volumes, one
    sample).
    Bounds the live activation memory; the last chunk is padded by
    edge-repeat and sliced back (exact: the items are independent).

    ``int8``: serve the kernels held in int8 (``quantize.QuantizedApply``;
    the net's dense kernels are freed). ``w8a8``: the eligible convs as
    int8 x int8 -> int32 (``quantize.make_w8a8_apply``): ``True`` calibrates
    static activation scales on the first batch served (its first ``chunk``
    items when chunked), a ``{flax module path: scale}`` dict gives them,
    ``"dynamic"`` takes per-call scales. ``w8a8_kernels``: quantize only the
    convs of these spatial kernel sizes (static scales only).
    ``quantize_deconvs``: the eligible transposed convs too
    (``quantize.make_w8a8_apply``). The returned
    pipeline's ``module`` is the module that holds the served state; a lazy
    W8A8 pipeline's ``act_scales`` are the scales it calibrated (after its
    first call).

    Turns TF32 off for cuDNN convs and cuBLAS matmuls (process-wide): the
    k-space chain and the f32 net must run in full float32."""
    if chunk < 0:
        raise ValueError("chunk must be >= 0 (0 = disabled)")
    if chunk and video_t:
        raise ValueError(
            "chunk applies to frame/window serving; the video_t (whole-"
            "sequence) path is already sequence-batched")
    if window and video_t:
        raise ValueError("window (MISR) and video_t (VSR) are mutually "
                         "exclusive")
    if volume and (video_t or window):
        raise ValueError("volume serving excludes video_t/window modes")
    if volume and volume[0] == "4d" and chunk:
        raise ValueError("chunk has no effect on 4D volume serving (the "
                         "whole scan is one sample)")
    if window and window[2] not in ("middle", "last"):
        raise ValueError(f"window order must be 'middle' or 'last', got "
                         f"{window[2]!r}")
    net_apply = _quantized_apply(net, int8, w8a8, w8a8_kernels,
                                 quantize_deconvs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prep = make_prep(factor, dataset, video_t, window, volume)
    net.eval()
    state = {"apply": net_apply}

    def apply(zb: torch.Tensor) -> torch.Tensor:
        """net -> (items, C, H, W), one frame-shaped output per item (a
        volumetric net's output as it comes): a tuple's first element
        (FRVSR's SR frames), a feedback net's last step."""
        out = state["apply"](zb)
        if isinstance(out, tuple):
            out = out[0]
        if volume:
            return out
        if video_t:  # (D, T, C, H, W): flatten the frames back out
            return out.reshape(-1, *out.shape[2:])
        if out.dim() == 5:  # feedback nets stack their steps on axis 0
            out = out[-1]
        return out

    def calibrate(z: torch.Tensor):
        """w8a8=True: static scales from the first batch's net inputs (its
        first chunk when chunked), then the W8A8 apply for every batch. The
        convs of a scan body are not calibrated and serve full precision."""
        from vsr_tpu_torch.quantize import (calibrate_w8a8,
                                            filter_scales_by_kernel,
                                            make_w8a8_apply)

        act_scales = calibrate_w8a8(net, [z[:chunk] if chunk else z],
                                    quantize_deconvs=quantize_deconvs)
        if w8a8_kernels is not None:
            act_scales = filter_scales_by_kernel(net, act_scales,
                                                 w8a8_kernels)
        if not act_scales:
            raise ValueError(
                "lazy W8A8 calibration found no quantizable conv "
                + (f"of kernel sizes {sorted(w8a8_kernels)} "
                   if w8a8_kernels is not None else "")
                + "— the whole net would silently serve full precision. "
                "Eligible = non-recurrent Conv with min(C_in, C_out) >= 16; "
                "thinner nets cannot benefit (drop --w8a8), and scan-body "
                "(recurrent) convs need precomputed scales from "
                "calibrate_w8a8(method='callback') / --w8a8-scales")
        state["apply"] = make_w8a8_apply(net, act_scales,
                                         quantize_deconvs=quantize_deconvs)
        pipeline.act_scales = act_scales

    @torch.inference_mode()
    def pipeline(hr_frames: torch.Tensor):
        lr, z = prep(hr_frames)
        if state["apply"] is None:
            calibrate(z)
        if chunk:
            outs = []
            for start in range(0, len(z), chunk):
                zb = z[start:start + chunk]
                short = chunk - len(zb)
                if short:
                    zb = torch.cat([zb, zb[-1:].expand(short, *zb.shape[1:])])
                outs.append(apply(zb)[:chunk - short])
            sr = torch.cat(outs)
        else:
            sr = apply(z)
        if volume:
            # (T, C, D, H, W) ("4d": with a leading 1) back to slice-major
            # frames (D*T, C, H, W), the inverse of prep's regrouping.
            if volume[0] == "4d":
                sr = sr[0]
            sr = sr.permute(2, 0, 1, 3, 4).reshape(-1, *sr.shape[1:2],
                                                   *sr.shape[3:])
        return lr, denormalize(sr, dataset)

    pipeline.module = net_apply if isinstance(net_apply,
                                              torch.nn.Module) else net
    return pipeline


def load_hr_frames(path: Path) -> tuple[np.ndarray, tuple[int, int, int, int]]:
    """One NIfTI volume -> (frames (d*t, h, w), (h, w, d, t)) with the
    serving preprocessing: outlier clip, center crop to a multiple of 12, a
    3D volume as one frame per slice. The frames are contiguous, of the
    volume's type after the clip."""
    data = clip_outliers_minmax(load_nifti(path))
    if data.ndim == 3:
        data = data[..., None]  # (H, W, D) -> single-frame
    h0, hn, w0, wn = center_crop_multiple(data.shape[:2])
    data = data[h0:hn, w0:wn]  # (H, W, D, T)
    h, w, d, t = data.shape
    frames = np.moveaxis(data.reshape(h, w, d * t), -1, 0)  # (D*T, H, W)
    return np.ascontiguousarray(frames), (h, w, d, t)


def serving_pipelines(args):
    """``run``'s checks of its namespace, its net, and the pipeline each
    volume takes: ``(mode, pipeline_for)``, where ``pipeline_for(t,
    n_frames)`` builds the pipeline of a volume of ``t`` time points and
    ``n_frames`` frames (the net is built once, for every pipeline)."""
    for dest, (flag, why) in _NOT_PORTED.items():
        if getattr(args, dest, None):
            raise SystemExit(f"{flag} is not yet ported to vsr_tpu_torch: "
                             f"{why} (serve it with python -m vsr_tpu.infer)")
    for dest, (flag, why) in _NEVER_PORTED.items():
        if getattr(args, dest, None):
            raise SystemExit(f"{flag} is refused by vsr_tpu_torch: {why}")
    if args.windows and args.video:
        raise SystemExit("--windows (MISR) and --video (VSR) are mutually "
                         "exclusive")
    resolve_volume(args.net, video=args.video, windows=args.windows,
                   seq_t=None, chunk=args.chunk, exc=SystemExit)
    if args.chunk < 0 or args.windows < 0:
        raise SystemExit("--chunk and --windows must be >= 0 (0 = disabled)")
    if args.chunk and args.video:
        raise SystemExit("--chunk applies to frame/window serving; the "
                         "--video path is already sequence-batched")
    if args.checkpoint and not Path(args.checkpoint).is_file():
        raise SystemExit(f"--checkpoint: no such file: {args.checkpoint}")
    w8a8 = args.w8a8
    if args.w8a8_scales:  # precomputed static scales imply --w8a8
        with open(args.w8a8_scales) as f:
            w8a8 = {k: float(v) for k, v in json.load(f).items()}
    w8a8_kernels = None
    if args.w8a8_kernels:
        if not w8a8:
            raise SystemExit("--w8a8-kernels needs --w8a8 or --w8a8-scales")
        w8a8_kernels = {int(s) for s in args.w8a8_kernels.split(",")}
    mode = "video" if args.video else "window" if args.windows else "frame"
    net_mode = getattr(get_class("net", args.net), "serving_mode", mode)
    if net_mode == "volume":
        mode = net_mode
    if net_mode != mode:
        raise SystemExit(f"{args.net} is served in {net_mode} mode: pass "
                         f"{_MODE_FLAGS[net_mode]}")
    device = torch.device(args.device)
    net_kwargs = json.loads(args.net_kwargs) if args.net_kwargs else {}
    if args.bf16:
        net_kwargs["dtype"] = torch.bfloat16
    if args.fused_tail:
        net_kwargs["fused_tail"] = True
    if args.ema and not args.checkpoint:
        raise SystemExit("--ema needs --checkpoint")
    try:
        net = build_serving_net(args.net, net_kwargs, args.checkpoint,
                                device=device, ema=args.ema)
    except ValueError as err:  # no checkpoint of either kind, or no EMA
        raise SystemExit(f"--checkpoint: {err}") from err
    if args.int8 and not w8a8:  # quantized once, for every pipeline
        from vsr_tpu_torch import quantize

        net = quantize.make_quantized_apply(net,
                                            *quantize.quantize_params(net))

    def pipeline_for(t: int, n_frames: int):
        volume = resolve_volume(args.net, seq_t=t, chunk=args.chunk,
                                n_frames=n_frames, exc=SystemExit)
        return make_pipeline(
            net, args.factor, args.dataset,
            video_t=t if mode == "video" else 0,
            window=((args.windows, t, args.window_order)
                    if mode == "window" else None),
            volume=volume, chunk=args.chunk, int8=args.int8, w8a8=w8a8,
            w8a8_kernels=w8a8_kernels)

    return mode, pipeline_for


def run(args) -> dict:
    mode, pipeline_for = serving_pipelines(args)
    device = torch.device(args.device)
    paths = sorted(Path(args.input_dir).glob("**/*.nii*"))
    if not paths:
        raise SystemExit(f"No NIfTI volumes under {args.input_dir}")

    pipelines: dict = {}
    n_frames = 0
    pipeline_seconds = 0.0
    psnr_rows: list[tuple[str, float]] = []
    start = time.perf_counter()
    for path in paths:
        frames, (h, w, d, t) = load_hr_frames(path)

        key = t if mode != "frame" else None
        if key not in pipelines:
            pipelines[key] = pipeline_for(t, len(frames))
        t0 = time.perf_counter()
        lr, sr = pipelines[key](torch.from_numpy(frames).to(device))
        sr_np = sr.cpu().numpy()  # waits for the device
        pipeline_seconds += time.perf_counter() - t0
        n_frames += d * t

        rel = path.relative_to(args.input_dir)
        out_base = Path(args.output_dir) / rel.parent / rel.name.split(".")[0]
        sr_seq = np.moveaxis(sr_np, 0, -1).reshape(h, w, d, t)
        save_nifti(sr_seq.astype(np.float32), Path(str(out_base) + "_sr.nii.gz"))
        if args.gif:
            for di in range(d):  # uint8 by truncation, as vsr_tpu's writer
                write_gif(Path(str(out_base) + f"_slice{di + 1:0>2d}.gif"),
                          [sr_seq[:, :, di, ti].astype(np.uint8)
                           for ti in range(t)])
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
    parser.add_argument("--net", default="EDSRNet")
    parser.add_argument("--net-kwargs", default="")
    parser.add_argument("--factor", type=int, default=2)
    parser.add_argument("--dataset", choices=["acdc", "dsb15"], default="acdc")
    parser.add_argument("--video", action="store_true",
                        help="sequence (VSR) net: SR every slice's whole "
                             "time series as one sequence (without --video "
                             "and --windows the net sees single frames)")
    parser.add_argument("--bf16", action="store_true",
                        help="serve the net in bfloat16")
    parser.add_argument("--fused-tail", dest="fused_tail", action="store_true",
                        help="fold the final conv through the pixel-shuffle")
    parser.add_argument("--psnr", action="store_true",
                        help="report PSNR of each SR volume vs its input; "
                             "writes <output_dir>/metrics.csv")
    parser.add_argument("--device", default="cuda",
                        help="torch device to serve on (cuda, cuda:1, cpu)")
    parser.add_argument("--checkpoint", default="",
                        help="a checkpoint written by the port's trainer "
                             "(model_N.ckpt, model_best.ckpt) or by "
                             "vsr_tpu's (a flax msgpack file)")
    parser.add_argument("--int8", action="store_true",
                        help="serve the kernels held in int8 (per-channel "
                             "scales, dequantized at each call)")
    parser.add_argument("--w8a8", action="store_true",
                        help="serve the wide convs as int8 x int8 -> int32 "
                             "on the tensor cores (narrow head / tail convs "
                             "stay full precision); static activation "
                             "scales are calibrated on the first batch")
    parser.add_argument("--w8a8-scales", dest="w8a8_scales", default="",
                        help="JSON file of precomputed {module_path: scale} "
                             "activation scales (quantize.calibrate_w8a8 of "
                             "vsr_tpu or of this port; needed for the "
                             "recurrent nets' scan-body convs); implies "
                             "--w8a8")
    parser.add_argument("--w8a8-kernels", dest="w8a8_kernels", default="",
                        help="comma-separated spatial kernel sizes to "
                             "quantize (e.g. '6' or '3,6'); other convs "
                             "serve full precision")
    parser.add_argument("--mesh", default="", help="not yet ported")
    parser.add_argument("--windows", type=int, default=0,
                        help="MISR net (DUF): serve every frame from one "
                             "circular N-frame temporal window")
    parser.add_argument("--window-order", dest="window_order",
                        choices=["middle", "last"], default="middle",
                        help="window alignment relative to the output frame")
    parser.add_argument("--chunk", type=int, default=0,
                        help="feed the net this many frames/windows/3D "
                             "volumes at a time (frame, window and 3D volume "
                             "modes; bounds live memory)")
    parser.add_argument("--preset", choices=["tuned", "fast"], default="",
                        help="apply the net's serving knobs measured on the "
                             "card (vsr_tpu_torch/presets.py): 'tuned' = "
                             "exact knobs only (chunk, fused tail, dispatch, "
                             "video / windows), 'fast' = tuned + W8A8 where "
                             "it measured faster. Explicit flags win")
    parser.add_argument("--preset-file", dest="preset_file", default="",
                        help="JSON of {net: preset_entry} measured on this "
                             "machine (python -m vsr_tpu_torch.tune); "
                             "overrides the built-in table for the nets it "
                             "names. Implies --preset tuned unless --preset "
                             "is given")
    parser.add_argument("--ema", action="store_true",
                        help="serve the parameter EMA tracked by the trainer "
                             "(trainer.kwargs.ema_decay) instead of the raw "
                             "parameters; needs --checkpoint")
    parser.add_argument("--gif", action="store_true",
                        help="also write one animated GIF per slice "
                             "(<name>_sliceNN.gif)")
    parser.add_argument("--bucket-t", dest="bucket_t", type=int, default=0,
                        help="refused: the port compiles no program per "
                             "sequence length")
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    logging.basicConfig(
        format="%(asctime)s | %(levelname)s | %(message)s",
        level=logging.INFO,
        datefmt="%Y-%m-%d %H:%M:%S",
    )
    args = parse_args(argv)
    apply_cli_preset(args)
    return run(args)


if __name__ == "__main__":
    main()
