"""Serving artifacts: the fused serving program, traced and saved with its
weights (port of ``vsr_tpu/export.py``).

``export_serving`` traces ``infer.make_pipeline``'s program (k-space degrade
-> normalize -> net -> denormalize: the program the infer CLI serves) with
``torch.export`` at one static frames shape, on the device it will serve
on. The hand-written kernels appear in the graph as the port's custom ops
(``torch.ops.vsr_tpu_torch.*``), so the loaded program launches them.

Artifact format (``.pt2.zip``): a zip with
  program.pt2  — ``torch.export.save`` of the program (weights inside)
  meta.json    — the JAX artifact's keys (net, kwargs, factor, dataset,
                 shapes, modes), plus ``format`` and the ``device`` type the
                 program was traced on

The k-space matrices are made at trace time on the tracing device and
become constants of the program, so an artifact serves on the device type
it was traced on and is refused on any other: export one per device, as one
per serving geometry.

Quantized artifacts: ``--int8`` keeps the int8 kernels and their scales in
the program (dequantized at each call); ``--w8a8`` bakes static activation
scales (``--w8a8-scales <json>``, or ``--calib <nifti dir>`` to calibrate
here) and the program calls ``torch.ops.vsr_tpu_torch.w8a8_conv``, the
kernel of ``ops/w8a8_conv.py``.

CLI:
  python -m vsr_tpu_torch.export --net EDSRNet --checkpoint model.ckpt \\
      --shape 300,192,192 --factor 2 --out edsr_x2.pt2.zip [--device cuda] \\
      [--int8 | --w8a8-scales scales.json | --w8a8 --calib <nifti dir>]
  python -m vsr_tpu_torch.export --run edsr_x2.pt2.zip in_dir out_dir
"""

from __future__ import annotations

import argparse
import io
import json
import logging
import time
import zipfile
from pathlib import Path
from typing import Sequence

import numpy as np
import torch
from torch import nn

FORMAT = "vsr_tpu_torch-export"
FORMAT_VERSION = 1


def make_serving_fn(net: nn.Module, factor: int, dataset: str,
                    video_t: int = 0, window=None, chunk: int = 0,
                    volume=None, int8: bool = False, w8a8=False,
                    quantize_deconvs: bool = False):
    """The fused HR-frames -> (lr, sr) serving program: exactly
    ``infer.make_pipeline``'s, so the artifact is the program the CLI
    serves (frame, whole-sequence ``video_t``, circular window ``window =
    (nf, seq_t, order)`` and ``volume`` modes, ``chunk``, ``int8``, and
    ``w8a8`` as a ``{path: scale}`` dict: lazy first-batch calibration
    (``w8a8=True``) cannot be serialized and is refused;
    ``quantize_deconvs``: the dict's transposed convs serve W8A8 too)."""
    from vsr_tpu_torch.infer import make_pipeline

    if w8a8 is True:
        raise ValueError(
            "export needs static W8A8 activation scales (a {path: scale} "
            "dict from vsr_tpu_torch.quantize.calibrate_w8a8) — lazy "
            "first-batch calibration cannot be serialized")
    return make_pipeline(net, factor, dataset, video_t=video_t or 0,
                         window=window, volume=volume, chunk=chunk, int8=int8,
                         w8a8=w8a8, quantize_deconvs=quantize_deconvs)


class _Program(nn.Module):
    """The pipeline as a module: the net is a submodule, so its weights are
    the program's state, not loose constants."""

    def __init__(self, net: nn.Module, pipeline):
        super().__init__()
        self.net = net
        self._pipeline = pipeline

    def forward(self, hr_frames: torch.Tensor):
        return self._pipeline(hr_frames)


def export_serving(net: nn.Module, frames_shape: Sequence[int], factor: int,
                   dataset: str = "acdc", video_t: int = 0, window=None,
                   chunk: int = 0, volume=None, int8: bool = False, w8a8=False,
                   quantize_deconvs: bool = False
                   ) -> tuple[torch.export.ExportedProgram, dict]:
    """Trace the serving program at ``frames_shape`` on the net's device.
    Returns ``(program, meta)``."""
    from vsr_tpu_torch.infer import net_device

    device = net_device(net)
    fn = make_serving_fn(net, factor, dataset, video_t=video_t, window=window,
                         chunk=chunk, volume=volume, int8=int8, w8a8=w8a8,
                         quantize_deconvs=quantize_deconvs)
    example = torch.zeros(tuple(frames_shape), dtype=torch.float32,
                          device=device)
    program = torch.export.export(_Program(fn.module, fn), (example,))
    meta = {
        "format": FORMAT,
        "format_version": FORMAT_VERSION,
        "frames_shape": list(frames_shape),
        "factor": factor,
        "dataset": dataset,
        "video_t": video_t or None,
        "window": list(window) if window else None,
        "volume": list(volume) if volume else None,
        "chunk": chunk,
        "int8": bool(int8),
        "w8a8_convs": len(w8a8) if isinstance(w8a8, dict) else 0,
        "platforms": [device.type],  # the JAX key; ``device`` is checked
        "device": device.type,
        "torch": torch.__version__,
        "created": time.strftime("%Y-%m-%d %H:%M:%S"),
    }
    return program, meta


def save_artifact(path: str | Path, program: torch.export.ExportedProgram,
                  meta: dict) -> None:
    buf = io.BytesIO()
    torch.export.save(program, buf)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("program.pt2", buf.getvalue())
        zf.writestr("meta.json", json.dumps(meta, indent=1))


class ExportedServing:
    """A loaded artifact: ``__call__(hr_frames) -> (lr, sr)`` on the device
    it was traced for. Needs only torch and the port's ops (no model code,
    no checkpoint). ``device``: where to serve (default ``cuda``); an
    artifact traced for another device type is refused."""

    def __init__(self, path: str | Path, device: torch.device | str = "cuda"):
        import vsr_tpu_torch.ops  # noqa: F401  (registers the custom ops)

        self.path = Path(path)

        with zipfile.ZipFile(path) as zf:
            names = set(zf.namelist())
            if "program.stablehlo" in names:
                raise ValueError(
                    f"{path} is a JAX .vsrx artifact (program.stablehlo) of "
                    "vsr_tpu.export; vsr_tpu_torch serves its own artifacts "
                    "(python -m vsr_tpu_torch.export)")
            if "program.pt2" not in names or "meta.json" not in names:
                raise ValueError(f"{path} is not a vsr_tpu_torch artifact "
                                 "(no program.pt2 + meta.json)")
            self.meta = json.loads(zf.read("meta.json"))
            if self.meta.get("format") != FORMAT:
                raise ValueError(f"{path}: meta format "
                                 f"{self.meta.get('format')!r} is not {FORMAT}")
            if self.meta.get("format_version", 0) > FORMAT_VERSION:
                raise ValueError(
                    f"artifact format {self.meta['format_version']} is newer "
                    f"than this runtime ({FORMAT_VERSION})")
            self.device = torch.device(device)
            if self.meta["device"] != self.device.type:
                raise ValueError(
                    f"{path} was traced for device {self.meta['device']!r} "
                    f"and cannot serve on {self.device.type!r} (its k-space "
                    "constants and weights live there): export it again on "
                    f"{self.device.type}")
            program = torch.export.load(io.BytesIO(zf.read("program.pt2")))
        self._fn = program.module()

    def __call__(self, hr_frames):
        frames = torch.as_tensor(hr_frames, dtype=torch.float32)
        with torch.inference_mode():
            return self._fn(frames.to(self.device))


# JAX CLI flags this port does not export: dest -> (flag, why).
_NOT_PORTED = {
    "platforms": ("--platforms", "an artifact serves on the device type "
                  "it was traced on (--device)"),
}


def _calibrate_from_volumes(net: nn.Module, calib_dir: Path, want, factor,
                            dataset, video_t, window, method: str,
                            max_volumes: int = 4, volume=None) -> dict:
    """Export-time W8A8 calibration: net inputs from sample NIfTI volumes of
    the artifact's geometry, through the prep stage the artifact runs
    (``infer.make_prep``), then static activation scales
    (``vsr_tpu.export._calibrate_from_volumes``)."""
    from vsr_tpu_torch.infer import load_hr_frames, make_prep, net_device
    from vsr_tpu_torch.quantize import calibrate_w8a8

    prep = make_prep(factor, dataset, video_t or 0, window, volume)
    device = net_device(net)
    zs = []
    for path in sorted(Path(calib_dir).glob("**/*.nii*")):
        frames, _ = load_hr_frames(path)
        if frames.shape == tuple(want):
            with torch.inference_mode():
                zs.append(prep(torch.from_numpy(
                    frames.astype(np.float32)).to(device))[1])
        if len(zs) >= max_volumes:
            break
    if not zs:
        raise SystemExit(
            f"--calib: no NIfTI volume under {calib_dir} matches the "
            f"artifact geometry {tuple(want)}")
    return calibrate_w8a8(net, zs, method=method)


def _cmd_export(args) -> None:
    from vsr_tpu_torch.infer import build_serving_net, resolve_volume

    for dest, (flag, why) in _NOT_PORTED.items():
        if getattr(args, dest):
            raise SystemExit(f"{flag} is not yet ported to vsr_tpu_torch: "
                             f"{why} (export it with python -m "
                             "vsr_tpu.export)")
    net_kwargs = json.loads(args.net_kwargs) if args.net_kwargs else {}
    if args.bf16:
        net_kwargs["dtype"] = torch.bfloat16
    shape = tuple(int(s) for s in args.shape.split(","))
    if len(shape) != 3:
        raise SystemExit(f"--shape must be N,H,W, got {args.shape!r}")
    if args.windows and args.video_t:
        raise SystemExit("--windows (MISR) and --video-t (VSR) are "
                         "mutually exclusive")
    if args.chunk < 0:
        raise SystemExit("--chunk must be >= 0 (0 = disabled)")
    if args.chunk and args.video_t:
        raise SystemExit("--chunk applies to frame/window serving; the "
                         "--video-t path is already sequence-batched")
    volume = resolve_volume(args.net, video=bool(args.video_t),
                            windows=args.windows, seq_t=args.seq_t,
                            chunk=args.chunk, n_frames=shape[0],
                            exc=SystemExit)
    if volume and (args.w8a8 or args.w8a8_scales):
        raise SystemExit("W8A8 quantizes wide 2D nn.Conv layers; the "
                         "volumetric nets' 3D convs have no quantizable "
                         "path — drop --w8a8/--w8a8-scales")
    window = None
    if args.windows:
        if not args.seq_t:
            raise SystemExit("--windows needs --seq-t (frames per slice "
                             "sequence in the serving geometry)")
        window = (args.windows, args.seq_t, args.window_order)
    try:
        net = build_serving_net(args.net, net_kwargs, args.checkpoint,
                                device=args.device)
    except ValueError as err:
        raise SystemExit(f"--checkpoint: {err}") from err
    w8a8: dict | bool = False
    if args.w8a8_scales:
        with open(args.w8a8_scales) as f:
            w8a8 = {k: float(v) for k, v in json.load(f).items()}
    elif args.w8a8:
        if not args.calib:
            raise SystemExit(
                "--w8a8 export needs static activation scales: pass "
                "--w8a8-scales <json> (vsr_tpu_torch.quantize.calibrate_w8a8"
                " or vsr_tpu's) or --calib <nifti dir> to calibrate from "
                "sample volumes here")
        w8a8 = _calibrate_from_volumes(
            net, Path(args.calib), shape, args.factor, args.dataset,
            args.video_t, window, args.calib_method, volume=volume)
        logging.info(f"Calibrated {len(w8a8)} conv activation scales "
                     f"from {args.calib} (method={args.calib_method})")
    if w8a8 and args.int8:
        raise SystemExit("--int8 (weight-only) and --w8a8 (int8 tensor-core "
                         "compute) are separate paths; pick one")
    if args.w8a8_kernels:
        if not isinstance(w8a8, dict):
            raise SystemExit("--w8a8-kernels needs W8A8 scales "
                             "(--w8a8-scales or --w8a8 with --calib)")
        from vsr_tpu_torch.quantize import filter_scales_by_kernel

        sizes = {int(s) for s in args.w8a8_kernels.split(",")}
        w8a8 = filter_scales_by_kernel(net, w8a8, sizes)
        logging.info(f"--w8a8-kernels {sorted(sizes)}: "
                     f"{len(w8a8)} convs stay quantized")
    program, meta = export_serving(
        net, shape, args.factor, dataset=args.dataset,
        video_t=args.video_t, window=window, chunk=args.chunk, volume=volume,
        int8=args.int8, w8a8=w8a8)
    meta.update({"net": args.net, "net_kwargs": net_kwargs if not args.bf16
                 else {**net_kwargs, "dtype": "bfloat16"}})
    save_artifact(args.out, program, meta)
    logging.info(f"Exported {args.net} ({meta['device']}) {shape} -> "
                 f"{args.out} ({Path(args.out).stat().st_size / 1e6:.1f} MB)")


def _cmd_run(args) -> None:
    from vsr_tpu_torch.infer import load_hr_frames
    from vsr_tpu_torch.io.nifti import save_nifti

    serving = ExportedServing(args.run, device=args.device)
    want = tuple(serving.meta["frames_shape"])
    paths = sorted(Path(args.input_dir).glob("**/*.nii*"))
    if not paths:
        raise SystemExit(f"No NIfTI volumes under {args.input_dir}")
    done = 0
    for path in paths:
        frames, (h, w, d, t) = load_hr_frames(path)
        if frames.shape != want:
            logging.warning(
                f"{path.name}: shape {frames.shape} != artifact {want} — "
                "skipped (export one artifact per serving geometry)")
            continue
        _, sr = serving(frames.astype(np.float32))
        sr_np = sr.cpu().numpy()
        rel = path.relative_to(args.input_dir)
        out_base = Path(args.output_dir) / rel.parent / rel.name.split(".")[0]
        out_base.parent.mkdir(parents=True, exist_ok=True)
        save_nifti(np.moveaxis(sr_np, 0, -1).reshape(h, w, d, t),
                   Path(str(out_base) + "_sr.nii.gz"))
        done += 1
    logging.info(f"Served {done}/{len(paths)} volumes from {args.run}")
    if done == 0:
        raise SystemExit(
            f"All {len(paths)} volumes were skipped (shape != artifact "
            f"geometry {want}) — nothing served")


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Export / run serving artifacts (PyTorch port)")
    p.add_argument("--run", default="",
                   help="path to an artifact: serve input_dir -> output_dir")
    p.add_argument("input_dir", nargs="?", type=Path)
    p.add_argument("output_dir", nargs="?", type=Path)
    p.add_argument("--net", default="EDSRNet")
    p.add_argument("--net-kwargs", default="")
    p.add_argument("--checkpoint", default="",
                   help="a checkpoint of the port's trainer or of vsr_tpu's "
                        "(flax msgpack); without it a seeded init")
    p.add_argument("--factor", type=int, default=2)
    p.add_argument("--dataset", choices=["acdc", "dsb15"], default="acdc")
    p.add_argument("--shape", default="300,96,96",
                   help="HR frames shape N,H,W the artifact is specialized to")
    p.add_argument("--video-t", dest="video_t", type=int, default=0,
                   help="whole-sequence (VSR) serving with this T")
    p.add_argument("--windows", type=int, default=0,
                   help="MISR net (DUF, ...): one circular N-frame window "
                        "per output frame")
    p.add_argument("--seq-t", dest="seq_t", type=int, default=0,
                   help="frames per slice sequence (with --windows and the "
                        "volumetric nets)")
    p.add_argument("--window-order", dest="window_order",
                   choices=["middle", "last"], default="middle")
    p.add_argument("--chunk", type=int, default=0,
                   help="feed the net this many frames/windows at a time")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="device to trace on and serve on (cuda, cpu)")
    p.add_argument("--out", default="model.pt2.zip")
    p.add_argument("--int8", action="store_true",
                   help="keep the kernels in int8 in the artifact "
                        "(dequantized at each call)")
    p.add_argument("--w8a8", action="store_true",
                   help="bake W8A8 convs (int8 x int8 -> int32 on the "
                        "tensor cores) into the artifact; needs "
                        "--w8a8-scales or --calib")
    p.add_argument("--w8a8-scales", dest="w8a8_scales", default="",
                   help="JSON file of precomputed {module_path: scale} "
                        "activation scales; implies --w8a8")
    p.add_argument("--w8a8-kernels", dest="w8a8_kernels", default="",
                   help="comma-separated spatial kernel sizes to quantize "
                        "(e.g. '6'); other convs stay full precision")
    p.add_argument("--calib", default="",
                   help="with --w8a8: directory of sample NIfTI volumes of "
                        "the artifact geometry to calibrate activation "
                        "scales from at export time")
    p.add_argument("--calib-method", dest="calib_method",
                   choices=["outputs", "callback"], default="outputs",
                   help="'callback' also calibrates the recurrent nets' "
                        "scan-body convs")
    p.add_argument("--platforms", default="",
                   help="not ported: an artifact serves on the device type "
                        "it was traced on (--device)")
    p.add_argument("--preset-file", dest="preset_file", default="",
                   help="JSON of {net: preset_entry} measured on this "
                        "machine (python -m vsr_tpu_torch.tune); overrides "
                        "the built-in table. Implies --preset tuned")
    p.add_argument("--preset", choices=["tuned", "fast"], default="",
                   help="apply the net's serving knobs measured on the card "
                        "(vsr_tpu_torch/presets.py) to the exported "
                        "program; explicit flags win. W8A8 at export time "
                        "needs --calib or --w8a8-scales")
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> None:
    logging.basicConfig(format="%(asctime)s | %(levelname)s | %(message)s",
                        level=logging.INFO, datefmt="%Y-%m-%d %H:%M:%S")
    args = parse_args(argv)
    if not args.run:
        from vsr_tpu_torch.presets import apply_cli_preset

        apply_cli_preset(args)
    if args.run:
        if not (args.input_dir and args.output_dir):
            raise SystemExit("--run needs input_dir and output_dir")
        _cmd_run(args)
    else:
        _cmd_export(args)


if __name__ == "__main__":
    main()
