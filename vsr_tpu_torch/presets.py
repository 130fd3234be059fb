"""Measured serving presets: per-net knob settings that won on the card
(port of ``vsr_tpu/presets.py``).

The JAX package's table is TPU v5e measurements; none of its numbers carries
over. Every entry of :data:`SERVING_PRESETS` here comes from a run of
``python -m vsr_tpu_torch.tune`` (the exact knobs) and of ``infer`` with and
without ``--w8a8`` (the ``fast`` level) on one NVIDIA H100 80GB HBM3 at a
700 W power limit, at the serving geometry of a 192 x 192 x 10 x 30 study:
``python3 chip_smoke.py --preset-table`` runs that sweep and writes its
figures, which PERF.md section 5 records. ``{}`` is a measured "no knob
won".

Two levels, as in the JAX package:

- ``tuned`` — exact knobs only: ``--chunk`` sizes, fused sub-pixel tails,
  the MoE dispatch, the video / window serving modes. Outputs are the
  un-preset path's to float reassociation.
- ``fast`` — ``tuned`` plus W8A8 (int8 activations x int8 weights on the
  int8 tensor cores, ``quantize.make_w8a8_apply``) where it served faster on
  the card. Approximate. The ``w8a8`` field keeps the JAX meaning:
  ``"lazy"`` = first-batch calibration reaches every eligible conv (in the
  port, wherever the nets' Python loops let it: the convs of
  ``interop.SCAN_BODIES`` are left out); ``"scales"`` = a precomputed
  scales file is needed (``quantize.calibrate_w8a8(method="callback")``).

Usage::

    python -m vsr_tpu_torch.infer IN OUT --net DUFNet --preset fast ...
    python -m vsr_tpu_torch.serve --net DUFNet --preset tuned ...
    from vsr_tpu_torch.presets import serving_config
    serving_config("DUFNet", "fast")

Explicit user flags always win: the preset only fills knobs still at their
CLI defaults. Knobs the port refuses for good (the TPU scan's ``unroll``;
``volumes_per_call``, which no serving CLI of the port reads) are refused by
name when a ``--preset-file`` names them.
"""
from __future__ import annotations

import json
import logging

LEVELS = ("tuned", "fast")

#: Construction kwarg that holds each MISR net's window length, so the
#: preset follows a user's ``--net-kwargs`` override instead of assuming.
_WINDOW_KWARG = {
    "TOFlowNet": "num_frames",
    "DUFNet": "num_frames",
    "RBPNet": "num_frames",
    "EDVRNet": "nframes",
}

#: Preset knobs the port refuses, at an entry's top level or in its
#: ``net_kwargs``: knob -> why.
REFUSED_KNOBS = {
    "unroll": "it is the TPU lax.scan unroll; the port's frame and step "
              "loops are Python loops",
    "volumes_per_call": "the port's serving CLIs serve one volume a call "
                        "and read no volumes-per-call",
    "volumes_per_call_w8a8": "the port's serving CLIs serve one volume a "
                             "call and read no volumes-per-call",
}

#: The card's table (see the module docstring): run P1 of
#: ``python3 chip_smoke.py --preset-table`` on one NVIDIA H100 80GB HBM3 at
#: 700.00 W, a 192 x 192 x 10 x 30 volume (300 frames) a call. An exact
#: knob enters where the tuner's best row beat the row without knobs by
#: more than 5 % and by more than the spread of the run (two pipeline runs
#: of the same knobs differed by up to 4 % in it); W8A8 where it served faster than the tuned knobs without
#: it, within 0.5 dB. Figures: volumes/s of the tuner, frames/s of the W8A8
#: on / off run (low-passed volume).
SERVING_PRESETS: dict[str, dict] = {
    # chunk 100: 514.9 volumes/s against 126.6 unchunked.
    "Bicubic": {"chunk": 100},
    # fused tail / chunk 100: 3.978 volumes/s against 3.857 (+3.1 %);
    # W8A8 1755.1 / 925.3 frames/s = 1.90x, -0.006 dB.
    "EDSRNet": {"w8a8": "lazy"},
    # dense dispatch + fused tail: 2.054 volumes/s against sparse 1.857
    # (+10.6 %); W8A8 838.5 / 576.5 frames/s = 1.45x, +0.001 dB.
    "MoEEDSRNet": {"net_kwargs": {"fused_tail": True,
                                  "dispatch_impl": "dense"},
                   "w8a8": "lazy"},
    # chunk 60 and 0 alike (0.287 volumes/s); W8A8 with callback scales
    # 110.7 / 84.8 frames/s = 1.30x, +0.0001 dB.
    "SRFBNet": {"w8a8": "scales"},
    # fused tail 0.352 against 0.350 volumes/s; W8A8 (callback scales)
    # 147.7 / 104.8 frames/s = 1.41x, +0.003 dB.
    "DRFSISRNet": {"w8a8": "scales"},
    # fused tail 1.343 against 1.344 volumes/s; W8A8 (callback scales)
    # 489.2 / 384.7 frames/s = 1.27x, +0.002 dB.
    "DRFNet": {"video": True, "w8a8": "scales"},
    # W8A8 (callback scales) 491.3 / 1644.6 frames/s = 0.30x: not taken.
    "FRVSRNet": {"video": True},
    # chunk 0 best (0.526 volumes/s; 30: 0.507); W8A8 464.1 / 154.3
    # frames/s = 3.01x, -0.033 dB.
    "TOFlowNet": {"windows": 5, "w8a8": "lazy"},
    # chunk 0 best (0.913 volumes/s; 100: 0.911); W8A8 558.7 / 266.4
    # frames/s = 2.10x, +0.0004 dB.
    "DUFNet": {"windows": 7, "w8a8": "lazy"},
    # chunk 0 best (0.170 volumes/s); W8A8 87.5 / 50.7 frames/s = 1.73x,
    # +0.001 dB.
    "RBPNet": {"windows": 5, "w8a8": "lazy"},
    # chunk 100 0.922 against 0.914 volumes/s; W8A8 246.0 / 247.0 frames/s
    # = 1.00x: not taken.
    "EDVRNet": {"windows": 5},
    # fused tail 7.163 against 7.046 volumes/s (+1.7 %); W8A8 3629.4 /
    # 1759.8 frames/s = 2.06x, +0.003 dB.
    "Volume3DSRNet": {"w8a8": "lazy"},
    # hoist_tail + fused tail 10.51 against 9.952 volumes/s (+5.6 %), one
    # best-of-2 reading in a run whose repeats moved up to 4 %: no margin
    # over the spread, not taken; W8A8 (callback scales) 1631.4 / 2318.8
    # frames/s = 0.70x: not taken.
    "Volume4DSRNet": {},
}


def _refuse_knobs(path: str, name: str, entry: dict) -> None:
    for where, knobs in (("", entry),
                         ("net_kwargs.", entry.get("net_kwargs") or {})):
        for knob in knobs:
            if knob in REFUSED_KNOBS:
                raise ValueError(
                    f"{path}: {name}.{where}{knob} is refused by "
                    f"vsr_tpu_torch: {REFUSED_KNOBS[knob]}")


def load_preset_file(path: str) -> dict:
    """A ``--preset-file`` JSON (written by ``python -m vsr_tpu_torch.tune``
    or ``vsr_tpu.tune``, or by hand): ``{net_name: preset_entry}`` in
    SERVING_PRESETS shape. The entries OVERRIDE the built-ins for the nets
    they name. A knob the port refuses (:data:`REFUSED_KNOBS`) raises by
    name."""
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict):
        raise ValueError(
            f"{path}: expected a JSON object of {{net_name: preset_entry}}"
            f", got {type(data).__name__}")
    entries = data.get("presets", data)  # tune.py wraps under "presets"
    if not isinstance(entries, dict) or not all(
            isinstance(v, dict) for v in entries.values()):
        raise ValueError(
            f"{path}: expected {{net_name: preset_entry}} (optionally "
            "under a 'presets' key)")
    for name, entry in entries.items():
        _refuse_knobs(path, name, entry)
    return entries


def merged_preset_table(overrides: dict | None) -> dict:
    """SERVING_PRESETS with ``overrides`` (a --preset-file) MERGED per net,
    override keys winning: a tune file carries only the exact knobs it
    swept; wholesale replacement would silently strip the shipped w8a8
    knobs. tune writes explicit values (chunk 0, fused_tail False) for
    everything it DID sweep, so its measurements still win. The single
    merge authority — serving_config and apply_preset_to_args both consult
    it."""
    table = dict(SERVING_PRESETS)
    if overrides:
        for name, entry in overrides.items():
            merged = dict(table.get(name, {}))
            nk = {**merged.get("net_kwargs", {}),
                  **entry.get("net_kwargs", {})}
            merged.update(entry)
            if nk:
                merged["net_kwargs"] = nk
            table[name] = merged
    return table


def serving_config(net_name: str, level: str = "tuned",
                   net_kwargs: dict | None = None,
                   have_scales: bool = False,
                   overrides: dict | None = None) -> dict:
    """The measured serving knobs for ``net_name`` at ``level``.

    Returns a dict with any of: ``net_kwargs`` (extra construction kwargs,
    e.g. ``fused_tail``), ``chunk``, ``windows``, ``video``, ``w8a8``
    (``True`` = lazy first-batch calibration), ``w8a8_kernels`` (and, for a
    table that carries it, ``volumes_per_call``). ``net_kwargs`` (the
    user's) is consulted for window-length overrides; ``have_scales`` says
    whether a precomputed activation-scales file is available (required to
    quantize the loop-body convs). ``overrides`` (from
    :func:`load_preset_file`) replaces the built-in entry for nets it names.
    """
    if level not in LEVELS:
        raise ValueError(f"Unknown preset level {level!r}; one of {LEVELS}")
    table = merged_preset_table(overrides)
    if net_name not in table:
        raise ValueError(
            f"No serving preset for net {net_name!r}; presets exist for: "
            f"{', '.join(sorted(table))}")
    preset = table[net_name]
    out: dict = {}
    if preset.get("net_kwargs"):
        out["net_kwargs"] = dict(preset["net_kwargs"])
    for knob in ("chunk", "video", "volumes_per_call"):
        if knob in preset:
            out[knob] = preset[knob]
    if "windows" in preset:
        kw = _WINDOW_KWARG.get(net_name)
        out["windows"] = int((net_kwargs or {}).get(kw, preset["windows"])
                             if kw else preset["windows"])
    if level == "fast" and "w8a8" in preset:
        mode = preset["w8a8"]
        if mode == "lazy":
            out["w8a8"] = True
        elif mode == "scales" and have_scales:
            out["w8a8"] = "scales"  # caller supplies the dict
        # loop-body net without scales: stay full precision (exact)
        if "w8a8" in out and "w8a8_kernels" in preset:
            out["w8a8_kernels"] = set(preset["w8a8_kernels"])
        if "w8a8" in out and "volumes_per_call_w8a8" in preset:
            out["volumes_per_call"] = preset["volumes_per_call_w8a8"]
    return out


def apply_preset_to_args(args, level: str,
                         overrides: dict | None = None) -> list[str]:
    """Fill a CLI namespace in place from the net's preset.

    Works for all three serving CLIs — ``infer`` (bool ``--video``,
    lazy-calibration-capable ``--w8a8``), ``export`` (``--video-t``, W8A8
    only with ``--calib`` / ``--w8a8-scales``) and ``serve`` (``--video-t``,
    static scales only) — by detecting which knobs the namespace carries.
    Only knobs still at their argparse defaults are touched: explicit user
    flags win. Impossible combinations (chunk under ``--mesh``, lazy W8A8
    where only static scales work) are skipped with a logged note instead
    of erroring, so ``--preset`` composes with the rest of the CLI. Returns
    the list of notes (also logged).
    """
    have_scales = bool(getattr(args, "w8a8_scales", "")
                       or getattr(args, "calib", ""))
    try:
        cfg = serving_config(
            args.net, level,
            net_kwargs=json.loads(args.net_kwargs) if args.net_kwargs else {},
            have_scales=have_scales, overrides=overrides)
    except ValueError as exc:  # unknown net/level: a clean CLI error
        raise SystemExit(str(exc)) from None
    applied: list[str] = []

    if cfg.get("net_kwargs"):
        user = json.loads(args.net_kwargs) if args.net_kwargs else {}
        extra = {k: v for k, v in cfg["net_kwargs"].items() if k not in user}
        if extra:
            user.update(extra)
            args.net_kwargs = json.dumps(user)
            applied.append(f"net_kwargs += {extra}")

    mesh = bool(getattr(args, "mesh", ""))
    video_set = bool(getattr(args, "video", False)
                     or getattr(args, "video_t", 0))
    windows_set = bool(getattr(args, "windows", 0))
    user_chunk = bool(getattr(args, "chunk", 0))  # before the preset fills it

    if cfg.get("chunk") and not getattr(args, "chunk", 0):
        if mesh:
            applied.append("chunk skipped (--mesh shards the un-chunked "
                           "batch)")
        elif video_set:
            applied.append("chunk skipped (the --video path is already "
                           "sequence-batched)")
        else:
            args.chunk = cfg["chunk"]
            applied.append(f"chunk = {cfg['chunk']}")

    if (cfg.get("video") and not video_set and not windows_set
            and user_chunk):
        # The user explicitly chunked frame-mode serving; switching the
        # mode under them would turn their flag into a hard CLI error.
        applied.append("video skipped (explicit --chunk pins frame-mode "
                       "serving)")
    elif cfg.get("video") and not video_set and not windows_set:
        if hasattr(args, "video"):  # infer: T comes from each volume
            args.video = True
            applied.append("video = True (whole-sequence VSR serving)")
        else:  # export/serve build a fixed-T program the user must pick
            applied.append(f"{args.net} serves best whole-sequence; "
                           "pass --video-t <frames per slice>")
    if cfg.get("windows") and not windows_set and not video_set:
        if hasattr(args, "seq_t") and not getattr(args, "seq_t", 0):
            applied.append(f"windows = {cfg['windows']} needs --seq-t "
                           "(frames per slice) here; not applied")
        else:
            args.windows = cfg["windows"]
            applied.append(f"windows = {cfg['windows']} (circular MISR eval)")

    w8a8 = cfg.get("w8a8")
    already = (getattr(args, "w8a8", False) or getattr(args, "int8", False)
               or getattr(args, "w8a8_scales", ""))
    if w8a8 is True and not already:
        # "lazy" nets: every eligible conv is reachable by first-batch
        # calibration — but only infer can do that; export needs sample
        # volumes (--calib) and the daemon static scales.
        if not hasattr(args, "w8a8"):
            applied.append("w8a8 skipped (live serving takes static scales "
                           "only; pass --w8a8-scales from "
                           "vsr_tpu_torch.quantize.calibrate_w8a8)")
        elif hasattr(args, "calib"):  # export CLI
            if getattr(args, "calib", ""):
                args.w8a8 = True
                applied.append("w8a8 = calibrate from --calib volumes")
            else:
                applied.append("w8a8 skipped (export needs --calib <nifti "
                               "dir> or --w8a8-scales to calibrate)")
        elif mesh:
            applied.append("w8a8 skipped (lazy calibration needs static "
                           "scales under --mesh; pass --w8a8-scales)")
        else:
            args.w8a8 = True
            applied.append("w8a8 = lazy first-batch calibration")
    if w8a8 == "scales" and not already and hasattr(args, "calib") \
            and getattr(args, "calib", ""):
        # Loop-body net on the export CLI with sample volumes: only the
        # callback recorder reaches the convs of the nets' frame loops.
        if getattr(args, "calib_method", "outputs") == "callback":
            args.w8a8 = True
            applied.append("w8a8 = calibrate from --calib volumes "
                           "(callback recorder)")
        else:
            applied.append("w8a8 skipped (this net's eligible convs live in "
                           "its frame loop; re-run with --calib-method "
                           "callback)")
    merged_entry = merged_preset_table(overrides).get(args.net, {})
    if level == "fast" and "w8a8" not in cfg \
            and merged_entry.get("w8a8") == "scales":
        applied.append("w8a8 skipped (eligible convs live in the frame "
                       "loop; pass --w8a8-scales from vsr_tpu_torch."
                       "quantize.calibrate_w8a8(method='callback') to "
                       "quantize)")
    kernels = cfg.get("w8a8_kernels")
    if kernels and not getattr(args, "w8a8_kernels", ""):
        # Only restrict scales the preset itself enabled or the user
        # supplied; never invent a quantization mode.
        if getattr(args, "w8a8", False) or getattr(args, "w8a8_scales", ""):
            args.w8a8_kernels = ",".join(str(k) for k in sorted(kernels))
            applied.append(f"w8a8_kernels = {args.w8a8_kernels} "
                           "(the other convs measured slower quantized)")

    for line in applied:
        logging.info(f"preset[{level}] {args.net}: {line}")
    return applied


def apply_cli_preset(args) -> list[str]:
    """The serving CLIs' ``--preset`` / ``--preset-file`` (``main`` of
    ``infer``, ``export`` and ``serve``): ``--preset-file`` alone implies
    ``--preset tuned``; a file that does not load is a clean CLI error.
    Returns the notes of :func:`apply_preset_to_args` (none without a
    preset)."""
    if args.preset_file and not args.preset:
        args.preset = "tuned"
    if not args.preset:
        return []
    try:
        overrides = (load_preset_file(args.preset_file)
                     if args.preset_file else None)
    except (OSError, ValueError) as exc:
        raise SystemExit(f"--preset-file: {exc}") from None
    return apply_preset_to_args(args, args.preset, overrides=overrides)
