"""Training loggers: scalars + HR|SR image grids per epoch (port of
``vsr_tpu/callbacks/logger.py``).

One logger per task family, each pairing train/valid scalars per key and
emitting a side-by-side target-vs-output image grid each epoch.

Backends: always a ``metrics.jsonl`` (one JSON object per epoch) and PNG
grids under ``<log_dir>/images``, written by the module's own PNG encoder
(``zlib`` + ``struct``); plus TensorBoard event files via
``torch.utils.tensorboard`` when importable. A grid that cannot be made
raises.

Batches and outputs arrive channels-last, as the loader makes them: the
trainer hands over ``(N, H, W, C)`` / ``(N, T, H, W, C)`` numpy arrays, and
for the volume nets their outputs in the JAX nets' ``(N, D, H, W, C)`` /
``(N, T, D, H, W, C)`` layouts beside the batches' ``(N, H, W, D, C)`` /
``(N, T, H, W, D, C)``.
"""

from __future__ import annotations

import json
import struct
import zlib
from pathlib import Path

import numpy as np

from vsr_tpu_torch.registry import register


def _to_uint8_grid(pairs: list[np.ndarray], pad: int = 2) -> np.ndarray:
    """Tile a list of equally-sized (H, W, C) float images into one row-major
    grid, min-max normalized over the whole grid (the tensors arriving here
    are z-scored)."""
    arrs = [np.asarray(p, dtype=np.float32) for p in pairs]
    h, w, c = arrs[0].shape
    n = len(arrs)
    cols = min(n, 8)
    rows = (n + cols - 1) // cols
    grid = np.zeros((rows * (h + pad) + pad, cols * (w + pad) + pad, c), np.float32)
    for i, a in enumerate(arrs):
        r, col = divmod(i, cols)
        y0, x0 = pad + r * (h + pad), pad + col * (w + pad)
        grid[y0 : y0 + h, x0 : x0 + w] = a
    lo, hi = grid.min(), grid.max()
    if hi > lo:
        grid = (grid - lo) / (hi - lo)
    grid = (grid * 255.0).round().astype(np.uint8)
    if c == 1:
        grid = np.repeat(grid, 3, axis=-1)
    return grid


def write_png(path: str | Path, image: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 array as an 8-bit RGB PNG, or an (H, W)
    one as an 8-bit greyscale PNG."""
    image = np.ascontiguousarray(image)
    grey = image.ndim == 2
    if image.dtype != np.uint8 or not (
            grey or (image.ndim == 3 and image.shape[2] == 3)):
        raise ValueError(f"write_png takes (H, W, 3) or (H, W) uint8, got "
                         f"{image.dtype} {image.shape}")
    h, w = image.shape[:2]

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return struct.pack(">I", len(data)) + body + struct.pack(
            ">I", zlib.crc32(body) & 0xFFFFFFFF)

    # Every scanline starts with filter type 0 (none).
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), image.reshape(h, -1)], axis=1).tobytes()
    Path(path).write_bytes(
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0 if grey else 2,
                                     0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


class BaseLogger:
    """``net`` / ``dummy_input`` are the configs' graph-plotting kwargs,
    accepted and unused (no graph is exported)."""

    def __init__(self, log_dir: str | Path, net=None, dummy_input=None):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        (self.log_dir / "images").mkdir(exist_ok=True)
        self._jsonl = open(self.log_dir / "metrics.jsonl", "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            pass
        else:
            self._tb = SummaryWriter(log_dir=str(self.log_dir))

    def write(self, epoch: int, train_log: dict, train_batch, train_outputs,
              valid_log: dict, valid_batch, valid_outputs) -> None:
        record = {"epoch": epoch, "train": dict(train_log), "valid": dict(valid_log)}
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for key in train_log:
                self._tb.add_scalars(key, {"train": train_log[key], "valid": valid_log[key]}, epoch)
        grid = self._make_grid(valid_batch, valid_outputs)
        write_png(self.log_dir / "images" / f"epoch_{epoch:05d}.png", grid)
        if self._tb is not None:
            self._tb.add_image("valid/target_vs_output", grid, epoch, dataformats="HWC")

    def _make_grid(self, batch, outputs) -> np.ndarray:
        raise NotImplementedError

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class SISRLogger(BaseLogger):
    """Grid = [HR target | SR output] per sample."""

    def _make_grid(self, batch, outputs):
        targets = np.asarray(batch["hr_img"])
        outs = np.asarray(outputs)
        pairs = [img for t, o in zip(targets, outs) for img in (t, o)]
        return _to_uint8_grid(pairs)


class SISRSRFBLogger(BaseLogger):
    """Feedback nets return per-step stacks (S, N, H, W, C): use the last."""

    def _make_grid(self, batch, outputs):
        targets = np.asarray(batch["hr_img"])
        outs = np.asarray(outputs)[-1]
        pairs = [img for t, o in zip(targets, outs) for img in (t, o)]
        return _to_uint8_grid(pairs)


class MISRLogger(SISRLogger):
    """Windows in, the centre frame out: the SISR grid against ``hr_img``."""


class VSRLogger(BaseLogger):
    """Sequences (N, T, H, W, C): show the last frame. A tuple of outputs
    (FRVSR's ``(sr, warped_lr)``) shows its first, the SR frames."""

    def _make_grid(self, batch, outputs):
        hr = np.asarray(batch["hr_imgs"])
        if isinstance(outputs, tuple):
            outputs = outputs[0]
        outs = np.asarray(outputs)[:, hr.shape[1] - 1]
        pairs = [img for t, o in zip(hr[:, -1], outs) for img in (t, o)]
        return _to_uint8_grid(pairs)


class VolumeLogger(BaseLogger):
    """3D volumes, batch (N, H, W, D, C) / outputs (N, D, H, W, C): show the
    middle depth slice."""

    def _make_grid(self, batch, outputs):
        targets = np.asarray(batch["hr_vol"])
        outs = np.asarray(outputs)
        d = targets.shape[3] // 2
        pairs = [img for t, o in zip(targets, outs) for img in (t[:, :, d], o[d])]
        return _to_uint8_grid(pairs)


class Volume4DLogger(BaseLogger):
    """4D sequences, batch (N, T, H, W, D, C) / outputs (N, T, D, H, W, C):
    show the mid-depth slice of the last frame."""

    def _make_grid(self, batch, outputs):
        hr = np.asarray(batch["hr_vols"])
        t, d = hr.shape[1] - 1, hr.shape[4] // 2
        outs = np.asarray(outputs)[:, t, d]
        pairs = [img for tg, o in zip(hr[:, t, :, :, d], outs)
                 for img in (tg, o)]
        return _to_uint8_grid(pairs)


for _name, _cls in [
    ("AcdcSISRLogger", SISRLogger),
    ("Dsb15SISRLogger", SISRLogger),
    ("AcdcSISRSRFBLogger", SISRSRFBLogger),
    ("Dsb15SISRSRFBLogger", SISRSRFBLogger),
    ("AcdcMISRLogger", MISRLogger),
    ("Dsb15MISRLogger", MISRLogger),
    ("AcdcVSRLogger", VSRLogger),
    ("Dsb15VSRLogger", VSRLogger),
    ("Acdc3DSRLogger", VolumeLogger),
    ("Dsb153DSRLogger", VolumeLogger),
    ("Acdc4DSRLogger", Volume4DLogger),
    ("Dsb154DSRLogger", Volume4DLogger),
]:
    register("logger", _name)(_cls)
