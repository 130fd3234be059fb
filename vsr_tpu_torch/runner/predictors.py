"""Predictors: test-set evaluation + CSV/PNG/GIF export (port of
``vsr_tpu/runner/predictors.py``).

Batch-size-1 streaming evaluation, per-sample (SISR / MISR / 3D volume) or
per-frame (VSR, 4D volume sequence) metric rows in ``results.csv``,
per-frame PNGs, per-sequence GIFs (the trailing sequence's too), NIfTI SR
volumes, and ``Cardiac*`` metrics receiving the patient name. Nets
returning tuples are evaluated on ``outputs[0]``. Row names, column order
and file names are the JAX package's.

The net runs on the predictor's device under ``torch.no_grad()``, and so do
every loss and metric (the ``Cardiac*`` crops included: a crop is a slice,
no shape needs compiling). A sequence's scalars and its denormalized frames
come to the host in one copy. The JAX predictor pads sequences to T buckets
only to bound its recompiles; there is no compile step here, so sequences
run at their own length and ``t_bucket`` is not a parameter. PNGs and GIFs
are written by the port's own encoders (``callbacks/logger.py:write_png``,
``utils/gif.py``); SR volumes by the port's NIfTI writer (``io/nifti.py``).
"""

from __future__ import annotations

import csv
import logging
from pathlib import Path
from typing import Any, Sequence

import numpy as np
import torch
from torch import nn

from vsr_tpu_torch.callbacks.logger import write_png
from vsr_tpu_torch.io.nifti import NiftiWriter, save_nifti
from vsr_tpu_torch.registry import register
from vsr_tpu_torch.utils.checkpoint import load_net_weights
from vsr_tpu_torch.utils.gif import write_gif
from vsr_tpu_torch.utils.normalize import DATASET_STATS


class BasePredictor:
    """Args mirror the JAX predictor. ``device``: where the net runs
    (``cuda`` unless the caller asks for ``cpu``)."""

    dataset_stats = "acdc"

    def __init__(
        self,
        test_dataloader,
        net: nn.Module,
        loss_fns: Sequence,
        loss_weights: Sequence[float],
        metric_fns: Sequence,
        saved_dir: str | None = None,
        exported: bool = False,
        device: str | torch.device = "cuda",
    ):
        if test_dataloader.batch_size != 1:
            raise ValueError(
                f"The testing batch size should be 1. Got {test_dataloader.batch_size}."
            )
        self.device = torch.device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.test_dataloader = test_dataloader
        self.net = net.to(self.device).eval()
        self.loss_fns = list(loss_fns)
        self.loss_weights = np.asarray([float(w) for w in loss_weights])
        self.metric_fns = list(metric_fns)
        self.exported = exported
        if exported:
            self.saved_dir = Path(saved_dir)

    # ------------------------------------------------------------- loading

    def load(self, path: str | Path) -> None:
        """Restore the net's parameters only, from a checkpoint of the
        port's format or of ``vsr_tpu`` (a flax msgpack file)."""
        load_net_weights(self.net, path, map_location=self.device)

    # --------------------------------------------------------------- hooks

    def _init_log(self) -> dict:
        log = {"Loss": 0.0}
        for fn in (*self.loss_fns, *self.metric_fns):
            log[fn.__class__.__name__] = 0.0
        return log

    def _denormalize(self, x: torch.Tensor) -> torch.Tensor:
        mean, std = DATASET_STATS[self.dataset_stats]
        return torch.clamp(torch.round(x * std + mean), 0.0, 255.0)

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(array)).to(self.device)

    def _metric_value(self, fn, output, target, patient: str):
        if getattr(fn, "needs_name", "Cardiac" in fn.__class__.__name__):
            return fn(output, target, patient)
        return fn(output, target)

    def _frame_scalars(self, losses: list, d_out, d_tgt,
                       patient: str) -> torch.Tensor:
        """One frame's row on the device: the metrics, then the losses."""
        metrics = [self._metric_value(fn, d_out, d_tgt, patient)
                   for fn in self.metric_fns]
        values = [v.float().reshape(()) for v in (*metrics, *losses)]
        return (torch.stack(values) if values
                else torch.zeros(0, device=self.device))

    def _to_host(self, scalars: torch.Tensor, frames: torch.Tensor | None):
        """(T, n scalars) and, when exporting, the (T, H, W) denormalized
        frames (integers in [0, 255], exact in float32), in ONE copy."""
        t = scalars.shape[0]
        parts = [scalars.flatten()]
        if frames is not None:
            parts.append(frames.float().flatten())
        packed = torch.cat(parts).cpu().numpy()
        rows = packed[:scalars.numel()].reshape(t, -1).astype(np.float64)
        imgs = None
        if frames is not None:
            imgs = packed[scalars.numel():].reshape(frames.shape).astype(np.uint8)
        return rows, imgs

    def _add_to_log(self, log: dict, row: np.ndarray, weight: float = 1.0) -> None:
        """``row``: one frame's (or a sequence's mean) metrics then losses."""
        n_m = len(self.metric_fns)
        metrics, losses = row[:n_m], row[n_m:]
        if self.loss_fns:
            log["Loss"] += float((losses * self.loss_weights).sum()) * weight
        for fn, l in zip(self.loss_fns, losses):
            log[fn.__class__.__name__] += float(l) * weight
        for fn, m in zip(self.metric_fns, metrics):
            log[fn.__class__.__name__] += float(m) * weight

    def _finish(self, log: dict, count: float, results: list | None) -> dict:
        if results is not None:
            self._write_csv(results)
        for key in log:
            log[key] /= count
        logging.info(f"Test log: {log}.")
        return log

    def _write_csv(self, results: list) -> None:
        self.saved_dir.mkdir(parents=True, exist_ok=True)
        with open(self.saved_dir / "results.csv", "w", newline="") as f:
            csv.writer(f).writerows(results)

    def _csv_header(self) -> list[str]:
        return (
            ["name"]
            + [fn.__class__.__name__ for fn in self.metric_fns]
            + [fn.__class__.__name__ for fn in self.loss_fns]
        )

    def _save_png(self, patient: str, name: str, img: np.ndarray) -> None:
        out_dir = self.saved_dir / "imgs" / patient
        out_dir.mkdir(parents=True, exist_ok=True)
        write_png(out_dir / name, img)

    def _dump_video(self, patient: str, sid, imgs: list[np.ndarray]) -> None:
        out_dir = self.saved_dir / "videos" / patient
        out_dir.mkdir(parents=True, exist_ok=True)
        write_gif(out_dir / f"sequence{sid}.gif", imgs)


class ImagePredictor(BasePredictor):
    """Shared flow for SISR / MISR / SRFB: one HR frame per sample; a GIF
    per run of samples that share (patient, slice), the last run included.

    Two walks of the data, which give the same rows and files:

    - ``sequence_batch=True`` (default): the frames of one slice sequence
      are fetched from the dataset together, evaluated frame by frame
      (batch 1 each, as in the other walk) on the device, and their rows and
      frames come to the host in one copy per sequence;
    - ``sequence_batch=False``: the literal batch-1 loop over the loader,
      one copy per frame; also taken when the loader shuffles.
    """

    input_key = "lr_img"

    def __init__(self, *args: Any, sequence_batch: bool = True, **kwargs: Any):
        super().__init__(*args, **kwargs)
        self.sequence_batch = bool(sequence_batch)

    # Per-variant hooks ----------------------------------------------------
    def _sample_losses(self, output, target) -> list:
        return [fn(output, target) for fn in self.loss_fns]

    def _eval_output(self, output):
        """The tensor metrics/export should use (identity for plain nets)."""
        return output

    # ---------------------------------------------------------------------
    def _channels_first(self, array: np.ndarray) -> torch.Tensor:
        """(..., H, W, C) numpy -> (..., C, H, W) on the device."""
        return self._to_device(array).movedim(-1, -3)

    @torch.no_grad()
    def _eval_frame(self, inputs: torch.Tensor, target: torch.Tensor,
                    patient: str):
        """One sample (leading batch axis of 1): its row of scalars and its
        denormalized (H, W) frame, on the device."""
        output = self.net(inputs)
        if isinstance(output, tuple):
            output = output[0]
        losses = self._sample_losses(output, target)
        d_out = self._denormalize(self._eval_output(output))
        d_tgt = self._denormalize(target)
        return (self._frame_scalars(losses, d_out, d_tgt, patient),
                d_out[0, 0])

    def _sequence_groups(self, dataset) -> list[tuple[str, str, list[int]]]:
        """Dataset-order runs of samples sharing (patient, slice id)."""
        groups: list[tuple[str, str, list[int]]] = []
        for i in range(len(dataset)):
            patient, sid, _ = dataset.sample_name(i)
            if not groups or (groups[-1][0], groups[-1][1]) != (patient, sid):
                groups.append((patient, sid, []))
            groups[-1][2].append(i)
        return groups

    def _record(self, results, log, patient, sid, fid, row, img) -> None:
        if results is not None:
            results.append([f"{patient}_2d_slice{sid}_frame{fid}"]
                           + [float(v) for v in row])
            self._save_png(patient, f"slice{sid}_frame{fid}.png", img)
        self._add_to_log(log, row)

    def _predict_sequences(self) -> dict:
        dataset = self.test_dataloader.dataset
        results = [self._csv_header()] if self.exported else None
        log = self._init_log()
        count = 0
        collate = self.test_dataloader.collate_fn
        for patient, sid, indices in self._sequence_groups(dataset):
            batch = collate([dataset.__getitem__(i, rng=None) for i in indices])
            inputs = self._channels_first(batch[self.input_key])
            targets = self._channels_first(batch["hr_img"])
            evaluated = [self._eval_frame(inputs[k:k + 1], targets[k:k + 1],
                                          patient)
                         for k in range(len(indices))]
            rows, imgs = self._to_host(
                torch.stack([e[0] for e in evaluated]),
                torch.stack([e[1] for e in evaluated]) if self.exported else None)
            for k, i in enumerate(indices):
                _, _, fid = dataset.sample_name(i)
                self._record(results, log, patient, sid, fid, rows[k],
                             None if imgs is None else imgs[k])
                count += 1
            if self.exported:
                self._dump_video(patient, sid, list(imgs))
        return self._finish(log, count, results)

    def predict(self) -> dict:
        if self.sequence_batch and not getattr(
                self.test_dataloader, "shuffle", False):
            return self._predict_sequences()
        dataset = self.test_dataloader.dataset
        results = [self._csv_header()] if self.exported else None
        sr_imgs: list[np.ndarray] = []
        last = None  # (slice id, patient) of the frames gathered in sr_imgs
        log = self._init_log()
        count = 0
        for batch in self.test_dataloader:
            index = int(np.asarray(batch["index"])[0])
            patient, sid, fid = dataset.sample_name(index)
            scalars, frame = self._eval_frame(
                self._channels_first(batch[self.input_key]),
                self._channels_first(batch["hr_img"]), patient)
            rows, imgs = self._to_host(
                scalars[None], frame[None] if self.exported else None)
            if self.exported:
                if last is not None and (sid, patient) != last:
                    self._dump_video(last[1], last[0], sr_imgs)
                    sr_imgs = []
                sr_imgs.append(imgs[0])
                last = (sid, patient)
            self._record(results, log, patient, sid, fid, rows[0],
                         None if imgs is None else imgs[0])
            count += 1
        if self.exported and sr_imgs:  # the trailing sequence
            self._dump_video(last[1], last[0], sr_imgs)
        return self._finish(log, count, results)


class SISRPredictor(ImagePredictor):
    """``lr_img (N, h, w, C)`` -> the HR frame."""


class SISRSRFBPredictor(ImagePredictor):
    """Feedback nets return (S, N, C, H, W): losses mean over steps, metrics
    and export on the last step."""

    def _sample_losses(self, output, target):
        return [torch.stack([fn(o, target) for o in output]).mean()
                for fn in self.loss_fns]

    def _eval_output(self, output):
        return output[-1]


class MISRPredictor(ImagePredictor):
    """Windows ``lr_imgs (N, T, h, w, C)`` -> the centre HR frame."""

    input_key = "lr_imgs"


class VSRPredictor(BasePredictor):
    """Whole-sequence evaluation with per-frame losses and metrics (a row
    per frame) and T-weighted log averaging."""

    def _row_name(self, patient: str, sid, t: int) -> str:
        return f"{patient}_2d_slice{sid}_frame{t + 1:0>2d}"

    def _export_sequence(self, imgs: np.ndarray, patient: str, sid) -> None:
        """imgs: the denormalized (T, H, W) uint8 SR frames."""
        self._dump_video(patient, sid, list(imgs))
        for t, img in enumerate(imgs):
            self._save_png(patient, f"slice{sid}_frame{t + 1:0>2d}.png", img)

    @torch.no_grad()
    def _eval_sequence(self, inputs, targets, patient: str):
        """(1, T, C, h, w) -> the (T, n scalars) rows and the (T, H, W)
        denormalized frames, on the device."""
        outputs = self.net(inputs)
        if isinstance(outputs, tuple):
            outputs = outputs[0]
        d_out, d_tgt = self._denormalize(outputs), self._denormalize(targets)
        rows = [self._frame_scalars(
            [fn(outputs[:, t], targets[:, t]) for fn in self.loss_fns],
            d_out[:, t], d_tgt[:, t], patient)
            for t in range(outputs.shape[1])]
        return torch.stack(rows), d_out[0, :, 0]

    def _sequence_tensors(self, batch: dict):
        """(1, T, h, w, C) numpy -> (1, T, C, h, w) on the device."""
        return (self._to_device(batch["lr_imgs"]).movedim(-1, -3),
                self._to_device(batch["hr_imgs"]).movedim(-1, -3))

    def predict(self) -> dict:
        dataset = self.test_dataloader.dataset
        results = [self._csv_header()] if self.exported else None
        log = self._init_log()
        count = 0
        for batch in self.test_dataloader:
            index = int(np.asarray(batch["index"])[0])
            patient, sid, _ = dataset.sample_name(index)
            scalars, frames = self._eval_sequence(
                *self._sequence_tensors(batch), patient)
            rows, imgs = self._to_host(scalars,
                                       frames if self.exported else None)
            t_frames = rows.shape[0]
            if self.exported:
                for t in range(t_frames):
                    results.append([self._row_name(patient, sid, t)]
                                   + [float(v) for v in rows[t]])
                self._export_sequence(imgs, patient, sid)
            self._add_to_log(log, rows.mean(axis=0), weight=t_frames)
            count += t_frames
        return self._finish(log, count, results)


class VolumePredictor(BasePredictor):
    """3D volumetric SR: one (H, W, D, C) volume per sample, a row per
    (patient, frame), losses and metrics on the whole denormalized volume
    (SSIM ``dim: 3`` applies directly); exports each SR volume as
    ``volumes/<patient>/frameNN_sr.nii.gz`` (H, W, D) and its middle slice
    as ``frameNN_mid.png``. The NIfTIs (gzip 9, a volume a frame) are
    written on a ``NiftiWriter``'s threads while the next frames run."""

    def predict(self) -> dict:
        with NiftiWriter() as writer:
            return self._predict(writer)

    def _predict(self, writer: NiftiWriter) -> dict:
        dataset = self.test_dataloader.dataset
        results = [self._csv_header()] if self.exported else None
        log = self._init_log()
        count = 0
        for batch in self.test_dataloader:
            index = int(np.asarray(batch["index"])[0])
            patient, _, fid = dataset.sample_name(index)
            with torch.no_grad():
                # (1, H, W, D, C) -> (1, C, D, H, W)
                inputs = self._to_device(batch["lr_vol"]).permute(0, 4, 3, 1, 2)
                targets = self._to_device(batch["hr_vol"]).permute(0, 4, 3, 1, 2)
                output = self.net(inputs)
                losses = [fn(output, targets) for fn in self.loss_fns]
                d_out = self._denormalize(output)
                scalars = self._frame_scalars(
                    losses, d_out, self._denormalize(targets), patient)
            rows, vols = self._to_host(
                scalars[None], d_out[:, 0] if self.exported else None)
            if self.exported:
                results.append([f"{patient}_frame{fid}"]
                               + [float(v) for v in rows[0]])
                vol = vols[0]  # (D, H, W)
                out_dir = self.saved_dir / "volumes" / patient
                out_dir.mkdir(parents=True, exist_ok=True)
                writer.save(np.moveaxis(vol, 0, -1).astype(np.float32),
                            out_dir / f"frame{fid}_sr.nii.gz")
                write_png(out_dir / f"frame{fid}_mid.png",
                          vol[vol.shape[0] // 2])
            self._add_to_log(log, rows[0])
            count += 1
        return self._finish(log, count, results)


class Volume4DPredictor(VSRPredictor):
    """4D spatio-temporal SR: whole volumetric sequences, per-frame losses
    and metrics (a row ``<patient>_frameTT`` per frame, T-weighted log),
    the SR sequence exported as one ``volumes/<patient>/sequence_sr.nii.gz``
    of (H, W, D, T)."""

    def _sequence_tensors(self, batch: dict):
        """(1, T, h, w, D, C) numpy -> (1, T, C, D, h, w) on the device."""
        return (self._to_device(batch["lr_vols"]).permute(0, 1, 5, 4, 2, 3),
                self._to_device(batch["hr_vols"]).permute(0, 1, 5, 4, 2, 3))

    def _row_name(self, patient: str, sid, t: int) -> str:
        return f"{patient}_frame{t + 1:0>2d}"

    def _export_sequence(self, imgs: np.ndarray, patient: str, sid) -> None:
        """imgs: the denormalized (T, D, H, W) uint8 SR volumes."""
        out_dir = self.saved_dir / "volumes" / patient
        out_dir.mkdir(parents=True, exist_ok=True)
        save_nifti(imgs.transpose(2, 3, 1, 0).astype(np.float32),
                   out_dir / "sequence_sr.nii.gz")


def _twin(base: type, name: str, stats: str) -> type:
    cls = type(name, (base,), {"dataset_stats": stats})
    register("predictor", name)(cls)
    return cls


AcdcSISRPredictor = _twin(SISRPredictor, "AcdcSISRPredictor", "acdc")
Dsb15SISRPredictor = _twin(SISRPredictor, "Dsb15SISRPredictor", "dsb15")
AcdcSISRSRFBPredictor = _twin(SISRSRFBPredictor, "AcdcSISRSRFBPredictor", "acdc")
Dsb15SISRSRFBPredictor = _twin(SISRSRFBPredictor, "Dsb15SISRSRFBPredictor", "dsb15")
AcdcMISRPredictor = _twin(MISRPredictor, "AcdcMISRPredictor", "acdc")
Dsb15MISRPredictor = _twin(MISRPredictor, "Dsb15MISRPredictor", "dsb15")
AcdcVSRPredictor = _twin(VSRPredictor, "AcdcVSRPredictor", "acdc")
Dsb15VSRPredictor = _twin(VSRPredictor, "Dsb15VSRPredictor", "dsb15")
Acdc3DSRPredictor = _twin(VolumePredictor, "Acdc3DSRPredictor", "acdc")
Dsb153DSRPredictor = _twin(VolumePredictor, "Dsb153DSRPredictor", "dsb15")
Acdc4DSRPredictor = _twin(Volume4DPredictor, "Acdc4DSRPredictor", "acdc")
Dsb154DSRPredictor = _twin(Volume4DPredictor, "Dsb154DSRPredictor", "dsb15")
