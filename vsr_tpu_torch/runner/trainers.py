"""Trainers: the epoch/step control loop (port of
``vsr_tpu/runner/trainers.py``: the trainer core, SISR, SISR with a
feedback net (SRFB), MISR, VSR, FRVSR, and the 3D and 4D volume trainers).

The same ``train()`` epoch loop as the JAX package (train epoch -> valid
epoch -> scheduler -> logger -> monitor-driven checkpoint -> early stop) and
the same subclass hooks (``_get_inputs_targets`` / ``_compute_losses`` /
``_compute_metrics``), with the per-dataset twins registered under the same
names.

The step: forward, weighted loss sum, backward, optimizer step, then the
metrics on denormalized ``clip(round(x * std + mean), 0, 255)`` outputs
under ``no_grad``. Scalar logs accumulate on the device, weighted by the
real batch size, and are read once per epoch: no host round trip per step.
Randomness comes from the explicit ``RngTree``; nothing reads global RNG
state. A net's BatchNorm running statistics are buffers: the train step
updates them (the port's ``BatchNorm``, flax's update), and the checkpoint
saves and restores them with the parameters, so resume and preemption
reproduce them. Batches arrive channels-last numpy; the trainer moves each to the
device (pinned memory, non-blocking) and permutes it to the nets' NCHW /
``(N, T, C, h, w)`` / ``(N, C, D, h, w)`` / ``(N, T, C, D, h, w)`` layout.

TF32 is off (constructing a trainer turns it off for cuDNN and cuBLAS,
process-wide, as the serving pipeline does). Parameters and optimizer state
are float32; a net may compute in bf16 (its ``dtype``, the precision policy
of ``models/common.py``, flax's mixed precision), and a net that holds
parameters of another dtype is refused. The JAX trainer pads validation
sequences to T buckets only to bound its recompiles; there is no compile
step here, so sequences run at their own length and ``t_bucket`` is not a
parameter. The parallel knobs of the JAX trainer (``mesh_axes``,
``pipe_microbatches``, ``zero_optim``, ``fsdp``, ``sharded_ckpt``) are not
ported yet and raise when passed.

The JAX trainer's optax chain runs as ``optim.GradientChain`` after the
backward: ``grad_accumulation`` (a running mean of the micro-gradients,
applied every k-th micro-step), ``grad_clip`` (optax's global-norm clip of
the accumulated gradient) and ``ema_decay`` (an EMA of the parameters after
each applied update, saved in the checkpoint for ``infer --ema``). ``qat``
runs every forward of the train and validation steps under the fake-quant
interceptor of ``quantize.py``.

``profile_dir`` records a ``torch.profiler`` trace of the second training
epoch into that directory (``utils/profiling.trace``); ``async_ckpt``
routes every save through ``utils/checkpoint.AsyncCheckpointWriter`` (an
on-device snapshot, the write on a thread), which ``train()`` drains at its
end and ``load()`` drains first. The device trainers inherit both.
"""

from __future__ import annotations

import contextlib
import logging
import signal
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np
import torch
from torch import nn

from vsr_tpu_torch.models.common import intercept_convs
from vsr_tpu_torch.optim import (GradientChain, OptimizerFactory, Scheduler,
                                 get_learning_rate, set_learning_rate)
from vsr_tpu_torch.registry import register
from vsr_tpu_torch.utils.checkpoint import (AsyncCheckpointWriter,
                                            load_checkpoint, save_checkpoint)
from vsr_tpu_torch.utils.normalize import DATASET_STATS
from vsr_tpu_torch.utils.profiling import trace
from vsr_tpu_torch.utils.rng import RngTree


def _detached(outputs):
    """A net's output, or tuple of outputs (FRVSR), off the graph."""
    if isinstance(outputs, tuple):
        return tuple(o.detach() for o in outputs)
    return outputs.detach()


def training_precision(net: nn.Module) -> None:
    """The trainers' precision policy: a net's parameters are float32
    (a bf16 net computes in bf16 and keeps them float32; a net that holds
    another dtype is refused), and TF32 is turned off for cuDNN and cuBLAS,
    process-wide."""
    bad = sorted({str(p.dtype) for p in net.parameters()
                  if p.dtype != torch.float32})
    if bad:
        raise ValueError(
            f"the trainer takes float32 parameters (a bf16 net computes in "
            f"bf16 and keeps them float32); this net holds {bad} parameters")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def qat_interceptor(qat, net: nn.Module):
    """The fake-quant interceptor of a trainer's ``qat`` option (``True`` or
    a dict, ``quantize.resolve_qat``), or ``None`` without it."""
    if not qat:
        return None
    from vsr_tpu_torch.quantize import resolve_qat

    return resolve_qat(qat, net)


def refuse_qat_with_pipe(qat, mesh_axes: dict | None) -> None:
    """QAT with a ``pipe`` mesh axis is refused, as in the JAX trainer (its
    pipelined apply would bypass the interceptor)."""
    if qat and "pipe" in (mesh_axes or {}):
        raise NotImplementedError(
            "qat does not compose with a 'pipe' mesh axis")


class TrainStep:
    """The train step of the host-loop and the device-epoch trainers. A
    subclass holds ``net``, ``optimizer``, its ``chain``
    (``optim.GradientChain``), ``loss_weights``, ``dataset_stats`` and
    ``_qat_interceptor`` and gives the ``_compute_losses`` /
    ``_compute_metrics`` hooks."""

    dataset_stats = "acdc"
    _qat_interceptor = None

    def _forward(self, inputs):
        """The net's forward, under the QAT interceptor when there is one."""
        ctx = (contextlib.nullcontext() if self._qat_interceptor is None
               else intercept_convs(self._qat_interceptor))
        with ctx:
            return self.net(inputs)

    def _compute_losses(self, outputs, targets) -> list:
        raise NotImplementedError

    def _compute_metrics(self, outputs, targets) -> list:
        raise NotImplementedError

    def _denorm(self, x: torch.Tensor) -> torch.Tensor:
        mean, std = DATASET_STATS[self.dataset_stats]
        return torch.clamp(torch.round(x * std + mean), 0.0, 255.0)

    def _scalars(self, total, losses, metrics) -> torch.Tensor:
        """The step's scalars in the order of ``_scalar_names``, one float32
        vector on the device."""
        return torch.stack([v.detach().float() for v in
                            (total, *losses, *metrics)])

    def _weighted_total(self, losses: list) -> torch.Tensor:
        return sum(w * l for w, l in zip(self.loss_weights, losses))

    def _train_step(self, inputs, targets):
        """One step. Returns (the scalars vector, the outputs, detached)."""
        self.net.train()
        outputs = self._forward(inputs)
        losses = self._compute_losses(outputs, targets)
        total = self._weighted_total(losses)
        self.optimizer.zero_grad(set_to_none=True)
        total.backward()
        self.chain.step()
        outputs = _detached(outputs)
        with torch.no_grad():
            metrics = self._compute_metrics(outputs, targets)
        return self._scalars(total, losses, metrics), outputs


class BaseTrainer(TrainStep):
    """Args mirror the JAX trainer. ``optimizer`` is the config's
    ``OptimizerFactory`` (bound to the net's parameters here) or a ready
    ``torch.optim.Optimizer``. ``device``: where the net trains (``cuda``
    unless the caller asks for ``cpu``)."""

    profile_dir = None
    _ckpt_writer = None  # an AsyncCheckpointWriter with async_ckpt

    def __init__(
        self,
        train_dataloader,
        valid_dataloader,
        net: nn.Module,
        loss_fns: Sequence,
        loss_weights: Sequence[float],
        metric_fns: Sequence,
        optimizer: OptimizerFactory | torch.optim.Optimizer,
        lr_scheduler: Scheduler | None,
        logger,
        monitor,
        num_epochs: int,
        random_seed: int | str = "vsr",
        device: str | torch.device = "cuda",
        prefetch_to_device: bool = True,
        mesh_axes: dict | None = None,
        pipe_microbatches: int | None = None,
        zero_optim: bool = False,
        fsdp: bool = False,
        qat: dict | bool | None = None,
        profile_dir: str | None = None,
        grad_accumulation: int = 1,
        grad_clip: float = 0.0,
        ema_decay: float | None = None,
        async_ckpt: bool = False,
        sharded_ckpt: bool = False,
    ):
        refuse_qat_with_pipe(qat, mesh_axes)
        for name, value in (("mesh_axes", mesh_axes),
                            ("pipe_microbatches", pipe_microbatches),
                            ("zero_optim", zero_optim), ("fsdp", fsdp),
                            ("sharded_ckpt", sharded_ckpt)):
            if value:
                raise NotImplementedError(
                    f"trainer {name} is not yet ported to vsr_tpu_torch")
        self.profile_dir = profile_dir
        # Non-blocking checkpoint writes: save() snapshots on the device and
        # a writer thread copies to the host and writes; the files equal
        # sync saves, and train() / load() drain the queue.
        self._ckpt_writer = AsyncCheckpointWriter() if async_ckpt else None
        self.device = torch.device(device)
        training_precision(net)
        self.prefetch_to_device = bool(prefetch_to_device)
        self.train_dataloader = train_dataloader
        self.valid_dataloader = valid_dataloader
        self.net = net.to(self.device)
        self._qat_interceptor = qat_interceptor(qat, self.net)
        self.loss_fns = list(loss_fns)
        self.loss_weights = [float(w) for w in loss_weights]
        self.metric_fns = list(metric_fns)
        if isinstance(optimizer, OptimizerFactory):
            optimizer = optimizer.bind(self.net.parameters())
        self.optimizer = optimizer
        self.chain = GradientChain(optimizer, self.net, grad_accumulation,
                                   grad_clip, ema_decay)
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            lr_scheduler.bind(get_learning_rate(optimizer))
        self.logger = logger
        self.monitor = monitor
        self.num_epochs = num_epochs
        self.rng_tree = RngTree(random_seed)
        self.epoch = 1
        self._scalar_names = ["Loss", *(fn.__class__.__name__
                                        for fn in (*self.loss_fns,
                                                   *self.metric_fns))]
        self._preempted = False
        # Step-granular preemption: progress of the interrupted epoch
        # ({"steps_done", "acc", "count", "total"}) stashed at the graceful
        # break, saved into model_preempt.ckpt, and replayed on resume so the
        # final parameters equal an uninterrupted run's.
        self._epoch_progress = None
        self._mid_epoch_resume = None

    # ---------------------------------------------------------------- hooks

    def _get_inputs_targets(self, batch: dict):
        raise NotImplementedError

    def _outputs_to_numpy(self, outputs: torch.Tensor) -> np.ndarray:
        """The net's channels-first outputs as the channels-last numpy the
        loggers take."""
        raise NotImplementedError

    def _host_outputs(self, outputs):
        """``_outputs_to_numpy`` of float32 copies (numpy has no bf16);
        None stays None (a device epoch keeps no batch for the logger)."""
        if outputs is None:
            return None
        if isinstance(outputs, tuple):
            return self._outputs_to_numpy(tuple(o.float() for o in outputs))
        return self._outputs_to_numpy(outputs.float())

    def _batch_weight(self, batch: dict) -> float:
        return float(batch["index"].shape[0])

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        tensor = torch.from_numpy(np.ascontiguousarray(array))
        if self.device.type == "cuda":
            return tensor.pin_memory().to(self.device, non_blocking=True)
        return tensor

    # ----------------------------------------------------------------- steps

    @torch.no_grad()
    def _eval_step(self, inputs, targets):
        self.net.eval()
        outputs = self._forward(inputs)
        losses = self._compute_losses(outputs, targets)
        metrics = self._compute_metrics(outputs, targets)
        return self._scalars(self._weighted_total(losses), losses,
                             metrics), outputs

    # ------------------------------------------------------------- epochs

    def _device_batches(self, iterator: Iterator[dict]) -> Iterator[tuple]:
        """(batch, inputs, targets) with the next batch's host-to-device
        copies already queued while the current one trains."""
        previous = None
        for batch in iterator:
            item = (batch, *self._get_inputs_targets(batch))
            if not self.prefetch_to_device:
                yield item
                continue
            if previous is not None:
                yield previous
            previous = item
        if previous is not None:
            yield previous

    def _run_epoch(self, mode: str, epoch: int):
        training = mode == "training"
        loader = self.train_dataloader if training else self.valid_dataloader
        skip, acc, count = 0, None, 0.0
        if training:
            self._epoch_progress = None
            if self._mid_epoch_resume is not None:
                # Step-granular preemption resume: replay exactly the
                # interrupted epoch's remaining batches, with the saved
                # scalar accumulators restored so the epoch log equals the
                # uninterrupted run's.
                mid = self._mid_epoch_resume
                self._mid_epoch_resume = None
                total = mid.get("batches_total")
                if total is not None and total != len(loader):
                    raise ValueError(
                        f"mid-epoch preemption checkpoint was written with "
                        f"{total} train batches/epoch but this run has "
                        f"{len(loader)}: batch size or dataset changed, so "
                        "replaying 'the remaining batches' is undefined; "
                        "resume from an epoch-boundary checkpoint instead")
                skip = int(mid["steps_done"])
                count = float(mid["count"])
                if mid["acc"]:
                    acc = torch.tensor(
                        [mid["acc"][k] for k in self._scalar_names],
                        dtype=torch.float32, device=self.device)
                logging.info(
                    f"Mid-epoch resume: skipping the {skip} already-"
                    f"trained batches of epoch {epoch}.")
        iterator = (loader.epoch(self.rng_tree, epoch, skip=skip)
                    if training else loader.epoch(None, epoch))
        batch = outputs = None
        for step_i, (batch, inputs, targets) in enumerate(
                self._device_batches(iterator)):
            step = self._train_step if training else self._eval_step
            scalars, outputs = step(inputs, targets)
            w = self._batch_weight(batch)
            acc = scalars * w if acc is None else acc + scalars * w
            count += w
            if training and self._preempted:
                # Graceful stop at a batch boundary: record how far the
                # epoch got (plus the device-resident accumulators) so the
                # preempt checkpoint can resume step-granular.
                self._epoch_progress = {
                    "steps_done": skip + step_i + 1,
                    "acc": acc, "count": count, "total": len(loader),
                }
                break
        # The epoch's one read of the device-resident scalars.
        values = [] if acc is None else acc.tolist()
        log = {k: v / count for k, v in zip(self._scalar_names, values)}
        return log, batch, outputs

    def _install_preemption_handlers(self) -> dict:
        """SIGTERM/SIGINT request a graceful stop: the current batch
        finishes, a ``model_preempt.ckpt`` is written, and train() returns.
        A SECOND signal restores the previous handlers and delivers
        normally, so a stuck run stays interruptible."""
        previous = {}

        def handler(signum, frame):
            if self._preempted:  # second signal: escalate
                self._restore_handlers(previous)
                logging.warning(f"Second signal {signum}: escalating.")
                signal.raise_signal(signum)
                return
            logging.warning(
                f"Received signal {signum}: checkpointing and stopping at "
                f"the next batch boundary (send again to force).")
            self._preempted = True

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                previous[sig] = signal.signal(sig, handler)
            except ValueError:  # not the main thread
                pass
        return previous

    def _restore_handlers(self, previous: dict) -> None:
        for sig, old in previous.items():
            signal.signal(sig, old)

    def _save_preempt_checkpoint(self) -> None:
        if self.monitor is None:
            logging.warning("Preempted with no monitor: nothing saved.")
            return
        path = Path(self.monitor.checkpoints_dir) / "model_preempt.ckpt"
        progress, self._epoch_progress = self._epoch_progress, None
        if progress and progress["steps_done"] < progress["total"]:
            # STEP-GRANULAR preemption: the checkpoint records how many of
            # the interrupted epoch's batches were applied plus the scalar
            # accumulators; resume replays exactly the remaining batches
            # (the epoch's batch order is a pure function of the seed). aux
            # epoch is the LAST COMPLETED epoch; the mid_epoch marker makes
            # load() re-enter the interrupted one.
            mid = {
                "steps_done": int(progress["steps_done"]),
                "count": float(progress["count"]),
                "acc": dict(zip(self._scalar_names, progress["acc"].tolist())),
                # Replay is defined only under the SAME batch partitioning
                # (resume validates this before skipping).
                "batches_total": int(progress["total"]),
            }
            self.save(path, epoch=self.epoch - 1, extra_aux={"mid_epoch": mid})
            logging.info(
                f"Preemption checkpoint saved to {path} (resume replays "
                f"epoch {self.epoch} from batch {mid['steps_done']}).")
            return
        # Preempted exactly at the epoch's last batch: the epoch is DONE
        # (validation/monitor skipped); resume starts the next.
        self.save(path, epoch=self.epoch)
        logging.info(f"Preemption checkpoint saved to {path} "
                     f"(resume continues at epoch {self.epoch + 1}).")

    def train(self) -> None:
        self._preempted = False
        previous_handlers = self._install_preemption_handlers()
        try:
            self._train_loop()
        finally:
            self._restore_handlers(previous_handlers)
            # Async writes must land before the process can exit (the
            # preemption checkpoint and the last epoch's saves).
            self.wait_for_checkpoints()

    def _train_loop(self) -> None:
        while self.epoch <= self.num_epochs:
            logging.info(f"Epoch {self.epoch}.")
            # A trace of the second training epoch (the first pays the
            # one-time costs: kernel builds, cuDNN's autotuning, captures).
            profiled = self.profile_dir if self.epoch == 2 else None
            with trace(profiled):
                train_log, train_batch, train_outputs = self._run_epoch(
                    "training", self.epoch)
            if self._preempted:
                self._save_preempt_checkpoint()
                break
            logging.info(f"Train log: { {k: round(v, 5) for k, v in train_log.items()} }.")
            valid_log, valid_batch, valid_outputs = self._run_epoch(
                "validation", self.epoch)
            logging.info(f"Valid log: { {k: round(v, 5) for k, v in valid_log.items()} }.")

            if self.lr_scheduler is not None:
                metric = valid_log.get("Loss") if self.lr_scheduler.needs_metric else None
                set_learning_rate(self.optimizer, self.lr_scheduler.step(metric))

            if self.logger is not None:
                self.logger.write(
                    self.epoch, train_log, train_batch,
                    self._host_outputs(train_outputs),
                    valid_log, valid_batch,
                    self._host_outputs(valid_outputs))

            saved_path = self.monitor.is_saved(self.epoch)
            if saved_path:
                logging.info(f"Save the checkpoint to {saved_path}.")
                self.save(saved_path)

            saved_path = self.monitor.is_best(valid_log)
            if saved_path:
                logging.info(
                    f"Save the best checkpoint to {saved_path} "
                    f"({self.monitor.mode} {self.monitor.target}: {self.monitor.best})."
                )
                self.save(saved_path)

            if self.monitor.is_early_stopped():
                logging.info("Early stopped.")
                break
            self.epoch += 1
        if self.logger is not None:
            self.logger.close()

    # ----------------------------------------------------------- checkpoint

    def save(self, path: str | Path, epoch: int | None = None,
             extra_aux: dict | None = None) -> None:
        aux = {
            "epoch": self.epoch if epoch is None else epoch,
            "monitor": self.monitor.state_dict(),
            "lr_scheduler": self.lr_scheduler.state_dict() if self.lr_scheduler else None,
            "random_seed": str(self.rng_tree.root_seed),
            **(extra_aux or {}),
        }
        state = {"net": self.net.state_dict(),
                 "optimizer": self._optimizer_state(),
                 "chain": self.chain.state_dict()}
        if self._ckpt_writer is not None:
            self._ckpt_writer.submit(path, state, aux)
            return
        save_checkpoint(path, state, aux)

    def wait_for_checkpoints(self) -> None:
        """Drain pending async checkpoint writes (no-op for sync saves)."""
        if self._ckpt_writer is not None:
            self._ckpt_writer.wait()

    def _optimizer_state(self) -> dict:
        return self.optimizer.state_dict()

    def _load_optimizer_state(self, state: dict) -> None:
        self.optimizer.load_state_dict(state)

    def load(self, path: str | Path) -> None:
        # A just-submitted async write to this very file must land first.
        self.wait_for_checkpoints()
        state, aux = load_checkpoint(path, map_location=self.device)
        self.net.load_state_dict(state["net"], strict=True)
        self._load_optimizer_state(state["optimizer"])
        self.chain.load_state_dict(state.get("chain"))
        self.epoch = aux["epoch"] + 1
        if aux.get("mid_epoch"):
            # Step-granular preemption checkpoint: aux epoch is the last
            # COMPLETED epoch, so self.epoch is the interrupted one;
            # _run_epoch replays its remaining batches.
            self._mid_epoch_resume = dict(aux["mid_epoch"])
        self.monitor.load_state_dict(aux["monitor"])
        if self.lr_scheduler is not None and aux.get("lr_scheduler"):
            self.lr_scheduler.load_state_dict(aux["lr_scheduler"])


class SISRTrainer(BaseTrainer):
    """lr_img -> hr_img; metrics on denormalized [0, 255] tensors."""

    def _get_inputs_targets(self, batch):
        # (N, h, w, C) -> (N, C, h, w)
        return (self._to_device(batch["lr_img"]).permute(0, 3, 1, 2),
                self._to_device(batch["hr_img"]).permute(0, 3, 1, 2))

    def _outputs_to_numpy(self, outputs):
        return outputs.permute(0, 2, 3, 1).cpu().numpy()

    def _compute_losses(self, outputs, targets):
        return [fn(outputs, targets) for fn in self.loss_fns]

    def _compute_metrics(self, outputs, targets):
        o, t = self._denorm(outputs), self._denorm(targets)
        return [fn(o, t) for fn in self.metric_fns]


class SISRSRFBTrainer(SISRTrainer):
    """Feedback nets return (S, N, C, H, W) step stacks: every loss is the
    mean over the steps, metrics on the last step."""

    def _outputs_to_numpy(self, outputs):
        return outputs.permute(0, 1, 3, 4, 2).cpu().numpy()

    def _compute_losses(self, outputs, targets):
        return [torch.stack([fn(o, targets) for o in outputs]).mean()
                for fn in self.loss_fns]

    def _compute_metrics(self, outputs, targets):
        return super()._compute_metrics(outputs[-1], targets)


class MISRTrainer(SISRTrainer):
    """The window ``lr_imgs`` -> the centre ``hr_img``."""

    def _get_inputs_targets(self, batch):
        # (N, T, h, w, C) -> (N, T, C, h, w); (N, H, W, C) -> (N, C, H, W)
        return (self._to_device(batch["lr_imgs"]).permute(0, 1, 4, 2, 3),
                self._to_device(batch["hr_img"]).permute(0, 3, 1, 2))


class VSRTrainer(BaseTrainer):
    """lr_imgs -> hr_imgs sequences; losses and metrics are means over the
    frames of per-frame values and log weights are batch * T. Validation
    feeds whole sequences of any length."""

    def _get_inputs_targets(self, batch):
        # (N, T, h, w, C) -> (N, T, C, h, w)
        return (self._to_device(batch["lr_imgs"]).permute(0, 1, 4, 2, 3),
                self._to_device(batch["hr_imgs"]).permute(0, 1, 4, 2, 3))

    def _outputs_to_numpy(self, outputs):
        return outputs.permute(0, 1, 3, 4, 2).cpu().numpy()

    def _batch_weight(self, batch):
        lr = batch["lr_imgs"]
        return float(lr.shape[0] * lr.shape[1])

    @staticmethod
    def _frame_mean(fn, outputs, targets):
        """Mean over the frames of the per-frame scalar ``fn``."""
        return torch.stack([fn(outputs[:, t], targets[:, t])
                            for t in range(outputs.shape[1])]).mean()

    def _compute_losses(self, outputs, targets):
        return [self._frame_mean(fn, outputs, targets) for fn in self.loss_fns]

    def _compute_metrics(self, outputs, targets):
        o, t = self._denorm(outputs), self._denorm(targets)
        return [self._frame_mean(fn, o, t) for fn in self.metric_fns]


class FRVSRTrainer(VSRTrainer):
    """FRVSR returns ``(sr, warped_lr)``: a ``FlowLoss`` compares the warped
    LR frames with the LR input, every other loss SR with HR; the metrics
    are on SR only. Targets are the pair ``(lr, hr)``."""

    def _get_inputs_targets(self, batch):
        lr, hr = super()._get_inputs_targets(batch)
        return lr, (lr, hr)

    def _outputs_to_numpy(self, outputs):
        return tuple(super(FRVSRTrainer, self)._outputs_to_numpy(o)
                     for o in outputs)

    def _compute_losses(self, outputs, targets):
        (sr, warped), (lr, hr) = outputs, targets
        return [self._frame_mean(fn, warped, lr)
                if fn.__class__.__name__ == "FlowLoss"
                else self._frame_mean(fn, sr, hr) for fn in self.loss_fns]

    def _compute_metrics(self, outputs, targets):
        return super()._compute_metrics(outputs[0], targets[1])


class VolumeTrainer(SISRTrainer):
    """3D volumetric SR: ``lr_vol`` -> ``hr_vol``, (N, H, W, D, C) batches
    permuted to the net's (N, C, D, H, W); losses and metrics on whole
    volumes (SSIM ``dim: 3`` applies directly). The logger gets the
    outputs as (N, D, H, W, C), the JAX net's layout."""

    def _get_inputs_targets(self, batch):
        return (self._to_device(batch["lr_vol"]).permute(0, 4, 3, 1, 2),
                self._to_device(batch["hr_vol"]).permute(0, 4, 3, 1, 2))

    def _outputs_to_numpy(self, outputs):
        return outputs.permute(0, 2, 3, 4, 1).cpu().numpy()


class Volume4DTrainer(VSRTrainer):
    """4D spatio-temporal SR: (N, T, H, W, D, C) batches permuted to the
    net's (N, T, C, D, H, W); losses and metrics are means over the frames
    of per-frame volume values, log weights batch * T, as in the VSR
    trainer. The logger gets (N, T, D, H, W, C)."""

    def _get_inputs_targets(self, batch):
        return (self._to_device(batch["lr_vols"]).permute(0, 1, 5, 4, 2, 3),
                self._to_device(batch["hr_vols"]).permute(0, 1, 5, 4, 2, 3))

    def _outputs_to_numpy(self, outputs):
        return outputs.permute(0, 1, 3, 4, 5, 2).cpu().numpy()

    def _batch_weight(self, batch):
        lr = batch["lr_vols"]
        return float(lr.shape[0] * lr.shape[1])


def _make_dataset_twin(base: type, name: str, stats: str) -> type:
    cls = type(name, (base,), {"dataset_stats": stats})
    register("trainer", name)(cls)
    return cls


AcdcSISRTrainer = _make_dataset_twin(SISRTrainer, "AcdcSISRTrainer", "acdc")
Dsb15SISRTrainer = _make_dataset_twin(SISRTrainer, "Dsb15SISRTrainer", "dsb15")
AcdcSISRSRFBTrainer = _make_dataset_twin(SISRSRFBTrainer,
                                         "AcdcSISRSRFBTrainer", "acdc")
Dsb15SISRSRFBTrainer = _make_dataset_twin(SISRSRFBTrainer,
                                          "Dsb15SISRSRFBTrainer", "dsb15")
AcdcMISRTrainer = _make_dataset_twin(MISRTrainer, "AcdcMISRTrainer", "acdc")
Dsb15MISRTrainer = _make_dataset_twin(MISRTrainer, "Dsb15MISRTrainer",
                                      "dsb15")
AcdcVSRTrainer = _make_dataset_twin(VSRTrainer, "AcdcVSRTrainer", "acdc")
Dsb15VSRTrainer = _make_dataset_twin(VSRTrainer, "Dsb15VSRTrainer", "dsb15")
AcdcFRVSRTrainer = _make_dataset_twin(FRVSRTrainer, "AcdcFRVSRTrainer",
                                      "acdc")
Dsb15FRVSRTrainer = _make_dataset_twin(FRVSRTrainer, "Dsb15FRVSRTrainer",
                                       "dsb15")
Acdc3DSRTrainer = _make_dataset_twin(VolumeTrainer, "Acdc3DSRTrainer", "acdc")
Dsb153DSRTrainer = _make_dataset_twin(VolumeTrainer, "Dsb153DSRTrainer",
                                      "dsb15")
Acdc4DSRTrainer = _make_dataset_twin(Volume4DTrainer, "Acdc4DSRTrainer",
                                     "acdc")
Dsb154DSRTrainer = _make_dataset_twin(Volume4DTrainer, "Dsb154DSRTrainer",
                                      "dsb15")
