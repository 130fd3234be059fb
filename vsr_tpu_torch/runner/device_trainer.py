"""Device-epoch training (port of ``vsr_tpu/runner/device_trainer.py``).

The whole train split is resident in device memory as raw [0, 255] float32
buffers in the nets' channel-first layout, and each epoch samples, crops,
flips and normalizes its batches on the device:

    draw the epoch's indices, crop offsets and flips in one go
    -> per step: gather -> paired crop (HR offsets = LR offsets x ratio,
       depth and time untouched) -> flips -> (x - mean) / (std + 1e-10)
       -> forward -> loss -> backward -> optimizer step -> metric sums

The JAX package runs that loop as one ``lax.scan`` program. Here, on a CUDA
device, the step (sampling included) is captured once per trainer as a CUDA
graph, after a few eager warm-up steps that are real steps of the first
epoch, and the graph is replayed for every later step: between replays only
a device step counter moves, which selects the step's draws from static
buffers. The host reads the epoch's per-step scalars once, at the end of
the epoch. On the CPU the same step runs eagerly. A capture that fails
raises: there is no eager fallback on the card.

Capturing the optimizer step needs a capturable step: on the card the
trainer rebuilds the optimizer with the learning rate as a device tensor,
which ``optim.set_learning_rate`` fills in place, so a scheduler's change
reaches the replayed step (``capturable=True`` where ``torch.optim`` has
the mode; ``optim.CapturableSGD`` and ``CapturableAdagrad`` for ``SGD`` and
``Adagrad``). The gradient chain (accumulation, clip, EMA) and QAT's
fake-quant convs run inside the captured step. Checkpoints are written in
the host-loop trainers' optimizer format (float learning rate, host step
counts) and read from it, so they interchange with those trainers both
ways.

The draws come from a ``torch.Generator`` on the trainer's device, seeded
from the ``RngTree`` under ``("device-epoch", epoch)``: a run is
deterministic by seed, not bit-equal to the JAX package's draws nor to the
host-loop loader's. ``draw_batch`` and ``apply_draws`` are split so that a
test can feed another package's draws.

``DeviceEpochTrainer`` is the standalone trainer over given buffers;
``DeviceTrainerMixin`` is the config-driven one, mixed into the task
trainers (validation, checkpoints, monitor, logger and scheduler inherited),
under the 14 ``*DeviceTrainer`` names of the JAX package.
"""

from __future__ import annotations

import gc
import logging
from typing import Sequence

import numpy as np
import torch

from vsr_tpu_torch.optim import (CAPTURABLE, GradientChain,
                                 OptimizerFactory)
from vsr_tpu_torch.registry import register
from vsr_tpu_torch.runner import trainers
from vsr_tpu_torch.utils.normalize import DATASET_STATS
from vsr_tpu_torch.utils.rng import RngTree

#: Eager steps before the capture: they initialize the optimizer's state,
#: the library workspaces and the kernels' one-time settings outside it.
WARMUP_STEPS = 3

_SAMPLE_KEYS = (("lr_img", "lr_imgs", "lr_vol", "lr_vols"),
                ("hr_img", "hr_imgs", "hr_vol", "hr_vols"))


# ------------------------------------------------------------------ buffers


def stack_dataset(dataset, limit: int | None = None,
                  indices=None) -> tuple[np.ndarray, np.ndarray]:
    """A dataset's (lr, hr) samples stacked into two dense channels-last
    arrays (``indices`` restricts the stacking to those samples)."""
    if indices is None:
        n = len(dataset) if limit is None else min(limit, len(dataset))
        indices = range(n)
    lrs, hrs = [], []
    for i in indices:
        s = dataset.__getitem__(i, rng=None)
        lrs.append(next(s[k] for k in _SAMPLE_KEYS[0] if k in s))
        hrs.append(next(s[k] for k in _SAMPLE_KEYS[1] if k in s))
    return np.stack(lrs), np.stack(hrs)


def stack_dataset_raw(dataset, limit: int | None = None, indices=None):
    """``stack_dataset`` with the dataset's transforms and augments bypassed
    (a bare ToTensor, identity augments), so the buffers hold the raw
    [0, 255] frames that the device epoch crops, flips and normalizes."""
    from vsr_tpu_torch.data.transforms import compose

    old_t, old_a = dataset.transforms, dataset.augments
    dataset.transforms = compose(None)  # ToTensor only
    dataset.augments = lambda *imgs, rng=None: imgs
    try:
        return stack_dataset(dataset, limit, indices)
    finally:
        dataset.transforms, dataset.augments = old_t, old_a


# ----------------------------------------------------------------- sampling


def draw_batch(generator: torch.Generator, m: int, batch: int | tuple,
               h: int, w: int, patch: int) -> tuple[torch.Tensor, ...]:
    """``(idx, y0, x0, hflip, vflip)`` of shape ``batch`` (an int, or a
    tuple such as ``(steps, batch)`` for a whole epoch): sample indices in
    [0, m), LR crop offsets in [0, h - patch] and [0, w - patch], and two
    fair coin flips, drawn on the generator's device."""
    if patch > h or patch > w:
        raise ValueError(f"patch {patch} exceeds the buffers' LR size "
                         f"{h} x {w}")
    shape = (batch,) if isinstance(batch, int) else tuple(batch)
    kw = dict(generator=generator, device=generator.device)
    return (torch.randint(0, m, shape, **kw),
            torch.randint(0, h - patch + 1, shape, **kw),
            torch.randint(0, w - patch + 1, shape, **kw),
            torch.rand(shape, **kw) < 0.5,
            torch.rand(shape, **kw) < 0.5)


def epoch_draws(rng_tree: RngTree, epoch: int, lr_buf: torch.Tensor,
                steps: int, batch: int, patch: int,
                window: int | None = None) -> list[torch.Tensor]:
    """An epoch's ``(steps, batch)`` draws for ``lr_buf`` from the generator
    ``("device-epoch", epoch)`` on its device, and with ``window`` the
    windows' start frames."""
    gen = rng_tree.torch_generator("device-epoch", epoch,
                                   device=lr_buf.device)
    h, w = lr_buf.shape[-2:]
    draws = list(draw_batch(gen, lr_buf.shape[0], (steps, batch), h, w,
                            patch))
    if window is not None:
        draws.append(torch.randint(0, lr_buf.shape[1], (steps, batch),
                                   generator=gen, device=lr_buf.device))
    return draws


def _crop(x: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
          size: int) -> torch.Tensor:
    """Per-sample ``x[b, ..., y0:y0+size, x0:x0+size]`` as two gathers."""
    b, h, w = x.shape[0], x.shape[-2], x.shape[-1]
    flat = x.reshape(b, -1, h, w)
    span = torch.arange(size, device=x.device)
    rows = (y0[:, None] + span)[:, None, :, None]
    flat = flat.gather(2, rows.expand(b, flat.shape[1], size, w))
    cols = (x0[:, None] + span)[:, None, None, :]
    flat = flat.gather(3, cols.expand(b, flat.shape[1], size, size))
    return flat.reshape(*x.shape[:-2], size, size)


def _flip(x: torch.Tensor, hflip: torch.Tensor,
          vflip: torch.Tensor) -> torch.Tensor:
    view = (-1,) + (1,) * (x.dim() - 1)
    x = torch.where(hflip.view(view), x.flip(-1), x)
    return torch.where(vflip.view(view), x.flip(-2), x)


def take_windows(x: torch.Tensor, t0: torch.Tensor,
                 window: int) -> torch.Tensor:
    """``window`` frames of each (T_full, ...) sequence from ``t0`` on,
    wrapping around the end (the circular windows of the JAX sampler)."""
    t_full = x.shape[1]
    tidx = (t0[:, None] + torch.arange(window, device=x.device)) % t_full
    tidx = tidx.view(*tidx.shape, *[1] * (x.dim() - 2))
    return x.gather(1, tidx.expand(-1, -1, *x.shape[2:]))


def apply_draws(lr_buf: torch.Tensor, hr_buf: torch.Tensor, draws,
                patch: int, ratio: int, stats: tuple[float, float],
                window: int | None = None, t0: torch.Tensor | None = None):
    """One batch from the resident buffers and one step's draws: the
    gather, (with ``window``) the circular windows from ``t0``, the paired
    crop on the last two axes (HR offsets and size x ``ratio``), the flips
    (``hflip`` the last axis, ``vflip`` the one before) and
    ``(x - mean) / (std + 1e-10)``. Returns ``(lr, hr)``."""
    idx, y0, x0, hflip, vflip = draws
    lr, hr = lr_buf.index_select(0, idx), hr_buf.index_select(0, idx)
    if window is not None:
        lr, hr = take_windows(lr, t0, window), take_windows(hr, t0, window)
    lr = _flip(_crop(lr, y0, x0, patch), hflip, vflip)
    hr = _flip(_crop(hr, y0 * ratio, x0 * ratio, patch * ratio), hflip,
               vflip)
    mean, std = stats
    # Times the float32 reciprocal: the jitted JAX sampler's arithmetic (XLA
    # turns the division by a constant into that product), bit for bit.
    scale = float(np.float32(1.0) / np.float32(std + 1e-10))
    return (lr - mean) * scale, (hr - mean) * scale


# -------------------------------------------------------------- the engine


def check_scan_unroll(scan_unroll) -> None:
    """The frame loops are Python loops, which give the same numbers as any
    unroll of the JAX scan: "auto", 0 and 1 are taken, and any other value
    is refused."""
    if scan_unroll not in ("auto", 0, 1):
        raise NotImplementedError(
            f"scan_unroll={scan_unroll!r} is a TPU lax.scan knob; the port's "
            "frame loops are Python loops (accepted: 'auto', 0, 1)")


def make_capturable(optimizer: torch.optim.Optimizer,
                    device: torch.device) -> torch.optim.Optimizer:
    """The same optimizer rebuilt for a captured step, with each group's
    learning rate a tensor on ``device``, so that a new learning rate still
    reaches the replays: ``capturable=True`` where ``torch.optim`` has the
    mode, the port's ``optim.CapturableSGD`` / ``CapturableAdagrad`` for
    ``SGD`` and ``Adagrad``, which have none."""
    cls = CAPTURABLE.get(type(optimizer), type(optimizer))
    capturable = "capturable" in optimizer.defaults
    if cls is type(optimizer) and not capturable:
        raise NotImplementedError(
            f"{type(optimizer).__name__} has no capturable mode: a device "
            "epoch on the card replays a captured optimizer step (use one "
            "of the optimizers of vsr_tpu_torch.optim)")
    if any(float(st["step"]) > 0 if "step" in st else bool(st)
           for st in optimizer.state.values()):
        raise ValueError("make_capturable takes an optimizer that has not "
                         "stepped yet")
    groups = [{**g, "lr": torch.tensor(float(g["lr"]), device=device),
               **({"capturable": True} if capturable else {})}
              for g in optimizer.param_groups]
    return cls(groups)


def host_optimizer_state(state: dict) -> dict:
    """An optimizer state dict in the host-loop trainers' format: float
    learning rates, ``capturable`` off, step counts as host float32."""
    groups = [{**g, "lr": float(g["lr"]),
               **({"capturable": False} if "capturable" in g else {})}
              for g in state["param_groups"]]
    per_param = {k: {**v, "step": v["step"].detach().to("cpu", torch.float32)}
                 if torch.is_tensor(v.get("step")) else v
                 for k, v in state["state"].items()}
    return {"state": per_param, "param_groups": groups}


def load_capturable_state(optimizer: torch.optim.Optimizer,
                          state: dict) -> None:
    """Load a host-format (or capturable) state dict into a capturable
    optimizer, keeping its learning-rate tensors (filled with the loaded
    values) and moving step counts to the parameters' device."""
    lrs = [g["lr"] for g in optimizer.param_groups]
    capturable = ({"capturable": True} if "capturable" in optimizer.defaults
                  else {})
    optimizer.load_state_dict({
        "state": state["state"],
        "param_groups": [{**g, **capturable}
                         for g in state["param_groups"]]})
    for group, lr in zip(optimizer.param_groups, lrs):
        lr.fill_(float(group["lr"]))
        group["lr"] = lr
    for param, st in optimizer.state.items():
        if torch.is_tensor(st.get("step")):
            st["step"] = st["step"].to(param.device, torch.float32)


class EpochEngine:
    """Runs epochs of ``step(inputs, hr) -> scalars`` over resident buffers,
    the batches cut by ``apply_draws``. On a CUDA device the step is
    captured after ``warmup`` eager steps (on a side stream, as capture
    asks; at least ``WARMUP_STEPS``) and replayed. A step that takes one of
    several courses, decided on the host, gives one graph per course:
    ``graph_key()`` names the course of the next step, and ``after_replay()``
    moves the host state that the step's Python moves and a replay does not
    (the gradient chain's micro-step: an accumulate-only step and an
    accumulate-then-apply step, ``optim.GradientChain``). ``eager_steps``,
    ``captures`` and ``replays`` count what ran. ``log`` holds the last
    epoch's per-step scalars ``(steps, n)`` on the device. ``use_graph`` is
    not a setting of the trainers: a test clears it to hold the graphs
    against eager steps. ``before_capture()`` runs before each capture (the
    trainers drain their async checkpoint writer there: no other thread may
    copy from the device while a capture runs)."""

    def __init__(self, step, lr_buf: torch.Tensor, hr_buf: torch.Tensor,
                 patch: int, ratio: int, stats: tuple[float, float],
                 steps: int, n_scalars: int, window: int | None = None,
                 graph_key=lambda: None, after_replay=lambda: None,
                 warmup: int = WARMUP_STEPS, before_capture=lambda: None):
        self.step = step
        self.lr_buf, self.hr_buf = lr_buf, hr_buf
        self.patch, self.ratio, self.stats = patch, ratio, stats
        self.steps, self.window = steps, window
        self.graph_key, self.after_replay = graph_key, after_replay
        self.before_capture = before_capture
        self.warmup = max(int(warmup), WARMUP_STEPS)
        self.device = lr_buf.device
        self.use_graph = self.device.type == "cuda"
        self.counter = torch.zeros(1, dtype=torch.long, device=self.device)
        self.log = torch.zeros(steps, n_scalars, device=self.device)
        self.draws: list[torch.Tensor] | None = None
        self.graphs: dict = {}
        self.eager_steps = self.captures = self.replays = 0

    def reset(self) -> None:
        """Drop the captured graphs (the state they read was replaced):
        the next steps warm up and capture again."""
        self.graphs = {}
        self.eager_steps = 0

    def _one_step(self) -> None:
        step_draws = [d.index_select(0, self.counter)[0] for d in self.draws]
        inputs, hr = apply_draws(
            self.lr_buf, self.hr_buf, step_draws[:5], self.patch, self.ratio,
            self.stats, self.window,
            step_draws[5] if self.window is not None else None)
        scalars = self.step(inputs, hr)
        self.log.index_copy_(0, self.counter, scalars.detach()[None])
        self.counter.add_(1)

    def _eager_step(self) -> None:
        if self.use_graph:
            current = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                self._one_step()
            current.wait_stream(side)
        else:
            self._one_step()
        self.eager_steps += 1

    def _capture(self) -> torch.cuda.CUDAGraph:
        """Capture the next step; its Python runs once, moving the host
        state as an eager step does. The garbage collector stays off for
        the capture (``torch.cuda.graph`` collects once before it begins):
        a collection inside it that frees an earlier trainer's graphs
        releases their memory pool mid-capture and invalidates it."""
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                self._one_step()
        finally:
            if collecting:
                gc.enable()
        self.captures += 1
        return graph

    def run(self, draws: Sequence[torch.Tensor]) -> torch.Tensor:
        """One epoch from ``draws`` (``(steps, batch)`` tensors: idx, y0,
        x0, hflip, vflip, and t0 with ``window``). Returns ``log``."""
        draws = [d.to(self.device) for d in draws]
        if self.draws is None:
            self.draws = [d.clone() for d in draws]
        else:
            for static, d in zip(self.draws, draws):
                static.copy_(d)
        self.counter.zero_()
        for _ in range(self.steps):
            if not self.use_graph or (not self.graphs and
                                      self.eager_steps < self.warmup):
                self._eager_step()
                continue
            key = self.graph_key()
            graph = self.graphs.get(key)
            if graph is None:
                self.before_capture()
                graph = self.graphs[key] = self._capture()
            else:
                self.after_replay()
            graph.replay()
            self.replays += 1
        return self.log


# ------------------------------------------------------ standalone trainer


class DeviceEpochTrainer(trainers.TrainStep):
    """Epochs over given resident ``(lr, hr)`` buffers, through the
    host-loop trainers' step.

    Args:
        net: a net of the port (float32 parameters; any compute dtype).
        loss_fns / loss_weights / metric_fns: as in the host-loop trainers;
            a tuple output is scored on its first member.
        optimizer: an ``OptimizerFactory`` or an unstepped optimizer.
        lr_data / hr_data: buffers in the nets' channel-first layout,
            ``(M, C, h, w)``, ``(M, T, C, h, w)``, ``(M, C, D, h, w)`` or
            ``(M, T, C, D, h, w)`` (HR with the last two axes x ``ratio``).
        batch_size, patch, ratio: the sampler (patch = LR crop size).
        window: with whole-sequence buffers ``(M, T_full, C, h, w)``, each
            sample is ``window`` frames from a random start, wrapping.
        scan_unroll: "auto", 0 or 1 (``check_scan_unroll``).
        qat: ``True`` or a dict of ``quantize.resolve_qat``: the step's
            forward runs the fake-quant convs. ``device``: ``cuda`` unless
            the caller asks for ``cpu``.
        grad_accumulation: ``optim.GradientChain``'s micro-steps an update
            (two captured graphs on the card, as in the config trainers).
    """

    def __init__(self, net, loss_fns: Sequence, loss_weights: Sequence[float],
                 metric_fns: Sequence, optimizer, lr_data, hr_data,
                 batch_size: int, patch: int, ratio: int,
                 steps_per_epoch: int | None = None,
                 dataset_stats: str = "acdc", random_seed: int | str = "vsr",
                 window: int | None = None, scan_unroll: int | str = "auto",
                 qat: dict | bool | None = None,
                 device: str | torch.device = "cuda",
                 grad_accumulation: int = 1):
        check_scan_unroll(scan_unroll)
        self.device = torch.device(device)
        trainers.training_precision(net)
        self.net = net.to(self.device)
        self._qat_interceptor = trainers.qat_interceptor(qat, self.net)
        self.loss_fns = list(loss_fns)
        self.loss_weights = [float(w) for w in loss_weights]
        self.metric_fns = list(metric_fns)
        if isinstance(optimizer, OptimizerFactory):
            optimizer = optimizer.bind(self.net.parameters())
        self.optimizer = (make_capturable(optimizer, self.device)
                          if self.device.type == "cuda" else optimizer)
        self.chain = GradientChain(self.optimizer, self.net,
                                   grad_accumulation)
        self.lr_buf = torch.as_tensor(np.asarray(lr_data, np.float32)).to(
            self.device)
        self.hr_buf = torch.as_tensor(np.asarray(hr_data, np.float32)).to(
            self.device)
        if window is not None and self.lr_buf.dim() != 5:
            raise NotImplementedError(
                f"window={window} needs (M, T_full, C, h, w) sequence "
                f"buffers; got rank-{self.lr_buf.dim()}")
        self.window = window
        self.batch_size, self.patch, self.ratio = batch_size, patch, ratio
        self.m = self.lr_buf.shape[0]
        self.steps_per_epoch = steps_per_epoch or max(1, self.m // batch_size)
        self.dataset_stats = dataset_stats
        self.stats = DATASET_STATS[dataset_stats]
        self.rng_tree = RngTree(random_seed)
        self.scalar_names = ["Loss", *(fn.__class__.__name__
                                       for fn in self.metric_fns)]
        self.engine = EpochEngine(
            lambda inputs, hr: self._train_step(inputs, hr)[0], self.lr_buf,
            self.hr_buf, patch, ratio, self.stats, self.steps_per_epoch,
            len(self.scalar_names), window, graph_key=self.chain.graph_key,
            after_replay=self.chain.advance, warmup=self.chain.every_k)
        self.epoch = 0

    @staticmethod
    def _first(outputs):
        """A tuple output is scored on its first member."""
        return outputs[0] if isinstance(outputs, tuple) else outputs

    def _compute_losses(self, outputs, targets):
        return [fn(self._first(outputs), targets) for fn in self.loss_fns]

    def _compute_metrics(self, outputs, targets):
        o, t = self._denorm(self._first(outputs)), self._denorm(targets)
        return [fn(o, t) for fn in self.metric_fns]

    def _scalars(self, total, losses, metrics) -> torch.Tensor:
        # The total and the metrics, as the JAX trainer logs them.
        return super()._scalars(total, [], metrics)

    def draws(self, epoch: int) -> list[torch.Tensor]:
        """The epoch's draws (``epoch_draws``)."""
        return epoch_draws(self.rng_tree, epoch, self.lr_buf,
                           self.steps_per_epoch, self.batch_size, self.patch,
                           self.window)

    def train_epoch(self, draws: Sequence[torch.Tensor] | None = None
                    ) -> dict:
        """One epoch (its own draws unless ``draws`` are given); returns
        the mean of the per-step scalars."""
        self.epoch += 1
        log = self.engine.run(self.draws(self.epoch) if draws is None
                              else draws)
        out = dict(zip(self.scalar_names, log.mean(0).tolist()))
        logging.info(f"Device epoch {self.epoch}: "
                     f"{ {k: round(v, 5) for k, v in out.items()} }")
        return out


# ------------------------------------------------------ config-driven mixin


class DeviceTrainerMixin:
    """The task trainer with its training epoch replaced by the device
    epoch. Validation, checkpoints, monitor, logger and scheduler are the
    host-loop trainer's, and its checkpoints interchange with the host-loop
    trainer's both ways (``host_optimizer_state``).

    trainer.kwargs: ``patch`` (LR crop size), ``ratio`` (the HR crop's
    scale), ``steps_per_epoch`` (default: train samples // batch),
    ``buffer_limit`` (the most samples made resident), ``scan_unroll``
    ("auto", 0 or 1). The dataset config's ``augments`` are ignored in the training epoch: it
    always draws the crop and both flips; normalization uses the dataset's
    canonical statistics. The host-loop trainer's ``qat``,
    ``grad_accumulation``, ``grad_clip`` and ``ema_decay`` run inside the
    captured step: with ``grad_accumulation > 1`` two graphs are captured,
    an accumulate-only micro-step and an accumulate-then-apply one, and the
    host's micro-step counter picks the one to replay. ``profile_dir``
    traces the second epoch's replays, and ``async_ckpt`` snapshots between
    epochs, never inside a capture (a capture waits for the writes in
    flight). Refused by name: the
    parallel trainer knobs (``mesh_axes`` with any axis, the ``'expert'``
    axis among them, ``zero_optim``, ``fsdp``, a multi-process run), and
    resuming a host-loop trainer's mid-epoch preemption checkpoint."""

    def __init__(self, *args, patch: int, ratio: int,
                 steps_per_epoch: int | None = None,
                 buffer_limit: int | None = None,
                 scan_unroll: int | str = "auto", **kwargs):
        mesh_axes = kwargs.get("mesh_axes") or {}
        trainers.refuse_qat_with_pipe(kwargs.get("qat"), mesh_axes)
        if "expert" in mesh_axes:
            raise NotImplementedError(
                "device trainers: the 'expert' mesh axis is not yet ported "
                "to vsr_tpu_torch")
        for name in ("mesh_axes", "zero_optim", "fsdp"):
            if kwargs.get(name):
                raise NotImplementedError(
                    f"device trainers: {name} is not yet ported to "
                    "vsr_tpu_torch")
        if (torch.distributed.is_available()
                and torch.distributed.is_initialized()
                and torch.distributed.get_world_size() > 1):
            raise NotImplementedError(
                "device trainers: multi-process training is not yet ported "
                "to vsr_tpu_torch")
        check_scan_unroll(scan_unroll)
        super().__init__(*args, **kwargs)
        self.patch, self.ratio = int(patch), int(ratio)
        self._steps_cfg = steps_per_epoch
        self.buffer_limit = buffer_limit
        if self.device.type == "cuda":
            self.optimizer = make_capturable(self.optimizer, self.device)
            self.chain.optimizer = self.optimizer
        self.lr_buf = self.hr_buf = None
        self.engine = None

    # -------------------------------------------------------- checkpoints
    def _optimizer_state(self) -> dict:
        return host_optimizer_state(self.optimizer.state_dict())

    def _load_optimizer_state(self, state: dict) -> None:
        if self.device.type != "cuda":
            return super()._load_optimizer_state(state)
        load_capturable_state(self.optimizer, state)
        if self.engine is not None:  # the captured steps read the old state
            self.engine.reset()

    # ------------------------------------------------------------ buffers
    def _buffer_layout(self, lr: np.ndarray, hr: np.ndarray):
        """Stacked channels-last buffers -> the nets' channel-first layout:
        ``(M, [T,] h, w, C) -> (M, [T,] C, h, w)``; the volume twins
        override it."""
        return np.moveaxis(lr, -1, -3), np.moveaxis(hr, -1, -3)

    def _ensure_buffers(self) -> None:
        if self.lr_buf is not None:
            return
        self.batch_size = self.train_dataloader.batch_size
        lr, hr = stack_dataset_raw(self.train_dataloader.dataset,
                                   limit=self.buffer_limit)
        lr, hr = self._buffer_layout(lr, hr)
        self.lr_buf = torch.from_numpy(
            np.ascontiguousarray(lr, np.float32)).to(self.device)
        self.hr_buf = torch.from_numpy(
            np.ascontiguousarray(hr, np.float32)).to(self.device)
        self.m = self.lr_buf.shape[0]
        self.steps_per_epoch = self._steps_cfg or max(
            1, self.m // self.batch_size)
        self.engine = EpochEngine(
            self._engine_step, self.lr_buf, self.hr_buf, self.patch,
            self.ratio, DATASET_STATS[self.dataset_stats],
            self.steps_per_epoch, len(self._scalar_names),
            graph_key=self.chain.graph_key, after_replay=self.chain.advance,
            warmup=self.chain.every_k,
            before_capture=self.wait_for_checkpoints)

    def _pack_device_targets(self, hr, inputs):
        """The task trainer's target structure (``inputs``: the sampled LR
        batch, for tasks whose loss reads it). The port's VSR and 4D
        trainers take the HR frames alone (they keep no frame mask)."""
        return hr

    def _engine_step(self, inputs, hr) -> torch.Tensor:
        scalars, _ = self._train_step(
            inputs, self._pack_device_targets(hr, inputs))
        return scalars

    def epoch_draws(self, epoch: int) -> list[torch.Tensor]:
        """The epoch's draws (the module's ``epoch_draws``)."""
        return epoch_draws(self.rng_tree, epoch, self.lr_buf,
                           self.steps_per_epoch, self.batch_size, self.patch)

    def _run_epoch(self, mode: str, epoch: int):
        if mode != "training":
            return super()._run_epoch(mode, epoch)
        if self._mid_epoch_resume is not None:
            raise NotImplementedError(
                "this mid-epoch preemption checkpoint was written by a "
                "host-loop trainer; resume it with the same trainer family "
                "(a device epoch cannot be entered at a batch offset)")
        self._ensure_buffers()
        log = self.engine.run(self.epoch_draws(epoch)).mean(0).tolist()
        return dict(zip(self._scalar_names, log)), None, None


class _DeviceFRVSRBase(DeviceTrainerMixin, trainers.FRVSRTrainer):
    def _pack_device_targets(self, hr, inputs):
        # The flow loss reads the LR inputs.
        return inputs, hr


class _DeviceVolumeBase(DeviceTrainerMixin, trainers.VolumeTrainer):
    """3D volumes: (M, h, w, D, C) stacks -> the net's (M, C, D, h, w), so
    the crop slices (h, w) and leaves the depth whole."""

    def _buffer_layout(self, lr, hr):
        return lr.transpose(0, 4, 3, 1, 2), hr.transpose(0, 4, 3, 1, 2)


class _DeviceVolume4DBase(DeviceTrainerMixin, trainers.Volume4DTrainer):
    """4D windows: (M, T, h, w, D, C) stacks -> (M, T, C, D, h, w)."""

    def _buffer_layout(self, lr, hr):
        return (lr.transpose(0, 1, 5, 4, 2, 3),
                hr.transpose(0, 1, 5, 4, 2, 3))


def _register_device_trainers() -> dict[str, type]:
    bases = {
        "SISR": (DeviceTrainerMixin, trainers.SISRTrainer),
        "SISRSRFB": (DeviceTrainerMixin, trainers.SISRSRFBTrainer),
        "MISR": (DeviceTrainerMixin, trainers.MISRTrainer),
        "VSR": (DeviceTrainerMixin, trainers.VSRTrainer),
        "FRVSR": (_DeviceFRVSRBase,),
        "3DSR": (_DeviceVolumeBase,),
        "4DSR": (_DeviceVolume4DBase,),
    }
    made = {}
    for family, base in bases.items():
        for prefix, stats in (("Acdc", "acdc"), ("Dsb15", "dsb15")):
            name = f"{prefix}{family}DeviceTrainer"
            made[name] = register("trainer", name)(
                type(name, base, {"dataset_stats": stats}))
    return made


globals().update(_register_device_trainers())
