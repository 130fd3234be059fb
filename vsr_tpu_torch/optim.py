"""Optimizers and LR schedulers (port of ``vsr_tpu/optim.py``).

Configs say ``Adam`` / ``SGD`` / ``StepLR`` / ``ReduceLROnPlateau`` with torch
kwargs. An optimizer name resolves to a factory that holds the config's
arguments; the trainer binds it to the net's parameters
(``factory.bind(params)`` returns the ``torch.optim`` optimizer). ``lr`` and
``learning_rate`` both name the learning rate, and each optimizer keeps the
JAX package's default for it. ``weight_decay`` is torch's coupled decay,
which is what the JAX package emulates. Param EMA (``with_param_ema``) is not
ported.

The schedulers are copies of the JAX package's pure-Python classes, not
``torch.optim.lr_scheduler`` lookups, so both packages follow the same LR
curve bit for bit. They are driven once per epoch by the trainer
(``step`` returns the next epoch's LR, which the trainer writes into every
``param_groups[i]["lr"]``); their state is a JSON-friendly dict for
checkpointing. ``ReduceLROnPlateau`` steps on the validation ``Loss``.
"""

from __future__ import annotations

import math
from typing import Any, Iterable, Sequence

import torch

from vsr_tpu_torch.registry import register

# name -> the JAX package's default learning rate for it.
_OPTIMIZERS = {"Adam": 1e-3, "AdamW": 1e-3, "SGD": 1e-2, "RMSprop": 1e-2,
               "Adagrad": 1e-2, "Adadelta": 1.0, "Adamax": 2e-3,
               "NAdam": 2e-3, "RAdam": 1e-3, "ASGD": 1e-2, "Rprop": 1e-2}


class OptimizerFactory:
    """The config's optimizer arguments, bound to parameters later."""

    torch_name = ""
    default_lr = 1e-3

    def __init__(self, learning_rate: float | None = None,
                 lr: float | None = None, **kwargs: Any):
        if lr is None:
            lr = self.default_lr if learning_rate is None else learning_rate
        self.lr = float(lr)
        self.kwargs = kwargs

    def bind(self, params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
        kwargs = dict(self.kwargs)
        if "betas" in kwargs:
            kwargs["betas"] = tuple(kwargs["betas"])
        return getattr(torch.optim, self.torch_name)(params, lr=self.lr, **kwargs)


for _name, _lr in _OPTIMIZERS.items():
    # Also module attributes (``optim.Adam(lr=1e-4)``), as in the JAX package.
    globals()[_name] = register("optimizer", _name)(type(
        _name, (OptimizerFactory,), {"torch_name": _name, "default_lr": _lr}))


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """A learning rate held as a tensor (a captured CUDA graph reads it by
    address) is filled in place; a float one is replaced."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def _refuse_unknown_kwargs(name: str, kwargs: dict) -> None:
    """Schedulers resolve by name from YAML configs under the
    torch.optim.lr_scheduler names: a swallowed unknown key (a typo like ``step_size_dwon``, or a torch knob this
    reimplementation does not drive, like CyclicLR's ``scale_fn``) would
    silently train a different LR curve than the same torch config.
    ``verbose`` is cosmetic in torch and ignored; ``last_epoch`` is
    accepted only at torch's -1 default (resume restores the epoch via
    ``load_state_dict``, not construction)."""
    kwargs = dict(kwargs)
    kwargs.pop("verbose", None)
    if kwargs.pop("last_epoch", -1) != -1:
        raise ValueError(
            f"{name}: last_epoch is restored by checkpoint resume "
            "(load_state_dict), not construction — only the torch default "
            "-1 is accepted")
    if kwargs:
        raise ValueError(
            f"{name}: unsupported kwargs {sorted(kwargs)} — unknown keys "
            "fail loudly (a typo, or a torch knob this scheduler does not "
            "implement)")


class Scheduler:
    """Epoch-level LR scheduler: returns the LR for the *next* epoch."""

    needs_metric = False

    def __init__(self, base_lr: float | None = None):
        self.base_lr = base_lr
        self.last_epoch = 0

    def bind(self, base_lr: float) -> None:
        if self.base_lr is None:
            self.base_lr = base_lr

    def step(self, metric: float | None = None) -> float:
        self.last_epoch += 1
        return self._lr()

    def _lr(self) -> float:
        raise NotImplementedError

    def state_dict(self) -> dict:
        return {"base_lr": self.base_lr, "last_epoch": self.last_epoch}

    def load_state_dict(self, state: dict) -> None:
        self.base_lr = state["base_lr"]
        self.last_epoch = state["last_epoch"]


@register("lr_scheduler")
class StepLR(Scheduler):
    def __init__(self, step_size: int, gamma: float = 0.1, **kwargs: Any):
        super().__init__()
        _refuse_unknown_kwargs(type(self).__name__, kwargs)
        self.step_size = step_size
        self.gamma = gamma

    def _lr(self) -> float:
        return self.base_lr * self.gamma ** (self.last_epoch // self.step_size)


@register("lr_scheduler")
class MultiStepLR(Scheduler):
    def __init__(self, milestones: Sequence[int], gamma: float = 0.1, **kwargs: Any):
        super().__init__()
        _refuse_unknown_kwargs(type(self).__name__, kwargs)
        self.milestones = sorted(milestones)
        self.gamma = gamma

    def _lr(self) -> float:
        passed = sum(1 for m in self.milestones if m <= self.last_epoch)
        return self.base_lr * self.gamma**passed


@register("lr_scheduler")
class ExponentialLR(Scheduler):
    def __init__(self, gamma: float, **kwargs: Any):
        super().__init__()
        _refuse_unknown_kwargs(type(self).__name__, kwargs)
        self.gamma = gamma

    def _lr(self) -> float:
        return self.base_lr * self.gamma**self.last_epoch


@register("lr_scheduler")
class ConstantLR(Scheduler):
    """torch.optim.lr_scheduler.ConstantLR: ``base_lr * factor`` for the
    first ``total_iters`` epochs, ``base_lr`` after."""

    def __init__(self, factor: float = 1.0 / 3, total_iters: int = 5,
                 **kwargs: Any):
        super().__init__()
        _refuse_unknown_kwargs(type(self).__name__, kwargs)
        self.factor = factor
        self.total_iters = total_iters

    def _lr(self) -> float:
        return self.base_lr * (
            self.factor if self.last_epoch < self.total_iters else 1.0)


@register("lr_scheduler")
class LinearLR(Scheduler):
    """torch.optim.lr_scheduler.LinearLR: the multiplicative factor ramps
    linearly from ``start_factor`` to ``end_factor`` over ``total_iters``
    epochs (warmup when start < end)."""

    def __init__(self, start_factor: float = 1.0 / 3,
                 end_factor: float = 1.0, total_iters: int = 5,
                 **kwargs: Any):
        super().__init__()
        _refuse_unknown_kwargs(type(self).__name__, kwargs)
        self.start_factor = start_factor
        self.end_factor = end_factor
        self.total_iters = total_iters

    def _lr(self) -> float:
        t = min(self.last_epoch, self.total_iters) / self.total_iters
        return self.base_lr * (
            self.start_factor + (self.end_factor - self.start_factor) * t)


@register("lr_scheduler")
class PolynomialLR(Scheduler):
    """torch.optim.lr_scheduler.PolynomialLR: decays to zero at
    ``total_iters`` epochs with the given ``power``."""

    def __init__(self, total_iters: int = 5, power: float = 1.0,
                 **kwargs: Any):
        super().__init__()
        _refuse_unknown_kwargs(type(self).__name__, kwargs)
        self.total_iters = total_iters
        self.power = power

    def _lr(self) -> float:
        t = min(self.last_epoch, self.total_iters) / self.total_iters
        return self.base_lr * (1.0 - t) ** self.power


@register("lr_scheduler")
class CosineAnnealingLR(Scheduler):
    def __init__(self, T_max: int, eta_min: float = 0.0, **kwargs: Any):
        super().__init__()
        _refuse_unknown_kwargs(type(self).__name__, kwargs)
        self.T_max = T_max
        self.eta_min = eta_min

    def _lr(self) -> float:
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * self.last_epoch / self.T_max)
        ) / 2


@register("lr_scheduler")
class CosineAnnealingWarmRestarts(Scheduler):
    def __init__(self, T_0: int, T_mult: int = 1, eta_min: float = 0.0,
                 **kwargs: Any):
        super().__init__()
        _refuse_unknown_kwargs(type(self).__name__, kwargs)
        if T_0 <= 0:
            raise ValueError(f"Expected positive integer T_0, got {T_0}")
        if T_mult < 1:
            raise ValueError(f"Expected integer T_mult >= 1, got {T_mult}")
        self.T_0 = T_0
        self.T_mult = int(T_mult)
        self.eta_min = eta_min

    def _lr(self) -> float:
        t, t_i = self.last_epoch, self.T_0
        while t >= t_i:
            t -= t_i
            t_i = t_i * self.T_mult if self.T_mult > 1 else t_i
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * t / t_i)
        ) / 2


@register("lr_scheduler")
class CyclicLR(Scheduler):
    """torch.optim.lr_scheduler.CyclicLR stepped once per epoch. ``base_lr`` comes from the config (as in torch it overrides
    the optimizer's lr); momentum cycling is not implemented, and torch
    DEFAULTS to ``cycle_momentum=True`` whenever the optimizer has
    momentum/betas — so a config must pass ``cycle_momentum: false``
    explicitly to acknowledge the LR-only schedule (a silent default here
    would silently train differently from the same torch config)."""

    def __init__(self, base_lr: float, max_lr: float,
                 step_size_up: int = 2000, step_size_down: int | None = None,
                 mode: str = "triangular", gamma: float = 1.0,
                 cycle_momentum: bool | None = None,
                 base_momentum: float | None = None,
                 max_momentum: float | None = None, **kwargs: Any):
        super().__init__(base_lr=base_lr)
        _refuse_unknown_kwargs(type(self).__name__, kwargs)
        if cycle_momentum is None or cycle_momentum:
            raise ValueError(
                "CyclicLR momentum cycling is not implemented — this "
                "scheduler drives only the learning rate, while torch "
                "DEFAULTS to cycle_momentum=True when the optimizer has "
                "momentum/betas. Pass cycle_momentum: false explicitly to "
                "opt in to the LR-only schedule.")
        if base_momentum is not None or max_momentum is not None:
            raise ValueError(
                "base_momentum/max_momentum are momentum-cycling knobs; "
                "momentum cycling is not implemented (see cycle_momentum)")
        if mode not in ("triangular", "triangular2", "exp_range"):
            raise ValueError(f"unknown CyclicLR mode {mode!r}")
        self.max_lr = max_lr
        self.step_size_up = step_size_up
        self.step_size_down = (step_size_down if step_size_down is not None
                               else step_size_up)
        self.mode = mode
        self.gamma = gamma

    def _lr(self) -> float:
        total = self.step_size_up + self.step_size_down
        cycle = math.floor(1 + self.last_epoch / total)
        x = 1.0 + self.last_epoch / total - cycle
        ratio = self.step_size_up / total
        if x <= ratio:
            scale = x / ratio
        else:
            scale = (x - 1.0) / (ratio - 1.0)
        height = (self.max_lr - self.base_lr) * scale
        if self.mode == "triangular":
            return self.base_lr + height
        if self.mode == "triangular2":
            return self.base_lr + height / (2.0 ** (cycle - 1))
        return self.base_lr + height * self.gamma ** self.last_epoch


@register("lr_scheduler")
class OneCycleLR(Scheduler):
    """torch.optim.lr_scheduler.OneCycleLR stepped once per epoch, so
    ``total_steps`` counts epochs here. Warmup from
    ``max_lr / div_factor`` to ``max_lr`` over ``pct_start`` of the run,
    then anneal to ``max_lr / div_factor / final_div_factor`` (cos or
    linear; optional symmetric ``three_phase``). As with CyclicLR,
    momentum cycling is not implemented and torch DEFAULTS to
    ``cycle_momentum=True`` — configs must pass ``cycle_momentum: false``
    to opt in to the LR-only schedule."""

    def __init__(self, max_lr: float, total_steps: int | None = None,
                 epochs: int | None = None,
                 steps_per_epoch: int | None = None,
                 pct_start: float = 0.3, anneal_strategy: str = "cos",
                 cycle_momentum: bool | None = None,
                 base_momentum: float | None = None,
                 max_momentum: float | None = None,
                 div_factor: float = 25.0, final_div_factor: float = 1e4,
                 three_phase: bool = False, **kwargs: Any):
        super().__init__(base_lr=max_lr / div_factor)
        _refuse_unknown_kwargs(type(self).__name__, kwargs)
        if cycle_momentum is None or cycle_momentum:
            raise ValueError(
                "OneCycleLR momentum cycling is not implemented — this "
                "scheduler drives only the learning rate, while torch "
                "DEFAULTS to cycle_momentum=True when the optimizer has "
                "momentum/betas. Pass cycle_momentum: false explicitly to "
                "opt in to the LR-only schedule.")
        if base_momentum is not None or max_momentum is not None:
            raise ValueError(
                "base_momentum/max_momentum are momentum-cycling knobs; "
                "momentum cycling is not implemented (see cycle_momentum)")
        if total_steps is None:
            if epochs is None or steps_per_epoch is None:
                raise ValueError(
                    "OneCycleLR needs total_steps, or epochs together with "
                    "steps_per_epoch")
            total_steps = epochs * steps_per_epoch
        if total_steps <= 0:
            raise ValueError(f"Expected positive total_steps, got {total_steps}")
        if not 0.0 <= pct_start <= 1.0:
            raise ValueError(f"Expected pct_start in [0, 1], got {pct_start}")
        if anneal_strategy not in ("cos", "linear"):
            raise ValueError(f"unknown anneal_strategy {anneal_strategy!r}")
        self.max_lr = max_lr
        self.total_steps = int(total_steps)
        self.anneal_strategy = anneal_strategy
        initial_lr = max_lr / div_factor
        min_lr = initial_lr / final_div_factor
        # torch's phase table (lr_scheduler.OneCycleLR.__init__): fractional
        # end_step boundaries, last phase always ends at total_steps - 1.
        if three_phase:
            self.phases = [
                (float(pct_start * total_steps) - 1, initial_lr, max_lr),
                (float(2 * pct_start * total_steps) - 2, max_lr, initial_lr),
                (self.total_steps - 1, initial_lr, min_lr),
            ]
        else:
            self.phases = [
                (float(pct_start * total_steps) - 1, initial_lr, max_lr),
                (self.total_steps - 1, max_lr, min_lr),
            ]

    def _anneal(self, start: float, end: float, pct: float) -> float:
        if self.anneal_strategy == "cos":
            return end + (start - end) / 2.0 * (1 + math.cos(math.pi * pct))
        return (end - start) * pct + start

    def _lr(self) -> float:
        step_num = self.last_epoch
        if step_num > self.total_steps:
            raise ValueError(
                f"Tried to step {step_num} times. The specified number of "
                f"total steps is {self.total_steps}")
        start_step = 0.0
        for i, (end_step, start_lr, end_lr) in enumerate(self.phases):
            if step_num <= end_step or i == len(self.phases) - 1:
                pct = (step_num - start_step) / (end_step - start_step)
                return self._anneal(start_lr, end_lr, pct)
            start_step = end_step
        raise AssertionError("unreachable")


@register("lr_scheduler")
class ReduceLROnPlateau(Scheduler):
    """Steps on the validation 'Loss'."""

    needs_metric = True

    def __init__(self, mode: str = "min", factor: float = 0.1, patience: int = 10,
                 threshold: float = 1e-4, min_lr: float = 0.0, cooldown: int = 0,
                 **kwargs: Any):
        super().__init__()
        _refuse_unknown_kwargs(type(self).__name__, kwargs)
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.cooldown = cooldown
        self.best: float | None = None
        self.num_bad = 0
        self.cooldown_counter = 0
        self.current_lr: float | None = None

    def _improved(self, metric: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            return metric < self.best * (1 - self.threshold)
        return metric > self.best * (1 + self.threshold)

    def step(self, metric: float | None = None) -> float:
        if metric is None:
            raise ValueError("ReduceLROnPlateau.step needs the validation metric")
        self.last_epoch += 1
        if self.current_lr is None:
            self.current_lr = self.base_lr
        if self._improved(metric):
            self.best = metric
            self.num_bad = 0
        elif self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.current_lr = max(self.current_lr * self.factor, self.min_lr)
                self.cooldown_counter = self.cooldown
                self.num_bad = 0
        return self.current_lr

    def state_dict(self) -> dict:
        return {
            **super().state_dict(),
            "best": self.best,
            "num_bad": self.num_bad,
            "cooldown_counter": self.cooldown_counter,
            "current_lr": self.current_lr,
        }

    def load_state_dict(self, state: dict) -> None:
        super().load_state_dict(state)
        self.best = state["best"]
        self.num_bad = state["num_bad"]
        self.cooldown_counter = state["cooldown_counter"]
        self.current_lr = state["current_lr"]
