"""Optimizers, the JAX trainer's gradient chain, and LR schedulers (port of
``vsr_tpu/optim.py``).

Configs say ``Adam`` / ``SGD`` / ``StepLR`` / ``ReduceLROnPlateau`` with torch
kwargs. An optimizer name resolves to a factory that holds the config's
arguments; the trainer binds it to the net's parameters
(``factory.bind(params)`` returns the ``torch.optim`` optimizer). ``lr`` and
``learning_rate`` both name the learning rate, and each optimizer keeps the
JAX package's default for it. An argument that the JAX function's signature
lacks is refused (``TypeError``, as calling the JAX function raises), and so
is ``Adam``'s ``amsgrad=True``, which the JAX function takes and ignores.
``weight_decay`` is torch's coupled decay, which is what the JAX package
emulates: torch adds it inside the update rule, after the gradient chain's
clip, where the JAX chain's ``_maybe_l2`` sits.

:class:`GradientChain` is the trainers' optax chain around the bound
optimizer, ``MultiSteps(chain(clip_by_global_norm(grad_clip),
with_param_ema(optimizer, ema_decay)), every_k=grad_accumulation)``, each
wrapper present only when its knob is set, as plain tensor code with no
host sync (a captured CUDA graph runs it). :class:`CapturableSGD` and
:class:`CapturableAdagrad` are the steps of ``SGD`` and ``Adagrad`` with the
learning rate a device tensor: ``torch.optim`` gives neither a capturable
mode, and the device trainers capture the step.

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
import torch.distributed as dist

from vsr_tpu_torch.parallel.distributed import assign_full, local
from vsr_tpu_torch.registry import register

# name -> the JAX package's default learning rate for it.
_OPTIMIZERS = {"Adam": 1e-3, "AdamW": 1e-3, "SGD": 1e-2, "RMSprop": 1e-2,
               "Adagrad": 1e-2, "Adadelta": 1.0, "Adamax": 2e-3,
               "NAdam": 2e-3, "RAdam": 1e-3, "ASGD": 1e-2, "Rprop": 1e-2}
# name -> the JAX function's other keyword arguments (``vsr_tpu/optim.py``).
_SIGNATURES = {
    "Adam": ("betas", "eps", "weight_decay", "amsgrad"),
    "AdamW": ("betas", "eps", "weight_decay"),
    "SGD": ("momentum", "weight_decay", "nesterov"),
    "RMSprop": ("alpha", "eps", "weight_decay", "momentum"),
    "Adagrad": ("eps", "weight_decay", "initial_accumulator_value"),
    "Adadelta": ("rho", "eps", "weight_decay"),
    "Adamax": ("betas", "eps", "weight_decay"),
    "NAdam": ("betas", "eps", "weight_decay", "momentum_decay"),
    "RAdam": ("betas", "eps", "weight_decay"),
    "ASGD": ("lambd", "alpha", "t0", "weight_decay"),
    "Rprop": ("etas", "step_sizes"),
}
_PAIRS = ("betas", "etas", "step_sizes")  # YAML lists -> torch's tuples


class OptimizerFactory:
    """The config's optimizer arguments, bound to parameters later."""

    torch_name = ""
    default_lr = 1e-3

    def __init__(self, learning_rate: float | None = None,
                 lr: float | None = None, **kwargs: Any):
        unknown = sorted(set(kwargs) - set(_SIGNATURES[self.torch_name]))
        if unknown:
            raise TypeError(
                f"{self.torch_name}() got unexpected keyword arguments "
                f"{unknown}: the JAX package's {self.torch_name} takes "
                f"{list(_SIGNATURES[self.torch_name])} besides the learning "
                "rate")
        if kwargs.get("amsgrad"):
            raise TypeError(
                "Adam(amsgrad=True): the JAX package's Adam takes amsgrad "
                "and ignores it, so the two would train differently")
        if lr is None:
            lr = self.default_lr if learning_rate is None else learning_rate
        self.lr = float(lr)
        self.kwargs = kwargs

    def optimizer_class(self) -> type:
        return getattr(torch.optim, self.torch_name)

    def bind_kwargs(self) -> dict[str, Any]:
        """The class's keyword arguments, the learning rate among them."""
        return {"lr": self.lr, **{k: tuple(v) if k in _PAIRS else v
                                  for k, v in self.kwargs.items()}}

    def bind(self, params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
        return self.optimizer_class()(params, **self.bind_kwargs())


for _name, _lr in _OPTIMIZERS.items():
    # Also module attributes (``optim.Adam(lr=1e-4)``), as in the JAX package.
    globals()[_name] = register("optimizer", _name)(type(
        _name, (OptimizerFactory,), {"torch_name": _name, "default_lr": _lr}))


class CapturableSGD(torch.optim.SGD):
    """``SGD`` (with and without momentum and ``nesterov``) as the JAX chain
    computes it, ``p + (-lr) * u`` with ``u`` the (decayed, traced) gradient,
    for a learning rate held as a device tensor: no host sync, so a CUDA
    graph captures it. State and groups are ``torch.optim.SGD``'s (a
    ``momentum_buffer`` per parameter), so its state dict loads into either.
    The first step with momentum makes the buffers: run it before a
    capture."""

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            neg_lr = -group["lr"]
            wd, mom = group["weight_decay"], group["momentum"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad if not wd else p.grad.add(p, alpha=wd)
                if mom:
                    state = self.state[p]
                    buf = state.get("momentum_buffer")
                    if buf is None:
                        buf = state["momentum_buffer"] = g.clone()
                    else:
                        buf.mul_(mom).add_(g)
                    g = g.add(buf, alpha=mom) if group["nesterov"] else buf
                p.add_(g * neg_lr)


class CapturableAdagrad(torch.optim.Adagrad):
    """``Adagrad`` as the JAX chain computes it (``_scale_by_torch_adagrad``:
    ``acc += g * g``, ``p + (-lr) * g / (sqrt(acc) + eps)``) for a learning
    rate held as a device tensor. State and groups are
    ``torch.optim.Adagrad``'s (``sum`` and ``step`` per parameter; ``step``
    kept on the parameter's device)."""

    def __init__(self, params, **kwargs: Any):
        super().__init__(params, **kwargs)
        # torch fills the sums from the constructor's argument, not from
        # each group's (which a rebuilt optimizer carries).
        for group in self.param_groups:
            for p in group["params"]:
                state = self.state[p]
                state["sum"].fill_(group["initial_accumulator_value"])
                state["step"] = state["step"].to(p.device, torch.float32)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            neg_lr, wd, eps = -group["lr"], group["weight_decay"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad if not wd else p.grad.add(p, alpha=wd)
                state = self.state[p]
                state["sum"].addcmul_(g, g)
                state["step"].add_(1)
                p.add_(g / (state["sum"].sqrt() + eps) * neg_lr)


# The torch.optim classes without a capturable mode -> the port's step.
CAPTURABLE = {torch.optim.SGD: CapturableSGD,
              torch.optim.Adagrad: CapturableAdagrad}


class GradientChain:
    """The JAX trainer's optax chain (``vsr_tpu/runner/trainers.py:135-159``)
    around ``optimizer``, whose groups hold ``net``'s parameters; ``step()``
    runs after the backward, on the parameters' ``.grad``.

    - ``grad_accumulation = k > 1`` (``optax.MultiSteps``): a running mean
      of the micro-gradients, ``acc + (g - acc) / (n + 1)``; the inner chain
      runs on every k-th micro-step only, on the mean, and the other
      micro-steps leave the parameters and the inner state as they are. The
      micro-step counter is the host's :attr:`mini_step` (deterministic, so
      a captured step is chosen by it, :meth:`graph_key`) mirrored on the
      device; it and the accumulator carry across epochs and are saved.
    - ``grad_clip`` (``optax.clip_by_global_norm``): ``g`` where the global
      norm is below ``grad_clip``, else ``(g / norm) * grad_clip``, on the
      accumulated gradient, computed on the device.
    - ``ema_decay = d`` (``with_param_ema``): ``ema <- d * ema + (1 - d) *
      new_params`` after each applied update, starting from a copy of the
      parameters when the chain is built, no bias correction; the trainable
      parameters only (no buffers), keyed by their names.

    ``param_groups`` are the optimizer's, so ``get_learning_rate`` /
    ``set_learning_rate`` and the schedulers work through the chain.

    Under a ``data`` mesh (``parallel/data_parallel.py``): FSDP's sharded
    parameters (``DTensor``) are updated block by block, and the clip's
    norm sums the squares of every rank's blocks; under DDP an applying
    micro-step that follows :meth:`preload` is ``step(summed=True)``."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 net: torch.nn.Module, grad_accumulation: int = 1,
                 grad_clip: float = 0.0, ema_decay: float | None = None):
        self.optimizer = optimizer
        named = dict(net.named_parameters())
        in_groups = {id(p) for g in optimizer.param_groups for p in g["params"]}
        self.names = [n for n, p in named.items() if id(p) in in_groups]
        self.params = [named[n] for n in self.names]
        self.every_k = max(int(grad_accumulation), 1)
        self.max_norm = float(grad_clip or 0.0)
        self.decay = None
        if ema_decay:
            self.decay = float(ema_decay)
            if not 0.0 < self.decay < 1.0:
                raise ValueError(f"ema decay must be in (0, 1), got {ema_decay}")
        self.mini_step = 0
        self.acc = self.count = self.ema = None
        self._sharded = any(local(p) is not p for p in self.params)
        # (group, names) of the parameters split over a 'model' / 'expert'
        # axis (parallel/placement.py): the clip's norm sums their blocks'
        # squares over the group.
        self.split = None
        with torch.no_grad():
            if self.every_k > 1:
                self.acc = [torch.zeros_like(p) for p in self.params]
                self.count = torch.zeros((), device=self.params[0].device)
            if self.decay is not None:
                self.ema = [p.detach().clone() for p in self.params]

    @property
    def param_groups(self) -> list:
        return self.optimizer.param_groups

    def graph_key(self) -> bool:
        """Whether the next micro-step applies the update: the captured
        step a device epoch replays next."""
        return self.mini_step == self.every_k - 1

    def advance(self) -> None:
        """The host's micro-step counter after one micro-step (what a
        replayed step does not move)."""
        self.mini_step = (self.mini_step + 1) % self.every_k

    @torch.no_grad()
    def preload(self) -> None:
        """Before the backward of an applying micro-step whose earlier
        micro-steps ran under DDP's ``no_sync``: ``.grad`` becomes the sum
        of this rank's earlier micro-gradients, which the backward adds to
        and DDP all-reduces; ``step(summed=True)`` divides by k."""
        for p, a in zip(self.params, self.acc):
            p.grad = a * self.mini_step

    @torch.no_grad()
    def step(self, summed: bool = False) -> None:
        grads = [p.grad for p in self.params]
        if self.acc is not None or self.max_norm:
            # A parameter the loss does not reach has a gradient of zeros
            # in JAX: it counts in the mean and the norm.
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(self.params, grads)]
        if self.acc is not None and summed:
            for g in grads:
                local(g).div_(self.every_k)
        elif self.acc is not None:
            for a, g in zip(self.acc, grads):
                local(a).add_((local(g) - local(a)) / (self.count + 1))
            if not self.graph_key():
                self.count.add_(1)
                self.advance()
                return
            grads = self.acc
        if self.max_norm:
            squares = torch.stack([local(g).square().sum() for g in grads])
            square = squares.sum()
            if self._sharded:
                dist.all_reduce(square)
            if self.split is not None:
                group, names = self.split
                mask = torch.tensor([n in names for n in self.names],
                                    device=squares.device)
                part = squares[mask].sum()
                dist.all_reduce(part, group=group)
                square = squares[~mask].sum() + part
            norm = square.sqrt()
            keep = norm < self.max_norm
            for g in map(local, grads):
                g.copy_(torch.where(keep, g, (g / norm) * self.max_norm))
        for p, g in zip(self.params, grads):
            p.grad = g
        self.optimizer.step()
        if self.ema is not None:
            for e, p in zip(map(local, self.ema), map(local, self.params)):
                e.copy_(e * self.decay + p * (1.0 - self.decay))
        if self.acc is not None:
            for a in self.acc:
                local(a).zero_()
            self.count.zero_()
        self.advance()

    def ema_state(self) -> dict[str, torch.Tensor]:
        """``{parameter name: EMA tensor}`` (``get_ema_params``)."""
        if self.ema is None:
            raise ValueError("Optimizer state carries no param EMA — train "
                             "with trainer.kwargs.ema_decay to track one")
        return dict(zip(self.names, self.ema))

    def state_dict(self) -> dict | None:
        """The chain's own state (``None`` without any knob): the
        accumulator and micro-step, the EMA, keyed by parameter name."""
        if self.acc is None and self.ema is None:
            return None
        return {"every_k": self.every_k, "mini_step": self.mini_step,
                "acc": (None if self.acc is None
                        else dict(zip(self.names, self.acc))),
                "ema": None if self.ema is None else self.ema_state()}

    @torch.no_grad()
    def load_state_dict(self, state: dict | None) -> None:
        """Restore :meth:`state_dict`'s output into the chain's tensors, in
        place (a captured step reads them by address). A checkpoint of
        another chain (accumulation, EMA) is refused, as restoring an optax
        state of another structure is."""
        state = state or {"every_k": 1, "acc": None, "ema": None}
        has = (self.every_k, self.ema is not None)
        got = (int(state["every_k"]), state["ema"] is not None)
        if has != got:
            raise ValueError(
                f"the checkpoint's gradient chain (grad_accumulation "
                f"{got[0]}, EMA {got[1]}) is not this trainer's (grad_"
                f"accumulation {has[0]}, EMA {has[1]})")
        if self.acc is not None:
            for name, a in zip(self.names, self.acc):
                assign_full(a, state["acc"][name])
            self.mini_step = int(state["mini_step"])
            self.count.fill_(self.mini_step)
        if self.ema is not None:
            for name, e in zip(self.names, self.ema):
                assign_full(e, state["ema"][name])


def find_ema(opt_state) -> dict | None:
    """The ``ema`` tree of a flax checkpoint's ``opt_state``: the dict of
    exactly ``{inner_opt_state, ema}`` (``ParamEmaState``) under any nesting
    of ``MultiSteps`` and ``optax.chain`` (``{'0': ..., '1': ...}``)."""
    if not isinstance(opt_state, dict):
        return None
    if set(opt_state) == {"inner_opt_state", "ema"}:
        return opt_state["ema"]
    for value in opt_state.values():
        found = find_ema(value)
        if found is not None:
            return found
    return None


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
