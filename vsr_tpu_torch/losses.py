"""Loss functions (port of ``vsr_tpu/losses.py``).

The project's own losses are ``nn.Module``s under their names: ``L1Loss``,
``MSELoss``, ``SmoothL1Loss``, ``HuberLoss``, ``CharbonnierLoss``,
``FlowLoss``, and the eleven ``torch.nn``-named losses the JAX package
defines for itself (``BCELoss`` ... ``HingeEmbeddingLoss``,
``vsr_tpu/losses.py:94-251``) with its conventions. A name registered by
neither raises, as in ``vsr_tpu``: there is no fallback to ``torch.nn``.

Quirks kept on purpose: ``CharbonnierLoss`` adds epsilon (not epsilon^2)
under the square root, and ``HuberLoss`` is the project's delta-split flavor,
``mean(0.5 * min(|e|, delta)^2 + delta * (|e| - min(|e|, delta)))`` with a
required ``delta``. ``torch.nn.HuberLoss`` is a different function; the
project's own wins the lookup because registered names are found first.

The reductions of the image losses are means over every element, so
layouts do not matter there. ``NLLLoss`` and ``CrossEntropyLoss`` are
channels-last, as in the JAX package: scores ``(..., C)``, an integer
target ``(...)`` (``torch.nn``'s take the class axis at dim 1).
"""

from __future__ import annotations

import torch
from torch import nn

import torch.nn.functional as F

from vsr_tpu_torch.registry import register


class Loss(nn.Module):
    """Base: a named callable (output, target) -> scalar."""

    @property
    def name(self) -> str:
        return self.__class__.__name__

    def __repr__(self) -> str:
        return self.__class__.__name__


@register("loss")
class L1Loss(Loss):
    def forward(self, output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return torch.mean(torch.abs(output - target))


@register("loss")
class MSELoss(Loss):
    def forward(self, output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return torch.mean(torch.square(output - target))


@register("loss")
class SmoothL1Loss(Loss):
    """torch.nn.SmoothL1Loss semantics (beta=1)."""

    def forward(self, output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        err = torch.abs(output - target)
        return torch.mean(torch.where(err < 1.0, 0.5 * err * err, err - 0.5))


@register("loss")
class HuberLoss(Loss):
    """min(|e|, delta) quadratic + linear split, mean."""

    def __init__(self, delta: float):
        super().__init__()
        self.delta = float(delta)

    def forward(self, output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        abs_error = torch.abs(output - target)
        quadratic = torch.clamp(abs_error, max=self.delta)
        linear = abs_error - quadratic
        return torch.mean(0.5 * quadratic ** 2 + self.delta * linear)


@register("loss")
class CharbonnierLoss(Loss):
    def __init__(self, epsilon: float):
        super().__init__()
        self.epsilon = float(epsilon)

    def forward(self, output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return torch.mean(torch.sqrt(torch.square(output - target) + self.epsilon))


@register("loss")
class FlowLoss(MSELoss):
    """Alias of MSE used as the FRVSR flow-warp loss."""


@register("loss")
class BCELoss(Loss):
    """Mean binary cross-entropy on probabilities, logs clamped at -100 as
    torch's."""

    def forward(self, output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        log_o = torch.clamp(torch.log(output), min=-100.0)
        log_1o = torch.clamp(torch.log1p(-output), min=-100.0)
        return -torch.mean(target * log_o + (1.0 - target) * log_1o)


@register("loss")
class BCEWithLogitsLoss(Loss):
    """Binary cross-entropy on logits, in the numerically stable form."""

    def forward(self, output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return torch.mean(torch.clamp(output, min=0.0) - output * target
                          + torch.log1p(torch.exp(-torch.abs(output))))


@register("loss")
class KLDivLoss(Loss):
    """``target * (log target - output)`` (output: log-probabilities), zero
    where the target is 0, averaged over every element."""

    def forward(self, output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        positive = target > 0
        point = target * (torch.log(torch.where(positive, target,
                                                torch.ones_like(target)))
                          - output)
        return torch.mean(torch.where(positive, point,
                                      torch.zeros_like(point)))


@register("loss")
class PoissonNLLLoss(Loss):
    """``torch.nn.PoissonNLLLoss``'s defaults (``full=False``)."""

    def __init__(self, log_input: bool = True, eps: float = 1e-8):
        super().__init__()
        self.log_input = bool(log_input)
        self.eps = float(eps)

    def forward(self, output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        if self.log_input:
            return torch.mean(torch.exp(output) - target * output)
        return torch.mean(output - target * torch.log(output + self.eps))


@register("loss")
class SoftMarginLoss(Loss):
    """``mean(log(1 + exp(-target * output)))``, in the stable form."""

    def forward(self, output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        z = -target * output
        return torch.mean(torch.clamp(z, min=0.0)
                          + torch.log1p(torch.exp(-torch.abs(z))))


def _picked(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``output[..., target]``: the score of each target class."""
    return torch.gather(output, -1, target.long()[..., None])[..., 0]


@register("loss")
class NLLLoss(Loss):
    """Negative log-likelihood, channels-last: log-probabilities
    ``(..., C)``, integer class indices ``(...)``."""

    def forward(self, output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return -torch.mean(_picked(output, target))


@register("loss")
class CrossEntropyLoss(Loss):
    """Cross-entropy on logits, channels-last: ``(..., C)`` logits, integer
    class indices ``(...)``."""

    def forward(self, output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        logz = torch.logsumexp(output, dim=-1)
        return torch.mean(logz - _picked(output, target))


@register("loss")
class MultiMarginLoss(Loss):
    """``(N, C)`` scores, ``(N,)`` integer classes; per sample
    ``sum_{i != y} max(0, margin - x[y] + x[i]) ** p / C``, mean over the
    batch (p 1 or 2)."""

    def __init__(self, p: int = 1, margin: float = 1.0):
        super().__init__()
        if p not in (1, 2):
            raise ValueError("MultiMarginLoss supports p in {1, 2}")
        self.p = int(p)
        self.margin = float(margin)

    def forward(self, output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        c = output.shape[1]
        target = target.long()
        x_y = torch.gather(output, 1, target[:, None])
        hinge = torch.clamp(self.margin - x_y + output, min=0.0)
        if self.p == 2:
            hinge = hinge * hinge
        not_y = torch.arange(c, device=output.device)[None, :] != target[:, None]
        hinge = torch.where(not_y, hinge, torch.zeros_like(hinge))
        return torch.mean(torch.sum(hinge, dim=1) / c)


@register("loss")
class MultiLabelMarginLoss(Loss):
    """``(N, C)`` scores; ``(N, C)`` integer classes of which only the
    prefix before the first negative counts. Per sample ``sum_{j in
    prefix} sum_{i not a label} max(0, 1 - (x[y_j] - x[i])) / C``, mean
    over the batch."""

    def forward(self, output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        c = output.shape[1]
        target = target.long()
        valid = torch.cumprod((target >= 0).long(), dim=1).bool()
        safe_t = torch.where(valid, target, torch.zeros_like(target))
        one_hot = F.one_hot(safe_t, c).bool() & valid[..., None]
        is_label = torch.any(one_hot, dim=1)
        x_y = torch.gather(output, 1, safe_t)
        hinge = torch.clamp(1.0 - (x_y[:, :, None] - output[:, None, :]),
                            min=0.0)
        mask = valid[:, :, None] & ~is_label[:, None, :]
        hinge = torch.where(mask, hinge, torch.zeros_like(hinge))
        return torch.mean(torch.sum(hinge, dim=(1, 2)) / c)


@register("loss")
class MultiLabelSoftMarginLoss(Loss):
    """``(N, C)`` logits, ``(N, C)`` binary targets; per sample
    ``-mean_C(y log sigmoid(x) + (1 - y) log sigmoid(-x))``, mean over the
    batch."""

    def forward(self, output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        per = -torch.mean(target * F.logsigmoid(output)
                          + (1.0 - target) * F.logsigmoid(-output), dim=-1)
        return torch.mean(per)


@register("loss")
class HingeEmbeddingLoss(Loss):
    """``x`` where the target is 1, ``max(0, margin - x)`` where it is -1,
    mean."""

    def __init__(self, margin: float = 1.0):
        super().__init__()
        self.margin = float(margin)

    def forward(self, output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        neg = torch.clamp(self.margin - output, min=0.0)
        return torch.mean(torch.where(target > 0, output, neg))
