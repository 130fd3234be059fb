"""Loss functions (port of ``vsr_tpu/losses.py``).

The project's own losses are ``nn.Module``s under their names: ``L1Loss``,
``MSELoss``, ``SmoothL1Loss``, ``HuberLoss``, ``CharbonnierLoss``,
``FlowLoss``. Any other ``*Loss`` name resolves to ``torch.nn``, as the
configs' name lookup always did.

Quirks kept on purpose: ``CharbonnierLoss`` adds epsilon (not epsilon^2)
under the square root, and ``HuberLoss`` is the project's delta-split flavor,
``mean(0.5 * min(|e|, delta)^2 + delta * (|e| - min(|e|, delta)))`` with a
required ``delta``. ``torch.nn.HuberLoss`` is a different function; the
project's own wins the lookup because registered names are found first.

All reductions are means over every element; layouts do not matter.
"""

from __future__ import annotations

import torch
from torch import nn

from vsr_tpu_torch.registry import register, register_fallback


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


def _torch_nn_loss(name: str) -> type | None:
    """Any other ``*Loss`` of ``torch.nn``, by name."""
    found = getattr(nn, name, None) if name.endswith("Loss") else None
    return found if isinstance(found, type) else None


register_fallback("loss", _torch_nn_loss)
