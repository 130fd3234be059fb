"""Checkpoint cadence / best-model / early-stop monitor.

A copy of ``vsr_tpu/callbacks/monitor.py`` (pure Python):
- regular save every ``saved_freq`` epochs -> ``model_{epoch}.ckpt``,
- best tracking of ``target`` under ``mode`` in {'max','min'} ->
  ``model_best.ckpt``,
- early stop when ``not_improved_count == early_stop`` (0 disables).

State is exported as a plain dict for the checkpoint's ``aux`` record.
"""

from __future__ import annotations

import math
from pathlib import Path

from vsr_tpu_torch.registry import register


@register("monitor")
class Monitor:
    def __init__(self, checkpoints_dir: str | Path, mode: str, target: str,
                 saved_freq: int, early_stop: int = 0):
        self.checkpoints_dir = Path(checkpoints_dir)
        if mode not in ("min", "max"):
            raise ValueError(f"mode should be 'min' or 'max', got {mode!r}")
        self.mode = mode
        self.target = target
        self.saved_freq = saved_freq
        self.early_stop = math.inf if early_stop == 0 else early_stop
        self.best = math.inf if mode == "min" else -math.inf
        self.not_improved_count = 0

    def is_saved(self, epoch: int) -> Path | None:
        if epoch % self.saved_freq == 0:
            self.checkpoints_dir.mkdir(parents=True, exist_ok=True)
            return self.checkpoints_dir / f"model_{epoch}.ckpt"
        return None

    def is_best(self, valid_log: dict) -> Path | None:
        score = valid_log[self.target]
        improved = score < self.best if self.mode == "min" else score > self.best
        if improved:
            self.best = score
            self.not_improved_count = 0
            self.checkpoints_dir.mkdir(parents=True, exist_ok=True)
            return self.checkpoints_dir / "model_best.ckpt"
        self.not_improved_count += 1
        return None

    def is_early_stopped(self) -> bool:
        return self.not_improved_count == self.early_stop

    def state_dict(self) -> dict:
        return {
            "best": None if math.isinf(self.best) else self.best,
            "best_sign": 1 if self.mode == "min" else -1,
            "not_improved_count": self.not_improved_count,
        }

    def load_state_dict(self, state: dict) -> None:
        if state.get("best") is None:
            self.best = math.inf if self.mode == "min" else -math.inf
        else:
            self.best = state["best"]
        self.not_improved_count = state["not_improved_count"]
