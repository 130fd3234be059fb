"""Failure recovery helpers (copy of ``vsr_tpu/utils/recovery.py``): find the
newest checkpoint in a run directory, so a preempted or crashed job restarted
with the same config picks up where it left off (``main.auto_resume: true``).
"""

from __future__ import annotations

import re
from pathlib import Path


def find_latest_checkpoint(checkpoints_dir: str | Path) -> Path | None:
    """Newest regular checkpoint (``model_<epoch>.ckpt``) by epoch number.
    A ``model_preempt.ckpt`` written by the graceful SIGTERM handler wins
    when it is newer (by mtime) than the newest regular one; falls back to
    ``model_best.ckpt`` when nothing else exists."""
    checkpoints_dir = Path(checkpoints_dir)
    if not checkpoints_dir.is_dir():
        return None
    best_epoch, best_path = -1, None
    for path in checkpoints_dir.glob("model_*.ckpt"):
        m = re.fullmatch(r"model_(\d+)\.ckpt", path.name)
        if m and int(m.group(1)) > best_epoch:
            best_epoch, best_path = int(m.group(1)), path
    preempt = checkpoints_dir / "model_preempt.ckpt"
    if preempt.exists() and (
        best_path is None or preempt.stat().st_mtime >= best_path.stat().st_mtime
    ):
        return preempt
    if best_path is not None:
        return best_path
    best = checkpoints_dir / "model_best.ckpt"
    return best if best.exists() else None
