"""Profiling hooks (port of ``vsr_tpu/utils/profiling.py``).

``trace(log_dir)`` records a ``torch.profiler`` trace (CPU and, where a card
is present, CUDA activities) and writes it into ``log_dir`` as a Chrome
trace (``trace_<pid>_<ns>.json``, readable by ``chrome://tracing`` and
Perfetto); ``StepTimer`` collects wall-time percentiles, synchronizing on
the result's device only when asked; ``kernel_events`` reads a trace's
device kernels back.

The JAX package's ``compiled_flops`` (XLA's cost analysis of a compiled
program) and ``summarize_trace`` (its XLA-op track by HLO category) have
no counterpart: the port compiles no program and its traces carry no HLO
categories.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(log_dir: str | Path | None):
    """Record a ``torch.profiler`` trace into ``log_dir`` (no-op when
    None). The trace is written when the block ends, an exception
    included."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    Path(log_dir).mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        try:
            yield
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(
        str(Path(log_dir) / f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _synchronize(result) -> None:
    """Wait for the device work behind ``result`` (a tensor or a nest of
    tuples, lists and dicts of tensors)."""
    if isinstance(result, torch.Tensor):
        if result.device.type == "cuda":
            torch.cuda.synchronize(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            _synchronize(v)
    elif isinstance(result, (tuple, list)):
        for v in result:
            _synchronize(v)


class StepTimer:
    """Wall-clock step statistics with an explicit sync boundary."""

    def __init__(self) -> None:
        self.samples: list[float] = []
        self._t0: float | None = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> float:
        """Optionally waits for ``result``'s device before taking the
        timestamp."""
        if result is not None:
            _synchronize(result)
        dt = time.perf_counter() - (self._t0 or time.perf_counter())
        self.samples.append(dt)
        return dt

    def summary(self) -> dict:
        if not self.samples:
            return {}
        xs = sorted(self.samples)
        n = len(xs)
        return {
            "steps": n,
            "mean_s": sum(xs) / n,
            "p50_s": xs[n // 2],
            "p90_s": xs[min(n - 1, int(n * 0.9))],
            "max_s": xs[-1],
        }


def kernel_events(path: str | Path) -> list[dict]:
    """The device kernels of a Chrome trace that :func:`trace` wrote."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    return [e for e in events if e.get("cat") == "kernel" and "dur" in e]
