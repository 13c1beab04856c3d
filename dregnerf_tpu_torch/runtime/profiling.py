"""Profiling and tracing (port of dregnerf_tpu/runtime/profiling.py):
  * `trace(logdir)`: a torch.profiler trace of a code region (the CPU, and
    the card when there is one), written for TensorBoard's profiler;
  * `annotate(name)`: a named range in that trace;
  * `PhaseTimer`: host wall-clock accumulated per named phase.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Capture a torch.profiler trace into `logdir` (tensorboard_trace_handler)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named range in the trace (little cost outside tracing)."""
    with torch.profiler.record_function(name):
        yield


class PhaseTimer:
    """Accumulating host-side phase timer.

    with timer.phase("train_step"): ...
    print(timer.summary())
    """

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        lines = []
        total = sum(self.totals.values()) or 1.0
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(
                f"{name:24s} {t:9.2f}s  {t / total * 100:5.1f}%  "
                f"x{n}  ({t / max(n, 1) * 1e3:.1f} ms avg)"
            )
        return "\n".join(lines)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
