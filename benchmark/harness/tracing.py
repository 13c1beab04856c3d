"""The device trace of a run's window (`--trace 1`).

`Tracer` runs `torch.profiler` over the first `seconds` of the window,
stopped at a unit boundary (a step or a pair) after a
synchronise, so that the traced window holds whole units. From the
profiler's events it takes:

  * busy_s: the union of the device's operation intervals (kernels,
    copies, sets), so that overlapping operations count once;
  * window_s: the host's seconds from the profiler's start to the
    synchronise after the last traced unit;
  * kernel seconds by name (the per-layer readers look up their kernel);
  * the number of device operations;
  * the breakdown: the device operations that took most time, and the
    longest idle gaps summed by what the host was doing (the innermost
    host event that covers the gap's middle).

With tracing off every call is a no-op.
"""
from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

TOP = 10
NAME_CHARS = 160  # of an operation's name in the breakdown


@dataclass
class TraceSummary:
    busy_s: float
    window_s: float
    units: int
    n_device_ops: int
    kernel_s: dict = field(default_factory=dict)  # device seconds by operation name
    device_ops: list = field(default_factory=list)  # [[name, seconds]] top TOP
    idle_gaps: list = field(default_factory=list)  # [[host op, seconds]] top TOP

    def kernel_seconds(self, name_part: str) -> float:
        """Device seconds of every operation whose name holds `name_part`."""
        return sum(s for k, s in self.kernel_s.items() if name_part in k)


class Tracer:
    """Profiles the first `seconds` of a window when `enabled`."""

    def __init__(self, enabled: bool, seconds: float, device_type: str = "cuda"):
        self.enabled = enabled
        self.seconds = seconds
        self.device_type = device_type
        self.active = False
        self.summary: TraceSummary | None = None
        self._prof = None
        self._t0 = self._t1 = 0.0
        self._units = 0

    def _sync(self) -> None:
        import torch

        if self.device_type == "cuda":
            torch.cuda.synchronize()

    def start(self) -> None:
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device_type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self.active = True
        self._t0 = time.perf_counter()

    def tick(self, units_done: int) -> bool:
        """Call after each unit of the window; stops the profiler once its
        seconds have passed. Returns whether the unit just done was traced."""
        if not self.active:
            return False
        if time.perf_counter() - self._t0 >= self.seconds:
            self.stop(units_done)
        return True

    def stop(self, units_done: int) -> None:
        if not self.active:
            return
        self._sync()
        self._t1 = time.perf_counter()
        self._units = units_done
        self._prof.__exit__(None, None, None)
        self.active = False

    def summarize(self) -> TraceSummary | None:
        """The summary of the traced window (after the run's window: reading
        the profiler's events takes seconds)."""
        if self._prof is not None and self.summary is None:
            self.summary = summarize(self._prof, self._t1 - self._t0, self._units,
                                     self.device_type)
            self._prof = None
        return self.summary


def _union_and_gaps(intervals):
    """(busy ns, [(gap_start, gap_end)]) of sorted (start, end) intervals."""
    busy, gaps = 0, []
    cur_s = cur_e = None
    for s, e in intervals:
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, gaps


def summarize(prof, window_s: float, units: int, device_type: str) -> TraceSummary:
    from torch.autograd import DeviceType

    dev_type = DeviceType.CUDA if device_type == "cuda" else DeviceType.CPU
    events = prof.profiler.kineto_results.events()
    dev, host = [], []
    for e in events:
        if e.device_type() == dev_type and not e.is_user_annotation():
            dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
        elif e.device_type() == DeviceType.CPU and not e.is_user_annotation():
            host.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
    if device_type != "cuda":  # a CPU rehearsal: the host's own aten ops
        dev = [d for d in dev if d[2].startswith("aten::")]
    dev.sort()
    busy_ns, gaps = _union_and_gaps([(s, e) for s, e, _ in dev])
    kernel_s: dict[str, float] = {}
    for s, e, name in dev:
        kernel_s[name] = kernel_s.get(name, 0.0) + (e - s) * 1e-9
    top_ops = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:TOP]
    top_ops = [(name[:NAME_CHARS], v) for name, v in top_ops]

    # what the host was doing in each gap: the shortest host event that
    # covers the gap's middle
    host.sort()
    starts = [h[0] for h in host]
    by_host: dict[str, float] = {}
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:2000]:
        mid = (g0 + g1) // 2
        i = bisect.bisect_right(starts, mid)
        best = None
        for j in range(i - 1, max(i - 400, -1), -1):
            s, e, name = host[j]
            if e >= mid and (best is None or e - s < best[1] - best[0]):
                best = (s, e, name)
        name = best[2][:NAME_CHARS] if best else "(host Python between operations)"
        by_host[name] = by_host.get(name, 0.0) + (g1 - g0) * 1e-9
    top_gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]
    return TraceSummary(busy_s=busy_ns * 1e-9, window_s=window_s, units=units,
                        n_device_ops=len(dev), kernel_s=kernel_s,
                        device_ops=[[k, v] for k, v in top_ops],
                        idle_gaps=[[k, v] for k, v in top_gaps])
