"""Profiling and tracing (port of dregnerf_tpu/runtime/profiling.py).

  * `annotate(name)`: the port's span. Off whenever no torch.profiler
    session is recording: it is then one shared no-op, which reads no
    clock, allocates nothing and adds no device operation. On, it is a
    `record_function` range, an event of the profiler's own trace on the
    kernels' clock, and the store below keeps its calls, its host time
    (perf_counter_ns at entry and exit) and, on the card, a pair of
    timing events on the current stream (host times only while a CUDA
    graph is being captured).
  * `count(name, value)`: a counter, on under the same gate: a host int,
    or a device scalar the step already computes (kept by reference and
    summed when read, so that counting adds no device operation).
  * `snapshot()` / `reset()`: the store's spans and counters.
  * `trace(logdir)`: a torch.profiler trace of a code region for
    TensorBoard's profiler, with the store's snapshot beside it in
    `spans.json`; `StepWindow` runs the steps of `--profile_steps` under it.

Span names are `<part>.<stage>`: a step span (`ngp.step`, `regtr.step`)
and the stage spans directly inside it, which divide the step between
them. A stage's `device_ms` runs from the stream reaching its first event
to the stream reaching its last, so it includes the device's wait for the
stage's launches, and the stages of a step add up to the step.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Iterator

import torch


class _Entry:
    """One span name's calls, host ns, device ms (None until a pair of
    events is read) and recorded pairs of events not read yet."""

    __slots__ = ("calls", "host_ns", "device_ms", "pairs")

    def __init__(self) -> None:
        self.calls, self.host_ns, self.device_ms, self.pairs = 0, 0, None, []


class _Store:
    """The spans ({name: _Entry}) and counters ({name: [values]}) of the
    profiled regions since the last reset."""

    def __init__(self) -> None:
        self.spans: dict = {}
        self.counters: dict = {}
        self.pool: list = []  # timing events to reuse
        # Stream objects by raw handle: torch.cuda.current_stream() builds
        # one a call, which costs more host time than recording the event
        self.streams: dict = {}

    def stream(self):
        """The current CUDA stream, or None off the card and inside a
        CUDA-graph capture (where a span keeps host times only)."""
        if not torch.cuda.is_initialized() or torch.cuda.is_current_stream_capturing():
            return None
        raw = torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())
        stream = self.streams.get(raw)
        if stream is None:
            stream = self.streams[raw] = torch.cuda.current_stream()
        return stream

    def event(self, stream):
        """A timing event recorded on `stream`: from the pool, refilled from
        the pairs the stream has passed before a new event is made (a new
        one costs more host time than the record)."""
        if not self.pool:
            self.fold(wait=False)
        ev = self.pool.pop() if self.pool else torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    def add(self, name: str, host_ns: int, start, end) -> None:
        entry = self.spans.get(name)
        if entry is None:
            entry = self.spans[name] = _Entry()
        entry.calls += 1
        entry.host_ns += host_ns
        if start is not None:
            entry.pairs.append((start, end))

    def fold(self, wait: bool) -> None:
        """Fold recorded pairs of events into their spans' device ms and put
        the events back in the pool: every pair after a synchronise when
        `wait`, else each span's pairs up to the first the stream has not
        passed yet (a span's pairs are in stream order)."""
        if wait:
            if not any(e.pairs for e in self.spans.values()):
                return
            torch.cuda.synchronize()
        for entry in self.spans.values():
            pairs = entry.pairs
            n = len(pairs) if wait else 0
            while n < len(pairs) and pairs[n][1].query():
                n += 1
            for start, end in pairs[:n]:
                entry.device_ms = (entry.device_ms or 0.0) + start.elapsed_time(end)
                self.pool += (start, end)
            del pairs[:n]

    @staticmethod
    def total(values: list):
        """The sum of host numbers and device scalars (one read a device)."""
        out = sum(v for v in values if not isinstance(v, torch.Tensor))
        by_device: dict = {}
        for v in values:
            if isinstance(v, torch.Tensor):
                by_device.setdefault(v.device, []).append(v.detach().reshape(()))
        for ts in by_device.values():
            exact = not any(t.is_floating_point() for t in ts)
            s = torch.stack([t.to(torch.int64 if exact else torch.float64) for t in ts]).sum()
            out += s.item()
        return out

    def snapshot(self) -> dict:
        self.fold(wait=True)
        for name, values in self.counters.items():
            self.counters[name] = [self.total(values)]
        return {
            "spans": {name: {"calls": e.calls, "host_ms": e.host_ns * 1e-6,
                             "device_ms": e.device_ms} for name, e in self.spans.items()},
            "counters": {name: v[0] for name, v in self.counters.items()},
        }

    def reset(self) -> None:
        for entry in self.spans.values():
            for pair in entry.pairs:
                self.pool += pair
        self.spans.clear()
        self.counters.clear()


_STORE = _Store()


class _Off:
    """The span while no profiler records: one shared instance."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "_range", "_stream", "_start", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> None:
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self._stream = _STORE.stream()
        self._start = None if self._stream is None else _STORE.event(self._stream)
        self._t0 = time.perf_counter_ns()

    def __exit__(self, *exc) -> bool:
        host_ns = time.perf_counter_ns() - self._t0
        end = None if self._stream is None else _STORE.event(self._stream)
        self._range.__exit__(*exc)
        _STORE.add(self.name, host_ns, self._start, end)
        return False


def annotate(name: str):
    """The span `name` (a context manager): a named range in the profiler's
    trace and an entry of the store while a profiler records; else a
    no-op."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name)


def count(name: str, value) -> None:
    """Adds `value` (a host int, or a device scalar the caller already
    computed) to the counter `name` while a profiler records."""
    if torch.autograd._profiler_enabled():
        _STORE.counters.setdefault(name, []).append(value)


def snapshot() -> dict:
    """{"spans": {name: {"calls", "host_ms", "device_ms"}}, "counters":
    {name: total}} of the store (synchronises the card first). device_ms
    is None for a span that recorded no timing events (off the card)."""
    return _STORE.snapshot()


def reset() -> None:
    """Empties the store."""
    _STORE.reset()


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Capture a torch.profiler trace into `logdir` (tensorboard_trace_handler)
    with a fresh store, and write its snapshot to `logdir`/spans.json."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    reset()
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield
    os.makedirs(logdir, exist_ok=True)
    with open(os.path.join(logdir, "spans.json"), "w") as f:
        json.dump(snapshot(), f, indent=1)


class StepWindow:
    """The steps START .. START+COUNT-1 of a training loop (--profile_steps
    START:COUNT, in the trainer's step numbering; '' profiles none) under
    `trace(logdir)`: call `begin(step)` before a step and `end(step)` after
    it; leaving the `with` block closes a window still open."""

    def __init__(self, spec: str, logdir: str):
        self.first = self.stop = 0
        if spec:
            try:
                first, n = (int(x) for x in spec.split(":"))
            except ValueError:
                raise ValueError(f"--profile_steps wants START:COUNT, got {spec!r}") from None
            if first < 0 or n < 1:
                raise ValueError(f"--profile_steps wants START >= 0 and COUNT >= 1, got {spec!r}")
            self.first, self.stop = first, first + n
        self.logdir = logdir
        self._open = None

    def begin(self, step: int) -> None:
        if self._open is None and step == self.first < self.stop:
            self._open = trace(self.logdir)
            self._open.__enter__()

    def end(self, step: int) -> None:
        if self._open is not None and step + 1 >= self.stop:
            self.close()

    def close(self) -> None:
        if self._open is not None:
            ctx, self._open = self._open, None
            ctx.__exit__(None, None, None)

    def __enter__(self) -> "StepWindow":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
