"""A trainer's step captured as one CUDA graph and replayed (both trainers'
single-device steps: runtime/ngp_trainer.py, runtime/reg_trainer.py).

A trainer writes its step once, as a `body` against static inputs that it
fills before each replay: a function of no arguments that returns the
step's metrics, a dict of tensors. `StepGraph(part, body, state, pool)`
captures it at the first `replay`: `warm_up` runs it on a side stream and
puts the tensors of `state` back, then the recording runs it into the
graph, in `pool` when given (graphs that never run at once may share one).
The body must not read the device on the host: capture refuses it. A body
that reaches its trainer through `weakref.proxy` lets a dropped trainer's
graph memory go at once, where a cycle would wait for the collector.

The static output is one byte vector (`pack`): the metrics, then the
device values of the counters the body counted (`profiling.collect`). It
is cloned once a replay and the metrics are views of the clone, so that
two steps' metrics never alias. After each replay every counter the body
counted is counted again, as the eager step counts it: a device value with
the replay's value, a host number with the recording's.
`<part>.graph_captures` and `<part>.graph_replays` count captures and
replays.
"""
from __future__ import annotations

import torch

from dregnerf_tpu_torch.runtime import profiling

DEVICE_TYPES = ("cuda",)  # where a step is captured


def new_pool(device):
    """A memory pool for graphs that never run at once, or None off the card."""
    return torch.cuda.graph_pool_handle() if torch.device(device).type == "cuda" else None


def warm_up(body, state: list):
    """Runs `body` once and puts the tensors of `state` back as they were,
    even when it raises; returns its output. One run does the lazy set-up a
    capture must not meet (cuDNN's and cuBLAS's handles and plans);
    make_graphed_callables' 3 (11 under DDP) serve DDP's bucket rebuild,
    which these steps do not have. A RegTr run costs 0.3 s."""
    saved = [t.clone() for t in state]
    try:
        return body()
    finally:
        for t, s in zip(state, saved):
            t.copy_(s)


def capture(body, state: list, pool=None):
    """(graph, its static output): `body` captured as a CUDA graph, in
    `pool` when given, after a warm-up on a side stream that leaves `state`
    as it found it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        warm_up(body, state)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool):
        out = body()
    return graph, out


def pack(values: list) -> tuple[torch.Tensor, list]:
    """One uint8 vector of the tensors `values`, wider elements first so that
    each lies aligned for its dtype, and the layout `unpack` reads."""
    layout, parts, at = [None] * len(values), [], 0
    for i in sorted(range(len(values)), key=lambda i: -values[i].element_size()):
        v = values[i].detach()
        n = v.numel() * v.element_size()
        layout[i] = (at, n, v.dtype, tuple(v.shape))
        parts.append(v.reshape(-1).view(torch.uint8))
        at += n
    return torch.cat(parts), layout


def unpack(out: torch.Tensor, layout: list) -> list:
    """The tensors of a packed vector, as views of it."""
    return [out[at:at + n].view(dtype).view(shape) for at, n, dtype, shape in layout]


class StepGraph:
    """A step `body` and its graph, captured at the first `replay` after a
    warm-up that puts `state` back, in `pool`; its counts go under `part`."""

    def __init__(self, part: str, body, state: list, pool=None):
        self.part, self.body, self.state, self.pool = part, body, state, pool
        self.graph = self.out = self.layout = None
        self.names: list = []  # the metrics' names, in the body's order
        self.counts: list = []  # (counter, its host number, or None for a device value)

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def record(self) -> torch.Tensor:
        """The body run once, its metrics and counters packed."""
        with profiling.collect({}) as counts:
            metrics = self.body()
        self.names = list(metrics)
        self.counts = [(name, None if isinstance(v, torch.Tensor) else v)
                       for name, values in counts.items() for v in values]
        device = [v for values in counts.values() for v in values if isinstance(v, torch.Tensor)]
        out, self.layout = pack([*metrics.values(), *device])
        return out

    def replay(self) -> dict:
        """One replay (after the capture, at the first call): the body's
        metrics, as views of this replay's own copy; counts the counters."""
        if self.graph is None:
            self.graph, self.out = capture(self.record, self.state, self.pool)
            profiling.count(f"{self.part}.graph_captures", 1)
        self.graph.replay()
        profiling.count(f"{self.part}.graph_replays", 1)
        values = unpack(self.out.clone(), self.layout)
        device = iter(values[len(self.names):])
        for name, v in self.counts:
            profiling.count(name, next(device) if v is None else v)
        return dict(zip(self.names, values))
