"""What a driver gets and gives back.

A driver module (`benchmark/drivers/<kind>.py`, named by the `driver` key
of a cell's workload file) defines three functions:

  setup(ctx) -> state       build the program, make the inputs from the
                            seed, warm up every shape the window uses, and
                            take the readings of the first steps that the
                            check needs; ends synchronised
  window(state, ctx, tracer) -> WindowResult
                            run for ctx.seconds, calling tracer.tick(n)
                            after each unit
  check(state, ctx) -> [Check]
                            free the program's state, run the reference,
                            and return every number compared beside its
                            limit
  control_values(state, ctx) -> {name: value}
                            after `check`: the same numbers for the control
                            (the reference one precision down in the
                            program's place); benchmark/tools/readings.py
                            reads it, the runs never do
"""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class Context:
    seed: int
    seconds: float
    trace: bool
    device: Any  # torch.device
    config: dict  # the configuration file
    workload: dict  # the cell's workload file
    cell: dict  # the cell's entry in BENCHMARK.json
    workdir: str  # scratch directory of this run (under TMPDIR), removed at exit
    fault: str | None = None  # a planted fault (tests only)


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit  # NaN fails


@dataclasses.dataclass
class WindowResult:
    attempted: int
    failed: int
    end_to_end: dict  # end-to-end metric name -> value
    record: dict  # what the per-layer readers read (see benchmark/metrics)
