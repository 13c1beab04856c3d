"""`correct` at tiny sizes on the CPU: the plain reference agrees with the
port's CPU path on each entry; the control (the reference one precision
down, in the program's place) fails one of each cell's numbers; and each
fault that a cell can have, planted under the timed path, makes the run
come out not correct. Every run skips the look for a card and drives
the rest of a run."""
from __future__ import annotations

import pytest

from benchmark.tests.tiny import SIZES, run_cell

CELLS = list(SIZES)
# where a tiny CPU run reads above the cell's limit for a reason of its size:
# at 64 rays a step the bf16 sums of the table gradient move the second and
# third steps' loss by up to about 2e-4 (at the cell's 4096-16384 rays on
# the card, at most 7.7e-6 over 12 seeds)
TINY_CPU = {("ngp-l4f8.train", "loss_gap"): 1e-3}
FAULTS = [("ngp-l4f8.train", "unchanged"), ("ngp-l4f8.train", "half_batch"),
          ("regtr-r50.train", "unchanged")]


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_port(cell):
    rc, line = run_cell(cell)
    assert rc == 0
    for name, c in line["checks"].items():
        assert c["value"] <= max(c["limit"], TINY_CPU.get((cell, name), 0.0)), (name, c)


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_planted_fault_is_not_correct(cell, fault):
    rc, line = run_cell(cell, fault=fault)
    assert rc == 0
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(cell):
    from benchmark.harness import registry
    from benchmark.tests.tiny import ROOT
    from benchmark.tools.readings import main

    cfg, wl = SIZES[cell]
    (line,) = main(["--workload", cell, "--seeds", "424242", "--seconds", "1", "--control"],
                   device="cpu", config_override=cfg, workload_override=wl)
    _, _, workload = registry.cell_files(ROOT, registry.load_benchmark(ROOT), cell)
    limits = workload["limits"]
    assert all(line["program"][k] <= max(lim, TINY_CPU.get((cell, k), 0.0))
               for k, lim in limits.items()), line
    assert any(line["control"][k] > lim for k, lim in limits.items()), line
