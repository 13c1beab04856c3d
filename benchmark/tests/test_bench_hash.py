"""The cell ngp-hash-l16f2.train at tiny sizes on the CPU, found by the
registry from its new files alone (configs/, workloads/, drivers/
ngp_hash_train.py, metrics/): both kinds of run give their result line,
the reference agrees with the port's CPU path, and each planted fault and
the control come out not correct. The program's hash grid stays at its
published size (the trainer builds HashGridConfig() from --encoder)."""
from __future__ import annotations

import io
import json
import time

import pytest

from benchmark.tests.tiny import NGP_CFG, NGP_SCENE, ROOT

CELL = "ngp-hash-l16f2.train"
WORKLOAD = {"scene": NGP_SCENE, "warm_steps": 6, "trace_seconds": 0.5}


def run_cell(trace: int = 0, fault: str | None = None):
    from benchmark.harness.cli import run

    out = io.StringIO()
    rc = run(["--workload", CELL, "--seed", "3000000001", "--seconds", "1", "--trace",
              str(trace)], time.perf_counter(), ROOT, device="cpu", fault=fault,
             config_override=NGP_CFG, workload_override=WORKLOAD, out=out)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


def test_the_registry_runs_the_cell():
    from benchmark.harness import registry

    bench = registry.load_benchmark(ROOT)
    rc, line = run_cell(trace=0)
    assert rc == 0 and line["correct"], line["checks"]
    assert set(line["metrics"]) == {"block_step_ms", "setup_s"}
    rc, line = run_cell(trace=1)
    assert rc == 0
    names = {m["name"] for m in registry.per_layer_for(bench, CELL)}
    assert len(names) == 10 and set(line["metrics"]) <= names
    # off the card: no kernel, no device span; the plain encoder counts its calls
    assert line["metrics"]["k6_share.hash_train"]["value"] == 0.0
    assert {"idle_share.hash_train", "device_ops.hash_train",
            "mfu.hash_train"} <= set(line["metrics"])


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_planted_fault_is_not_correct(fault):
    rc, line = run_cell(fault=fault)
    assert rc == 0 and not line["correct"], line["checks"]


def test_the_control_fails():
    from benchmark.tools.readings import main

    (line,) = main(["--workload", CELL, "--seeds", "424242", "--seconds", "1", "--control"],
                   device="cpu", config_override=NGP_CFG, workload_override=WORKLOAD)
    with open(f"{ROOT}/benchmark/workloads/{CELL}.json") as f:
        limits = json.load(f)["limits"]
    assert all(line["program"][k] <= lim for k, lim in limits.items()), line
    assert any(line["control"][k] > lim for k, lim in limits.items()), line
