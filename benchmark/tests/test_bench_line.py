"""The result line's schema, and the percentile that a tail metric takes."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from benchmark.harness import stats
from benchmark.tests.tiny import ROOT, run_cell


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_schema(trace):
    rc, line = run_cell("ngp-l4f8.train", trace=trace)
    assert rc == 0
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert isinstance(line["correct"], bool) and line["attempted"] >= 1 and line["failed"] == 0
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert set(line["metrics"]) == {"idle_share.block_train", "device_ops.block_train",
                                        "mfu.block_train"}  # no card: no kernel rooflines
        assert dev["busy_s"] > 0 and dev["window_s"] > 0
        for key in ("device_ops", "idle_gaps"):
            rows = line["breakdown"][key]
            assert len(rows) <= 10
            assert all(isinstance(n, str) and isinstance(v, float) for n, v in rows)
    else:
        assert set(line["metrics"]) == {"block_step_ms", "setup_s"}
        assert "breakdown" not in line


def test_percentile_is_numpys():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 200, 1001):
        xs = list(rng.exponential(size=n))
        assert stats.percentile(xs, 95) == pytest.approx(float(np.percentile(xs, 95)), rel=1e-12)


@pytest.mark.cuda
def test_a_cell_on_the_card(tmp_path):
    """On a machine with a card: one short run of the first cell prints a
    correct line."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark measures on the card only")
    p = subprocess.run([sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
                        "--workload", "ngp-l4f8.train", "--seed", "5", "--seconds", "2",
                        "--trace", "0"], capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
