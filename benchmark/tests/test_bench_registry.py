"""The harness finds a configuration, a cell and a per-layer metric added
as new files (and entries) in a copy of the benchmark, with no edit to a
file that is there."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.tests.tiny import NGP_CFG, NGP_SCENE, ROOT

LAUNCHER = """
import sys, time
sys.path[0] = {root!r}
from benchmark.harness.cli import run
sys.exit(run(sys.argv[1:], time.perf_counter(), {root!r}, device="cpu"))
"""


def _copy(tmp) -> str:
    """A checkout of BENCHMARK.json and the benchmark, with the program
    beside it (a link)."""
    root = str(tmp / "checkout")
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    return root


def _launch(root: str, *args) -> subprocess.CompletedProcess:
    with open(os.path.join(root, "launch.py"), "w") as f:
        f.write(LAUNCHER.format(root=root))
    return subprocess.run([sys.executable, os.path.join(root, "launch.py"), *args],
                          capture_output=True, text=True, timeout=600, cwd=root)


def test_new_config_cell_and_metric_as_files(tmp_path):
    root = _copy(tmp_path)
    os.symlink(os.path.join(ROOT, "dregnerf_tpu_torch"), os.path.join(root, "dregnerf_tpu_torch"))
    before = {os.path.join(d, p): open(os.path.join(d, p), "rb").read()
              for d, _, fs in os.walk(os.path.join(root, "benchmark")) for p in fs}
    bench_dir = os.path.join(root, "benchmark")
    with open(os.path.join(bench_dir, "configs", "ngp-l4f8.json")) as f:
        cfg = {**json.load(f), **NGP_CFG, "name": "ngp-small"}
    with open(os.path.join(bench_dir, "configs", "ngp-small.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench_dir, "workloads", "ngp-small.train.json"), "w") as f:
        json.dump({"driver": "ngp_train", "scene": NGP_SCENE, "warm_steps": 6,
                   "trace_seconds": 0.5,
                   "limits": {"loss_gap": 1.0, "grad_gap": 1.0, "update_gap": 1.0}}, f)
    with open(os.path.join(bench_dir, "metrics", "traced_units.py"), "w") as f:
        f.write('"""Units of the traced window."""\n\n\ndef read(record, trace):\n'
                '    return float(record["units"]) if record.get("units") else None\n')
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "ngp-small", "source": "https://example.org/ngp-small",
                             "file": "benchmark/configs/ngp-small.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "ngp-small.train", "config": "ngp-small",
                               "traffic": "train", "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("ngp-small.train")
    bench["per_layer"].append({"name": "traced_units.small", "unit": "steps",
                               "better": "higher", "source": "program_counter",
                               "layer": "NGP trainer loop", "moves": "block_step_ms",
                               "workloads": ["ngp-small.train"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    out = {}
    for trace in ("0", "1"):
        p = _launch(root, "--workload", "ngp-small.train", "--seed", "77", "--seconds", "1",
                    "--trace", trace)
        assert p.returncode == 0, p.stderr[-3000:]
        out[trace] = json.loads(p.stdout.strip().splitlines()[-1])
    assert set(out["0"]["metrics"]) == {"block_step_ms", "setup_s"}
    assert out["1"]["metrics"]["traced_units.small"]["value"] >= 1
    for path, data in before.items():
        assert open(path, "rb").read() == data, path


def test_a_per_layer_entry_without_workloads_is_refused():
    from benchmark.harness import registry

    bench = registry.load_benchmark(ROOT)
    entry = {k: v for k, v in bench["per_layer"][0].items() if k != "workloads"}
    bench["per_layer"].append({**entry, "name": "idle_share.unlisted"})
    with pytest.raises(KeyError, match="lists no workloads"):
        registry.per_layer_for(bench, "ngp-l4f8.train")


def test_without_the_program_the_run_fails(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark cannot run."""
    root = _copy(tmp_path)
    p = _launch(root, "--workload", "ngp-l4f8.train", "--seed", "1", "--seconds", "1",
                "--trace", "0")
    assert p.returncode != 0
    assert not p.stdout.strip()


def test_without_a_card_the_run_fails():
    p = subprocess.run([sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
                        "--workload", "ngp-l4f8.train", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, timeout=300,
                       cwd=ROOT, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert not p.stdout.strip()
