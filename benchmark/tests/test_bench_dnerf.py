"""The cell dnerf-8x256.train at tiny sizes on the CPU, found by the
registry from its new files alone (configs/, workloads/, drivers/
dnerf_train.py, metrics/, traffic/dynamic.py): both kinds of run give
their result line, the reference agrees with the port's CPU path, each
planted fault and the control come out not correct, and the MLP counts
agree with the smoke's. The field keeps its published widths; the scene,
the buffer, the grid and the loops shrink."""
from __future__ import annotations

import io
import json
import time

import pytest

from benchmark.tests.tiny import ROOT

CELL = "dnerf-8x256.train"
CFG = {"sample_budget": 4096, "max_march_steps": 64, "grid_resolution": 16,
       "init_num_rays": 64, "max_num_rays": 64}
SCENE = {"family": "moving_spheres", "scene_seed": 7, "views": 4, "image_size": 16,
         "camera_distance": 3.0, "fov_x": 0.9, "max_offset": 0.15}
WORKLOAD = {"scene": SCENE, "warm_steps": 6, "trace_seconds": 0.5}


def run_cell(trace: int = 0, fault: str | None = None):
    from benchmark.harness.cli import run

    out = io.StringIO()
    rc = run(["--workload", CELL, "--seed", "3000000001", "--seconds", "1", "--trace",
              str(trace)], time.perf_counter(), ROOT, device="cpu", fault=fault,
             config_override=CFG, workload_override=WORKLOAD, out=out)
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
    assert len(names) == 6 and set(line["metrics"]) <= names
    # off the card: no GEMM kernel names and no graph; the counters count
    assert {"idle_share.dnerf_train", "device_ops.dnerf_train", "mfu.dnerf_train",
            "warp_share.dnerf_train"} == set(line["metrics"])
    assert line["metrics"]["warp_share.dnerf_train"]["value"] == 100.0  # no update traced


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_planted_fault_is_not_correct(fault):
    rc, line = run_cell(fault=fault)
    assert rc == 0 and not line["correct"], line["checks"]


def test_the_control_fails():
    from benchmark.tools.readings import main

    (line,) = main(["--workload", CELL, "--seeds", "424242", "--seconds", "1", "--control"],
                   device="cpu", config_override=CFG, workload_override=WORKLOAD)
    with open(f"{ROOT}/benchmark/workloads/{CELL}.json") as f:
        limits = json.load(f)["limits"]
    assert all(line["program"][k] <= lim for k, lim in limits.items()), line
    assert any(line["control"][k] > lim for k, lim in limits.items()), line


@pytest.mark.parametrize("warp", [False, True])
def test_mlp_counts_agree_with_the_smoke(warp):
    """mlp_counts' forward multiply-adds a sample against chip_smoke's
    mlp_macs of the program's config; without the warp, less the warp's."""
    import torch

    from benchmark.drivers.dnerf_train import WIDTHS
    from benchmark.harness import mlp_counts
    from benchmark.reference.dnerf import layer_shapes
    from chip_smoke import mlp_macs
    from dregnerf_tpu_torch.models.mlp_nerf import VanillaNeRFConfig

    with open(f"{ROOT}/benchmark/configs/dnerf-8x256.json") as f:
        cfg = json.load(f)
    mc = VanillaNeRFConfig(**{k: cfg[k] for k in WIDTHS}, warp=warp,
                           compute_dtype=torch.bfloat16)
    shapes = layer_shapes(cfg)
    warp_macs = sum(a * b for a, b in [*shapes["warp"], shapes["warp_out"]])
    assert mlp_counts.forward_macs(cfg) - (0 if warp else warp_macs) == mlp_macs(mc)
    assert mlp_counts.forward_macs(cfg) == 610_496 and warp_macs == 17_088
