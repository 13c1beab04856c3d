"""Tiny sizes of each cell, for the CPU tests: every width of the
configuration stays; the scene, the buffer, the grids and the loops
shrink so that a run fits a test on the CPU."""
from __future__ import annotations

import io
import json
import os
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

NGP_CFG = {"sample_budget": 4096, "max_march_steps": 64, "grid_resolution": 16,
           "init_num_rays": 64, "max_num_rays": 256}
NGP_SCENE = {"family": "spheres", "scene_seed": 7, "views": 4, "image_size": 16,
             "camera_distance": 3.0, "fov_x": 0.9}
REG_CFG = {"grid_resolution": 16}

SIZES = {
    "ngp-l4f8.train": (NGP_CFG, {"scene": NGP_SCENE, "warm_steps": 6, "trace_seconds": 0.5}),
    "regtr-r50.train": (REG_CFG, {"warm_steps": 1, "trace_seconds": 0.5}),
}


def run_cell(cell: str, seed: int = 3000000001, trace: int = 0, fault: str | None = None,
             seconds: float = 1.0) -> tuple[int, dict | None]:
    """(exit code, the result line) of one tiny run on the CPU."""
    from benchmark.harness.cli import run

    cfg, wl = SIZES[cell]
    out = io.StringIO()
    rc = run(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
              "--trace", str(trace)], time.perf_counter(), ROOT, device="cpu", fault=fault,
             config_override=cfg, workload_override=wl, out=out)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)
