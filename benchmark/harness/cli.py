"""One run of one cell: set-up, the timed window, the check, the result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics with `--trace 0`, its
per-layer metrics with `--trace 1`), `device`, with `--trace 1`
`breakdown`, and last `checks`, every number compared beside its limit.
The checks are also the last lines of standard error.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import sys
import tempfile
import time

from benchmark.harness import registry
from benchmark.harness.api import Context
from benchmark.harness.device import device_info, forbidden_loaded, require_cards
from benchmark.harness.tracing import Tracer

EXIT_NO_CARD = 3
EXIT_FORBIDDEN = 4


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def set_cache_dirs(root: str) -> None:
    """Kernel caches of the libraries the program may use, at fixed paths
    inside the checkout (the port's own nvcc objects already live in
    dregnerf_tpu_torch/_build/)."""
    cache = os.path.join(root, ".bench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def _json_number(v: float):
    """v for strict JSON: an infinite gap as the largest float, NaN as null."""
    if math.isnan(v):
        return None
    return v if math.isfinite(v) else math.copysign(sys.float_info.max, v)


def _fail(msg: str, code: int) -> int:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    return code


def run(argv, t0: float, root: str, device: str | None = None, fault: str | None = None,
        config_override: dict | None = None, workload_override: dict | None = None,
        out=None) -> int:
    """Runs the cell; returns the exit code. `device` "cpu" (with the
    overrides, `fault`) is for the CPU tests only: a measuring run takes
    the card or exits."""
    args = parse(argv)
    out = out or sys.stdout
    set_cache_dirs(root)
    bench = registry.load_benchmark(root)
    cell, config, workload = registry.cell_files(root, bench, args.workload)
    config = {**config, **(config_override or {})}
    workload = {**workload, **(workload_override or {})}

    import torch

    if device is None:
        why = require_cards(int(cell["chips"]))
        if why:
            return _fail(why, EXIT_NO_CARD)
        device = "cuda"
    dev = torch.device(device)
    drv = registry.driver(workload["driver"])
    workdir = tempfile.mkdtemp(prefix="bench-")
    try:
        ctx = Context(seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                      device=dev, config=config, workload=workload, cell=cell,
                      workdir=workdir, fault=fault)
        state = drv.setup(ctx)
        setup_s = time.perf_counter() - t0
        print(f"[{time.perf_counter():.2f}] set-up done in {setup_s:.2f} s; the window opens",
              file=sys.stderr, flush=True)
        tracer = Tracer(ctx.trace, float(workload.get("trace_seconds", 3.0)), dev.type)
        result = drv.window(state, ctx, tracer)
        tracer.stop(result.attempted)
        summary = tracer.summarize()
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        loaded = forbidden_loaded()
        if loaded:
            return _fail(f"modules of JAX or the JAX package loaded: {loaded}",
                         EXIT_FORBIDDEN)
        print(f"[{time.perf_counter():.2f}] the window closed; checking",
              file=sys.stderr, flush=True)
        checks = drv.check(state, ctx)
        del state
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    metrics = {}
    if not ctx.trace:
        values = {**result.end_to_end, "setup_s": setup_s}
        for m in registry.end_to_end_for(bench, cell["name"]):
            if m["name"] not in values:
                raise KeyError(f"driver {workload['driver']} gave no {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m in registry.per_layer_for(bench, cell["name"]):
            value = registry.reader(m["name"]).read(result.record, summary)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    info = device_info(dev, int(cell["chips"]), peak)
    line = {"correct": bool(checks) and all(c.ok for c in checks), "attempted": result.attempted,
            "failed": result.failed, "metrics": metrics, "device": info}
    if ctx.trace and summary is not None:
        s = summary
        info.update(busy_s=s.busy_s, window_s=s.window_s)
        line["breakdown"] = {"device_ops": s.device_ops, "idle_gaps": s.idle_gaps}
    line["checks"] = {c.name: {"value": _json_number(c.value), "limit": c.limit} for c in checks}
    loaded = forbidden_loaded()
    if loaded:
        return _fail(f"modules of JAX or the JAX package loaded: {loaded}", EXIT_FORBIDDEN)
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr, flush=True)
    print(json.dumps(line), file=out, flush=True)
    return 0
