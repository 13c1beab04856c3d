"""The readings that a cell's limits are set from, many seeds in one process.

    python3 benchmark/tools/readings.py --workload <cell> --seeds 1,2,3 \
        [--seconds 2] [--control] [--fault <name>] [--out <file.jsonl>]

For each seed: the cell's set-up, a short window, and its check; prints
one JSON line of the program's numbers (under a planted `--fault`, the
faulty program's), and with `--control` the control's numbers (the
reference in the next lower precision, in the program's place). The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if __name__ == "__main__":
    sys.path[0] = ROOT


def main(argv=None, device: str = "cuda", config_override=None, workload_override=None):
    from benchmark.drivers import common
    from benchmark.harness import registry
    from benchmark.harness.api import Context
    from benchmark.harness.cli import set_cache_dirs
    from benchmark.harness.tracing import Tracer

    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    set_cache_dirs(ROOT)
    bench = registry.load_benchmark(ROOT)
    cell, config, workload = registry.cell_files(ROOT, bench, args.workload)
    config = {**config, **(config_override or {})}
    workload = {**workload, **(workload_override or {})}
    drv = registry.driver(workload["driver"])
    lines = []
    for seed in (int(x) for x in args.seeds.split(",")):
        workdir = tempfile.mkdtemp(prefix="bench-")
        t0 = time.perf_counter()
        try:
            ctx = Context(seed=seed, seconds=args.seconds, trace=False,
                          device=torch.device(device), config=config, workload=workload,
                          cell=cell, workdir=workdir, fault=args.fault)
            s = drv.setup(ctx)
            drv.window(s, ctx, Tracer(False, 0.0))
            checks = drv.check(s, ctx)
            line = {"seed": seed, "fault": args.fault,
                    "program": {**{c.name: c.value for c in checks},
                                **getattr(s, "diagnostics", {})}}
            if args.control:
                line["control"] = drv.control_values(s, ctx)
            line["seconds"] = time.perf_counter() - t0
            del s
            common.free(ctx.device)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        print(json.dumps(line), flush=True)
        lines.append(line)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return lines


if __name__ == "__main__":
    main()
