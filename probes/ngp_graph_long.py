#!/usr/bin/env python3
"""The NGP trainer's CUDA-graph step against its eager step over a long run,
on one CUDA card.

  python3 probes/ngp_graph_long.py [--steps 2000] [--seed 5] [--out PATH]

For each of the benchmark's stage-1 configurations (benchmark/configs/
ngp-l4f8.json, then ngp-hash-l16f2.json) on the benchmark's scene (100
views of 192 px), three trainers from one seed: one whose steps are
replays of its CUDA graphs (runtime/ngp_graph.py, the default on the
card), and two whose steps run eagerly (`ngp_graph.DEVICE_TYPES`
cleared), each for `--steps` steps through `train_iteration` with its
occupancy updates and ray-bucket feedback. All draw their rays from their
own generators, so they see the same rays while their buckets agree. The
step is not deterministic on the card (its atomics add in a varying
order), so the second eager run gives the size of a gap that is no fault.
Prints, and writes as JSON to `--out`, per configuration: the mean loss of
each window of 100 steps on each side and the largest relative gap of the
graph's and of the second eager run's windows from the first eager run's,
the first step whose ray bucket differs (None when none does), the buckets
each side met, the captures and replays, the final validation PSNR of each
(view 0, the trainer's `validate`) and the ms a step of each. A state that
the graph fails to carry from one replay to the next parts its curve from
both eager ones, however late. Imports nothing of JAX or of the JAX
package.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark.drivers import ngp_block, ngp_hash_train  # noqa: E402
from dregnerf_tpu_torch.runtime import ngp_graph  # noqa: E402
from dregnerf_tpu_torch.runtime.config import config_parser  # noqa: E402
from dregnerf_tpu_torch.runtime.ngp_trainer import NGPTrainer  # noqa: E402

CONFIGS = {"ngp-l4f8": ngp_block.program_flags, "ngp-hash-l16f2": ngp_hash_train.program_flags}
WINDOW = 100


def run(flags: list, scene, steps: int, graphed: bool) -> dict:
    """`steps` steps of a trainer built from `flags`, as graph replays or
    eagerly: the losses, the buckets, the validation PSNR and ms a step."""
    kept = ngp_graph.DEVICE_TYPES
    if not graphed:
        ngp_graph.DEVICE_TYPES = ()
    try:
        tr = NGPTrainer(config_parser(flags), scene, device="cuda")
        losses, buckets = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for step in range(steps):
            m = tr.train_iteration(step)
            losses.append(m["loss"])
            buckets.append(m["num_rays"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / steps * 1e3
        val_psnr = tr.validate(steps)
    finally:
        ngp_graph.DEVICE_TYPES = kept
    return {"losses": torch.stack(losses).tolist(), "buckets": buckets, "val_psnr": val_psnr,
            "ms_a_step": ms, "captures": tr.graph_captures, "replays": tr.graph_replays}


def windows(losses: list) -> list:
    return [sum(losses[i:i + WINDOW]) / len(losses[i:i + WINDOW])
            for i in range(0, len(losses), WINDOW)]


def gaps(run: dict, eager: dict) -> dict:
    """`run` against the first eager run: the worst relative gap of their
    window means, and the first step whose bucket differs."""
    rw, ew = windows(run["losses"]), windows(eager["losses"])
    return {"worst_window_gap": max(abs(a - b) / abs(b) for a, b in zip(rw, ew)),
            "buckets_part_at": next((i for i, (a, b) in enumerate(
                zip(run["buckets"], eager["buckets"])) if a != b), None)}


def compare(sides: dict) -> dict:
    eager = sides["eager"]
    out = {f"{name}_vs_eager": gaps(run, eager) for name, run in sides.items()
           if name != "eager"}
    for name, run in sides.items():
        out[name] = {"window_losses": windows(run["losses"]), "first_losses": run["losses"][:4],
                     "buckets": sorted(set(run["buckets"])), "captures": run["captures"],
                     "replays": run["replays"], "val_psnr": run["val_psnr"],
                     "ms_a_step": run["ms_a_step"]}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--out", default="ngp_graph_long.json")
    args = ap.parse_args(argv)
    with open(os.path.join(ROOT, "benchmark", "workloads", "ngp-l4f8.train.json")) as f:
        scene = ngp_block.scene_data(json.load(f)["scene"])
    out = {"device": torch.cuda.get_device_name(0), "steps": args.steps, "seed": args.seed}
    work = tempfile.mkdtemp(prefix="ngp_graph_long_")
    for name, program_flags in CONFIGS.items():
        with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as f:
            cfg = json.load(f)
        flags = program_flags(cfg, args.seed, os.path.join(work, name)) + [
            "--n_validation", str(1 << 30), "--n_checkpoint", str(1 << 30)]
        sides = {side: run(flags, scene, args.steps, side == "graph")
                 for side in ("graph", "eager", "eager2")}
        out[name] = res = compare(sides)
        print(f"{name}: {args.steps} steps; " + "; ".join(
            f"{k} worst window gap {v['worst_window_gap']:.3e}, buckets part at "
            f"{v['buckets_part_at']}" for k, v in res.items() if k.endswith("_vs_eager")) + "; "
            + "; ".join(f"{side}: buckets {res[side]['buckets']}, captures "
                        f"{res[side]['captures']}, replays {res[side]['replays']}, val psnr "
                        f"{res[side]['val_psnr']:.4f}, {res[side]['ms_a_step']:.3f} ms a step"
                        for side in sides), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
