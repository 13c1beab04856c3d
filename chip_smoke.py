#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

  python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. the device: require CUDA, print the card's name and power limit;
  2. the build: compile every kernel of dregnerf_tpu_torch/csrc;
  3. kernel K1 (ops/scatter_add.py) against its plain version at the main
     path's shapes (2^18 rows of 64 floats into 4096 and 2^19 rows), with
     times, the memory-traffic bound and the one-call library time;
  4. a small-input reference: one training step at a tiny size on the card
     against the same step on the CPU (the CPU path is held against the
     JAX package by tests/test_torch_*.py);
  5. training at full width (L4F8, 2^19 tables, 2^18-sample budget, 1024
     march steps, 128^3 grid, bf16 MLPs, grad_accum="pallas", no RLE) on
     the 36-view 128 px fixture scene: 64 steps with 4 warmup occupancy
     updates, then one steady-mode update; K1 must launch 4 times a step;
  6. 8 more steps under torch.profiler: the device's busy share and the
     kernels that take most of a step;
  7. one validate() render of a held-out view;
  8. a JSON line of every kernel with its launches on the main path, time,
     plain time, bound and library time; the card's line; and last
     {"ok": true, "device": {...}}.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
K1_TOL = 1e-5  # relative to max |out|: atomics sum in a varying order
TRAIN_STEPS = 64
PROFILE_STEPS = 8  # after TRAIN_STEPS, before the next occupancy update
PROFILE_TOP = 15


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds of fn() over `iters` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def k1_phase(torch, dev) -> dict:
    """K1 against index_add_ at the main path's shapes. The per-step figure
    sums one call per encoder level: level 0 (4096 rows) and levels 1-3
    (2^19 rows), with indices in runs of equal slots as long as a ray's
    steps per cell at each level (1024 steps over a 2-unit box)."""
    from dregnerf_tpu_torch.ops.scatter_add import scatter_add, scatter_add_plain

    n, w = 1 << 18, 64
    g = torch.Generator(device=dev).manual_seed(0)
    src = torch.randn(n, w, generator=g, device=dev)
    step_levels = [(4096, 37), (1 << 19, 7), (1 << 19, 1), (1 << 19, 1)]
    cases = {(4096, 1), (1 << 19, 1), (4096, 37), (1 << 19, 7)}
    results = {}
    max_err = 0.0
    for rows, run in sorted(cases):
        starts = torch.randint(0, rows, (-(-n // run),), generator=g, device=dev)
        idx = starts.repeat_interleave(run)[:n].to(torch.int32).contiguous()
        idx64 = idx.long()
        got = scatter_add(idx, src, rows)
        want = scatter_add_plain(idx, src, rows)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = K1_TOL * want.abs().max().item()
        check(err <= tol, f"K1 rows={rows} run={run}: max abs err {err} > {tol}")
        max_err = max(max_err, err)
        ms = cuda_ms(lambda: scatter_add(idx, src, rows))
        plain_ms = cuda_ms(lambda: scatter_add_plain(idx, src, rows))
        lib_ms = cuda_ms(lambda: torch.zeros(rows, w, device=dev).index_add_(0, idx64, src))
        nbytes = n * 4 + n * w * 4 + rows * w * 4
        bound = max(nbytes / HBM_BYTES_PER_S, n * w / F32_FLOPS) * 1e3
        results[(rows, run)] = (ms, plain_ms, lib_ms, bound)
        print(f"K1 table_rows={rows} run={run}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, index_add_ {lib_ms:.4f} ms, bound {bound:.4f} ms "
              f"(bytes), max abs err {err:.3e} (tol {tol:.3e})", flush=True)
    per_step = [sum(results[lv][i] for lv in step_levels) for i in range(4)]
    return {"ms": per_step[0], "plain_ms": per_step[1], "library_ms": per_step[2],
            "bound_ms": per_step[3], "max_abs_err": max_err}


def reference_phase(torch, dev) -> None:
    """One tiny f32 training step with the same weights and draws on the
    card and on the CPU: loss, PSNR, sample count and gradients agree."""
    from dregnerf_tpu_torch.datasets.fixtures import make_scene_data
    from dregnerf_tpu_torch.models import ngp
    from dregnerf_tpu_torch.ops import occupancy
    from dregnerf_tpu_torch.ops.packed_grid import PackedGridConfig
    from dregnerf_tpu_torch.render.renderer import RenderConfig
    from dregnerf_tpu_torch.runtime.ngp_trainer import draw_step_inputs, step_loss

    scene = make_scene_data("train", num_views=8, image_size=32)
    cfg = ngp.NGPConfig(grid=PackedGridConfig(n_levels=2, log2_table_size=10,
                                              base_resolution=4, per_level_scale=2.0,
                                              grad_accum="pallas"),
                        compute_dtype=torch.float32)
    params_cpu = ngp.init_ngp(cfg, torch.Generator().manual_seed(0))
    params_cpu["table"] = params_cpu["table"] * 1000.0
    g = torch.Generator().manual_seed(1)
    binary = torch.rand(16, 16, 16, generator=g) < 0.6
    draws_cpu = draw_step_inputs(g, 256, scene.num_images, scene.height, scene.width, "cpu")
    rcfg = RenderConfig(render_step_size=2 * math.sqrt(3) / 128, buffer_size=1 << 13,
                        max_steps=128, march_compaction="capped", k_cap=128)
    out = {}
    for d in ("cpu", dev):
        params = {k: ([w.detach().to(d).requires_grad_(True) for w in v] if isinstance(v, list)
                      else v.detach().to(d).requires_grad_(True))
                  for k, v in params_cpu.items()}
        grid = occupancy.OccupancyGrid(torch.zeros(16**3, device=d), binary.to(d))
        draws = type(draws_cpu)(*(t.to(d) for t in draws_cpu))
        loss, m = step_loss(params, cfg, rcfg, grid,
                            torch.tensor([-1.0, -1, -1, 1, 1, 1], device=d),
                            torch.as_tensor(scene.images, device=d),
                            torch.as_tensor(scene.camtoworlds, device=d),
                            torch.as_tensor(scene.K, device=d), draws, True, True)
        loss.backward()
        out[str(d)] = (loss.item(), m["psnr"].item(), int(m["n_samples"]),
                       [p.grad.cpu() for p in ngp.parameters(params)])
    (l0, p0, n0, g0), (l1, p1, n1, g1) = out["cpu"], out[str(dev)]
    check(n0 == n1, f"reference: n_samples cpu {n0} vs cuda {n1}")
    check(math.isclose(l0, l1, rel_tol=1e-4), f"reference: loss cpu {l0} vs cuda {l1}")
    check(math.isclose(p0, p1, rel_tol=1e-4), f"reference: psnr cpu {p0} vs cuda {p1}")
    worst = 0.0
    for a, b in zip(g0, g1):
        err = (a - b).abs().max().item() / max(a.abs().max().item(), 1e-30)
        worst = max(worst, err)
    check(worst <= 1e-4, f"reference: gradient rel err {worst}")
    print(f"reference step: loss cpu {l0:.6f} cuda {l1:.6f}, n_samples {n0}, "
          f"max grad err {worst:.2e} of max |g|", flush=True)


def profile_phase(torch, trainer, first_step: int) -> None:
    """Where a training step's device time goes: PROFILE_STEPS steps after
    the occupancy update of step `first_step`, under torch.profiler; prints
    the device's busy share of the window and the kernels that take most
    of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    trainer.train_iteration(first_step)
    torch.cuda.synchronize()
    steps = range(first_step + 1, first_step + 1 + PROFILE_STEPS)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for step in steps:
            trainer.train_iteration(step)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events, without the ranges that annotate the host's
    # calls (such as Optimizer.step), which span kernels counted already
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and not e.is_user_annotation),
                     key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels) / len(steps)
    print(f"profile: steps {steps.start}-{steps.stop - 1}, {wall_us / len(steps) / 1e3:.3f} "
          f"ms/step wall (profiled), device busy {busy_us / len(steps) / 1e3:.3f} ms/step, "
          f"idle share {1 - busy_us / wall_us:.4f}, {launches:.0f} device operations a "
          f"step of {len(kernels)} kinds", flush=True)
    for e in kernels[:PROFILE_TOP]:
        print(f"  {e.self_device_time_total / len(steps) / 1e3:8.3f} ms/step "
              f"{e.self_device_time_total / max(busy_us, 1e-9):6.1%} x{e.count // len(steps):<4d} "
              f"{e.key[:100]}", flush=True)


def train_phase(torch, out_dir: str):
    from dregnerf_tpu_torch.datasets.fixtures import make_scene_data
    from dregnerf_tpu_torch.ops.scatter_add import scatter_add
    from dregnerf_tpu_torch.runtime.config import config_parser
    from dregnerf_tpu_torch.runtime.ngp_trainer import OCC_WARMUP_STEPS, NGPTrainer

    scene = make_scene_data("train", num_views=36, image_size=128)
    val_scene = make_scene_data("test", num_views=36, image_size=128)
    cfg = config_parser([
        "--dataset", "objaverse", "--expname", "chip_smoke", "--out_dir", out_dir,
        "--aabb=-1.0,-1.0,-1.0,1.0,1.0,1.0", "--max_iterations", "100000",
        "--sample_budget", str(1 << 18), "--max_march_steps", "1024",
        "--grid_resolution", "128", "--init_num_rays", "4096",
        "--max_num_rays", str(1 << 15), "--grad_accum", "pallas",
        "--no-rle_backward", "--march_compaction", "capped",
    ])
    trainer = NGPTrainer(cfg, scene, val_scene)  # default device: cuda
    check(trainer.device.type == "cuda", f"trainer on {trainer.device}")
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    scatter_add.launches = 0  # count only the main path's launches
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(TRAIN_STEPS + 1)]
    metrics = []
    t0 = time.perf_counter()
    marks[0].record()
    for step in range(TRAIN_STEPS):
        metrics.append(trainer.train_iteration(step))
        marks[step + 1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = scatter_add.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    losses = [float(m["loss"]) for m in metrics]
    psnrs = [float(m["psnr"]) for m in metrics]
    n_samples = [int(m["n_samples"]) for m in metrics]
    step_ms = [marks[i].elapsed_time(marks[i + 1]) for i in range(TRAIN_STEPS)]
    check(launches == 4 * TRAIN_STEPS,
          f"K1 launched {launches} times in {TRAIN_STEPS} steps, expected 4 a step")
    check(all(math.isfinite(x) for x in losses), "non-finite loss")
    first, last = sum(losses[:8]) / 8, sum(losses[-8:]) / 8
    check(last < first, f"loss did not fall: first 8 {first}, last 8 {last}")
    # steps after the last warmup occupancy update at step 48
    steady = range(49, TRAIN_STEPS)
    steady_ms = sum(step_ms[i] for i in steady) / len(steady)
    sps = sum(n_samples[i] for i in steady) / (sum(step_ms[i] for i in steady) / 1e3)
    print(f"train: {TRAIN_STEPS} steps in {wall:.3f} s wall, {wall / TRAIN_STEPS * 1e3:.2f} "
          f"ms/step overall; steps 49-63 (no occupancy update) {steady_ms:.2f} ms/step "
          f"device, {sps:.1f} samples/s; ray bucket {trainer.num_rays} "
          f"(ran {metrics[-1]['num_rays']}); loss first 8 {first:.5f} last 8 {last:.5f}; "
          f"train psnr {psnrs[0]:.3f} -> {psnrs[-1]:.3f}; K1 launches {launches}; "
          f"peak device memory {peak_gib:.2f} GiB",
          flush=True)

    profile_phase(torch, trainer, TRAIN_STEPS)

    t1 = time.perf_counter()
    trainer.update_occupancy(OCC_WARMUP_STEPS)  # a steady-mode update
    torch.cuda.synchronize()
    frac = trainer.grid.binary.float().mean().item()
    check(0.0 < frac < 1.0, f"occupancy fraction {frac}")
    print(f"steady occupancy update: {(time.perf_counter() - t1) * 1e3:.2f} ms, "
          f"occupied fraction {frac:.5f}", flush=True)

    t2 = time.perf_counter()
    val_psnr = trainer.validate(TRAIN_STEPS)
    check(math.isfinite(val_psnr), f"val psnr {val_psnr}")
    print(f"validate: val psnr {val_psnr:.3f}, {time.perf_counter() - t2:.3f} s", flush=True)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from dregnerf_tpu_torch.ops import native

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"device: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls must be off")
    dev = torch.device("cuda")

    print(f"build: {native.build_all():.2f} s", flush=True)
    k1 = k1_phase(torch, dev)
    reference_phase(torch, dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
        launches = train_phase(torch, out_dir)

    kernels = [{
        "name": "scatter_add", "route": "cuda",
        "source": "dregnerf_tpu_torch/csrc/scatter_add.cu",
        "replaces": "dregnerf_tpu/ops/pallas_scatter.py:122",
        "launches": launches, "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": "bytes", "library_ms": k1["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
