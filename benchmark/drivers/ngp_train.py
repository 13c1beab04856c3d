"""Stage 1: an NGP block's training steps, `NGPTrainer.train_iteration`
back to back on the benchmark's pixel draws at the trainer's ray bucket,
occupancy updates (every 16 steps) and bucket feedback included.

Set-up builds one trainer, makes the first occupancy update on the
benchmark's jitter, runs the checked steps 1..3 through the window's own
call on draws that all differ (their loss, the first gradient as Adam
holds it, and the parameters after the third are kept), and warms up to
`warm_steps`. The window continues from there. The check frees the
trainer and runs the plain reference over the same three steps from the
same weights, jitter and draws.
"""
from __future__ import annotations

import time

import torch

from benchmark.drivers import common, ngp_block
from benchmark.harness import counts
from benchmark.harness.api import Check, WindowResult
from benchmark.reference import ngp as ref
from benchmark.reference.precision import no_tf32

CHECKED_STEPS = 3
OCC_INTERVAL = 16


class State:
    pass


def _plant(trainer, fault: str | None) -> None:
    """Test faults: a step that leaves the state unchanged, or one that
    drops half of its rays and averages over the rest."""
    if fault is None:
        return
    if fault == "unchanged":
        trainer.apply_gradients = lambda step: trainer.optimizer.zero_grad(set_to_none=True)
        return
    if fault == "half_batch":  # every second ray (the buffer may cut a step's last rays)
        inner = trainer.train_iteration

        def half(step, draws):
            return inner(step, draws._replace(img_id=draws.img_id[::2], x=draws.x[::2],
                                              y=draws.y[::2], jitter=draws.jitter[::2]))

        trainer.train_iteration = half
        return
    raise ValueError(f"no fault {fault!r} in this cell")


def setup(ctx):
    cfg, wl, dev = ctx.config, ctx.workload, ctx.device
    s = State()
    s.trainer, s.scene, s.weights, s.noise = ngp_block.build(cfg, wl["scene"], ctx.seed, dev,
                                                             ctx.workdir)
    _plant(s.trainer, ctx.fault)
    s.gen = common.generator(ctx.seed, ngp_block.SEED_DRAWS, dev)
    tr = s.trainer
    s.draws, losses = [], []
    for step in range(1, CHECKED_STEPS + 1):
        d = ngp_block.draw(s.gen, tr.num_rays, s.scene, dev)
        s.draws.append(d)
        losses.append(tr.train_iteration(step, d)["loss"])
        if step == 1:  # Adam's first moment after one update is (1 - b1) g
            moments = {k: tr.optimizer.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
                       for k, p in ref.leaves(tr.params).items()}
            s.first_grad = common.leaf_norms({k: m / 0.1 for k, m in moments.items()})
    init = ref.leaves(s.weights)
    s.update = common.leaf_norms({k: p.detach() - init[k]
                                  for k, p in ref.leaves(tr.params).items()})
    s.losses = [float(x) for x in losses]
    common.log("checked steps done; warming up")
    for step in range(CHECKED_STEPS + 1, wl["warm_steps"]):
        tr.train_iteration(step, ngp_block.draw(s.gen, tr.num_rays, s.scene, dev))
    s.step = wl["warm_steps"]
    common.synchronize(dev)
    return s


def window(s, ctx, tracer) -> WindowResult:
    tr, dev = s.trainer, ctx.device
    samples, steps, buckets, traced = [], [], [], 0
    tracer.start()
    t0 = time.perf_counter()
    while True:
        buckets.append(tr.num_rays)
        m = tr.train_iteration(s.step, ngp_block.draw(s.gen, tr.num_rays, s.scene, dev))
        samples.append(m["n_samples"])
        steps.append(s.step)
        s.step += 1
        if tracer.tick(len(steps)):
            traced = len(steps)
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    common.synchronize(dev)
    elapsed = time.perf_counter() - t0
    n = len(steps)
    common.log(f"window: {n} steps, ray buckets {sorted(set(buckets))}, "
               f"{sum(b == buckets[-1] for b in buckets)} at the last")
    record = _record(ctx.config, [int(x) for x in torch.stack(samples).cpu()], steps, traced)
    return WindowResult(attempted=n, failed=0,
                        end_to_end={"block_step_ms": elapsed / n * 1e3}, record=record)


def _record(cfg: dict, samples: list, steps: list, traced: int) -> dict:
    """The work of the traced steps: FLOPs of their marched samples and of
    the occupancy updates among them, and K1p's and K2p's bytes. A step's
    kernels take every row of the sample buffer, but only its `n` live
    samples carry work, so the bytes count those (a buffer row past them
    is padding, which a leaner step would not hand over)."""
    buf = cfg["sample_budget"]
    width = counts.packed_row_width(cfg)
    rows = counts.level_table_rows(cfg)
    n_occ = min(cfg["grid_resolution"] ** 3 // 4, 1 << 17) * 2  # points a non-warm-up update
    flops = k1p = k2p = live = 0
    for n, step in zip(samples[:traced], steps[:traced]):
        n = min(n, buf)
        live += n
        flops += n * counts.ngp_train_sample_flops(cfg)
        k2p += len(rows) * counts.k2p_bytes(n, width)
        # levels 1.. scatter the live rows; level 0's run-length rows are unseen
        k1p += sum(counts.k1p_bytes(n, width, r) for r in rows[1:])
        k1p += counts.k1p_bytes(0, width, rows[0])
        if step % OCC_INTERVAL == 0:
            flops += n_occ * counts.ngp_density_point_flops(cfg)
            k2p += len(rows) * counts.k2p_bytes(n_occ, width)
    if traced:
        common.log(f"traced steps: {traced}, live samples / buffer {live / (traced * buf):.4f}")
    return {"units": traced, "flops": flops, "bytes": {"k1p": k1p, "k2p": k2p}}


def reference_readings(s, ctx, precision: str):
    """(losses, first-gradient norms, update norms) of the plain reference
    over the checked steps."""
    cfg, dev = ctx.config, ctx.device
    field = ref.Field(cfg, precision)
    aabb = torch.tensor(cfg["aabb"], dtype=torch.float32, device=dev)
    r = cfg["grid_resolution"]
    step = ngp_block.render_step(cfg)
    binary = ref.warmup_grid(field, s.weights, aabb, r, step, s.noise).reshape(r, r, r)
    rcfg = {"step": step, "buffer": cfg["sample_budget"], "max_steps": cfg["max_march_steps"],
            "k_cap": min(512, cfg["max_march_steps"])}
    images = torch.as_tensor(s.scene.images, device=dev)
    c2ws = torch.as_tensor(s.scene.camtoworlds, dtype=torch.float32, device=dev)
    K = torch.as_tensor(s.scene.K, dtype=torch.float32, device=dev)
    losses, first, final = ref.train_steps(field, s.weights, binary, aabb, images, c2ws, K,
                                           s.draws, rcfg, cfg["lr"], cfg["adam_eps"])
    init = ref.leaves(s.weights)
    return (losses, common.leaf_norms(first),
            common.leaf_norms({k: v - init[k] for k, v in final.items()}))


def compare(program, reference) -> dict:
    losses, first, update = program
    r_losses, r_first, r_update = reference
    return {"loss_gap": max(common.rel_gap(a, b) for a, b in zip(losses, r_losses)),
            "grad_gap": common.worst_leaf_gap(first, r_first),
            "update_gap": common.worst_leaf_gap(update, r_update,
                                                common.moving_leaves(r_first))}


def check(s, ctx) -> list[Check]:
    program = (s.losses, s.first_grad, s.update)
    s.trainer = None
    common.free(ctx.device)
    restore = no_tf32()
    try:
        s.reference = reference_readings(s, ctx, "bf16")
    finally:
        restore()
    limits = ctx.workload["limits"]
    return [Check(k, v, limits[k]) for k, v in compare(program, s.reference).items()]


def control_values(s, ctx) -> dict:
    """The control's numbers: the reference with fp8 MLP operands in the
    program's place (after `check`)."""
    restore = no_tf32()
    try:
        return compare(reference_readings(s, ctx, "fp8"), s.reference)
    finally:
        restore()
