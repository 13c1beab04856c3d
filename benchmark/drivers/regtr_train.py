"""Stage 3 training: `RegTrainer.train_iteration(item)` back to back at
batch 1 on the device-cached path (grids on the device, the jitter and
the rigid perturbation applied there), cycling 8 pairs in a seeded order.

Set-up builds one trainer over the pairs, loads the benchmark's weights,
hands it a jitter generator of the benchmark's, and runs the checked
steps 1..3 through the window's own call on three different pairs (their
total loss, the first gradient as the optimizer's first moment holds it,
and the parameters after the third are kept), then warms up. The check
frees the trainer and runs the plain reference in f32 (TF32 off) over the
same three steps from the same weights, pairs, transforms and noise.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.drivers import common, regtr_pairs
from benchmark.harness import counts
from benchmark.harness.api import Check, WindowResult
from benchmark.reference.precision import no_tf32

CHECKED_STEPS = 3


class State:
    pass


def _plant(trainer, fault: str | None) -> None:
    """Test fault: a step that leaves the state unchanged."""
    if fault is None:
        return
    if fault == "unchanged":
        opt = trainer.optimizer
        opt.step = lambda grad, loss: torch.zeros((), dtype=torch.bool, device=grad.device)
        return
    raise ValueError(f"no fault {fault!r} in this cell")


def _items(s, n: int) -> list:
    """The next n items of the cycle: seeded permutations of the pairs."""
    out = []
    for _ in range(n):
        if not s.order:
            s.order = list(s.order_rng.permutation(len(s.pairs)))
        i = int(s.order.pop(0))
        out.append(regtr_pairs.train_item(s.pairs[i], i, s.item_rng, s.perturb_std))
    return out


def setup(ctx):
    from dregnerf_tpu_torch.runtime.config import config_parser
    from dregnerf_tpu_torch.runtime.reg_trainer import RegTrainer

    cfg, wl, dev = ctx.config, ctx.workload, ctx.device
    s = State()
    s.pairs = regtr_pairs.make_pairs(wl, cfg, dev)
    s.perturb_std = wl["perturb_std"]
    s.order_rng = np.random.default_rng(common.sub_seed(ctx.seed, regtr_pairs.SEED_ORDER))
    s.item_rng = np.random.default_rng(common.sub_seed(ctx.seed, regtr_pairs.SEED_ORDER + 100))
    s.order = []
    common.log("pairs made; building the trainer")
    pcfg = config_parser(regtr_pairs.program_flags(cfg, ctx.seed, ctx.workdir))
    data = regtr_pairs.Pairs(s.pairs)
    tr = RegTrainer(pcfg, data, data, output_dir=ctx.workdir, device=dev)
    if tr.model.dtype != torch.bfloat16 or sum(p.numel() for p in tr.model.parameters()) \
            != cfg["parameters"]:
        raise ValueError("the program's NeRFRegTr is not the configuration's")
    shapes = {k: tuple(v.shape) for k, v in tr.model.state_dict().items()}
    s.state0, s.w0 = regtr_pairs.draw_weights(shapes, cfg["d_model"], ctx.seed, dev)
    tr.model.load_state_dict(s.state0)
    with torch.no_grad():
        tr.infonce_W.copy_(s.w0)
    s.aug_seed = common.sub_seed(ctx.seed, regtr_pairs.SEED_AUG)
    tr._aug_gen = torch.Generator(device=dev).manual_seed(s.aug_seed)
    _plant(tr, ctx.fault)
    s.trainer = tr
    s.keys = [*tr.param_keys, "infonce_W"]
    s.leaves = [(k, t.numel()) for k, t in zip(s.keys, tr.optimizer.leaves)]
    flat0 = tr.optimizer.flat.clone()

    common.log("trainer built")
    s.checked = _items(s, CHECKED_STEPS)
    losses = []
    for step, item in enumerate(s.checked, start=1):
        losses.append(tr.train_iteration(item)["total"])
        if step == 1:  # the first moment after one update is (1 - b1) g
            s.first_vec = tr.optimizer.mu / 0.1
            s.first_grad = common.leaf_norms(dict(zip(s.keys, tr.optimizer.split(s.first_vec))))
    s.update = common.leaf_norms(
        dict(zip(s.keys, tr.optimizer.split(tr.optimizer.flat - flat0))))
    s.losses = [float(x) for x in losses]
    common.log("checked steps done; warming up")
    for item in _items(s, wl["warm_steps"]):
        tr.train_iteration(item)
    common.synchronize(dev)
    return s


def window(s, ctx, tracer) -> WindowResult:
    tr, dev = s.trainer, ctx.device
    skipped, traced = [], 0
    tracer.start()
    t0 = time.perf_counter()
    while True:
        (item,) = _items(s, 1)
        skipped.append(tr.train_iteration(item)["skipped_nonfinite"])
        if tracer.tick(len(skipped)):
            traced = len(skipped)
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    common.synchronize(dev)
    elapsed = time.perf_counter() - t0
    n = len(skipped)
    failed = int(torch.stack(skipped).sum())
    flops = traced * counts.regtr_train_flops(ctx.config, ctx.config["grid_resolution"])
    return WindowResult(attempted=n, failed=failed,
                        end_to_end={"regtr_step_ms": elapsed / n * 1e3},
                        record={"units": traced, "flops": flops})


def reference_readings(s, ctx, precision: str):
    """(losses, first-gradient norms, update norms) of the plain reference."""
    from benchmark.reference.regtr import train as rt
    from benchmark.reference.regtr.layers import set_operands

    cfg, dev = ctx.config, ctx.device
    model = regtr_pairs.reference_model(cfg, dev)
    model.load_state_dict(s.state0)
    set_operands(model, precision)
    w = s.w0.clone().requires_grad_(True)
    leaves = [*model.parameters(), w]
    names = [*(k for k, _ in model.named_parameters()), "infonce_W"]
    init = [p.detach().clone() for p in leaves]
    opt = rt.AdamW(leaves, cfg["lr"])
    aabb = torch.tensor(cfg["aabb"], dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(s.aug_seed)
    losses, first = [], None
    for item in s.checked:
        batch = {"pose": torch.as_tensor(item["pose"], device=dev)}
        for side in ("src", "tgt"):
            grid, mask = item[f"{side}_grid"], item[f"{side}_mask"]
            noise = torch.randn(mask.shape[0], 3, generator=gen, device=dev)
            p = torch.as_tensor(item["aug"][f"p_{side}"], device=dev)
            batch[f"{side}_grid"] = rt.device_augment(grid, mask, p, noise)
            batch[f"{side}_mask"] = mask
        total, _ = rt.compute_losses(model, w, batch, aabb, cfg["grid_resolution"])
        grads = torch.autograd.grad(total, leaves)
        clipped = opt.step(list(grads))
        losses.append(float(total.detach()))
        if first is None:
            first = common.leaf_norms(dict(zip(names, clipped)))
            first_vec = torch.cat([g.reshape(-1) for g in clipped])
    update = common.leaf_norms({k: p.detach() - p0 for k, p, p0 in zip(names, leaves, init)})
    if names != s.keys:
        raise ValueError("the reference's parameters are not the program's")
    return losses, first, update, first_vec


def compare(program, reference, leaves) -> dict:
    """grad_gap and update_gap: the worst leaf's gap of norms (of the first
    gradient; of the change after the steps, over the leaves that move);
    grad_err: |g - g_ref| / |g_ref| of the whole first gradient;
    xformer_grad_err: the same over the leaves after the FPN (cross-encoder,
    decoder, InfoNCE). `leaves`: (name, size) in the flat order. A
    diagnostic, not compared: the worst step's loss gap (PERF.md)."""
    losses, first, update, vec = program
    r_losses, r_first, r_update, r_vec = reference
    d, r = (vec - r_vec).double(), r_vec.double()
    head = torch.tensor([not k.startswith("fpn3d.") for k, _ in leaves], device=d.device)
    head = head.repeat_interleave(torch.tensor([n for _, n in leaves], device=d.device))
    return {"grad_gap": common.worst_leaf_gap(first, r_first),
            "update_gap": common.worst_leaf_gap(update, r_update,
                                                common.moving_leaves(r_first)),
            "xformer_grad_err": float(d[head].norm() / r[head].norm()),
            "grad_err": float(d.norm() / r.norm()),
            "diag.loss_gap": max(common.rel_gap(a, b) for a, b in zip(losses, r_losses))}


def check(s, ctx) -> list[Check]:
    program = (s.losses, s.first_grad, s.update, s.first_vec)
    s.trainer = None
    common.free(ctx.device)
    restore = no_tf32()
    try:
        s.reference = reference_readings(s, ctx, "f32")
    finally:
        restore()
    limits = ctx.workload["limits"]
    values = compare(program, s.reference, s.leaves)
    s.diagnostics = {k: v for k, v in values.items() if k not in limits}
    return [Check(k, v, limits[k]) for k, v in values.items() if k in limits]


def control_values(s, ctx) -> dict:
    """The control's numbers: the reference with fp8 operands in every
    convolution and dense layer, in the program's place (after `check`)."""
    restore = no_tf32()
    try:
        return compare(reference_readings(s, ctx, "fp8"), s.reference, s.leaves)
    finally:
        restore()
