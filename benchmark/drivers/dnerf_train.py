"""Stage 1 with D-NeRF's field: a dynamic block's training steps,
`NGPTrainer.train_iteration` back to back, as in `ngp_train`, with the
program built under `--field dnerf` at the configuration's widths and base
learning rate (`--field_lr`).

The set-up, window, check and control are `ngp_train`'s own functions,
run with four of the names they look up bound to this cell's: `ngp_block`
(the block built here: the moving-sphere scene with a time a view, its
flags, the field's layers drawn, the layout checked), `ref`
(benchmark/reference/dnerf.py), `_record` (the MLPs' FLOPs,
benchmark/harness/mlp_counts.py) and `reference_readings` (the reference's
steps at the scene's times). So the draws, the warm-up, the window, the
checked steps, the faults and the comparison are the NGP cells', and what a
later change does to them reaches this cell too.
"""
from __future__ import annotations

import types

import numpy as np
import torch

from benchmark.drivers import common, ngp_block, ngp_train
from benchmark.harness import mlp_counts
from benchmark.reference import dnerf as ref
from benchmark.traffic import dynamic

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
WIDTHS = ("net_depth", "net_width", "skip_layer", "net_depth_condition",
          "net_width_condition", "posenc_xyz", "posenc_dir", "warp_depth", "warp_width",
          "posenc_time")


def program_flags(cfg: dict, seed: int, out_dir: str) -> list[str]:
    """The port's flags: the NGP block's (the packed encoder's knobs, which
    the MLP field ignores, at their defaults) with the D-NeRF field, its
    base learning rate and its operands."""
    packed_knobs = {"grad_accum": "bf16", "rle_backward": True}
    flags = ngp_block.program_flags({**cfg, **packed_knobs}, seed, out_dir) + [
        "--field", "dnerf", "--field_lr", repr(cfg["lr"])]
    return flags + (["--no_bf16"] if DTYPES[cfg["mlp_operands"]] == torch.float32 else [])


def scene_data(wl_scene: dict):
    """The port's SceneData of the dynamic scene, with a time a view (all
    views train; no near or far plane, as in the NGP cells)."""
    from dregnerf_tpu_torch.datasets.dnerf_synthetic import DNeRFSceneData

    images, c2w, K, times = dynamic.block_views(wl_scene)
    return DNeRFSceneData(images=images, camtoworlds=c2w[:, :3, :4].astype(np.float32), K=K,
                          opengl=True, synthetic=True, subject_id="bench", timestamps=times)


def check_layout(trainer, cfg: dict) -> None:
    """The program runs the configuration's D-NeRF field, operands and
    learning rate, or the run stops."""
    mc = trainer.model_config
    got = {k: getattr(mc, k, None) for k in WIDTHS}
    lrs = (trainer.lr_at(0), trainer.optimizer.param_groups[0]["lr"])
    if (type(mc).__name__ != "VanillaNeRFConfig" or not mc.warp
            or got != {k: cfg[k] for k in WIDTHS} or cfg["bottleneck_width"] != mc.net_width
            or mc.compute_dtype != DTYPES[cfg["mlp_operands"]] or lrs != (cfg["lr"],) * 2):
        raise ValueError(f"the program's field {mc} at lr {lrs} is not the configuration's")


def draw_weights(cfg: dict, seed: int, device) -> dict:
    """The field's layers from the seed, on the device in one call: weights
    He-uniform (bound sqrt(6 / fan_in), the program's initialiser), biases
    zero; in the program's tree."""
    shapes = ref.layer_shapes(cfg)
    layers = [s for v in shapes.values() for s in (v if isinstance(v, list) else [v])]
    flat = torch.rand(sum(a * b for a, b in layers),
                      generator=common.generator(seed, ngp_block.SEED_WEIGHTS, device),
                      device=device)
    at = 0

    def dense(shape):
        nonlocal at
        a, b = shape
        bound = (6.0 / a) ** 0.5
        w = flat[at:at + a * b].view(a, b) * (2 * bound) - bound
        at += a * b
        return {"w": w, "b": torch.zeros(b, device=device)}

    return {k: [dense(s) for s in v] if isinstance(v, list) else dense(v)
            for k, v in shapes.items()}


def load_weights(trainer, weights: dict) -> None:
    have, want = ref.leaves(trainer.params), ref.leaves(weights)
    if {k: tuple(v.shape) for k, v in have.items()} != {k: tuple(v.shape)
                                                        for k, v in want.items()}:
        raise ValueError("the program's D-NeRF layers are not the configuration's")
    with torch.no_grad():
        for k, p in have.items():
            p.copy_(want[k])


def build(cfg: dict, wl_scene: dict, seed: int, device, out_dir: str):
    """(trainer, scene, weights, jitter) of one dynamic block, as
    ngp_block.build. The flags are parsed first, so a program without
    `--field_lr` stops at once."""
    from dregnerf_tpu_torch.runtime.config import config_parser
    from dregnerf_tpu_torch.runtime.ngp_trainer import NGPTrainer

    args = config_parser(program_flags(cfg, seed, out_dir))
    common.log("D-NeRF block: rendering the scene")
    scene = scene_data(wl_scene)
    common.log("D-NeRF block: building the trainer")
    trainer = NGPTrainer(args, scene, output_dir=out_dir, device=device)
    check_layout(trainer, cfg)
    weights = draw_weights(cfg, seed, device)
    load_weights(trainer, weights)
    r = cfg["grid_resolution"]
    noise = torch.rand(r**3, 3, generator=common.generator(seed, ngp_block.SEED_NOISE, device),
                       device=device) - 0.5
    trainer.update_occupancy(0, noise=noise)
    common.log("D-NeRF block: built")
    return trainer, scene, weights, noise


def _record(cfg: dict, samples: list, steps: list, traced: int) -> dict:
    """The work of the traced steps: the MLPs' FLOPs over their live
    samples (a buffer row past them is padding) and over the occupancy
    updates' points among them (density only, at no time)."""
    buf = cfg["sample_budget"]
    n_occ = min(cfg["grid_resolution"] ** 3 // 4, 1 << 17) * 2  # points a non-warm-up update
    flops = live = 0
    for n, step in zip(samples[:traced], steps[:traced]):
        n = min(n, buf)
        live += n
        flops += n * mlp_counts.train_sample_flops(cfg)
        if step % ngp_train.OCC_INTERVAL == 0:
            flops += n_occ * mlp_counts.density_point_flops(cfg)
    if traced:
        common.log(f"traced steps: {traced}, live samples / buffer {live / (traced * buf):.4f}")
    return {"units": traced, "flops": flops, "mlp_flops": flops}


def reference_readings(s, ctx, precision: str):
    """(losses, first-gradient norms, update norms) of the plain reference
    over the checked steps, each ray at its view's time."""
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
    times = torch.as_tensor(s.scene.timestamps, dtype=torch.float32, device=dev)
    losses, first, final = ref.train_steps(field, s.weights, binary, aabb, images, c2ws, K,
                                           times, s.draws, rcfg, cfg["lr"], cfg["adam_eps"])
    init = ref.leaves(s.weights)
    return (losses, common.leaf_norms(first),
            common.leaf_norms({k: v - init[k] for k, v in final.items()}))


# the block's functions that ngp_train's set-up, window and reference use
_BLOCK = types.SimpleNamespace(build=build, draw=ngp_block.draw,
                               SEED_DRAWS=ngp_block.SEED_DRAWS,
                               render_step=ngp_block.render_step)
_NAMES = {**vars(ngp_train), "ngp_block": _BLOCK, "ref": ref, "_record": _record,
          "reference_readings": reference_readings}


def _bound(fn):
    """ngp_train's function `fn`, looking its names up in _NAMES."""
    return types.FunctionType(fn.__code__, _NAMES, fn.__name__, fn.__defaults__,
                              fn.__closure__)


setup = _bound(ngp_train.setup)
window = _bound(ngp_train.window)
check = _bound(ngp_train.check)
control_values = _bound(ngp_train.control_values)
