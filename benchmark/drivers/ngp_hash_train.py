"""Stage 1 with Instant-NGP's published xor-hash grid: an NGP block's
training steps, `NGPTrainer.train_iteration` back to back, as in
`ngp_train`, with the program built under `--encoder xor_hash`.

The set-up, window, check and control are `ngp_train`'s own functions,
run with three of the names they look up bound to this cell's:
`ngp_block` (the block built here: its flags, its [L*T, F] table drawn,
the hash layout checked), `ref` (benchmark/reference/ngp_hash.py, whose
`Field` encodes with the hash grid) and `_record` (K6's bytes in place of
K1p's and K2p's). So the scene, the draws, the warm-up, the window, the
checked steps, the faults and the comparison are the packed cell's, and
what a later change does to them reaches both cells.
"""
from __future__ import annotations

import types

import torch

from benchmark.drivers import common, ngp_block, ngp_train
from benchmark.harness import counts, hash_counts
from benchmark.reference import ngp_hash


def program_flags(cfg: dict, seed: int, out_dir: str) -> list[str]:
    """The port's flags: the packed cell's, with the hash encoder (which
    ignores the packed layout's --grad_accum and --rle_backward)."""
    packed_knobs = {"grad_accum": "bf16", "rle_backward": True}
    return ngp_block.program_flags({**cfg, **packed_knobs}, seed, out_dir) + [
        "--encoder", "xor_hash"]


def check_layout(trainer, cfg: dict) -> None:
    """The program runs the configuration's hash grid, or the run stops."""
    mc = trainer.model_config
    g = cfg["grid"]
    keys = ("n_levels", "n_features", "log2_table_size", "base_resolution", "per_level_scale")
    got = {k: getattr(mc.grid, k, None) for k in keys}
    rows = g["n_levels"] << g["log2_table_size"]
    if (type(mc.grid).__name__ != "HashGridConfig" or got != {k: g[k] for k in keys}
            or mc.compute_dtype != torch.bfloat16
            or tuple(trainer.params["table"].shape) != (rows, g["n_features"])):
        raise ValueError(f"the program's NGP layout {mc} is not the configuration's {g}")


def draw_weights(cfg: dict, seed: int, device) -> dict:
    """The field's weights from the seed, on the device in two calls: the
    [L*T, F] vertex table uniform in (-1e-4, 1e-4), the MLPs He-uniform
    (bound sqrt(6 / fan_in), tcnn's layer scale)."""
    g = common.generator(seed, ngp_block.SEED_WEIGHTS, device)
    grid = cfg["grid"]
    table = torch.rand(grid["n_levels"] << grid["log2_table_size"], grid["n_features"],
                       generator=g, device=device) * 2e-4 - 1e-4
    shapes = [(a, b) for mlp in (cfg["density_mlp"], cfg["color_mlp"])
              for a, b in zip(mlp[:-1], mlp[1:])]
    flat = torch.rand(sum(a * b for a, b in shapes), generator=g, device=device)
    mats, i = [], 0
    for a, b in shapes:
        bound = (6.0 / a) ** 0.5
        mats.append(flat[i:i + a * b].view(a, b) * (2 * bound) - bound)
        i += a * b
    nd = len(cfg["density_mlp"]) - 1
    return {"table": table, "density_mlp": mats[:nd], "color_mlp": mats[nd:]}


def build(cfg: dict, wl_scene: dict, seed: int, device, out_dir: str):
    """As ngp_block.build, with the hash grid. The flags are parsed first,
    so a program without `--encoder` stops at once."""
    from dregnerf_tpu_torch.runtime.config import config_parser
    from dregnerf_tpu_torch.runtime.ngp_trainer import NGPTrainer

    args = config_parser(program_flags(cfg, seed, out_dir))
    common.log("NGP hash block: rendering the scene")
    scene = ngp_block.scene_data(wl_scene)
    common.log("NGP hash block: building the trainer")
    trainer = NGPTrainer(args, scene, output_dir=out_dir, device=device)
    check_layout(trainer, cfg)
    weights = draw_weights(cfg, seed, device)
    ngp_block.load_weights(trainer, weights)
    r = cfg["grid_resolution"]
    noise = torch.rand(r**3, 3, generator=common.generator(seed, ngp_block.SEED_NOISE, device),
                       device=device) - 0.5
    trainer.update_occupancy(0, noise=noise)
    common.log("NGP hash block: built")
    return trainer, scene, weights, noise


def _record(cfg: dict, samples: list, steps: list, traced: int) -> dict:
    """The work of the traced steps: FLOPs of their marched samples and of
    the occupancy updates among them, and K6's bytes over the live samples
    (forward and backward) and the updates' points (forward)."""
    buf = cfg["sample_budget"]
    n_occ = min(cfg["grid_resolution"] ** 3 // 4, 1 << 17) * 2  # points a non-warm-up update
    flops = k6f = k6b = live = 0
    for n, step in zip(samples[:traced], steps[:traced]):
        n = min(n, buf)
        live += n
        flops += n * counts.ngp_train_sample_flops(cfg)
        k6f += hash_counts.k6_forward_bytes(n, cfg)
        k6b += hash_counts.k6_backward_bytes(n, cfg)
        if step % ngp_train.OCC_INTERVAL == 0:
            flops += n_occ * counts.ngp_density_point_flops(cfg)
            k6f += hash_counts.k6_forward_bytes(n_occ, cfg)
    if traced:
        common.log(f"traced steps: {traced}, live samples / buffer {live / (traced * buf):.4f}")
    return {"units": traced, "flops": flops, "bytes": {"k6f": k6f, "k6b": k6b}}


# the block's functions that ngp_train's set-up, window and reference use
_BLOCK = types.SimpleNamespace(build=build, draw=ngp_block.draw,
                               SEED_DRAWS=ngp_block.SEED_DRAWS,
                               render_step=ngp_block.render_step)
_NAMES = {**vars(ngp_train), "ngp_block": _BLOCK, "ref": ngp_hash, "_record": _record}


def _bound(fn):
    """ngp_train's function `fn`, looking its names up in _NAMES."""
    return types.FunctionType(fn.__code__, _NAMES, fn.__name__, fn.__defaults__,
                              fn.__closure__)


setup = _bound(ngp_train.setup)
window = _bound(ngp_train.window)
reference_readings = _NAMES["reference_readings"] = _bound(ngp_train.reference_readings)
check = _bound(ngp_train.check)
control_values = _bound(ngp_train.control_values)
