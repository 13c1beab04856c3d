"""An NGP block of the port built from a configuration file: its trainer,
its weights drawn on the device from the seed, and its step's draws."""
from __future__ import annotations

import numpy as np
import torch

from benchmark.drivers.common import generator, log
from benchmark.harness import counts
from benchmark.traffic import scenes

SEED_WEIGHTS, SEED_NOISE, SEED_DRAWS = 1, 2, 3


def program_flags(cfg: dict, seed: int, out_dir: str) -> list[str]:
    """The port's command-line flags of the configuration."""
    aabb = ",".join(str(float(v)) for v in cfg["aabb"])
    return [f"--aabb={aabb}", "--sample_budget", str(cfg["sample_budget"]),
            "--max_march_steps", str(cfg["max_march_steps"]),
            "--grid_resolution", str(cfg["grid_resolution"]),
            "--init_num_rays", str(cfg["init_num_rays"]),
            "--max_num_rays", str(cfg["max_num_rays"]),
            "--march_compaction", cfg["march_compaction"], "--grad_accum", cfg["grad_accum"],
            "--rle_backward" if cfg["rle_backward"] else "--no-rle_backward",
            "--max_iterations", str(cfg["max_iterations"]), "--seed", str(seed % (1 << 31)),
            "--out_dir", out_dir, "--expname", "block", "--watchdog_s", "0",
            "--field", "ngp"]


def render_step(cfg: dict) -> float:
    """The march's step: the box's diagonal over the steps (the trainer's
    convention)."""
    aabb = np.asarray(cfg["aabb"], np.float32)
    return float(np.linalg.norm(aabb[3:] - aabb[:3])) / cfg["max_march_steps"]


def scene_data(wl_scene: dict):
    """The port's SceneData of the workload's scene (all views train)."""
    from dregnerf_tpu_torch.datasets.base import SceneData

    images, c2w, K = scenes.block_views(wl_scene)
    return SceneData(images=images, camtoworlds=c2w[:, :3, :4].astype(np.float32), K=K,
                     opengl=True, synthetic=True, subject_id="bench")


def draw_weights(cfg: dict, seed: int, device) -> dict:
    """The field's weights from the seed, on the device in two calls: the
    vertex table uniform in (-1e-4, 1e-4), the MLPs He-uniform (bound
    sqrt(6 / fan_in), tcnn's layer scale)."""
    g = generator(seed, SEED_WEIGHTS, device)
    rows = sum(counts.level_table_rows(cfg))
    table = torch.rand(rows, cfg["grid"]["n_features"], generator=g, device=device) * 2e-4 - 1e-4
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


def check_layout(trainer, cfg: dict) -> None:
    """The program runs the configuration as stated, or the run stops."""
    mc = trainer.model_config
    g = cfg["grid"]
    stated = {"n_levels": g["n_levels"], "n_features": g["n_features"],
              "log2_table_size": g["log2_table_size"],
              "base_resolution": g["base_resolution"], "per_level_scale": g["per_level_scale"],
              "grad_accum": cfg["grad_accum"]}
    got = {k: getattr(mc.grid, k) for k in stated}
    if got != stated or mc.compute_dtype != torch.bfloat16 or (
            cfg["rle_backward"] != (mc.grid.rle_step_u > 0)):
        raise ValueError(f"the program's NGP layout {mc} is not the configuration's {stated}")


def load_weights(trainer, weights: dict) -> None:
    p = trainer.params
    with torch.no_grad():
        p["table"].copy_(weights["table"])
        for key in ("density_mlp", "color_mlp"):
            if len(p[key]) != len(weights[key]):
                raise ValueError(f"the program's {key} has {len(p[key])} layers")
            for dst, src in zip(p[key], weights[key]):
                dst.copy_(src)


def build(cfg: dict, wl_scene: dict, seed: int, device, out_dir: str):
    """(trainer, scene) of one block at the configuration, with the
    benchmark's weights and the first (warm-up) occupancy update made on
    the benchmark's jitter; also returns the weights and the jitter."""
    from dregnerf_tpu_torch.runtime.config import config_parser
    from dregnerf_tpu_torch.runtime.ngp_trainer import NGPTrainer

    log("NGP block: rendering the scene")
    scene = scene_data(wl_scene)
    log("NGP block: building the trainer")
    trainer = NGPTrainer(config_parser(program_flags(cfg, seed, out_dir)), scene,
                         output_dir=out_dir, device=device)
    check_layout(trainer, cfg)
    weights = draw_weights(cfg, seed, device)
    load_weights(trainer, weights)
    r = cfg["grid_resolution"]
    noise = torch.rand(r**3, 3, generator=generator(seed, SEED_NOISE, device),
                       device=device) - 0.5
    trainer.update_occupancy(0, noise=noise)
    log("NGP block: built")
    return trainer, scene, weights, noise


def draw(gen: torch.Generator, num_rays: int, scene, device):
    """A step's pixel draws (the port's StepDraws) at the trainer's bucket."""
    from dregnerf_tpu_torch.runtime.ngp_trainer import StepDraws

    def randint(high):
        return torch.randint(0, high, (num_rays,), generator=gen, device=device)

    return StepDraws(img_id=randint(scene.num_images), x=randint(scene.width),
                     y=randint(scene.height), bg=torch.rand(3, generator=gen, device=device),
                     jitter=torch.rand(num_rays, 1, generator=gen, device=device))
