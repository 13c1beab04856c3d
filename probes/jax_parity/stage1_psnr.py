#!/usr/bin/env python3
"""Stage-1 validation PSNR at equal steps, the JAX package against the
port, on the CPU: a reading, not a gate.

  JAX_PLATFORMS=cpu python probes/jax_parity/stage1_psnr.py [--steps 300] [--every 100] [--seeds 3]

Both packages train one NGP block on the same scene (JAX's make_scene of
the stage-3 experiment's first sphere cluster, 24 views of 32 px, read by
each package's objaverse loader) at the same small size (4 levels of
2^12-row tables, base resolution 4, scale 2; 2^12 samples a step, 64
march steps, a 16^3 occupancy grid; bf16 MLPs and bf16 table gradients,
the defaults), each from its own seeded weights and its own random draws
(jax.random and torch cannot share a stream), and validate() on the test
view every `--every` steps, for each of `--seeds` seeds (the weights'
and the config's --seed). Prints both packages' curves, each seed's gap
and the spread of each package over the seeds, as one JSON line: the
packages agree in this reading when their gap lies within the seeds'
spread.

This probe imports JAX and the JAX package, as the tests do, so it lives
apart from the card-side probes in probes/ and runs here on the CPU only.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import jax

jax.config.update("jax_platforms", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

SCENE = "scene_00"
GRID = dict(n_levels=4, n_features=8, log2_table_size=12, base_resolution=4,
            per_level_scale=2.0, grad_accum="bf16")


def flags(data_root: str, out: str, steps: int, every: int, seed: int) -> list:
    return ["--seed", str(seed), "--dataset", "objaverse", "--root_dir", data_root, "--scene", SCENE,
            "--expname", SCENE, "--out_dir", out, "--factor", "1",
            "--aabb=-1.0,-1.0,-1.0,1.0,1.0,1.0", "--max_iterations", str(steps),
            "--sample_budget", str(1 << 12), "--max_march_steps", "64",
            "--grid_resolution", "16", "--init_num_rays", "256", "--max_num_rays", "1024",
            "--test_chunk_size", "1024", "--n_tensorboard", str(steps), "--n_validation",
            str(every), "--n_checkpoint", str(10 * steps)]


def jax_curve(data_root: str, out: str, steps: int, every: int, seed: int) -> dict:
    from dregnerf_tpu.datasets.base import load_scene_blocks
    from dregnerf_tpu.models.ngp import NGPConfig, init_ngp
    from dregnerf_tpu.ops.packed_grid import PackedGridConfig
    from dregnerf_tpu.runtime.config import config_parser
    from dregnerf_tpu.runtime.ngp_trainer import NGPTrainer

    cfg = config_parser(flags(data_root, out, steps, every, seed) + ["--compilation_cache", ""])
    train = load_scene_blocks("objaverse", data_root, SCENE, "train", 1)[0]
    test = load_scene_blocks("objaverse", data_root, SCENE, "test", 1)[0]
    trainer = NGPTrainer(cfg, train, test, output_dir=os.path.join(out, f"jax_{seed}"))
    # the stage-3 experiment's recipe for a block of its own config
    model = NGPConfig(grid=PackedGridConfig(**GRID))
    trainer.model_config = model
    trainer.params = init_ngp(jax.random.PRNGKey(seed), model)
    trainer.opt_state = trainer.optimizer.init(trainer.params)
    trainer.state.params = trainer.params
    trainer.state.opt_state = trainer.opt_state
    trainer._step_fns = {}
    trainer.__dict__.pop("_occ_update_fns", None)
    return _curve(NGPTrainer, trainer)


def port_curve(data_root: str, out: str, steps: int, every: int, seed: int) -> dict:
    import torch

    from dregnerf_tpu_torch.datasets.base import load_scene_blocks
    from dregnerf_tpu_torch.models.ngp import NGPConfig
    from dregnerf_tpu_torch.ops.packed_grid import PackedGridConfig
    from dregnerf_tpu_torch.runtime.config import config_parser
    from dregnerf_tpu_torch.runtime.ngp_trainer import NGPTrainer

    cfg = config_parser(flags(data_root, out, steps, every, seed) + ["--device", "cpu"])
    train = load_scene_blocks("objaverse", data_root, SCENE, "train", 1)[0]
    test = load_scene_blocks("objaverse", data_root, SCENE, "test", 1)[0]
    trainer = NGPTrainer(cfg, train, test, output_dir=os.path.join(out, f"port_{seed}"))
    trainer.model_config = NGPConfig(grid=PackedGridConfig(**GRID))
    trainer.init_params(torch.Generator().manual_seed(seed))
    trainer.setup_optimizer()
    return _curve(NGPTrainer, trainer)


def _curve(cls, trainer) -> dict:
    """{step: val PSNR} of trainer.train()'s validations."""
    curve, real = {}, cls.validate

    def validate(self, step):
        curve[step] = float(real(self, step))
        return curve[step]

    cls.validate = validate
    try:
        trainer.train()
    finally:
        cls.validate = real
    return curve


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--every", type=int, default=100)
    ap.add_argument("--seeds", type=int, default=3)
    args = ap.parse_args()
    from dregnerf_tpu.datasets import fixtures

    with tempfile.TemporaryDirectory(prefix="stage1_psnr_") as work:
        data_root = os.path.join(work, "data")
        fixtures.make_scene(data_root, num_views=24, image_size=32, seed=0, name=SCENE,
                            spheres=fixtures.random_spheres(100))
        out = os.path.join(work, "out")
        jc = [jax_curve(data_root, out, args.steps, args.every, k) for k in range(args.seeds)]
        pc = [port_curve(data_root, out, args.steps, args.every, k) for k in range(args.seeds)]
    steps = sorted(jc[0])
    gaps = {s: [p[s] - j[s] for j, p in zip(jc, pc)] for s in steps}
    mean = {s: sum(gaps[s]) / len(gaps[s]) for s in steps}
    spread = {name: {s: max(c[s] for c in curves) - min(c[s] for c in curves) for s in steps}
              for name, curves in (("jax", jc), ("port", pc))}
    print(json.dumps({"val_psnr_jax": jc, "val_psnr_port": pc, "port_minus_jax": gaps,
                      "mean_gap": mean, "seed_spread": spread,
                      "largest_abs_mean_gap": max(abs(g) for g in mean.values())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
