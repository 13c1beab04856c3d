#!/usr/bin/env python3
"""Stage-3 loss curves, the JAX package against the port, on the CPU: a
reading, not a gate.

  JAX_PLATFORMS=cpu python probes/jax_parity/stage3_loss_curves.py [--steps 50]

The fixture pairs are the stage-3 experiment's own: its twin
(dregnerf_tpu_torch/scripts/experiments/stage3_fleet.py) trains and
extracts the two blocks of its first two scenes (a sphere cluster and a
box cluster) at a small size (4 levels of 2^12-row tables, 8 views of
24 px, 80 steps, 16^3 grids). Both packages then train NeRFRegTr at the
tests' small width (resnet18, d 64, 2 layers, 4 heads) in f32 from the
same weights (drawn by the port in flax's layout, `params_from_jax` on
its side), with the same optimizer, on the same unaugmented items: each
scene's test-split pair in both block orders, in turn. Prints each
step's losses on both sides and, per loss, the largest relative gap and
where it lies, as one JSON line.

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

SMALL = dict(backbone="resnet18", d_model=64, num_layers=2, num_heads=4, dim_feedforward=128,
             max_input_points=512, num_tokens=128, max_points=100, num_downsample=3)
LOSSES = ("overlap", "nerf_cont", "feature", "corr", "total")


def fixture_pairs(work: str) -> str:
    """The twin's regdata tree of two small scenes; returns its root."""
    import torch

    from dregnerf_tpu_torch.scripts.experiments import stage3_fleet as twin

    torch.set_num_threads(2)
    knobs = twin.Knobs(
        scenes=2, test_scenes=0, ngp_iters=80, budget=1 << 11, views=8, img=24,
        work=work, out=os.path.join(work, "out"), layout="L4F8",
        grid=dict(log2_table_size=12, base_resolution=4, per_level_scale=2.0),
        ngp_flags=("--grid_resolution", "16", "--max_march_steps", "32", "--init_num_rays",
                   "256", "--max_num_rays", "1024", "--test_chunk_size", "256"))
    return twin.stage1_and_2(knobs, "cpu")


def main() -> int:
    import jax.numpy as jnp
    import numpy as np

    from dregnerf_tpu.datasets.register_pairs import NeRFRegDataset as JDataset
    from dregnerf_tpu.models import regtr as jregtr
    from dregnerf_tpu.runtime import checkpoint as jckpt
    from dregnerf_tpu.runtime import reg_trainer as JRT
    from dregnerf_tpu.runtime.config import config_parser as jax_config
    from dregnerf_tpu_torch.datasets.register_pairs import NeRFRegDataset
    from dregnerf_tpu_torch.models.regtr import NeRFRegTr, params_to_jax
    from dregnerf_tpu_torch.runtime import reg_trainer as PRT
    from dregnerf_tpu_torch.runtime.config import config_parser as port_config

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=50)
    args = ap.parse_args()
    with tempfile.TemporaryDirectory(prefix="stage3_curves_") as work:
        root = fixture_pairs(work)
        scenes = ["scene_00", "scene_01"]
        items = []
        for s in scenes:
            ds = NeRFRegDataset(root, subject_id=s, split="test", seed=0)
            for order in ((0, 1), (1, 0)):
                ds.fixed_order = order
                items.append(ds[0])
        flags = ["--no_bf16", "--robust_loss", "--root_dir", root, "--out_dir", work,
                 "--position_embedding_dim", str(SMALL["d_model"]), "--num_downsample",
                 str(SMALL["num_downsample"])]
        train_ds = NeRFRegDataset(root, subject_id=scenes[0], split="train", seed=0)
        port = PRT.RegTrainer(port_config(flags + ["--expname", "port"]), train_ds, [],
                              model=NeRFRegTr(**SMALL), device="cpu")
        # the JAX trainer from the port's weights, assembled as the JAX tests do
        jcfg = jax_config(flags + ["--expname", "jax", "--compilation_cache", ""])
        jtr = JRT.RegTrainer.__new__(JRT.RegTrainer)
        jtr.config = jcfg
        jtr.train_dataset = JDataset(root, subject_id=scenes[0], split="train", seed=0)
        jtr.val_dataset = []
        jtr.output_dir = os.path.join(work, "jax")
        os.makedirs(jtr.output_dir, exist_ok=True)
        jtr.ckpt_manager = jckpt.CheckpointManager(os.path.join(jtr.output_dir, "model"))
        jtr.aabb = jnp.asarray(jcfg.aabb, jnp.float32)
        jtr.model = jregtr.NeRFRegTr(dtype=jnp.float32, **SMALL)
        jtr.grid_resolution = int(items[0]["src_grid"].shape[0])
        jtr.params = {"model": jax.tree_util.tree_map(jnp.asarray, params_to_jax(port.model)),
                      "infonce_W": jnp.asarray(np.array(port.infonce_W.detach()))}
        jtr.setup_optimizer()
        jtr.iteration = 0
        jtr._log_file = open(os.path.join(jtr.output_dir, "log.txt"), "a")
        jtr._step_fn = jtr._make_step_fn()

        curves = {"jax": [], "port": []}
        for step in range(args.steps):
            item = items[step % len(items)]
            m = port.train_iteration(item)
            curves["port"].append({k: float(m[k]) for k in LOSSES})
            batch = {k: jnp.asarray(item[k]) for k in PRT.BATCH_KEYS}
            jtr.params, jtr.opt_state, jm = jtr._step_fn(jtr.params, jtr.opt_state, batch)
            curves["jax"].append({k: float(jm[k]) for k in LOSSES})
            print(f"step {step}: jax {curves['jax'][-1]} port {curves['port'][-1]}",
                  flush=True)
    worst = {}
    for k in LOSSES:
        rel = [abs(p[k] - j[k]) / max(abs(j[k]), 1e-3)
               for p, j in zip(curves["port"], curves["jax"])]
        i = int(np.argmax(rel))
        worst[k] = {"rel": rel[i], "step": i, "first_over_1e-3": next(
            (s for s, r in enumerate(rel) if r > 1e-3), None)}
    print(json.dumps({"steps": args.steps, "largest_rel_gap": worst, "curves": curves}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
