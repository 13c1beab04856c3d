"""Train Instant-NGP blocks with the PyTorch port (twin of the root
train_ngp_nerf.py).

One block per scene; with --multi_blocks the scene is split into a random
number of camera blocks in [min_num_blocks, max_num_blocks], each in its
own world frame (persisted to <root>/<scene>/world_frame_transforms.json),
and each block trains into <out_dir>/<expname>/block_k: one after another,
or with --fleet all together (runtime/fleet_trainer.py). With
--mesh_shape N, under `torchrun --nproc_per_node N`, each step is data
parallel over the N ranks (parallel/ngp_dp.py), or with --fleet each rank
trains its own blocks.

Usage:
  python -m dregnerf_tpu_torch.train_ngp_nerf --dataset objaverse \
      --root_dir <root> --scene <subject> --expname <name> \
      [--multi_blocks [--fleet]] [--device cpu]
  torchrun --nproc_per_node N -m dregnerf_tpu_torch.train_ngp_nerf ... --mesh_shape N
"""
from __future__ import annotations

import copy
import os
import random

from dregnerf_tpu_torch.runtime.config import config_parser


def train_blocks(config, train_blocks, test_blocks) -> list:
    """Train block k of `train_blocks` (validated on block k of
    `test_blocks`) into <out_dir>/<expname>/block_k; returns the trainers."""
    from dregnerf_tpu_torch.runtime.ngp_trainer import NGPTrainer

    trainers = []
    for k, (train_scene, test_scene) in enumerate(zip(train_blocks, test_blocks)):
        out_dir = os.path.join(config.out_dir, config.expname, f"block_{k}")
        print(f"=== training block {k}: {train_scene.num_images} images ===", flush=True)
        trainer = NGPTrainer(config, train_scene, test_scene, output_dir=out_dir)
        trainer.train()
        trainers.append(trainer)
    return trainers


def train_fleet(config, train_blocks, test_blocks):
    """Train every block of `train_blocks` together (--fleet) into
    <out_dir>/<expname>/block_k; returns the FleetNGPTrainer."""
    from dregnerf_tpu_torch.runtime.fleet_trainer import FleetNGPTrainer

    out_dirs = [os.path.join(config.out_dir, config.expname, f"block_{k}")
                for k in range(len(train_blocks))]
    print(f"=== fleet-training {len(train_blocks)} blocks ===", flush=True)
    fleet = FleetNGPTrainer(config, train_blocks, test_blocks, out_dirs)
    fleet.train()
    return fleet


def train(config):
    """Train the config's scene; returns the trainer (a list of them, or the
    fleet, with --multi_blocks)."""
    from dregnerf_tpu_torch.datasets.base import load_scene_blocks
    from dregnerf_tpu_torch.runtime.ngp_trainer import NGPTrainer

    if config.multi_blocks:
        num_blocks = random.randint(config.min_num_blocks, config.max_num_blocks)
        blocks = [load_scene_blocks(config.dataset, config.root_dir, config.scene, split,
                                    config.factor, True, num_blocks)
                  for split in ("train", "test")]
        return (train_fleet if config.fleet else train_blocks)(config, *blocks)
    train_scene, test_scene = (load_scene_blocks(config.dataset, config.root_dir,
                                                 config.scene, split, config.factor)[0]
                               for split in ("train", "test"))
    trainer = NGPTrainer(config, train_scene, test_scene)
    trainer.train()
    return trainer


def main(argv=None) -> None:
    config = config_parser(argv)
    scenes = [s for s in config.scene.split(",") if s] or [""]
    for scene in scenes:
        cfg = copy.deepcopy(config)
        cfg.scene = scene
        if len(scenes) > 1:
            cfg.expname = scene
        scene_dir = os.path.join(cfg.root_dir, scene)
        if scene and not os.path.isdir(scene_dir):
            print(f"skipping missing scene dir: {scene_dir}")
            continue
        train(cfg)


if __name__ == "__main__":
    main()
