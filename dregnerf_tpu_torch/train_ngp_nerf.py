"""Train one Instant-NGP block with the PyTorch port (twin of the root
train_ngp_nerf.py, single-block).

Usage:
  python -m dregnerf_tpu_torch.train_ngp_nerf --dataset objaverse \
      --root_dir <root> --scene <subject> --expname <name> \
      --grad_accum pallas --no-rle_backward [--device cpu]
"""
from __future__ import annotations

import copy
import os

from dregnerf_tpu_torch.runtime.config import config_parser


def train(config) -> None:
    from dregnerf_tpu_torch.datasets.objaverse import load_blocks
    from dregnerf_tpu_torch.runtime.ngp_trainer import NGPTrainer

    if config.multi_blocks:
        raise NotImplementedError("--multi_blocks is not ported yet (ROADMAP.md queue 1)")
    train_scene = load_blocks(config.root_dir, config.scene, "train", config.factor)[0]
    test_scene = load_blocks(config.root_dir, config.scene, "test", config.factor)[0]
    NGPTrainer(config, train_scene, test_scene).train()


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
