"""Train NeRFRegTr on NeRF pairs, stage 3 (twin of the root
train_nerf_regtr.py).

Trains the registration transformer over the scene pairs of
<root_dir>/<dataset>/nerf_models (the train and test splits of
objaverse.json), or over the pairs of one scene with --scene. Writes
<out_dir>/<expname>/model/ (step-stamped, latest and best checkpoints with
the JAX RegTrainer's keys), log.txt and log.jsonl; with
--enable_tensorboard an event file under <out_dir>/logs/<expname>; with
--enable_visdom the live pose viewer on --visdom_port.

Usage:
  python -m dregnerf_tpu_torch.train_nerf_regtr --dataset objaverse \
      --root_dir <root> --expname <name> [--epochs 80 --lr 1e-4 --robust_loss] \
      [--enable_tensorboard] [--enable_visdom] [--watchdog_s 1200] [--no_bf16] [--device cpu]
"""
from __future__ import annotations

from dregnerf_tpu_torch.runtime.config import config_parser


def main(argv=None):
    from dregnerf_tpu_torch.datasets.register_pairs import NeRFRegDataset
    from dregnerf_tpu_torch.runtime.reg_trainer import RegTrainer

    config = config_parser(argv)
    datasets = [NeRFRegDataset(config.root_dir, config.dataset or "objaverse", config.json_dir,
                               subject_id=config.scene or None, split=split, seed=config.seed)
                for split in ("train", "test")]
    trainer = RegTrainer(config, *datasets)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
