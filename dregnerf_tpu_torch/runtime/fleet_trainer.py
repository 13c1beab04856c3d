"""Fleet stage-1 training: every block of a scene trained together (port of
dregnerf_tpu/runtime/fleet_trainer.py).

`train_ngp_nerf --multi_blocks --fleet` replaces the loop over blocks with
one hot loop over all of them (parallel/fleet.py): the blocks go to the
visible CUDA devices in contiguous runs, and a device steps its blocks one
after another, with no collectives. On one card every block trains on
it. Under `--mesh_shape N` (N ranks under torchrun) rank r trains the
blocks of device r and writes their checkpoints.

One NGPTrainer per block does the setup, the meta, validation and
checkpoints; only the hot loop is new. The ray count is fixed at
--init_num_rays (no ray-bucket feedback, as in JAX's one compiled
program). JAX pads the blocks' image stacks to one count for its one
program and bounds each block's image draws by its own count; here each
block keeps its own stack and draws from it, which is the same draw.
Every block must have the same image size, as in JAX. JAX's fleet step
and occupancy update call the NGP field's functions whatever `--field`
says, so another field fails there; here it raises at once.
"""
from __future__ import annotations

import copy
import time

import numpy as np
import torch

from dregnerf_tpu_torch.device import resolve_device
from dregnerf_tpu_torch.parallel.fleet import block_layout, fleet_occ_update, fleet_train_step
from dregnerf_tpu_torch.parallel.mesh import barrier, make_mesh_from_config
from dregnerf_tpu_torch.runtime.ngp_trainer import OCC_UPDATE_INTERVAL, NGPTrainer


class FleetNGPTrainer:
    """Trains the blocks `train_scenes` (validated on `test_scenes`) into
    `output_dirs`, on `device` (default: the config's --device, else every
    visible CUDA device)."""

    def __init__(self, config, train_scenes, test_scenes, output_dirs, device=None):
        if config.field != "ngp":
            raise ValueError(f"--fleet trains NGP fields only, not --field {config.field}")
        sizes = {(s.height, s.width) for s in train_scenes}
        if len(sizes) > 1:
            raise ValueError(f"fleet blocks must share image resolution, got {sorted(sizes)}")
        self.config = config
        device = device if device is not None else getattr(config, "device", None)
        self.mesh = make_mesh_from_config(config, device)
        n_blocks = len(train_scenes)
        if self.mesh is not None:
            n_devices, devices = self.mesh.size, {self.mesh.rank: self.mesh.device}
        else:
            dev = resolve_device(device)
            if dev.type == "cuda" and dev.index is None:
                n_devices = min(n_blocks, torch.cuda.device_count())
                devices = {i: torch.device("cuda", i) for i in range(n_devices)}
            else:
                n_devices, devices = 1, {0: dev}
        self.layout = block_layout(n_blocks, n_devices)
        self.blocks = [k for k, (d, _) in enumerate(self.layout) if d in devices]
        block_cfg = copy.copy(config)
        block_cfg.mesh_shape = ""  # a block trains alone on its device
        self.trainers = [NGPTrainer(block_cfg, train_scenes[k], test_scenes[k],
                                    output_dir=output_dirs[k], device=devices[self.layout[k][0]])
                         for k in self.blocks]
        for k, t in zip(self.blocks, self.trainers):  # each block's own stream
            t.generator.manual_seed(config.seed + k)
        self.val_psnr: list[float] = []

    def train(self) -> None:
        cfg = self.config
        num_rays = int(cfg.init_num_rays)
        wall = time.time()
        for it in range(cfg.max_iterations):
            if it % OCC_UPDATE_INTERVAL == 0:
                fleet_occ_update(self.trainers, it)
            metrics = fleet_train_step(self.trainers, it, num_rays)
            if (it + 1) % cfg.n_tensorboard == 0:
                loss = np.mean([float(m["loss"]) for m in metrics])
                psnr = "/".join(f"{float(m['psnr']):.1f}" for m in metrics)
                print(f"[fleet] step {it + 1}/{cfg.max_iterations} loss {loss:.5f} psnr {psnr} "
                      f"| {time.time() - wall:.1f}s", flush=True)
        # each block writes its own checkpoint and validation render
        for t in self.trainers:
            t.step = cfg.max_iterations
            t.save_checkpoint(cfg.max_iterations)
            if t.val_scene is not None and t.val_scene.num_images:
                self.val_psnr.append(t.validate(cfg.max_iterations))
        barrier(self.mesh)
