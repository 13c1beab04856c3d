"""Per-block NeRF fleet training: every block of a scene trained from one
program, with no collectives (port of dregnerf_tpu/parallel/fleet.py).

The JAX fleet stacks the blocks' states along a leading axis sharded over
the mesh (`P("data")`), pads the block count to a multiple of the device
count with replicas of the last block, and steps each device's local
blocks in turn (a `fori_loop`), so one chip trains several blocks. Here
each block keeps its own state (field parameters, Adam state, occupancy
grid, images) on its own device, in the NGPTrainer that built it: the
same contiguous assignment (`block_layout`), the local blocks stepped one
after another, and the padded replicas, which JAX trains and discards,
never trained. A block's step is JAX's `one_block` at a fixed ray count
with no ray-bucket feedback; a block's draws come from its own generator.

JAX repacks each block's region bitmask after every occupancy update; the
port's marcher reads the binary grid itself (ops/occupancy.py), so there
is nothing to repack.
"""
from __future__ import annotations

from typing import Sequence

from dregnerf_tpu_torch.runtime.ngp_trainer import StepDraws, draw_step_inputs, step_loss


def block_layout(n_blocks: int, n_devices: int) -> list[tuple[int, int]]:
    """(device index, index among that device's blocks) of each block: the
    blocks padded to a multiple of n_devices and split into equal
    contiguous runs, as a `P("data")` sharding of the padded stack splits
    them (3 blocks on 2 devices: two on device 0, one and a pad on 1)."""
    per = -(-n_blocks // n_devices)
    return [(b // per, b % per) for b in range(n_blocks)]


def block_step(trainer, step: int, num_rays: int, draws: StepDraws | None = None) -> dict:
    """One step of one block (`one_block`): num_rays rays from the block's
    own generator (or `draws`), the Huber loss over alive rays, backward
    and the block's Adam update number `step`. Returns the loss, psnr and
    n_samples as device tensors."""
    scene = trainer.scene
    if draws is None:
        draws = draw_step_inputs(trainer.generator, num_rays, scene.num_images, scene.height,
                                 scene.width, trainer.device)
    loss, m = step_loss(trainer.params, trainer.model_config, trainer.render_config,
                        trainer.grid, trainer.aabb, trainer.images, trainer.c2ws, trainer.K,
                        draws, scene.synthetic, scene.opengl)
    loss.backward()
    trainer.apply_gradients(step)
    return {"loss": loss.detach(), "psnr": m["psnr"], "n_samples": m["n_samples"]}


def fleet_train_step(trainers: Sequence, step: int, num_rays: int,
                     draws: Sequence[StepDraws] | None = None) -> list[dict]:
    """One step of every local block, in block order (block k on
    draws[k] when given)."""
    return [block_step(t, step, num_rays, None if draws is None else draws[k])
            for k, t in enumerate(trainers)]


def fleet_occ_update(trainers: Sequence, step: int, draws: Sequence[dict] | None = None) -> None:
    """The occupancy EMA update of every local block at step `step`
    (every cell below OCC_WARMUP_STEPS, else min(R^3 // 4, 2^17) uniform
    and as many occupied cells), each from its block's generator or from
    draws[k] (occupancy.update_grid's explicit draws)."""
    for k, t in enumerate(trainers):
        t.update_occupancy(step, **({} if draws is None else draws[k]))
