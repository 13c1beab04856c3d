"""Data-parallel NGP training step over a mesh of ranks (port of
dregnerf_tpu/parallel/ngp_dp.py).

Every rank marches and renders its own rays against the same field and
occupancy grid (a step's marching and compaction are per ray, so nothing
crosses ranks until the gradient), with the packed sample buffer split
evenly: `buffer_size // N` samples a rank. One `all_reduce` then sums a
single flat buffer that holds every gradient leaf, the loss, the squared
error, the sample count and the alive-ray count; the gradient, loss and
squared error are divided by N (JAX's `pmean`), the counts stay sums
(`psum`). Every rank then takes the same Adam step, so the ranks stay
equal bit for bit.

`train_ngp_nerf --mesh_shape N` routes NGPTrainer through this step
(runtime/ngp_trainer.py): rank 0's initial weights are broadcast once,
each rank draws `num_rays // N` rays from its own generator, the occupancy
update draws from a generator that is the same on every rank (so every
rank computes the same grid), and the ray-bucket feedback reads the summed
sample count and sets the global ray count.
"""
from __future__ import annotations

import dataclasses

import torch

from dregnerf_tpu_torch.models import ngp
from dregnerf_tpu_torch.parallel.mesh import Mesh
from dregnerf_tpu_torch.runtime.checkpoint import leaves_with_paths
from dregnerf_tpu_torch.runtime.ngp_trainer import StepDraws, mse_to_psnr, step_loss


def dp_train_step(mesh: Mesh, params, model_config, render_config, grid, aabb, images,
                  c2ws, K, draws: StepDraws, synthetic: bool = True, opengl: bool = True,
                  field=ngp, timestamps=None) -> dict:
    """This rank's loss and backward on its `draws`, then the one all_reduce:
    leaves the mean gradient in each parameter's `.grad` (for the caller's
    optimizer step) and returns the step's metrics over every rank (loss,
    psnr, n_samples, alive_rays), as device tensors."""
    n = mesh.size
    local = dataclasses.replace(render_config,
                                buffer_size=max(render_config.buffer_size // n, 1))
    loss, m = step_loss(params, model_config, local, grid, aabb, images, c2ws, K, draws,
                        synthetic, opengl, field, timestamps)
    leaves = list(leaves_with_paths(params).values())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    stats = torch.stack([loss.detach(), m["sq"], m["n_samples"].to(torch.float32),
                         m["alive_rays"]]).to(torch.float32)
    flat = torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1).float()
                      for p, g in zip(leaves, grads)] + [stats])
    mesh.all_reduce_sum_(flat)
    g_flat, stats = flat[:-4] / n, flat[-4:]
    for p, g in zip(leaves, g_flat.split([p.numel() for p in leaves])):
        p.grad = g.view_as(p).to(p.dtype)
    return {"loss": stats[0] / n, "psnr": mse_to_psnr(stats[1] / n),
            "n_samples": stats[2].to(torch.int64), "alive_rays": stats[3]}
