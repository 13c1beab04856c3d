"""Data-parallel registration training over a mesh of ranks (port of
dregnerf_tpu/parallel/regtr_dp.py).

Each rank runs the whole NeRFRegTr forward and the four losses on its own
scene pair; one `all_reduce` then sums a single flat buffer that holds the
gradient (the optimizer's flat layout, runtime/reg_optim.py) and the
step's scalars (total, each loss, R_error, t_error), and everything is
divided by N (JAX's `pmean`). The nonfinite-step guard reads the reduced
gradient and total, which every rank holds alike, so one rank's degenerate
pair skips the update on every rank together and the ranks stay equal.
"""
from __future__ import annotations

from typing import Dict

import torch

from dregnerf_tpu_torch.geometry import se3
from dregnerf_tpu_torch.parallel.mesh import Mesh


def dp_reg_step(mesh: Mesh, trainer, batch: Dict[str, torch.Tensor]) -> Dict:
    """One step of `trainer` (a RegTrainer) on this rank's pair `batch`
    (its tensors on the trainer's device); returns the metrics averaged
    over the ranks, as 0-dim device tensors."""
    grad, total, losses, pose = trainer.pair_grads([batch])
    names = list(losses)
    rre, rte = se3.pose_error(pose.float(), batch["pose"][:3, :4])
    stats = torch.stack([total, *(losses[k] for k in names), rre, rte]).to(torch.float32)
    flat = torch.cat([grad, stats])
    mesh.all_reduce_sum_(flat)
    flat = flat / mesh.size
    grad, stats = flat[:grad.numel()], flat[grad.numel():]
    finite = trainer.optimizer.step(grad, stats[0])
    return {**dict(zip(names, stats[1:-2])), "total": stats[0], "R_error": stats[-2],
            "t_error": stats[-1], "skipped_nonfinite": (~finite).to(torch.float32)}
