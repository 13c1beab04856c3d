"""The registration trainer's step, plain: the device augmentation, the
four losses with their voxel-mask labels, and clip + AdamW (a frozen copy
of the arithmetic of dregnerf_tpu_torch: runtime/reg_trainer.py
`compute_losses`, losses/visibility.py `grid_visibility`,
datasets/register_pairs.py `device_augment`, runtime/reg_optim.py).
"""
from __future__ import annotations

import torch

from benchmark.reference.regtr import registration as L
from benchmark.reference.regtr import se3

LOSS_WEIGHTS = {"overlap": 1.0, "nerf_cont": 1.0, "feature": 0.1, "corr": 1.0}
MAX_GRAD_NORM = 0.1
B1, B2, EPS = 0.9, 0.999, 1e-8
WEIGHT_DECAY = 1e-4


def device_augment(grid, mask, p, noise, jitter_scale=0.005, jitter_clip=0.05):
    """Masked xyz jitter, then the rigid transform p [4, 4] of the masked xyz."""
    r3 = mask.shape[0]
    flat = grid.reshape(r3, 7)
    xyz = flat[:, :3]
    if noise is not None and jitter_scale != 0:
        xyz = xyz + torch.clamp(noise * jitter_scale, -jitter_clip, jitter_clip) * mask[:, None]
    warped = xyz @ p[:3, :3].T + p[:3, 3]
    xyz = torch.where(mask[:, None], warped, xyz)
    return torch.cat([xyz, flat[:, 3:]], dim=-1).reshape(grid.shape)


def grid_visibility(points, mask_flat, aabb, res):
    """{0, 1} labels of world points by the voxel mask."""
    u = (points - aabb[:3]) / (aabb[3:] - aabb[:3])
    idx = torch.floor(u * res).to(torch.int64)
    in_range = ((idx >= 0) & (idx < res)).all(dim=-1)
    idx = idx.clamp(0, res - 1)
    flat = idx[..., 0] * res * res + idx[..., 1] * res + idx[..., 2]
    return (mask_flat[flat] & in_range).to(torch.float32)


def compute_losses(model, infonce_W, batch, aabb, res, robust=False):
    """(total, losses) of one pair."""
    pred = model(batch)
    pose_gt = batch["pose"][:3, :4]
    pose_gt_inv = se3.se3_inv(pose_gt)
    src_kp, tgt_kp = pred["src_kp"], pred["tgt_kp"]
    src_valid, tgt_valid = pred["src_valid"], pred["tgt_valid"]
    src_warped, tgt_warped = pred["src_kp_warped"], pred["tgt_kp_warped"]
    n_layers = src_warped.shape[0]
    with torch.no_grad():
        src_labels = grid_visibility(torch.cat([src_kp[None], src_warped.detach()]),
                                     batch["src_mask"], aabb, res)
        tgt_labels = grid_visibility(torch.cat([tgt_kp[None], tgt_warped.detach()]),
                                     batch["tgt_mask"], aabb, res)
        src_gt, src_tilde = src_labels[0], src_labels[1:]
        tgt_gt, tgt_tilde = tgt_labels[0], tgt_labels[1:]
    losses = {}
    losses["overlap"] = L.overlap_bce(
        torch.cat([pred["src_overlap"][-1], pred["tgt_overlap"][-1]]),
        torch.cat([src_gt, tgt_gt]), torch.cat([src_valid, tgt_valid]))
    losses["nerf_cont"] = 0.5 * (
        L.nerf_consistency(src_tilde, src_gt.expand(n_layers, -1), src_valid)
        + L.nerf_consistency(tgt_tilde, tgt_gt.expand(n_layers, -1), tgt_valid))
    cell = model.init_subsample_cell * torch.pow(2.0, pred["ds_level"].to(torch.float32))
    r_p = torch.clamp(1.25 * cell, min=0.2)
    src_warped_gt = se3.se3_transform(pose_gt, src_kp)
    losses["feature"] = L.infonce_loss(
        infonce_W, pred["src_feats"][-1, 0].float(), pred["tgt_feats"][-1, 0].float(),
        src_warped_gt, tgt_kp, src_valid, tgt_valid, r_p=r_p, r_n=2.0 * r_p)
    tgt_warped_gt = se3.se3_transform(pose_gt_inv, tgt_kp)
    losses["corr"] = (
        L.correspondence_loss(src_warped[-1], src_warped_gt, src_gt, src_valid, robust)
        + L.correspondence_loss(tgt_warped[-1], tgt_warped_gt, tgt_gt, tgt_valid, robust))
    total = sum(losses[k] * LOSS_WEIGHTS[k] for k in LOSS_WEIGHTS)
    return total, losses


class AdamW:
    """clip_by_global_norm(0.1), Adam (0.9, 0.999, eps 1e-8), decoupled
    weight decay 1e-4, at a constant learning rate (the schedule's first
    halving is 34000 updates away)."""

    def __init__(self, leaves, lr):
        self.leaves, self.lr = list(leaves), lr
        self.mu = [torch.zeros_like(p) for p in self.leaves]
        self.nu = [torch.zeros_like(p) for p in self.leaves]
        self.count = 0

    @torch.no_grad()
    def step(self, grads):
        """Returns the clipped gradients (what the moments take)."""
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
        scale = torch.where(norm < MAX_GRAD_NORM, torch.ones_like(norm), MAX_GRAD_NORM / norm)
        clipped = [g * scale for g in grads]
        self.count += 1
        c = self.count
        for p, g, m, v in zip(self.leaves, clipped, self.mu, self.nu):
            m.mul_(B1).add_(g, alpha=1 - B1)
            v.mul_(B2).addcmul_(g, g, value=1 - B2)
            u = (m / (1 - B1**c)) / (torch.sqrt(v / (1 - B2**c)) + EPS) + WEIGHT_DECAY * p
            p.sub_(self.lr * u)
        return clipped
