"""Registration losses, masked and static-shape (port of
dregnerf_tpu/losses/registration.py).

The four losses of stage 3, weighted {overlap 1, nerf_cont 1, feature 0.1,
corr 1} by the trainer: a masked BCE of the predicted overlap against the
NeRF visibility labels, a smooth-L1 "nerf consistency" of the warped
keypoints' labels, an InfoNCE feature loss with a learned symmetric
bilinear form, and a Charbonnier correspondence loss weighted by the
ground-truth overlap. Every loss takes validity masks, since tokens are
padded to a fixed count.

Clips and maxima are written as torch.maximum/minimum, whose gradient at
a tie is split in half as jnp.maximum's is (torch.clamp passes all of it).
"""
from __future__ import annotations

import numpy as np
import torch


def masked_mean(x: torch.Tensor, mask: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    m = mask.to(torch.float32)
    return (x * m).sum() / torch.clamp(m.sum(), min=eps)


def overlap_bce(pred_prob: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked BCE on probabilities, in f32 whatever pred's dtype: in bf16 the
    upper bound 1 - 1e-6 would round to 1, and a prediction saturated at 1
    with gt 1 would give 0 * log(0) = NaN. pred_prob/gt/mask: [N]."""
    # the bounds filled on the device: a tensor built from Python numbers is
    # copied from the host, which waits for the device
    lo, hi = (torch.full((), v, dtype=torch.float32, device=pred_prob.device)
              for v in (1e-6, 1.0 - 1e-6))
    p = torch.minimum(torch.maximum(pred_prob.float(), lo), hi)
    bce = -(gt * torch.log(p) + (1.0 - gt) * torch.log(1.0 - p))
    return masked_mean(bce, mask)


def smooth_l1(x: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < delta, 0.5 * x * x / delta, ax - 0.5 * delta)


def nerf_consistency(overlap_tilde: torch.Tensor, overlap_gt: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """smooth_l1 between the labels of the warped keypoints and the GT
    labels, over every layer. overlap_*: [L, N]; mask: [N]."""
    return masked_mean(smooth_l1(overlap_tilde - overlap_gt), mask.expand(overlap_gt.shape))


def charbonnier(x: torch.Tensor, scale: float = 0.5) -> torch.Tensor:
    """Barron's general robust loss at alpha = 1: sqrt((x/c)^2 + 1) - 1."""
    return torch.sqrt((x / scale) ** 2 + 1.0) - 1.0


def correspondence_loss(kp_warped_pred: torch.Tensor, kp_warped_gt: torch.Tensor,
                        overlap_weights: torch.Tensor, mask: torch.Tensor,
                        robust: bool = True, metric: str = "mae",
                        eps: float = 1e-6) -> torch.Tensor:
    """Weighted (robust) correspondence error. kp_*: [N, 3] (one layer);
    overlap_weights/mask: [N]."""
    err = kp_warped_pred - kp_warped_gt
    if robust:
        err = charbonnier(err)
    per_pt = err.abs().sum(dim=-1) if metric == "mae" else (err ** 2).sum(dim=-1)
    w = overlap_weights * mask.to(torch.float32)
    return (w * per_pt).sum() / torch.clamp(w.sum(), min=eps)


def init_infonce_W(generator: np.random.Generator | torch.Generator, d_embed: int = 256,
                   std: float = 0.1, device=None) -> torch.Tensor:
    """[d_embed, d_embed] f32 normal(0, std), drawn from a numpy or a torch
    generator."""
    if isinstance(generator, np.random.Generator):
        w = (generator.standard_normal((d_embed, d_embed)) * std).astype(np.float32)
        return torch.as_tensor(w, device=device)
    return torch.randn(d_embed, d_embed, generator=generator, device=device) * std


def infonce_loss(W: torch.Tensor, anchor_feat: torch.Tensor, positive_feat: torch.Tensor,
                 anchor_xyz: torch.Tensor, positive_xyz: torch.Tensor,
                 anchor_valid: torch.Tensor, positive_valid: torch.Tensor,
                 r_p=0.2, r_n=0.4, return_stats: bool = False):
    """InfoNCE with a learned symmetric bilinear form.

    The positive of an anchor is its nearest valid point (the caller moves
    anchor_xyz by the GT pose) if nearer than r_p; points nearer than r_n
    other than the positive leave the denominator. r_p and r_n may be 0-dim
    tensors. return_stats=True also returns the count of positives.

    Distances are the norm of the difference, as in JAX (torch.cdist takes
    a matmul expansion above 25 points, which moves the argmin near ties);
    argmin takes the first index on a row of ties (all-inf rows included).
    Masked logits take a finite -1e9, not -inf: with no valid positive
    every row is masked, and logsumexp of an all -inf row has a NaN
    gradient that the loss's isfinite guard cannot stop.
    """
    W_sym = torch.triu(W) + torch.triu(W).T
    logits = torch.einsum("ic,cd,jd->ij", anchor_feat, W_sym, positive_feat)

    d = torch.linalg.vector_norm(anchor_xyz[:, None, :] - positive_xyz[None, :, :], dim=-1)
    d = torch.where(positive_valid[None, :], d, torch.inf)
    idx1 = d.argmin(dim=-1, keepdim=True)  # nearest positive per anchor
    dist1 = d.gather(1, idx1)[:, 0]
    has_match = (dist1 < r_p) & anchor_valid

    ignore = (d < r_n).scatter(1, idx1, False)  # out of place: `d` stays intact
    ignore = ignore | ~positive_valid[None, :]
    neg = torch.full((), -1e9, dtype=logits.dtype, device=logits.device)
    masked_logits = torch.where(ignore, neg, logits)

    pos_logit = masked_logits.gather(1, idx1)[:, 0]
    loss = -pos_logit + torch.logsumexp(masked_logits, dim=-1)
    loss = torch.where(torch.isfinite(loss), loss, 0.0)
    n_match = has_match.sum()
    out = (loss * has_match).sum() / torch.clamp(n_match.to(torch.float32), min=1.0)
    if return_stats:
        return out, n_match
    return out
