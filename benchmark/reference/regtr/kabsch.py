"""Weighted Kabsch and Umeyama alignment (port of dregnerf_tpu/geometry/kabsch.py).

Always f32, whatever the network's dtype: a 3x3 SVD in bf16 is useless.
`torch.linalg.svd` (LAPACK on the CPU, cuSOLVER on the card) may give the
singular vectors other signs than JAX; the rotation V diag(1, 1, det) U^T
is the same wherever the singular values differ.
"""
from __future__ import annotations

import torch


def weighted_rigid_transform(a: torch.Tensor, b: torch.Tensor, weights: torch.Tensor,
                             eps: float = 1e-5) -> torch.Tensor:
    """Least-squares rigid transform aligning a -> b.

    a, b: [..., N, 3]; weights: [..., N] (negatives count as 0).
    Returns [..., 3, 4] T with T(a) ~= b; finite when all weights are 0,
    NaN when an input is not finite.
    """
    a, b = a.float(), b.float()
    w = weights.float().clamp(min=0.0)
    w_norm = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=eps)

    centroid_a = torch.einsum("...n,...ni->...i", w_norm, a)
    centroid_b = torch.einsum("...n,...ni->...i", w_norm, b)
    a_c = a - centroid_a[..., None, :]
    b_c = b - centroid_b[..., None, :]
    cov = torch.einsum("...ni,...n,...nj->...ij", a_c, w_norm, b_c)

    # a nonfinite input gives a NaN transform, as JAX's SVD does (LAPACK's
    # raises instead): the trainer's guard then skips the step
    finite = torch.isfinite(cov).all(dim=-1).all(dim=-1)[..., None, None]
    u, _, vt = torch.linalg.svd(torch.where(finite, cov, 0.0), full_matrices=False)
    v = vt.transpose(-1, -2)
    ut = u.transpose(-1, -2)
    det = torch.linalg.det(v @ ut)
    d = torch.cat([torch.ones(*det.shape, 2, device=det.device), det[..., None]], dim=-1)
    rot = (v * d[..., None, :]) @ ut
    trans = centroid_b - torch.einsum("...ij,...j->...i", rot, centroid_a)
    return torch.where(finite, torch.cat([rot, trans[..., None]], dim=-1), torch.nan)


def umeyama(src: torch.Tensor, dst: torch.Tensor, with_scale: bool = True,
            eps: float = 1e-8):
    """Similarity alignment: (scale, R, t) with dst ~= scale * R @ src + t;
    src, dst [N, 3]."""
    src, dst = src.float(), dst.float()
    n = src.shape[-2]
    mu_s, mu_d = src.mean(dim=-2), dst.mean(dim=-2)
    sc, dc = src - mu_s, dst - mu_d
    cov = (dc.T @ sc) / n
    var_s = (sc**2).sum() / n

    u, s, vt = torch.linalg.svd(cov)
    d = torch.sign(torch.linalg.det(u) * torch.linalg.det(vt))
    diag = torch.stack([torch.ones_like(d), torch.ones_like(d), d])
    rot = (u * diag[None, :]) @ vt
    scale = (s * diag).sum() / torch.clamp(var_s, min=eps) if with_scale else torch.ones_like(d)
    trans = mu_d - scale * rot @ mu_s
    return scale, rot, trans
