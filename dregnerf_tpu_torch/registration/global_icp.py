"""Global registration by a race of colour-aware ICP runs from 24 seeds,
with no initial pose (port of dregnerf_tpu/registration/global_icp.py).

FPFH proposals (FGR, RANSAC) degrade on surfaces of constant curvature;
the voxel shells carry a colour per point, which tells such poses apart.
So: seed the 24 rotations of the cube (every pose lies within about 31
degrees of one), each with the centroids aligned; run all 24 as one
batched `icp_core` call at a coarse point count (a [24, N, M] distance
tensor a step); score every result with the GT-free joint trimmed-NN
score; polish the best with `icp_refine` at the full point count.
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from dregnerf_tpu_torch.device import resolve_device
from dregnerf_tpu_torch.registration.icp import (_prep, _unpadded, icp_core, icp_refine,
                                                 score_pose_feat)


def octahedral_rotations() -> np.ndarray:
    """The 24 rotation matrices of the cube (chiral octahedral group)."""
    mats = []
    for perm in ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0)):
        for sx in (1, -1):
            for sy in (1, -1):
                for sz in (1, -1):
                    m = np.zeros((3, 3))
                    m[0, perm[0]] = sx
                    m[1, perm[1]] = sy
                    m[2, perm[2]] = sz
                    if np.linalg.det(m) > 0:
                        mats.append(m)
    return np.stack(mats).astype(np.float32)  # [24, 3, 3]


def _coarse_race(src, tgt, src_c, tgt_c, sv, tv, seeds, gate0, gate1, iters: int = 20):
    """Colour-aware ICP from every seed pose [K, 3, 4] at once; returns the
    K (pose, joint score) pairs as ([K, 3, 4], [K])."""
    poses, _, _ = icp_core(src, tgt, src_c, tgt_c, sv, tv, seeds, gate0, gate1, iters=iters)
    return poses, score_pose_feat(src, tgt, src_c, tgt_c, sv, tv, poses)


def global_colored_icp(src_points: np.ndarray, tgt_points: np.ndarray,
                       src_colors: Optional[np.ndarray] = None,
                       tgt_colors: Optional[np.ndarray] = None,
                       voxel_size: float = 2.0 / 128 * 2, color_weight: float = 0.5,
                       n_coarse: int = 1024, n_refine: int = 4096, seed: int = 0, device=None
                       ) -> Tuple[Optional[np.ndarray], dict]:
    """Global src->tgt registration without an initial pose, on `device`
    (cuda unless the caller asks for the CPU). Returns (T [3, 4] or None,
    info with the coarse race's best score and seed and the timings)."""
    device = resolve_device(device)
    t0 = time.time()
    rng = np.random.default_rng(seed)
    src, src_c, sv = _prep(src_points, src_colors, n_coarse, rng)
    tgt, tgt_c, tv = _prep(tgt_points, tgt_colors, n_coarse, rng)
    if sv.sum() < 3 or tv.sum() < 3:
        return None, {"error": "too few points"}

    # every rotation turns about the src centroid, then centroid -> centroid
    mu_s = src[sv].mean(axis=0)
    mu_t = tgt[tv].mean(axis=0)
    rots = octahedral_rotations()
    trans = mu_t[None, :] - np.einsum("kij,j->ki", rots, mu_s)
    seeds = np.concatenate([rots, trans[:, :, None]], axis=-1)  # [24, 3, 4]

    lam = float(color_weight) if src_colors is not None else 0.0
    src_t, src_c, sv_t = _unpadded(src, src_c, sv, device)
    tgt_t, tgt_c, tv_t = _unpadded(tgt, tgt_c, tv, device)
    poses, scores = _coarse_race(
        src_t, tgt_t, torch.as_tensor(lam * src_c, device=device),
        torch.as_tensor(lam * tgt_c, device=device), sv_t, tv_t,
        torch.as_tensor(seeds, device=device), 8.0 * voxel_size, 0.8 * voxel_size)
    scores = np.asarray(scores.tolist(), np.float32)
    best = int(np.argmin(scores))
    coarse = poses[best].cpu().numpy()
    info = {"coarse_best_score": float(scores[best]), "coarse_seed": best,
            "coarse_time_s": time.time() - t0}

    T, rms, cnt = icp_refine(src_points, tgt_points, coarse, voxel_size=voxel_size,
                             n_points=n_refine, seed=seed, src_colors=src_colors,
                             tgt_colors=tgt_colors, device=device)
    info["time_s"] = time.time() - t0
    if T is None:
        return coarse, info
    info["icp_rms"] = float(rms)
    info["icp_inliers"] = int(cnt)
    return T, info
