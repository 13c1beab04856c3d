"""The classical global-registration baseline: global colour ICP, FGR and
RANSAC at several scales in both directions, each candidate polished by a
short ICP, the winner chosen by a GT-free score and optionally refined
(port of dregnerf_tpu/registration/pipeline.py).

FGR and RANSAC run on the host (registration/fgr.py); the ICP parts and
the scores run on `device` (cuda unless the caller asks for the CPU).
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from dregnerf_tpu_torch.device import resolve_device
from dregnerf_tpu_torch.registration.fgr import run_ransac_registration, run_registration
from dregnerf_tpu_torch.registration.global_icp import global_colored_icp
from dregnerf_tpu_torch.registration.icp import (_prep, _unpadded, icp_core, icp_refine,
                                                 score_pose_feat)


def _inv34(T: np.ndarray) -> np.ndarray:
    T = np.asarray(T, np.float32)
    R, t = T[:3, :3], T[:3, 3]
    out = np.zeros((3, 4), np.float32)
    out[:3, :3] = R.T
    out[:3, 3] = -R.T @ t
    return out


def best_global_registration(src_points: np.ndarray, tgt_points: np.ndarray,
                             src_colors: Optional[np.ndarray] = None,
                             tgt_colors: Optional[np.ndarray] = None,
                             voxel_sizes: Tuple[float, ...] = (0.03, 0.05, 0.08, 0.12),
                             refine: bool = True, n_points: int = 4096, seed: int = 0,
                             icp_voxel: Optional[float] = None, both_directions: bool = True,
                             polish_each: bool = True, device=None
                             ) -> Tuple[Optional[np.ndarray], dict]:
    """Returns (T [3, 4] or None, info): every candidate's GT-free score and
    which (method, voxel, direction) won.

    The race, in candidate order: the 24-seed global colour ICP; then for
    each voxel size FGR and RANSAC, each forward and reverse (FPFH
    matching is direction-sensitive; a reverse pose is inverted). Each
    FGR/RANSAC candidate gets 12 ICP iterations at gates 3x and 0.4x the
    finest scale (all candidates in one batched call), then the joint
    (xyz, 0.5 * rgb) trimmed-NN score; geometry alone cannot separate
    far-off poses on self-similar clusters of primitives. The lowest score
    wins, then `icp_refine` at `icp_voxel` (2 cells of a 128^3 grid over
    [-1, 1] by default) when `refine`.
    """
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    src, sc, sv = _prep(src_points, src_colors, n_points, rng)
    tgt, tc, tv = _prep(tgt_points, tgt_colors, n_points, rng)
    src_t, sc, sv_t = _unpadded(src, sc, sv, device)
    tgt_t, tc, tv_t = _unpadded(tgt, tc, tv, device)
    lam = 0.5
    sc_t = torch.as_tensor(lam * sc, device=device)
    tc_t = torch.as_tensor(lam * tc, device=device)

    def score(poses: np.ndarray) -> list:
        return score_pose_feat(src_t, tgt_t, sc_t, tc_t, sv_t, tv_t,
                               torch.as_tensor(poses, device=device)).tolist()

    directions = (("fwd", src_points, tgt_points),)
    if both_directions:
        directions += (("rev", tgt_points, src_points),)

    cands = []
    t0 = time.time()
    # the rotation-grid candidate: FPFH proposals can all be wrong on
    # sphere-family clouds while one of 24 seeds lies within ~31 deg
    try:
        T_g, _ = global_colored_icp(src_points, tgt_points, src_colors, tgt_colors, seed=seed,
                                    device=device)
        if T_g is not None:
            T34 = np.asarray(T_g, np.float32)[:3, :4]
            cands.append({"method": "gicp", "voxel": None, "dir": "fwd",
                          "score": round(score(T34[None])[0], 6), "_T": T34})
    except Exception as e:  # noqa: BLE001 — one source must not kill the race
        cands.append({"method": "gicp", "voxel": None, "score": None, "error": str(e)[:200]})
    proposals = []
    for vs in voxel_sizes:
        for name, fn in (("fgr", run_registration), ("ransac", run_ransac_registration)):
            for dname, a_pts, b_pts in directions:
                T, _ = fn(a_pts, b_pts, voxel_size=vs)
                cand = {"method": name, "voxel": vs, "dir": dname, "score": None}
                cands.append(cand)
                if T is not None:
                    T34 = np.asarray(T, np.float32)[:3, :4]
                    proposals.append((cand, _inv34(T34) if dname == "rev" else T34))
    if proposals:
        poses = np.stack([T34 for _, T34 in proposals])
        if polish_each:
            gate0, gate1 = 3.0 * min(voxel_sizes), 0.4 * min(voxel_sizes)
            poses = icp_core(src_t, tgt_t, sc_t, tc_t, sv_t, tv_t,
                             torch.as_tensor(poses, device=device), gate0, gate1,
                             iters=12)[0].cpu().numpy()
        for (cand, _), T34, s in zip(proposals, poses, score(poses)):
            cand.update(score=round(s, 6), _T=T34)
    scored = [c for c in cands if c.get("_T") is not None]
    info = {
        "candidates": [
            {**{k: v for k, v in c.items() if k != "_T"},
             **({"T": np.asarray(c["_T"]).tolist()} if "_T" in c else {})}
            for c in cands
        ],
        "time_s": time.time() - t0,
    }
    if not scored:
        return None, info
    best = min(scored, key=lambda c: c["score"])
    info["winner"] = {"method": best["method"], "voxel": best["voxel"],
                      "dir": best.get("dir", "fwd"), "score": best["score"]}
    T = best["_T"]
    if refine:
        T_ref, rms, cnt = icp_refine(
            src_points, tgt_points, T,
            voxel_size=icp_voxel if icp_voxel is not None else 2.0 / 128 * 2,
            seed=seed, src_colors=src_colors, tgt_colors=tgt_colors, device=device)
        if T_ref is not None:
            info["icp"] = {"rms": round(float(rms), 6), "inliers": int(cnt)}
            T = T_ref
    info["time_s"] = time.time() - t0
    return T, info
