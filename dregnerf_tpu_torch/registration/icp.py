"""Point-to-point, colour-aware ICP refinement (port of
dregnerf_tpu/registration/icp.py).

Nearest neighbours come from a brute-force [K, N, M] squared-distance
tensor |x|^2 - 2 x.y + |y|^2 in the joint (xyz, cfeat) space; the gate on
the matches is geometric and anneals from coarse to strict; the rigid
solve is the weighted Kabsch of geometry/kabsch.py. `icp_core` runs K
poses at once (the multi-start of `icp_refine`, the 24-seed race of
global_icp.py, the polish of every candidate in pipeline.py) as plain
tensor code: a Python loop of `iters` steps that reads nothing back to
the host (torch.linalg.svd synchronises with the card, but nothing is
read).

The products stay in true f32, never TF32 and never torch.cdist (which
switches between formulas with the size and rounds differently): the
strict gate at the race's finest scale is 0.4 * 0.03 = 0.012, d2 = 1.44e-4,
and a TF32 product of coordinates near 1 errs by about 1e-3, which
would swamp it.

The host-facing functions keep JAX's numpy in and numpy out, take a
`device` (cuda unless the caller asks for the CPU) and drop `_prep`'s
trailing padding before the device work: padded rows are invalid, so
they change no match, weight or score, and eager tensors need no static
shape.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from dregnerf_tpu_torch.device import resolve_device
from dregnerf_tpu_torch.geometry.kabsch import weighted_rigid_transform


def _sq_dist(moved_f: torch.Tensor, tgt_f: torch.Tensor, tgt_sq: torch.Tensor) -> torch.Tensor:
    """[K, N, M] max((|x|^2 - 2 x.y) + |y|^2, 0), summed in JAX's order;
    the [K, N, M] buffer is written once and updated in place."""
    d2 = torch.matmul(moved_f, tgt_f.transpose(-1, -2))
    d2.mul_(-2.0).add_((moved_f * moved_f).sum(-1)[..., None]).add_(tgt_sq[..., None, :])
    return d2.clamp_(min=0.0)


def _as_batch(x, k: int, device) -> torch.Tensor:
    """A float or [K] gate as a [K] f32 tensor."""
    return torch.as_tensor(x, dtype=torch.float32, device=device).expand(k)


def icp_core(src: torch.Tensor, tgt: torch.Tensor, src_cfeat: torch.Tensor,
             tgt_cfeat: torch.Tensor, src_valid: torch.Tensor, tgt_valid: torch.Tensor,
             init_pose: torch.Tensor, dist_start, dist_end, iters: int = 30
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Refine K src->tgt poses by point-to-point ICP.

    src [N, 3], tgt [M, 3], *_valid [N] / [M] bool; src_cfeat [N, C] or
    [K, N, C] and tgt_cfeat [M, C] or [K, M, C]: matching features (e.g.
    lam * rgb) appended to the positions for the neighbour search only;
    init_pose [K, 3, 4]; dist_start, dist_end: gates, floats or [K].
    Returns (pose [K, 3, 4], inlier rms [K], inlier count [K]). rms and
    count are those of the last iteration's matches, taken under the pose
    that entered that iteration (as JAX's scan stacks them).
    """
    if iters < 1:
        raise ValueError(f"iters must be at least 1, got {iters}")
    dev = src.device
    pose = init_pose.float()
    k = pose.shape[0]
    src, tgt = src.float(), tgt.float()
    src_cf = src_cfeat.float().expand(k, *src_cfeat.shape[-2:])
    tgt_f = torch.cat([tgt.expand(k, *tgt.shape), tgt_cfeat.float().expand(
        k, *tgt_cfeat.shape[-2:])], dim=-1)  # [K, M, 3 + C]
    # invalid targets must never be selected
    tgt_sq = torch.where(tgt_valid, (tgt_f * tgt_f).sum(-1), torch.inf)
    start, end = _as_batch(dist_start, k, dev), _as_batch(dist_end, k, dev)
    # the gate anneals from coarse to strict: frac = it / max(iters - 1, 1) in f32
    frac = torch.arange(iters, dtype=torch.float32, device=dev) / float(max(iters - 1, 1))
    gate_sq = start + (end - start) * frac[:, None]
    gate_sq = gate_sq * gate_sq  # [iters, K]
    src_k = src.expand(k, *src.shape)
    for it in range(iters):
        moved = torch.matmul(src, pose[:, :, :3].transpose(-1, -2)) + pose[:, None, :, 3]
        d2 = _sq_dist(torch.cat([moved, src_cf], dim=-1), tgt_f, tgt_sq)
        nn = d2.argmin(dim=-1)  # [K, N], chosen in the joint space
        del d2
        # the gate is geometric: the joint distance grows with the colour
        # weight, so a joint gate would starve the inliers at high lam
        tgt_nn = tgt[nn]
        nn_d2 = ((moved - tgt_nn) ** 2).sum(-1)
        w = ((nn_d2 < gate_sq[it][:, None]) & src_valid & tgt_valid[nn]).float()
        new_pose = weighted_rigid_transform(src_k, tgt_nn, w)
        # a degenerate iteration (< 3 inliers) keeps the previous pose
        pose = torch.where((w.sum(-1) >= 3.0)[:, None, None], new_pose, pose)
    cnt = w.sum(-1)
    # inf distances carry weight 0, and inf * 0 is NaN
    safe_d2 = torch.where(w > 0, nn_d2, 0.0)
    rms = torch.sqrt(safe_d2.sum(-1) / cnt.clamp(min=1.0))
    return pose, rms, cnt


def _trimmed_nn_score(src_f: torch.Tensor, tgt_f: torch.Tensor, src_valid: torch.Tensor,
                      tgt_valid: torch.Tensor, pose: torch.Tensor, trim: float) -> torch.Tensor:
    """[K] trimmed mean nearest-neighbour distance of the valid src rows of
    src_f [N, 3 + C] (xyz moved by pose [K, 3, 4]) to tgt_f [M, 3 + C]."""
    k = pose.shape[0]
    moved = torch.matmul(src_f[:, :3], pose[:, :, :3].transpose(-1, -2)) + pose[:, None, :, 3]
    moved = torch.cat([moved, src_f[:, 3:].expand(k, -1, -1)], dim=-1)
    tgt_sq = torch.where(tgt_valid, (tgt_f * tgt_f).sum(-1), torch.inf)
    nn_d = torch.sqrt(_sq_dist(moved, tgt_f, tgt_sq).amin(dim=-1))
    # padded src rows go past the trim horizon
    nn_d = torch.where(src_valid, nn_d, torch.inf)
    # the trim counts the VALID rows, in f32 as JAX does: int(f32(count) * trim)
    count = src_valid.sum()
    trim_f32 = torch.tensor(trim, dtype=torch.float32, device=nn_d.device)
    keep_n = torch.clamp((count.float() * trim_f32).int(), min=1)
    sorted_d = torch.sort(nn_d, dim=-1).values
    keep = torch.arange(nn_d.shape[-1], device=nn_d.device) < keep_n
    vals = torch.where(keep & torch.isfinite(sorted_d), sorted_d, 0.0)
    return vals.sum(-1) / torch.clamp(torch.minimum(keep_n, count), min=1)


def _batched(pose: torch.Tensor):
    """([K, 3, 4] pose, whether the caller gave one [3, 4] pose)."""
    single = pose.dim() == 2
    return (pose[None] if single else pose).float(), single


def score_pose_feat(src: torch.Tensor, tgt: torch.Tensor, src_cfeat: torch.Tensor,
                    tgt_cfeat: torch.Tensor, src_valid: torch.Tensor, tgt_valid: torch.Tensor,
                    pose: torch.Tensor, trim: float = 0.9) -> torch.Tensor:
    """Colour-aware trimmed-NN score of pose [3, 4] (a scalar) or poses
    [K, 3, 4] (a [K] tensor): nearest neighbours in the joint (xyz, cfeat)
    space, the trimmed mean of the joint distance. Geometry alone cannot
    tell a far-off pose from the right one on self-similar clusters of
    primitives; the colour mismatch at the neighbour can."""
    poses, single = _batched(pose)
    src_f = torch.cat([src.float(), src_cfeat.float()], dim=-1)
    tgt_f = torch.cat([tgt.float(), tgt_cfeat.float()], dim=-1)
    out = _trimmed_nn_score(src_f, tgt_f, src_valid, tgt_valid, poses, trim)
    return out[0] if single else out


def score_pose(src: torch.Tensor, tgt: torch.Tensor, src_valid: torch.Tensor,
               tgt_valid: torch.Tensor, pose: torch.Tensor, trim: float = 0.9) -> torch.Tensor:
    """Trimmed (lowest `trim` of the valid count) mean geometric NN distance
    of the valid src rows under pose [3, 4] or poses [K, 3, 4]."""
    poses, single = _batched(pose)
    out = _trimmed_nn_score(src.float(), tgt.float(), src_valid, tgt_valid, poses, trim)
    return out[0] if single else out


def _prep(points: np.ndarray, colors, n: int, rng: np.random.Generator):
    """Subsample-or-pad to exactly `n` points + validity mask."""
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    if colors is None:
        cols = np.zeros((pts.shape[0], 3), np.float32)
    else:
        cols = np.asarray(colors, np.float32).reshape(-1, 3)
        if cols.size and cols.max() > 1.0:
            cols = cols / 255.0
    m = pts.shape[0]
    if m >= n:
        idx = rng.choice(m, n, replace=False)
        return pts[idx], cols[idx], np.ones(n, bool)
    out = np.zeros((n, 3), np.float32)
    out[:m] = pts
    outc = np.zeros((n, 3), np.float32)
    outc[:m] = cols
    valid = np.zeros(n, bool)
    valid[:m] = True
    return out, outc, valid


def _unpadded(pts: np.ndarray, cols: np.ndarray, valid: np.ndarray, device):
    """`_prep`'s output on `device` without its trailing padding (its valid
    rows come first): (points, colours as numpy, valid)."""
    m = int(valid.sum())
    return (torch.as_tensor(pts[:m], device=device), cols[:m],
            torch.as_tensor(valid[:m], device=device))


def icp_refine(src_points: np.ndarray, tgt_points: np.ndarray, init_pose: np.ndarray,
               voxel_size: float = 0.05, iters: int = 30, n_points: int = 4096, seed: int = 0,
               src_colors: Optional[np.ndarray] = None, tgt_colors: Optional[np.ndarray] = None,
               color_weights: Tuple[float, ...] = (0.0, 0.25, 0.5), device=None
               ) -> Tuple[Optional[np.ndarray], float, int]:
    """Multi-start refinement: (pose [3, 4] | None, inlier rms, count).

    One ICP run per (starting gate 3x or 8x the voxel, colour weight),
    geometry only without colours, all in one batched `icp_core` call,
    plus the unrefined init; the best score wins (`score_pose_feat` at
    0.5 * rgb with colours, else `score_pose`), so the refinement never
    worsens its input under that score. The strict final gate is
    0.4 * voxel_size. None when fewer than 3 correspondences survive.
    """
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    src, src_c, sv = _prep(src_points, src_colors, n_points, rng)
    tgt, tgt_c, tv = _prep(tgt_points, tgt_colors, n_points, rng)
    if sv.sum() < 3 or tv.sum() < 3:
        return None, float("inf"), 0
    init = np.asarray(init_pose, np.float32)
    if init.shape == (4, 4):
        init = init[:3, :4]
    src_t, src_c, sv_t = _unpadded(src, src_c, sv, device)
    tgt_t, tgt_c, tv_t = _unpadded(tgt, tgt_c, tv, device)
    init_t = torch.as_tensor(init, device=device)

    lams = list(color_weights) if src_colors is not None else [0.0]
    # two coarse gates: 3x the voxel (a local polish) and 8x (a wide basin:
    # 16 deg at object radius 0.5 moves points about 0.14)
    runs = [(gate0, lam) for gate0 in (3.0, 8.0) for lam in lams]
    src_cf = torch.as_tensor(np.stack([lam * src_c for _, lam in runs]), device=device)
    tgt_cf = torch.as_tensor(np.stack([lam * tgt_c for _, lam in runs]), device=device)
    gate0 = torch.tensor([g * voxel_size for g, _ in runs], dtype=torch.float32, device=device)
    poses, rms, cnt = icp_core(src_t, tgt_t, src_cf, tgt_cf, sv_t, tv_t,
                               init_t.expand(len(runs), 3, 4), gate0, 0.4 * voxel_size,
                               iters=iters)
    cands = torch.cat([init_t[None], poses])  # the unrefined init first
    if src_colors is not None:
        scores = score_pose_feat(src_t, tgt_t, torch.as_tensor(0.5 * src_c, device=device),
                                 torch.as_tensor(0.5 * tgt_c, device=device), sv_t, tv_t, cands)
    else:
        scores = score_pose(src_t, tgt_t, sv_t, tv_t, cands)
    best = int(np.argmin(scores.tolist()))
    if best == 0:
        # the init won: its own inlier statistics at the strict gate
        pose = init_t
        _, rms, cnt = icp_core(src_t, tgt_t, torch.zeros_like(src_t), torch.zeros_like(tgt_t),
                               sv_t, tv_t, init_t[None], 0.4 * voxel_size, 0.4 * voxel_size,
                               iters=1)
        rms, cnt = float(rms[0]), int(cnt[0])
    else:
        pose = poses[best - 1]
        rms, cnt = float(rms[best - 1]), int(cnt[best - 1])
    if cnt < 3:
        return None, rms, cnt
    return pose.cpu().numpy(), rms, cnt
