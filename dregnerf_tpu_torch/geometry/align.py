"""Pose-set and trajectory alignment (port of
dregnerf_tpu/geometry/align.py): the errors between two aligned camera
sets, and the Sim(3) alignment of two camera-centre trajectories."""
from __future__ import annotations

import torch

from dregnerf_tpu_torch.geometry.kabsch import umeyama
from dregnerf_tpu_torch.geometry.se3 import rotation_distance_deg


def evaluate_camera_alignment(pred_poses: torch.Tensor, gt_poses: torch.Tensor) -> dict:
    """Per-camera errors of two aligned [N, 3, 4] pose sets: R_error_deg [N]
    and t_error [N]."""
    r_err = rotation_distance_deg(pred_poses[..., :3, :3], gt_poses[..., :3, :3])
    t_err = torch.linalg.norm(pred_poses[..., :3, 3] - gt_poses[..., :3, 3], dim=-1)
    return {"R_error_deg": r_err, "t_error": t_err}


def align_trajectories(src_centers: torch.Tensor, dst_centers: torch.Tensor):
    """(scale, R, t) with dst ~= scale * R @ src + t."""
    return umeyama(src_centers, dst_centers, with_scale=True)
