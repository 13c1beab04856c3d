"""Pose-only ray dataset: rays of arbitrary camera poses, without images
(port of dregnerf_tpu/datasets/pose_only.py). The registration evaluator
renders its novel views from it."""
from __future__ import annotations

import numpy as np
import torch

from dregnerf_tpu_torch.device import resolve_device
from dregnerf_tpu_torch.geometry.cameras import Rays, image_rays

# (width, height, focal, opengl) per dataset name
_INTRINSICS = {
    "objaverse": (800, 800, None, True),  # focal from camera_angle_x 0.8575
    "nerf_synthetic": (800, 800, None, True),
    "scannerf": (1440, 1080, 1000.0, True),
    "dtu": (640, 512, 700.0, False),
    "BlendedMVS": (768, 576, 600.0, False),
}
_DEFAULT_ANGLE_X = 0.8575560450553894


def intrinsics_for(dataset: str, factor: int = 1) -> tuple[np.ndarray, int, int, bool]:
    """(K [3, 3] f32, height, width, opengl) of a dataset's cameras, downscaled
    by `factor`; unknown names take objaverse's."""
    w, h, focal, opengl = _INTRINSICS.get(dataset, _INTRINSICS["objaverse"])
    if focal is None:
        focal = 0.5 * w / np.tan(0.5 * _DEFAULT_ANGLE_X)
    w, h, focal = w // factor, h // factor, focal / factor
    K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]], np.float32)
    return K, h, w, opengl


class NeRFPoseOnlyDataset:
    """Full-image rays of each pose on `device` (default cuda)."""

    def __init__(self, poses: np.ndarray, dataset: str = "objaverse", factor: int = 1,
                 device=None):
        """poses: [N, 3, 4] or [N, 4, 4] camera-to-world."""
        self.poses = np.asarray(poses, np.float32)[:, :3, :4]
        self.K, self.height, self.width, self.opengl = intrinsics_for(dataset, factor)
        self.device = resolve_device(device)

    def __len__(self) -> int:
        return len(self.poses)

    def __getitem__(self, i: int) -> Rays:
        return image_rays(torch.as_tensor(self.K, device=self.device),
                          torch.as_tensor(self.poses[i], device=self.device),
                          self.height, self.width, self.opengl)
