"""Camera models and ray generation (port of dregnerf_tpu/geometry/cameras.py).

Pixel centres at +0.5, OpenGL (y/z flipped) or OpenCV sign, camera-to-world
[3, 4] poses.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Rays(NamedTuple):
    origins: torch.Tensor  # [..., 3]
    viewdirs: torch.Tensor  # [..., 3] unit-norm


def pixel_dirs(x: torch.Tensor, y: torch.Tensor, K: torch.Tensor,
               opengl: bool = True) -> torch.Tensor:
    """Camera-frame direction for pixel coords (x, y); K is the 3x3 intrinsic."""
    sign = -1.0 if opengl else 1.0
    dx = (x.to(torch.float32) - K[0, 2] + 0.5) / K[0, 0]
    dy = (y.to(torch.float32) - K[1, 2] + 0.5) / K[1, 1] * sign
    dz = torch.full_like(dx, sign)
    return torch.stack([dx, dy, dz], dim=-1)


def rays_from_pixels(x: torch.Tensor, y: torch.Tensor, K: torch.Tensor,
                     c2w: torch.Tensor, opengl: bool = True) -> Rays:
    """World-space rays for pixels (x, y) [...]; c2w [..., 3, 4] broadcasts."""
    cam_dirs = pixel_dirs(x, y, K, opengl)
    directions = torch.einsum("...ij,...j->...i", c2w[..., :3, :3], cam_dirs)
    origins = torch.broadcast_to(c2w[..., :3, 3], directions.shape)
    viewdirs = directions / torch.linalg.norm(directions, dim=-1, keepdim=True)
    return Rays(origins=origins, viewdirs=viewdirs)


def image_rays(K: torch.Tensor, c2w: torch.Tensor, height: int, width: int,
               opengl: bool = True) -> Rays:
    """Full-image ray grid, [H, W, 3] origins/dirs."""
    y, x = torch.meshgrid(
        torch.arange(height, device=K.device),
        torch.arange(width, device=K.device), indexing="ij")
    return rays_from_pixels(x, y, K, c2w[None, None], opengl)


def ray_aabb_intersect(origins: torch.Tensor, viewdirs: torch.Tensor,
                       aabb: torch.Tensor, near: float = 0.0,
                       far: float = 1e10) -> tuple[torch.Tensor, torch.Tensor]:
    """Slab-method ray/AABB intersection; (t_min, t_max), t_min > t_max = miss.

    aabb: [6] = (xmin, ymin, zmin, xmax, ymax, zmax). Direction components
    below 1e-10 in magnitude are clamped to 1e-10, as in the reference.
    """
    inv_dir = 1.0 / torch.where(viewdirs.abs() < 1e-10,
                                torch.full_like(viewdirs, 1e-10), viewdirs)
    t0 = (aabb[:3] - origins) * inv_dir
    t1 = (aabb[3:] - origins) * inv_dir
    t_small = torch.minimum(t0, t1)
    t_big = torch.maximum(t0, t1)
    t_min = torch.clamp(t_small.amax(dim=-1), min=near)
    t_max = torch.clamp(t_big.amin(dim=-1), max=far)
    return t_min, t_max
