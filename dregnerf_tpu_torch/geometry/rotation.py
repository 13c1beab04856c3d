"""Rotation representation conversions: quaternion, axis-angle, Euler and
matrix, batched (port of dregnerf_tpu/geometry/rotation.py). Quaternions
are (w, x, y, z), unit-norm."""
from __future__ import annotations

import torch

from dregnerf_tpu_torch.geometry.se3 import rotation_distance_deg, so3_exp, so3_log


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


def matrix_to_quat(rot: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Branch-free Shepperd-style conversion: all four candidate quaternions,
    the one with the largest trace term kept (the first on ties), the sign
    made canonical with w >= 0."""
    m = rot
    t0 = 1.0 + m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    t1 = 1.0 + m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2]
    t2 = 1.0 - m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2]
    t3 = 1.0 - m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2]

    s0 = torch.sqrt(torch.clamp(t0, min=eps)) * 2.0
    q0 = torch.stack([0.25 * s0,
                      (m[..., 2, 1] - m[..., 1, 2]) / s0,
                      (m[..., 0, 2] - m[..., 2, 0]) / s0,
                      (m[..., 1, 0] - m[..., 0, 1]) / s0], -1)
    s1 = torch.sqrt(torch.clamp(t1, min=eps)) * 2.0
    q1 = torch.stack([(m[..., 2, 1] - m[..., 1, 2]) / s1,
                      0.25 * s1,
                      (m[..., 0, 1] + m[..., 1, 0]) / s1,
                      (m[..., 0, 2] + m[..., 2, 0]) / s1], -1)
    s2 = torch.sqrt(torch.clamp(t2, min=eps)) * 2.0
    q2 = torch.stack([(m[..., 0, 2] - m[..., 2, 0]) / s2,
                      (m[..., 0, 1] + m[..., 1, 0]) / s2,
                      0.25 * s2,
                      (m[..., 1, 2] + m[..., 2, 1]) / s2], -1)
    s3 = torch.sqrt(torch.clamp(t3, min=eps)) * 2.0
    q3 = torch.stack([(m[..., 1, 0] - m[..., 0, 1]) / s3,
                      (m[..., 0, 2] + m[..., 2, 0]) / s3,
                      (m[..., 1, 2] + m[..., 2, 1]) / s3,
                      0.25 * s3], -1)

    idx = torch.argmax(torch.stack([t0, t1, t2, t3], -1), dim=-1)
    qs = torch.stack([q0, q1, q2, q3], -2)
    q = torch.gather(qs, -2, idx[..., None, None].expand(*idx.shape, 1, 4))[..., 0, :]
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def axis_angle_to_matrix(aa: torch.Tensor) -> torch.Tensor:
    return so3_exp(aa)


def matrix_to_axis_angle(rot: torch.Tensor) -> torch.Tensor:
    return so3_log(rot)


def euler_to_matrix(angles: torch.Tensor) -> torch.Tensor:
    """XYZ-intrinsic Euler angles (radians) -> rotation matrix, mz @ my @ mx."""
    rx, ry, rz = angles[..., 0], angles[..., 1], angles[..., 2]
    cx, sx = torch.cos(rx), torch.sin(rx)
    cy, sy = torch.cos(ry), torch.sin(ry)
    cz, sz = torch.cos(rz), torch.sin(rz)
    one = torch.ones_like(cx)
    zero = torch.zeros_like(cx)
    mx = torch.stack([torch.stack([one, zero, zero], -1),
                      torch.stack([zero, cx, -sx], -1),
                      torch.stack([zero, sx, cx], -1)], -2)
    my = torch.stack([torch.stack([cy, zero, sy], -1),
                      torch.stack([zero, one, zero], -1),
                      torch.stack([-sy, zero, cy], -1)], -2)
    mz = torch.stack([torch.stack([cz, -sz, zero], -1),
                      torch.stack([sz, cz, zero], -1),
                      torch.stack([zero, zero, one], -1)], -2)
    return mz @ my @ mx


def chordal_distance(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    return torch.linalg.norm((r1 - r2).reshape(*r1.shape[:-2], 9), dim=-1)


def angular_distance_deg(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    return rotation_distance_deg(r1, r2)
