"""SE(3)/SO(3) algebra on torch tensors (port of dregnerf_tpu/geometry/se3.py).

An SE(3) transform is a [..., 3, 4] tensor ``[R | t]`` mapping points as
``R @ p + t``; every function works on trailing dims and keeps the input's
(f32) precision. The random draws take a `torch.Generator`: their streams
differ from jax.random's.
"""
from __future__ import annotations

import math

import torch


def se3_init(rot: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """[..., 3, 4] from rotation [..., 3, 3] and translation [..., 3, 1] or [..., 3]."""
    if trans.shape[-1] != 1:
        trans = trans[..., None]
    return torch.cat([rot, trans], dim=-1)


def se3_rot(pose: torch.Tensor) -> torch.Tensor:
    return pose[..., :3, :3]


def se3_trans(pose: torch.Tensor) -> torch.Tensor:
    return pose[..., :3, 3]


def se3_identity(batch_shape=(), device=None) -> torch.Tensor:
    return torch.eye(3, 4, device=device).expand(*batch_shape, 3, 4)


def se3_cat(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compose: result(p) = a(b(p))."""
    rot = se3_rot(a) @ se3_rot(b)
    trans = se3_trans(a) + torch.einsum("...ij,...j->...i", se3_rot(a), se3_trans(b))
    return se3_init(rot, trans)


def se3_inv(pose: torch.Tensor) -> torch.Tensor:
    rot_t = se3_rot(pose).transpose(-1, -2)
    trans = -torch.einsum("...ij,...j->...i", rot_t, se3_trans(pose))
    return se3_init(rot_t, trans)


def se3_transform(pose: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply a [..., 3, 4] pose to [..., N, 3] points."""
    return (torch.einsum("...ij,...nj->...ni", se3_rot(pose), points)
            + se3_trans(pose)[..., None, :])


def to_homogeneous(pose: torch.Tensor) -> torch.Tensor:
    """[..., 3, 4] -> [..., 4, 4]."""
    bottom = torch.zeros(*pose.shape[:-2], 1, 4, dtype=pose.dtype, device=pose.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([pose, bottom], dim=-2)


def from_homogeneous(mat: torch.Tensor) -> torch.Tensor:
    return mat[..., :3, :4]


def hat(v: torch.Tensor) -> torch.Tensor:
    """so(3) hat: [..., 3] -> [..., 3, 3] skew-symmetric."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def so3_exp(omega: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Rodrigues' formula, safe near zero."""
    theta = torch.linalg.norm(omega, dim=-1, keepdim=True).clamp(min=eps)
    k = hat(omega / theta)
    th = theta[..., None]
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(k.shape)
    return eye + torch.sin(th) * k + (1.0 - torch.cos(th)) * (k @ k)


def so3_log(rot: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Log map SO(3) -> so(3) axis-angle vector."""
    trace = rot.diagonal(dim1=-2, dim2=-1).sum(-1)
    cos_theta = torch.clamp((trace - 1.0) / 2.0, -1.0 + eps, 1.0 - eps)
    theta = torch.arccos(cos_theta)
    w = torch.stack([rot[..., 2, 1] - rot[..., 1, 2],
                     rot[..., 0, 2] - rot[..., 2, 0],
                     rot[..., 1, 0] - rot[..., 0, 1]], dim=-1)
    scale = theta / torch.clamp(2.0 * torch.sin(theta), min=eps)
    return w * scale[..., None]


def se3_exp(xi: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Exp map se(3) -> SE(3); xi = [..., 6] (omega, v)."""
    omega, v = xi[..., :3], xi[..., 3:]
    theta = torch.linalg.norm(omega, dim=-1, keepdim=True).clamp(min=eps)
    k = hat(omega / theta)
    th = theta[..., None]
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(k.shape)
    rot = eye + torch.sin(th) * k + (1.0 - torch.cos(th)) * (k @ k)
    V = eye + ((1.0 - torch.cos(th)) / th) * k + ((th - torch.sin(th)) / th) * (k @ k)
    trans = torch.einsum("...ij,...j->...i", V, v)
    return se3_init(rot, trans)


def random_se3(generator: torch.Generator, rot_scale: float = 1.0,
               trans_clamp: float = 0.2) -> torch.Tensor:
    """Random rigid transform: a rotation of angle pi * min(|w|, 1) about
    a Gaussian axis w, translation clamped to +-trans_clamp."""
    omega = torch.randn(3, generator=generator) * rot_scale
    norm = torch.linalg.norm(omega)
    rot = so3_exp(omega * math.pi / norm.clamp(min=1e-8) * norm.clamp(max=1.0))
    trans = torch.clamp(torch.randn(3, generator=generator) * trans_clamp,
                        -trans_clamp, trans_clamp)
    return se3_init(rot, trans)


def sample_se3_small(generator: torch.Generator, std: float = 0.1) -> torch.Tensor:
    """Small random perturbation in the tangent space."""
    return se3_exp(torch.randn(6, generator=generator) * std)


def rotation_distance_deg(r1: torch.Tensor, r2: torch.Tensor, eps: float = 1e-7
                          ) -> torch.Tensor:
    """Relative rotation error in degrees."""
    r = r1.transpose(-1, -2) @ r2
    trace = r.diagonal(dim1=-2, dim2=-1).sum(-1)
    cos_angle = torch.clamp((trace - 1.0) / 2.0, -1.0 + eps, 1.0 - eps)
    return torch.rad2deg(torch.arccos(cos_angle))


def translation_distance(t1: torch.Tensor, t2: torch.Tensor) -> torch.Tensor:
    return torch.linalg.norm(t1 - t2, dim=-1)


def pose_error(pred: torch.Tensor, gt: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(RRE degrees, RTE) between [..., 3, 4] poses."""
    return (rotation_distance_deg(se3_rot(pred), se3_rot(gt)),
            translation_distance(se3_trans(pred), se3_trans(gt)))
