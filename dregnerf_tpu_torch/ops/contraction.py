"""Scene contractions (port of dregnerf_tpu/ops/contraction.py).

All maps send world space into the unit cube [0, 1]^3.
"""
from __future__ import annotations

import torch

AABB = "aabb"
UN_BOUNDED_SPHERE = "un_bounded_sphere"


def contract_aabb(x: torch.Tensor, aabb: torch.Tensor) -> torch.Tensor:
    """World -> [0,1]^3 by AABB normalization; aabb: [6]."""
    return (x - aabb[:3]) / (aabb[3:] - aabb[:3])


def contract_aabb_inv(u: torch.Tensor, aabb: torch.Tensor) -> torch.Tensor:
    return u * (aabb[3:] - aabb[:3]) + aabb[:3]


def contract_unisphere(x: torch.Tensor, aabb: torch.Tensor,
                       eps: float = 1e-6) -> torch.Tensor:
    """MipNeRF-360 contraction: linear inside the aabb sphere, compressed to
    radius 2 outside; output scaled to [0, 1]."""
    u = contract_aabb(x, aabb) * 2.0 - 1.0
    mag = torch.linalg.norm(u, dim=-1, keepdim=True).clamp(min=eps)
    contracted = torch.where(mag > 1.0, (2.0 - 1.0 / mag) * (u / mag), u)
    return contracted / 4.0 + 0.5


def contract_unisphere_inv(v: torch.Tensor, aabb: torch.Tensor,
                           eps: float = 1e-6) -> torch.Tensor:
    """Inverse of `contract_unisphere`."""
    u = (v - 0.5) * 4.0
    mag = torch.linalg.norm(u, dim=-1, keepdim=True).clamp(min=eps)
    m = 1.0 / torch.clamp(2.0 - mag, min=eps)
    expanded = torch.where(mag > 1.0, u / mag * m, u)
    return contract_aabb_inv(expanded * 0.5 + 0.5, aabb)


def contract(x: torch.Tensor, aabb: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == AABB:
        return contract_aabb(x, aabb)
    if kind == UN_BOUNDED_SPHERE:
        return contract_unisphere(x, aabb)
    raise ValueError(f"unknown contraction: {kind}")


def contract_inv(u: torch.Tensor, aabb: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == AABB:
        return contract_aabb_inv(u, aabb)
    if kind == UN_BOUNDED_SPHERE:
        return contract_unisphere_inv(u, aabb)
    raise ValueError(f"unknown contraction: {kind}")
