"""Real spherical-harmonics direction encoding, degree <= 4
(port of dregnerf_tpu/ops/sh.py, same instant-ngp constants)."""
from __future__ import annotations

import torch


def sh_encode(dirs: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """[..., 3] unit directions -> [..., degree**2] coefficients."""
    if not 1 <= degree <= 4:
        raise ValueError(f"sh degree must be in [1, 4], got {degree}")
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z

    out = [torch.full_like(x, 0.28209479177387814)]
    if degree >= 2:
        out += [
            -0.48860251190291987 * y,
            0.48860251190291992 * z,
            -0.48860251190291987 * x,
        ]
    if degree >= 3:
        out += [
            1.0925484305920792 * xy,
            -1.0925484305920792 * yz,
            0.94617469575755997 * zz - 0.31539156525251999,
            -1.0925484305920792 * xz,
            0.54627421529603959 * (xx - yy),
        ]
    if degree >= 4:
        out += [
            0.59004358992664352 * y * (-3.0 * xx + yy),
            2.8906114426405538 * xy * z,
            0.45704579946446572 * y * (1.0 - 5.0 * zz),
            0.3731763325901154 * z * (5.0 * zz - 3.0),
            0.45704579946446572 * x * (1.0 - 5.0 * zz),
            1.4453057213202769 * z * (xx - yy),
            0.59004358992664352 * x * (-xx + 3.0 * yy),
        ]
    return torch.stack(out, dim=-1)
