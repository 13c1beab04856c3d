"""Multiresolution xor-hash grid encoding, Instant-NGP's (port of
dregnerf_tpu/ops/hash_encoding.py).

All L levels in one pass: positions are scaled per level, the 8 corner
rows of every (point, level) pair form one [N, L, 8] index tensor, and one
gather pulls [N, L, 8, F] features from the [L*T, F] table. A level whose
dense vertex grid fits in T rows indexes it densely (x + y*res + z*res^2);
a larger one takes the spatial hash x*1 xor y*2654435761 xor z*805459861
(uint32 products) mod T. The choice is static per level. The table is f32
and so is the interpolation; the backward is autograd's scatter-add into
the table.

The JAX package computes this in XLA, outside any Pallas kernel, so the
port writes it in plain PyTorch.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dregnerf_tpu_torch.device import resolve_device

_PRIMES = (1, 2654435761, 805459861)
_MASK32 = (1 << 32) - 1

# The 8 corners of a unit cube, [8, 3].
_CORNERS = np.stack(
    np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"), axis=-1
).reshape(8, 3).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class HashGridConfig:
    """tiny-cuda-nn's HashGrid defaults: 16 levels x 2 features, 2^19 rows a level."""

    n_levels: int = 16
    n_features: int = 2
    log2_table_size: int = 19
    base_resolution: int = 16
    per_level_scale: float = 1.4472692012786865

    @property
    def table_size(self) -> int:
        return 1 << self.log2_table_size

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features

    def level_scales(self) -> np.ndarray:
        """Per-level grid scale (number of cells along an axis)."""
        return np.array(
            [
                self.base_resolution * self.per_level_scale**lvl - 1.0
                for lvl in range(self.n_levels)
            ],
            dtype=np.float32,
        )

    def level_resolutions(self) -> np.ndarray:
        """Per-level vertex count along an axis."""
        return (np.ceil(self.level_scales()) + 1.0).astype(np.int64)

    def level_is_dense(self) -> np.ndarray:
        """True for levels where the dense grid fits in the hash table."""
        res = self.level_resolutions()
        return (res**3) <= self.table_size


def init_hash_table(config: HashGridConfig, generator: torch.Generator | None = None,
                    device: torch.device | str | None = None) -> torch.Tensor:
    """[L*T, F] f32 table, uniform in (-1e-4, 1e-4), on `device` (cuda
    unless given; raises without CUDA)."""
    device = resolve_device(device)
    u = torch.rand(config.n_levels * config.table_size, config.n_features,
                   generator=generator, device=device, dtype=torch.float32)
    return u * 2e-4 - 1e-4


def _corner_indices(config: HashGridConfig, pos_grid: torch.Tensor) -> torch.Tensor:
    """Integer corner coordinates [N, L, 8, 3] (int64, clamped to the
    level's vertices) -> table rows [N, L, 8] (int64, offset by level)."""
    dev = pos_grid.device
    T = config.table_size
    res = torch.as_tensor(config.level_resolutions(), device=dev)[None, :, None]
    dense = torch.as_tensor(config.level_is_dense(), device=dev)[None, :, None]
    x, y, z = pos_grid.unbind(-1)
    dense_idx = x + y * res + z * (res * res)
    hashed = (((x * _PRIMES[0]) & _MASK32) ^ ((y * _PRIMES[1]) & _MASK32)
              ^ ((z * _PRIMES[2]) & _MASK32)) & (T - 1)
    idx = torch.where(dense, dense_idx, hashed)
    return idx + torch.arange(config.n_levels, device=dev)[None, :, None] * T


def hash_corners(x: torch.Tensor, config: HashGridConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """[N, 3] positions -> (table rows [N, L, 8] int64, trilinear weights
    [N, L, 8] f32) of every point's 8 corners at every level; corners
    outside the grid are clamped to it."""
    dev = x.device
    scales = torch.as_tensor(config.level_scales(), device=dev)
    pos = x[:, None, :] * scales[None, :, None] + 0.5  # [N, L, 3]
    pos_floor = torch.floor(pos)
    frac = pos - pos_floor

    corners = torch.as_tensor(_CORNERS, device=dev)  # [8, 3]
    pos_grid = pos_floor[:, :, None, :].to(torch.int64) + corners  # [N, L, 8, 3]
    res = torch.as_tensor(config.level_resolutions(), device=dev)
    pos_grid = torch.minimum(pos_grid.clamp(min=0), (res - 1)[None, :, None, None])

    # the product over the axes of frac (corner coordinate 1) or 1 - frac
    w = torch.where(corners.bool(), frac[:, :, None, :], 1.0 - frac[:, :, None, :])
    return _corner_indices(config, pos_grid), w[..., 0] * w[..., 1] * w[..., 2]


def hash_encode(table: torch.Tensor, x: torch.Tensor, config: HashGridConfig) -> torch.Tensor:
    """[..., 3] positions in [0, 1]^3 (corners outside are clamped to the
    grid) -> [..., L*F] f32 features."""
    batch_shape = x.shape[:-1]
    rows, w = hash_corners(x.reshape(-1, 3).to(torch.float32), config)
    out = (w[..., None] * table[rows]).sum(dim=2)  # [N, L, F]
    return out.reshape(*batch_shape, config.out_dim)
