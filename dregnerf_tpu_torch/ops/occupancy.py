"""Binary occupancy grid with EMA updates (port of dregnerf_tpu/ops/occupancy.py).

State: f32 EMA densities [R^3] + bool binary [R, R, R] in the contracted
space [0, 1]^3. An update evaluates the field at jittered cell positions
(every cell in warmup; else n uniform cells + n cells resampled from the
occupied ones by cumsum + searchsorted), takes an EMA-max at those cells
and thresholds at min(mean, occ_threshold).

The marcher reads `binary` directly; the JAX package's region bitmask
(`pack_regions`/`query_regions`) is a TPU gather layout with the same
answer under the linear aabb contraction, and is not ported.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch


class OccupancyGrid(NamedTuple):
    occs: torch.Tensor  # [R^3] f32 EMA density
    binary: torch.Tensor  # [R, R, R] bool

    @property
    def resolution(self) -> int:
        return self.binary.shape[0]

    @property
    def num_cells(self) -> int:
        return self.resolution**3


def init_grid(resolution: int = 128, device: torch.device | str = "cpu") -> OccupancyGrid:
    return OccupancyGrid(
        occs=torch.zeros(resolution**3, dtype=torch.float32, device=device),
        binary=torch.zeros((resolution,) * 3, dtype=torch.bool, device=device),
    )


def occupancy_from_numpy(occs, binary, device: torch.device | str = "cpu") -> OccupancyGrid:
    """An OccupancyGrid from numpy arrays (a JAX grid's `occs`, `binary`)."""
    return OccupancyGrid(
        occs=torch.as_tensor(np.array(occs, dtype=np.float32).reshape(-1), device=device),
        binary=torch.as_tensor(np.array(binary, dtype=bool), device=device),
    )


def cell_centers(indices: torch.Tensor, resolution: int) -> torch.Tensor:
    """Flat cell indices -> contracted-space cell centers in [0,1]^3."""
    r = resolution
    iz = indices % r
    iy = (indices // r) % r
    ix = indices // (r * r)
    grid = torch.stack([ix, iy, iz], dim=-1).to(torch.float32)
    return (grid + 0.5) / r


def jitter_cells(indices: torch.Tensor, resolution: int,
                 noise: torch.Tensor) -> torch.Tensor:
    """Position inside each cell; noise [M, 3] uniform in [-0.5, 0.5)."""
    return cell_centers(indices, resolution) + noise / resolution


def query_binary(grid: OccupancyGrid, u: torch.Tensor) -> torch.Tensor:
    """Occupancy at contracted positions u [..., 3]; out of range reads False."""
    r = grid.resolution
    v = u * r
    in_range = ((v >= 0) & (v < r)).all(dim=-1)
    idx = torch.floor(v).clamp(0, r - 1).long()
    occ = grid.binary[idx[..., 0], idx[..., 1], idx[..., 2]]
    return occ & in_range


def update_grid(
    grid: OccupancyGrid,
    occ_eval_fn: Callable[[torch.Tensor], torch.Tensor],
    warmup: bool,
    ema_decay: float = 0.95,
    occ_threshold: float = 0.01,
    n_samples: int | None = None,
    generator: torch.Generator | None = None,
    uniform_idx: torch.Tensor | None = None,
    occ_rank: torch.Tensor | None = None,
    noise: torch.Tensor | None = None,
) -> OccupancyGrid:
    """One EMA update step.

    occ_eval_fn: contracted positions [M, 3] -> occupancy values [M].
    The random draws come from `generator`, or are given explicitly:
    `uniform_idx` [n] cells in [0, R^3), `occ_rank` [n] ranks in
    [0, max(#occupied, 1)), `noise` [M, 3] in [-0.5, 0.5) with M = R^3 in
    warmup and 2n otherwise.
    """
    r = grid.resolution
    n_cells = grid.num_cells
    dev = grid.occs.device
    n = n_cells // 4 if n_samples is None else n_samples

    if warmup:
        indices = torch.arange(n_cells, device=dev)
    else:
        if uniform_idx is None:
            uniform_idx = torch.randint(0, n_cells, (n,), generator=generator,
                                        device=dev)
        # uniform over occupied cells: cumsum + searchsorted (exact);
        # uniform cells when none is occupied
        csum = torch.cumsum(grid.binary.reshape(-1).to(torch.int64), 0)
        total = csum[-1]
        if occ_rank is None:
            # floor(u * total) for u in [0, 1): uniform in [0, total) without
            # reading `total` back to the host
            u = torch.rand(n, generator=generator, device=dev, dtype=torch.float64)
            occ_rank = torch.minimum((u * total.clamp(min=1)).long(),
                                     total.clamp(min=1) - 1)
        occ_idx = torch.searchsorted(csum, occ_rank.to(csum.device).long() + 1)
        occ_idx = torch.where(total > 0, occ_idx.clamp(max=n_cells - 1),
                              uniform_idx.long())
        indices = torch.cat([uniform_idx.long(), occ_idx])
    if noise is None:
        noise = torch.rand(indices.shape[0], 3, generator=generator, device=dev) - 0.5
    vals = occ_eval_fn(jitter_cells(indices, r, noise)).reshape(-1)

    occs = (grid.occs * ema_decay).scatter_reduce(
        0, indices, vals.to(torch.float32), reduce="amax", include_self=True)
    thresh = torch.clamp(occs.mean(), max=occ_threshold)
    return OccupancyGrid(occs=occs, binary=(occs > thresh).reshape(r, r, r))
