"""Fixed-capacity hierarchical voxel subsampling (port of
dregnerf_tpu/ops/voxel_subsample.py).

Every level keeps the input's capacity N with a validity mask (valid
entries first), as the JAX package does:

  1. hash each point's integer cell coordinates (a spatial hash in uint32
     arithmetic, done here in int64 with a 32-bit mask after each product);
     invalid points get the sentinel 0xFFFFFFFF, which sorts last;
  2. stable sort by key; a group starts where the key or the cell
     coordinates change (a hash collision splits, never merges);
  3. the group rank by cumsum, then the mean of xyz and features per group
     (`index_add_` in place of `segment_sum`: another order of adds, so
     f32 means agree within rounding, and group counts exactly).

All `num_levels` levels are computed and the first whose combined count is
at most 2 * max_points is picked on the device, as in JAX: no host sync.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

_P0, _P1, _P2 = 73856093, 19349663, 83492791
_U32 = 0xFFFFFFFF
_SENTINEL = 0xFFFFFFFF


class PointSet(NamedTuple):
    xyz: torch.Tensor  # [N, 3] f32
    feats: torch.Tensor  # [N, F]
    valid: torch.Tensor  # [N] bool, valid entries first
    count: torch.Tensor  # [] int32


def spatial_hash(coords: torch.Tensor) -> torch.Tensor:
    """[N, 3] int32 cell coordinates -> [N] int64 holding JAX's uint32 hash:
    coordinates cast to uint32 (negatives wrap), products mod 2^32, xor,
    then the low 31 bits."""
    u = coords.long() & _U32
    h = ((u[:, 0] * _P0) & _U32) ^ ((u[:, 1] * _P1) & _U32) ^ ((u[:, 2] * _P2) & _U32)
    return h & 0x7FFFFFFF


def voxel_downsample(points: PointSet, cell_size: float) -> PointSet:
    """One quantize-and-average level at fixed capacity; features come out
    in f32 (JAX promotes them with the f32 validity weights)."""
    n = points.xyz.shape[0]
    dev = points.xyz.device
    # divide by a tensor, not a Python scalar: CUDA turns a scalar divisor
    # into a multiply by its reciprocal, which can move a point across a
    # cell boundary against JAX's true division
    cell = torch.full((3,), cell_size, dtype=torch.float32, device=dev)
    coords = torch.floor(points.xyz / cell).to(torch.int32)
    key = torch.where(points.valid, spatial_hash(coords),
                      torch.full((), _SENTINEL, dtype=torch.int64, device=dev))

    key_s, order = torch.sort(key, stable=True)
    coords_s = coords[order]
    valid_s = points.valid[order]
    xyz_s = points.xyz[order]
    feats_s = points.feats[order].float()

    prev_key = torch.cat([key_s[:1] ^ 1, key_s[:-1]])
    prev_coords = torch.cat([coords_s[:1] + 1, coords_s[:-1]])
    new_group = (key_s != prev_key) | (coords_s != prev_coords).any(dim=-1)
    rank = torch.cumsum(new_group.to(torch.int64), 0) - 1

    ones = valid_s.float()
    denom = torch.zeros(n, device=dev).index_add_(0, rank, ones).clamp(min=1.0)
    mean_xyz = (torch.zeros(n, 3, device=dev).index_add_(0, rank, xyz_s * ones[:, None])
                / denom[:, None])
    mean_feats = (torch.zeros(n, feats_s.shape[1], device=dev)
                  .index_add_(0, rank, feats_s * ones[:, None]) / denom[:, None])

    n_groups = torch.where(valid_s, rank + 1, 0).max()
    out_valid = torch.arange(n, device=dev) < n_groups
    return PointSet(
        xyz=mean_xyz * out_valid[:, None],
        feats=mean_feats * out_valid[:, None],
        valid=out_valid,
        count=n_groups.to(torch.int32),
    )


def hierarchical_subsample(src: PointSet, tgt: PointSet, num_levels: int = 6,
                           init_cell: float = 0.05, max_points: int = 1500,
                           ) -> tuple[PointSet, PointSet, torch.Tensor]:
    """`num_levels` doubling-cell levels on both clouds; returns the first
    level whose combined count is <= 2 * max_points, else the last:
    (src_out, tgt_out, level) with level a 0-dim int64 tensor."""
    src_levels, tgt_levels = [], []
    cell = init_cell
    s, t = src, tgt
    for _ in range(num_levels):
        s = voxel_downsample(s, cell)
        t = voxel_downsample(t, cell)
        src_levels.append(s)
        tgt_levels.append(t)
        cell *= 2.0

    counts = torch.stack([sl.count + tl.count for sl, tl in zip(src_levels, tgt_levels)])
    ok = (counts <= 2 * max_points).to(torch.int32)
    level = torch.where(ok.any(), ok.argmax(), num_levels - 1)

    def pick(levels):  # index_select: indexing by a 0-dim tensor would read it on the host
        return PointSet(*(torch.stack(field).index_select(0, level.view(1))[0]
                          for field in zip(*levels)))

    return pick(src_levels), pick(tgt_levels), level


def masked_select_strided(flat_valid: torch.Tensor, k: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Indices of about k True entries spread evenly over the True set
    (every stride-th by mask rank, stride = ceil(count / k)) and their
    validity; equal to `masked_select_first_k` when count <= k."""
    count = flat_valid.sum()
    stride = torch.clamp((count + k - 1) // k, min=1)
    rank = torch.cumsum(flat_valid.to(torch.int64), 0) - 1
    thinned = flat_valid & (rank % stride == 0)
    return masked_select_first_k(thinned, k)


def masked_select_first_k(flat_valid: torch.Tensor, k: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fixed-shape nonzero: the indices (int64) of the first k True entries
    in index order, and a validity mask of the k slots. Past the mask's
    length the slots read index 0 and are invalid."""
    order = torch.sort((~flat_valid).to(torch.int8), stable=True).indices
    if k > order.shape[0]:
        order = F.pad(order, (0, k - order.shape[0]))
    idx = order[:k]
    valid = torch.arange(k, device=flat_valid.device) < flat_valid.sum()
    return idx, valid
