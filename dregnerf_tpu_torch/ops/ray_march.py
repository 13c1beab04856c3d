"""Static-shape ray marching with occupancy skipping (port of dregnerf_tpu/ops/ray_march.py).

A dense [R, S] candidate lattice t = t_lo + (s + jitter) * dt per ray,
masked by the occupancy grid at each step's contracted midpoint; then
either each ray's first K survivors packed back to back into one buffer
(`march_rays`, compaction "capped", the training marcher) or laid out as
[R, K] rows (`march_rays_rows`, validation).

The occupancy test reads `grid.binary` at each step's cell. The JAX
marcher reads a region bitmask instead, which gives the same answer under
the linear "aabb" contraction; under "un_bounded_sphere" it reads cells
beyond the region margin as occupied, which this port does not mirror yet,
so that contraction raises here (ROADMAP.md queue 3). The "compact" and
"quota" compactions and per-ray `t_max` are still to be ported.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from dregnerf_tpu_torch.geometry.cameras import ray_aabb_intersect
from dregnerf_tpu_torch.ops.occupancy import OccupancyGrid

_BIG = 1 << 30


class PackedSamples(NamedTuple):
    """A fixed-capacity packed sample buffer. Entries beyond the live count
    have valid=False and ray_id == num_rays (an overflow segment)."""

    ray_id: torch.Tensor  # [B] int64, == num_rays for padding
    t_start: torch.Tensor  # [B] f32
    t_end: torch.Tensor  # [B] f32
    valid: torch.Tensor  # [B] bool
    num_samples: torch.Tensor  # [] int64, live entries
    num_rays: int


class RowSamples(NamedTuple):
    """Row-packed samples: ray r owns row r, its first K surviving steps."""

    t_start: torch.Tensor  # [R, K] f32
    dt: float
    valid: torch.Tensor  # [R, K] bool, depth-ordered, survivors first
    num_samples: torch.Tensor  # [] int64


def _jitter(num_rays, stratified, generator, jitter, device) -> torch.Tensor:
    if jitter is not None:
        return jitter.reshape(num_rays, 1).to(torch.float32)
    if stratified:
        return torch.rand(num_rays, 1, generator=generator, device=device)
    return torch.zeros(num_rays, 1, device=device)


def _candidate_mask(origins, viewdirs, grid: OccupancyGrid, aabb, contraction,
                    render_step_size, max_steps, near_plane, far_plane, jitter):
    """(mask [R, S] bool, t_lo [R]): steps whose midpoint is inside the ray's
    box interval and in an occupied cell."""
    if contraction != "aabb":
        raise NotImplementedError(
            f"marching under contraction {contraction!r} is not ported yet "
            "(ROADMAP.md queue 3)")
    t_lo, t_hi = ray_aabb_intersect(origins, viewdirs, aabb, near_plane, far_plane)
    steps = torch.arange(max_steps, dtype=torch.float32, device=origins.device)[None, :]
    ts = t_lo[:, None] + (steps + jitter) * render_step_size  # [R, S]
    t_mid = ts + 0.5 * render_step_size

    res = grid.resolution
    lo, ext = aabb[:3], aabb[3:] - aabb[:3]
    in_range = None
    flat = None
    for k in range(3):  # one axis at a time: [R, S] temporaries, not [R, S, 3]
        pos = origins[:, k, None] + viewdirs[:, k, None] * t_mid
        v = (pos - lo[k]) / ext[k] * res
        ok = (v >= 0) & (v < res)
        c = torch.floor(v).clamp(0, res - 1).to(torch.int64)
        in_range = ok if in_range is None else in_range & ok
        flat = c if flat is None else flat * res + c
    occupied = grid.binary.reshape(-1)[flat] & in_range
    alive = (t_mid < t_hi[:, None]) & (t_lo < t_hi)[:, None]
    return occupied & alive, t_lo


def _first_survivors(mask: torch.Tensor, k: int):
    """Each row's first k surviving step indices, ascending: (steps [R, k]
    int64, valid [R, k])."""
    steps = torch.arange(mask.shape[1], dtype=torch.int32, device=mask.device)
    keys = torch.where(mask, -steps[None, :], torch.full_like(steps, -_BIG)[None, :])
    vals = torch.topk(keys, k, dim=1, largest=True, sorted=True).values
    valid = vals > -_BIG
    return torch.where(valid, -vals, 0).to(torch.int64), valid


def march_rays_rows(origins, viewdirs, grid: OccupancyGrid, aabb, contraction: str,
                    render_step_size: float, k_per_ray: int, max_steps: int,
                    near_plane: float = 0.0, far_plane: float = 1e10,
                    stratified: bool = False, generator: torch.Generator | None = None,
                    jitter: torch.Tensor | None = None) -> RowSamples:
    """Row-packed marching: each ray's first `k_per_ray` surviving steps.

    Stratified jitter is an explicit [R, 1] tensor, or drawn from
    `generator` when `stratified`.
    """
    num_rays = origins.shape[0]
    jitter = _jitter(num_rays, stratified, generator, jitter, origins.device)
    mask, t_lo = _candidate_mask(origins, viewdirs, grid, aabb, contraction,
                                 render_step_size, max_steps, near_plane,
                                 far_plane, jitter)
    src, valid = _first_survivors(mask, k_per_ray)
    t0 = torch.where(valid, t_lo[:, None] + (src.to(torch.float32) + jitter)
                     * render_step_size, 0.0)
    return RowSamples(t_start=t0, dt=render_step_size, valid=valid,
                      num_samples=valid.sum())


def row_sample_positions(rows: RowSamples, origins, viewdirs):
    """[R, K, 3] world positions + broadcast dirs."""
    t_mid = rows.t_start + 0.5 * rows.dt
    pos = origins[:, None, :] + viewdirs[:, None, :] * t_mid[..., None]
    return pos, torch.broadcast_to(viewdirs[:, None, :], pos.shape)


def march_rays(origins, viewdirs, grid: OccupancyGrid, aabb, contraction: str,
               render_step_size: float, buffer_size: int, max_steps: int,
               near_plane: float = 0.0, far_plane: float = 1e10,
               stratified: bool = False, generator: torch.Generator | None = None,
               jitter: torch.Tensor | None = None, compaction: str = "capped",
               k_cap: int | None = None) -> PackedSamples:
    """March rays into a packed buffer of `buffer_size` samples.

    compaction "capped": each ray's first `k_cap` survivors (default
    min(256, max_steps, buffer_size)), packed back to back at the exclusive
    cumsum of the per-ray counts and cut at the buffer; ray-major and
    depth-ordered, as the compositor needs.
    """
    if compaction != "capped":
        raise NotImplementedError(
            f"march compaction {compaction!r} is not ported yet (ROADMAP.md queue 1)")
    num_rays = origins.shape[0]
    dev = origins.device
    jitter = _jitter(num_rays, stratified, generator, jitter, dev)
    mask, t_lo = _candidate_mask(origins, viewdirs, grid, aabb, contraction,
                                 render_step_size, max_steps, near_plane,
                                 far_plane, jitter)
    k_cap = min(k_cap or 256, max_steps, buffer_size)
    steps_rk, valid_rk = _first_survivors(mask, k_cap)
    del mask
    cnt = valid_rk.sum(dim=1)  # [R]
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                         torch.cumsum(cnt, 0)])  # [R+1]
    total = offsets[-1]
    ranks = torch.arange(buffer_size, device=dev)
    # row of flat slot i = (number of row starts <= i) - 1: a mark at every
    # row start, then a cumsum (empty rows put two marks on one slot)
    marks = torch.zeros(buffer_size + 1, dtype=torch.int64, device=dev)
    marks.index_add_(0, offsets[:-1].clamp(max=buffer_size),
                     torch.ones(num_rays, dtype=torch.int64, device=dev))
    row = torch.cumsum(marks[:buffer_size], 0) - 1
    n_live = torch.clamp(total, max=buffer_size)
    valid = ranks < n_live
    row_safe = row.clamp(0, num_rays - 1)
    k = (ranks - offsets[row_safe]).clamp(0, k_cap - 1)
    step_idx = steps_rk[row_safe, k].to(torch.float32)
    ts0 = torch.where(valid, t_lo[row_safe]
                      + (step_idx + jitter[row_safe, 0]) * render_step_size, 0.0)
    return PackedSamples(
        ray_id=torch.where(valid, row_safe, num_rays),
        t_start=ts0,
        t_end=ts0 + render_step_size,
        valid=valid,
        num_samples=n_live,
        num_rays=num_rays,
    )


def sample_positions(packed: PackedSamples, origins, viewdirs):
    """Packed sample world positions + their ray directions: ([B, 3], [B, 3])."""
    safe_ray = packed.ray_id.clamp(max=packed.num_rays - 1)
    o = origins[safe_ray]
    d = viewdirs[safe_ray]
    t_mid = (packed.t_start + packed.t_end) * 0.5
    return o + d * t_mid[:, None], d
