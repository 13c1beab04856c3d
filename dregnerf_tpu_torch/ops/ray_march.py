"""Static-shape ray marching with occupancy skipping (port of dregnerf_tpu/ops/ray_march.py).

A dense [R, S] candidate lattice t = t_lo + (s + jitter) * dt per ray,
masked by the occupancy grid at each step's contracted midpoint; then
either packed into one buffer of B samples (`march_rays`, the training
marchers: "capped", each ray's first K survivors back to back; "compact",
every survivor in ray-major order, cut at B; "quota", each ray's first
B/R survivors in a slot range of its own) or laid out as [R, K] rows
(`march_rays_rows`, validation).

The occupancy test mirrors the JAX marcher's region read without its
packed bitmask: steps go in groups, and a step's cell reads `grid.binary`
when it lies in the 8^3-cell region around the supercell of its group's
middle step, and reads occupied otherwise. Under the linear "aabb"
contraction at the trainer's step convention every cell lies in its
region, so this is the plain binary read; under "un_bounded_sphere", or
with steps coarser than the convention, far cells read occupied, as in
JAX. A per-ray `t_max` cuts each ray's far end (the surface pass of voxel
extraction).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from dregnerf_tpu_torch.geometry.cameras import ray_aabb_intersect
from dregnerf_tpu_torch.ops.contraction import contract
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


def _group_size(max_steps: int, resolution: int) -> int:
    """Steps per region group, as both JAX marchers size it: the steps that
    cross 3.5 cells at the step convention (aabb diagonal / max_steps), at
    most 32, decremented until it divides max_steps."""
    steps_per_cell = max_steps / (resolution * 1.7320508)
    group = min(max(math.floor(3.5 * steps_per_cell) + 1, 1), 32)
    while max_steps % group:
        group -= 1
    return group


def _contracted_axes(origins, viewdirs, t_mid, aabb, contraction):
    """The three contracted coordinates [R, S] of every step midpoint."""
    if contraction == "aabb":  # one axis at a time: [R, S] temporaries
        lo, ext = aabb[:3], aabb[3:] - aabb[:3]
        return [(origins[:, k, None] + viewdirs[:, k, None] * t_mid - lo[k]) / ext[k]
                for k in range(3)]
    pos = origins[:, None, :] + viewdirs[:, None, :] * t_mid[..., None]
    return contract(pos, aabb, contraction).unbind(-1)


def _candidate_mask(origins, viewdirs, grid: OccupancyGrid, aabb, contraction,
                    render_step_size, max_steps, near_plane, far_plane, t_max, jitter):
    """(mask [R, S] bool, t_lo [R]): steps whose midpoint is inside the ray's
    box interval (cut at t_max) and reads occupied."""
    t_lo, t_hi = ray_aabb_intersect(origins, viewdirs, aabb, near_plane, far_plane)
    if t_max is not None:
        t_hi = torch.minimum(t_hi, t_max)
    num_rays = origins.shape[0]
    steps = torch.arange(max_steps, dtype=torch.float32, device=origins.device)[None, :]
    ts = t_lo[:, None] + (steps + jitter) * render_step_size  # [R, S]
    t_mid = ts + 0.5 * render_step_size

    res = grid.resolution
    if res % 4:
        raise ValueError(f"occupancy resolution must be divisible by 4, got {res}")
    group = _group_size(max_steps, res)
    in_range = in_region = flat = None
    for u in _contracted_axes(origins, viewdirs, t_mid, aabb, contraction):
        v = torch.floor(u * res)
        ok = (v >= 0) & (v < res)
        c = v.clamp(0, res - 1).to(torch.int32)
        # the region of a group: cells [4 sc - 2, 4 sc + 6) around the
        # supercell sc of its middle step's cell
        cg = c.view(num_rays, max_steps // group, group)
        sc = (cg[:, :, group // 2] >> 2).clamp(0, res // 4 - 1)
        local = cg - (4 * sc - 2)[..., None]
        inside = ((local >= 0) & (local < 8)).view(num_rays, max_steps)
        in_range = ok if in_range is None else in_range & ok
        in_region = inside if in_region is None else in_region & inside
        flat = c.long() if flat is None else flat * res + c
    occupied = (grid.binary.reshape(-1)[flat] | ~in_region) & in_range
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
                    t_max: torch.Tensor | None = None, stratified: bool = False,
                    generator: torch.Generator | None = None,
                    jitter: torch.Tensor | None = None) -> RowSamples:
    """Row-packed marching: each ray's first `k_per_ray` surviving steps.

    `t_max` [R] optionally cuts each ray's far end. Stratified jitter is an
    explicit [R, 1] tensor, or drawn from `generator` when `stratified`.
    """
    num_rays = origins.shape[0]
    jitter = _jitter(num_rays, stratified, generator, jitter, origins.device)
    mask, t_lo = _candidate_mask(origins, viewdirs, grid, aabb, contraction,
                                 render_step_size, max_steps, near_plane,
                                 far_plane, t_max, jitter)
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
               t_max: torch.Tensor | None = None, stratified: bool = False,
               generator: torch.Generator | None = None,
               jitter: torch.Tensor | None = None, compaction: str = "capped",
               k_cap: int | None = None) -> PackedSamples:
    """March rays into a packed buffer of `buffer_size` samples, ray-major
    and depth-ordered, as the compositor needs.

    compaction "capped": each ray's first `k_cap` survivors (default
    min(256, max_steps, buffer_size)), packed back to back at the exclusive
    cumsum of the per-ray counts and cut at the buffer. "compact": every
    survivor, slot i holding the (i+1)-th of the flattened [R, S] mask,
    cut at the buffer. "quota": ray r owns slots [rK, (r+1)K), K =
    buffer_size // R, and fills them with its first K survivors; padding
    after R·K. `t_max` [R] optionally cuts each ray's far end.
    """
    if compaction not in ("capped", "compact", "quota"):
        raise ValueError(f"unknown march compaction {compaction!r}")
    num_rays = origins.shape[0]
    dev = origins.device
    jitter = _jitter(num_rays, stratified, generator, jitter, dev)
    mask, t_lo = _candidate_mask(origins, viewdirs, grid, aabb, contraction,
                                 render_step_size, max_steps, near_plane,
                                 far_plane, t_max, jitter)
    if compaction == "compact":
        return _compact(mask, t_lo, jitter, render_step_size, buffer_size)
    if compaction == "quota":
        return _quota(mask, t_lo, jitter, render_step_size, buffer_size)
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
    row_safe = row.clamp(0, num_rays - 1)
    k = (ranks - offsets[row_safe]).clamp(0, k_cap - 1)
    return _packed(row_safe, steps_rk[row_safe, k], ranks < n_live, t_lo, jitter,
                   render_step_size, n_live, num_rays)


def _packed(ray, step, valid, t_lo, jitter, render_step_size, num_samples, num_rays):
    """PackedSamples of slots holding (ray, step) where `valid`; t_start
    is t_lo + (step + jitter) * dt, the lattice's own arithmetic."""
    ray_safe = ray.clamp(0, num_rays - 1)
    ts0 = torch.where(valid, t_lo[ray_safe] + (step.to(torch.float32) + jitter[ray_safe, 0])
                      * render_step_size, 0.0)
    return PackedSamples(ray_id=torch.where(valid, ray_safe, num_rays), t_start=ts0,
                         t_end=ts0 + render_step_size, valid=valid,
                         num_samples=num_samples, num_rays=num_rays)


def _compact(mask, t_lo, jitter, render_step_size, buffer_size) -> PackedSamples:
    """Slot i holds the (i+1)-th survivor of the flattened mask: its index
    is searchsorted(cumsum(flat mask), i + 1), int32, clamped to R·S − 1."""
    num_rays, max_steps = mask.shape
    csum = torch.cumsum(mask.reshape(-1).to(torch.int32), 0, dtype=torch.int32)
    total = csum[-1]
    ranks = torch.arange(1, buffer_size + 1, dtype=torch.int32, device=mask.device)
    src = torch.searchsorted(csum, ranks, out_int32=True).clamp(max=csum.numel() - 1)
    src = src.to(torch.int64)
    return _packed(src // max_steps, src % max_steps, ranks <= total, t_lo, jitter,
                   render_step_size, total.clamp(max=buffer_size).to(torch.int64), num_rays)


def _quota(mask, t_lo, jitter, render_step_size, buffer_size) -> PackedSamples:
    """Ray r's k-th slot of K = buffer_size // R holds its k-th survivor,
    searchsorted(row cumsum, k) in its own row, clamped to S − 1; slots
    past a ray's count and past R·K are padding."""
    num_rays, max_steps = mask.shape
    dev = mask.device
    k_quota = max(buffer_size // num_rays, 1)
    pad = buffer_size - num_rays * k_quota
    if pad < 0:
        raise ValueError(f"quota marching: {num_rays} rays exceed the buffer of {buffer_size}")
    rows = torch.cumsum(mask.to(torch.int32), dim=1, dtype=torch.int32)
    counts = rows[:, -1]
    ranks = torch.arange(1, k_quota + 1, dtype=torch.int32, device=dev)
    src = torch.searchsorted(rows, ranks.expand(num_rays, k_quota).contiguous(),
                             out_int32=True).clamp(max=max_steps - 1)
    valid = ranks[None, :] <= counts[:, None]
    ray = torch.arange(num_rays, device=dev)[:, None].expand(num_rays, k_quota)
    num_samples = counts.clamp(max=k_quota).sum()
    fill = torch.zeros(pad, dtype=torch.int64, device=dev)
    return _packed(torch.cat([ray.reshape(-1), fill + num_rays]),
                   torch.cat([src.reshape(-1).to(torch.int64), fill]),
                   torch.cat([valid.reshape(-1), fill.bool()]), t_lo, jitter,
                   render_step_size, num_samples.clamp(max=buffer_size), num_rays)


def sample_positions(packed: PackedSamples, origins, viewdirs):
    """Packed sample world positions + their ray directions: ([B, 3], [B, 3])."""
    safe_ray = packed.ray_id.clamp(max=packed.num_rays - 1)
    o = origins[safe_ray]
    d = viewdirs[safe_ray]
    t_mid = (packed.t_start + packed.t_end) * 0.5
    return o + d * t_mid[:, None], d
