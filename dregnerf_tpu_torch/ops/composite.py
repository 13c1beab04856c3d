"""Transmittance and volumetric compositing (port of dregnerf_tpu/ops/composite.py).

Packed buffers (ray-major, depth-ordered): the exclusive per-ray product
of (1 - alpha) is one global cumsum of log(1 - alpha), with 1 - alpha
clipped to [1e-10, 1], re-based by each ray's maximum (its first sample)
and padding by itself (the JAX package bases padding by the last ray,
whose exp overflows between the rays of a quota buffer: a NaN gradient);
composites are segment sums into num_rays + 1 segments (the last one
collects padding). Row buffers: an axis-1 cumsum and row sums. The
surface field max_k T_k alpha_k is a segment max over a packed buffer
(exact visibility) or a row max (voxel extraction). All f32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from dregnerf_tpu_torch.ops.ray_march import PackedSamples, RowSamples


class RenderOutput(NamedTuple):
    rgb: torch.Tensor  # [R, 3]
    opacity: torch.Tensor  # [R]
    depth: torch.Tensor  # [R]
    weights: torch.Tensor  # per-sample composite weights (T * alpha)
    transmittance: torch.Tensor
    alphas: torch.Tensor


def composite_rows(rows: RowSamples, rgbs: torch.Tensor, sigmas: torch.Tensor,
                   background: torch.Tensor | None = None) -> RenderOutput:
    """Composite row-packed samples. rgbs [R, K, 3]; sigmas [R, K] or [R, K, 1]."""
    sigmas = sigmas.reshape(rows.valid.shape).to(torch.float32)
    alphas = torch.where(rows.valid, 1.0 - torch.exp(-sigmas * rows.dt), 0.0)
    log_1ma = torch.log(torch.clamp(1.0 - alphas, 1e-10, 1.0))
    csum = torch.cumsum(log_1ma, dim=1)
    excl = torch.cat([torch.zeros_like(csum[:, :1]), csum[:, :-1]], dim=1)
    trans = torch.where(rows.valid, torch.exp(excl), 0.0)
    weights = alphas * trans

    rgb = (weights[..., None] * rgbs.to(torch.float32)).sum(dim=1)
    opacity = weights.sum(dim=1)
    depth = (weights * (rows.t_start + 0.5 * rows.dt)).sum(dim=1)
    if background is not None:
        rgb = rgb + (1.0 - opacity)[:, None] * background
    return RenderOutput(rgb=rgb, opacity=opacity, depth=depth, weights=weights,
                        transmittance=trans, alphas=alphas)


def packed_alphas(packed: PackedSamples, sigmas: torch.Tensor) -> torch.Tensor:
    """alpha_i = 1 - exp(-sigma_i * dt_i); zero on padding."""
    dt = packed.t_end - packed.t_start
    alpha = 1.0 - torch.exp(-sigmas.reshape(-1).to(torch.float32) * dt)
    return torch.where(packed.valid, alpha, 0.0)


def _segment_sum(values: torch.Tensor, packed: PackedSamples) -> torch.Tensor:
    out = torch.zeros((packed.num_rays + 1, *values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, packed.ray_id, values)[: packed.num_rays]


def packed_transmittance(packed: PackedSamples, alphas: torch.Tensor) -> torch.Tensor:
    """Exclusive per-ray transmittance T_i = prod_{j<i, same ray} (1 - a_j)."""
    log_1ma = torch.log(torch.clamp(1.0 - alphas, 1e-10, 1.0))
    csum = torch.cumsum(log_1ma, 0)
    excl = torch.cat([torch.zeros_like(csum[:1]), csum[:-1]])
    # excl is non-increasing, so a ray's first sample holds its maximum
    base_per_ray = torch.full((packed.num_rays + 1,), -torch.inf,
                              dtype=excl.dtype, device=excl.device)
    base_per_ray = base_per_ray.scatter_reduce(
        0, packed.ray_id, torch.where(packed.valid, excl, -torch.inf),
        reduce="amax", include_self=True)
    base = base_per_ray[packed.ray_id.clamp(max=packed.num_rays - 1)]
    # padding is based at itself (exp(0)): a pad slot between two rays, as
    # the quota layout leaves them, would otherwise take the last ray's
    # base, overflow exp and turn the gradient through the where into NaN
    base = torch.where(packed.valid, base, excl)
    return torch.where(packed.valid, torch.exp(excl - base), 0.0)


def composite(packed: PackedSamples, rgbs: torch.Tensor, sigmas: torch.Tensor,
              background: torch.Tensor | None = None) -> RenderOutput:
    """Weighted composite of packed rgbs [B, 3] / sigmas [B] into per-ray outputs."""
    alphas = packed_alphas(packed, sigmas)
    trans = packed_transmittance(packed, alphas)
    weights = alphas * trans
    rgb = _segment_sum(weights[:, None] * rgbs.to(torch.float32), packed)
    opacity = _segment_sum(weights, packed)
    depth = _segment_sum(weights * (packed.t_start + packed.t_end) * 0.5, packed)
    if background is not None:
        rgb = rgb + (1.0 - opacity)[:, None] * background
    return RenderOutput(rgb=rgb, opacity=opacity, depth=depth, weights=weights,
                        transmittance=trans, alphas=alphas)


def surface_field_per_ray(packed: PackedSamples, sigmas: torch.Tensor) -> torch.Tensor:
    """Per-ray surface field S = max_i (T_i * alpha_i) over packed samples
    (a segment max over ray_id); [num_rays], 0 for a ray without samples."""
    alphas = packed_alphas(packed, sigmas)
    s = alphas * packed_transmittance(packed, alphas)
    out = torch.full((packed.num_rays + 1,), -torch.inf, dtype=s.dtype, device=s.device)
    out = out.scatter_reduce(0, packed.ray_id, s, reduce="amax", include_self=False)
    return torch.clamp(out[: packed.num_rays], min=0.0)


def surface_field_rows(rows: RowSamples, sigmas: torch.Tensor) -> torch.Tensor:
    """Per-ray surface field S = max_k (T_k * alpha_k) over row-packed
    samples; sigmas [R, K] (or [R, K, 1]). Returns [R], >= 0."""
    sigmas = sigmas.reshape(rows.valid.shape).to(torch.float32)
    alphas = torch.where(rows.valid, 1.0 - torch.exp(-sigmas * rows.dt), 0.0)
    log_1ma = torch.log(torch.clamp(1.0 - alphas, 1e-10, 1.0))
    csum = torch.cumsum(log_1ma, dim=1)
    excl = torch.cat([torch.zeros_like(csum[:, :1]), csum[:, :-1]], dim=1)
    trans = torch.where(rows.valid, torch.exp(excl), 0.0)
    return torch.clamp((alphas * trans).amax(dim=1), min=0.0)
