"""Visibility labels for registration training (port of
dregnerf_tpu/losses/visibility.py).

Two label sources:

  * `grid_visibility` (the training default): a nearest-voxel lookup into
    the voxel mask that stage 2 wrote (surface field S >= 0.5 from some
    training camera and sigma > 0.7), the same grid the keypoints come
    from;
  * `exact_visibility`: march a ray from every camera of the block's NeRF
    to every point and take max over cameras of S >= 0.5, as the
    reference's loss does, against the block's checkpoint (loaded once per
    checkpoint by `load_visibility_context`, not once per step).

Both return {0., 1.} labels, which carry no gradient; `exact_visibility`
runs under torch.no_grad().
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from dregnerf_tpu_torch.models import ngp
from dregnerf_tpu_torch.ops.composite import surface_field_per_ray
from dregnerf_tpu_torch.ops.contraction import contract
from dregnerf_tpu_torch.ops.occupancy import OccupancyGrid
from dregnerf_tpu_torch.ops.ray_march import march_rays, sample_positions
from dregnerf_tpu_torch.render.renderer import RenderConfig

SAMPLES_PER_RAY = 64  # the per-ray survivor cap, and rays per chunk = buffer // cap


class VisibilityContext(NamedTuple):
    """What exact visibility needs from one NeRF checkpoint, on the device."""

    params: Any  # NGP params with the packed table precomputed
    grid: OccupancyGrid
    cam_origins: torch.Tensor  # [C, 3] f32, the cameras used
    aabb: torch.Tensor  # [6] f32


def grid_visibility(points: torch.Tensor, visible_mask_flat: torch.Tensor,
                    aabb: torch.Tensor, resolution: int,
                    contraction: str = "aabb") -> torch.Tensor:
    """[..., 3] world points -> {0., 1.} labels by voxel-mask lookup.
    visible_mask_flat: [R^3] bool in ix*R^2 + iy*R + iz order."""
    u = contract(points, aabb, contraction)
    idx = torch.floor(u * resolution).to(torch.int64)
    in_range = ((idx >= 0) & (idx < resolution)).all(dim=-1)
    idx = idx.clamp(0, resolution - 1)
    flat = idx[..., 0] * resolution * resolution + idx[..., 1] * resolution + idx[..., 2]
    return (visible_mask_flat[flat] & in_range).to(torch.float32)


@torch.no_grad()
def exact_visibility_scores(params: Any, model_cfg: ngp.NGPConfig, grid: OccupancyGrid,
                            aabb: torch.Tensor, rcfg: RenderConfig, cam_origins: torch.Tensor,
                            points: torch.Tensor, buffer_size: int = 1 << 16,
                            samples_per_ray: int = SAMPLES_PER_RAY) -> torch.Tensor:
    """max over cameras of the surface field S of the ray from the camera
    to each point (cut at the point): [M] f32.

    `params` come through `ngp.prepare_params` (a CPU table packed once;
    on the card the encoder reads the vertex table in place). Points go
    in chunks of buffer_size // samples_per_ray rays and each ray keeps its
    first samples_per_ray survivors, so chunk * cap == buffer_size and the
    packed buffer cannot overflow. The camera loop runs on the host over
    the cameras given (JAX loops over a padded camera count)."""
    m = points.shape[0]
    chunk = max(min(buffer_size // max(samples_per_ray, 1), m), 1)
    n_chunks = -(-m // chunk)
    pad = n_chunks * chunk - m
    pts = torch.cat([points, points.new_ones(pad, 3)]).reshape(n_chunks, chunk, 3)

    def surface_chunk(origin, p):
        o = origin.expand(chunk, 3)
        d = p - o
        t_max = torch.linalg.vector_norm(d, dim=-1)
        viewdirs = d / torch.clamp(t_max[:, None], min=1e-10)
        packed = march_rays(o, viewdirs, grid, aabb, rcfg.contraction, rcfg.render_step_size,
                            buffer_size, rcfg.max_steps, rcfg.near_plane, rcfg.far_plane,
                            t_max=t_max, compaction="capped", k_cap=samples_per_ray)
        pos, _ = sample_positions(packed, o, viewdirs)
        sigma = ngp.query_density(params, pos, aabb, model_cfg).reshape(-1)
        return surface_field_per_ray(packed, torch.where(packed.valid, sigma, 0.0))

    smax = points.new_zeros(m)
    for origin in cam_origins:
        s = torch.cat([surface_chunk(origin, p) for p in pts])[:m]
        smax = torch.maximum(smax, s)
    return smax


def exact_visibility(params: Any, model_cfg: ngp.NGPConfig, grid: OccupancyGrid,
                     aabb: torch.Tensor, rcfg: RenderConfig, cam_origins: torch.Tensor,
                     points: torch.Tensor, buffer_size: int = 1 << 16, cutoff: float = 0.5,
                     samples_per_ray: int = SAMPLES_PER_RAY) -> torch.Tensor:
    """The reference's labels: max over cameras of S >= cutoff, [M] {0., 1.}."""
    scores = exact_visibility_scores(params, model_cfg, grid, aabb, rcfg, cam_origins,
                                     points, buffer_size, samples_per_ray)
    return (scores >= cutoff).to(torch.float32)


def exact_visibility_ctx(ctx: VisibilityContext, model_cfg: ngp.NGPConfig,
                         rcfg: RenderConfig, points: torch.Tensor,
                         buffer_size: int = 1 << 16, cutoff: float = 0.5) -> torch.Tensor:
    """`exact_visibility` over a context, for points of any leading shape
    (the warped keypoints come as [L, N, 3])."""
    out = exact_visibility(ctx.params, model_cfg, ctx.grid, ctx.aabb, rcfg, ctx.cam_origins,
                           points.reshape(-1, 3).detach().float(), buffer_size, cutoff)
    return out.reshape(points.shape[:-1])


def load_visibility_context(path: str, max_cameras: int = 128, device=None
                            ) -> tuple[VisibilityContext, ngp.NGPConfig, RenderConfig]:
    """One NeRF checkpoint (of either package) -> (context on the device,
    model config, render config), with the first `max_cameras` cameras of
    its meta (a warning names the cameras left out)."""
    from dregnerf_tpu_torch.runtime.ngp_trainer import load_field_from_checkpoint

    params, grid, meta, model_cfg, rcfg = load_field_from_checkpoint(path, device)
    if meta.get("field", "ngp") != "ngp":
        raise ValueError("exact visibility marches NGP checkpoints only, as in the JAX "
                         f"package (got field={meta.get('field')!r})")
    cams = np.asarray(meta["camera_poses"], np.float32)
    if len(cams) > max_cameras:
        print(f"[visibility] WARNING: {path} has {len(cams)} cameras; exact visibility uses "
              f"the first {max_cameras} (raise --vis_max_cameras: points seen only by the "
              "others are labeled invisible)", flush=True)
    dev = params["table"].device
    ctx = VisibilityContext(
        params=ngp.prepare_params(params, model_cfg),
        grid=grid,
        cam_origins=torch.as_tensor(cams[:max_cameras, :3, 3], device=dev),
        aabb=torch.as_tensor(meta["aabb"], dtype=torch.float32, device=dev),
    )
    return ctx, model_cfg, rcfg
