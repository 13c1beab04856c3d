"""Volume rendering of a ray bucket: field + occupancy grid + marcher + compositor
(port of dregnerf_tpu/render/renderer.py)."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from dregnerf_tpu_torch.device import resolve_device
from dregnerf_tpu_torch.models import ngp
from dregnerf_tpu_torch.ops.composite import RenderOutput, composite, composite_rows
from dregnerf_tpu_torch.ops.occupancy import OccupancyGrid
from dregnerf_tpu_torch.ops.ray_march import (
    march_rays,
    march_rays_rows,
    row_sample_positions,
    sample_positions,
)
from dregnerf_tpu_torch.runtime import profiling


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    contraction: str = "aabb"
    render_step_size: float = 5.1e-3
    buffer_size: int = 1 << 18
    max_steps: int = 1024
    near_plane: float = 0.0
    far_plane: float = 1e10
    chunk_size: int = 8192
    # "rows" (row-packed marcher + row compositor), or a packed buffer:
    # "capped" (per-ray capped lists, the training default), "compact"
    # (every survivor, cut at the buffer) or "quota" (buffer / rays slots a ray)
    march_compaction: str = "rows"
    # per-ray survivor cap for "capped"; None = min(256, max_steps)
    k_cap: int | None = None


def render_rays(
    params: Any,
    model_config: ngp.NGPConfig,
    grid: OccupancyGrid,
    origins: torch.Tensor,
    viewdirs: torch.Tensor,
    aabb: torch.Tensor,
    config: RenderConfig,
    background: torch.Tensor | None = None,
    stratified: bool = False,
    generator: torch.Generator | None = None,
    jitter: torch.Tensor | None = None,
    device: torch.device | str | None = None,
    field=ngp,
    times: torch.Tensor | None = None,
) -> tuple[RenderOutput, dict]:
    """Render one ray bucket; returns (RenderOutput, aux) with aux
    `n_samples` (live samples, the ray-bucket feedback), `ray_counts`
    (samples per ray, the alive-ray mask of the loss) and `buffer_rows`
    (the sample buffer's rows, a host int).

    Runs on `device` (default cuda; see dregnerf_tpu_torch.device), which
    must be where the inputs lie. Stratified jitter is an explicit [R, 1]
    tensor, or drawn from `generator`. `field` is a family of
    models/fields.py (or the ngp module); `times` [R], a time per ray for a
    time-conditioned field (D-NeRF), reaches each of the ray's samples.
    """
    dev = resolve_device(device)
    if origins.device.type != dev.type:
        raise ValueError(f"rays on {origins.device}, render device {dev}")
    num_rays = origins.shape[0]
    if config.march_compaction == "rows":
        # a ray cannot yield more than max_steps survivors
        k_per_ray = min(max(config.buffer_size // num_rays, 1), config.max_steps)
        with profiling.annotate("render.march"):
            rows = march_rays_rows(
                origins, viewdirs, grid, aabb, config.contraction,
                config.render_step_size, k_per_ray, config.max_steps,
                config.near_plane, config.far_plane, stratified=stratified,
                generator=generator, jitter=jitter)
            positions, dirs = row_sample_positions(rows, origins, viewdirs)
        with profiling.annotate("render.field"):
            if times is not None:
                t = times[:, None, None].expand(*rows.valid.shape, 1)
                rgbs, sigmas = field.forward(params, positions, dirs, aabb, model_config, t=t)
            else:
                rgbs, sigmas = field.forward(params, positions, dirs, aabb, model_config)
        with profiling.annotate("render.composite"):
            sigmas = torch.where(rows.valid, sigmas.reshape(rows.valid.shape), 0.0)
            out = composite_rows(rows, rgbs, sigmas, background=background)
            ray_counts = rows.valid.sum(dim=1)
        return out, {"n_samples": rows.num_samples, "ray_counts": ray_counts,
                     "buffer_rows": rows.valid.numel()}

    with profiling.annotate("render.march"):
        packed = march_rays(
            origins, viewdirs, grid, aabb, config.contraction,
            config.render_step_size, config.buffer_size, config.max_steps,
            config.near_plane, config.far_plane, stratified=stratified,
            generator=generator, jitter=jitter, compaction=config.march_compaction,
            k_cap=config.k_cap)
        positions, dirs = sample_positions(packed, origins, viewdirs)
    with profiling.annotate("render.field"):
        if times is not None:
            # a padding slot's ray id is num_rays: it takes the last ray's time
            t = times[torch.clamp(packed.ray_id, max=num_rays - 1)][:, None]
            rgbs, sigmas = field.forward(params, positions, dirs, aabb, model_config, t=t)
        else:
            rgbs, sigmas = field.forward(params, positions, dirs, aabb, model_config)
    with profiling.annotate("render.composite"):
        sigmas = torch.where(packed.valid, sigmas.reshape(-1), 0.0)
        out = composite(packed, rgbs, sigmas, background=background)
        ray_counts = torch.zeros(num_rays + 1, dtype=torch.int64, device=origins.device)
        ray_counts.index_add_(0, packed.ray_id, packed.valid.to(torch.int64))
    return out, {"n_samples": packed.num_samples, "ray_counts": ray_counts[:num_rays],
                 "buffer_rows": packed.valid.shape[0]}


@torch.no_grad()
def render_image_chunked(
    params: Any,
    model_config: ngp.NGPConfig,
    grid: OccupancyGrid,
    origins: torch.Tensor,
    viewdirs: torch.Tensor,
    aabb: torch.Tensor,
    config: RenderConfig,
    background: torch.Tensor,
    eval_buffer_size: int | None = None,
    device: torch.device | str | None = None,
    field=ngp,
    time: float | None = None,
):
    """Render [N, 3] rays (a flattened image) in chunks of `chunk_size`
    rays, padded to whole chunks as in the reference; returns (rgb [N, 3],
    opacity [N], depth [N]). `time` renders the whole image at one time
    (D-NeRF)."""
    params = field.prepare_params(params, model_config)  # once, not per chunk
    n = origins.shape[0]
    cs = config.chunk_size
    buf = eval_buffer_size or config.buffer_size
    if eval_buffer_size is None and config.march_compaction == "rows":
        # full-image eval must not inherit the training sample budget
        buf = max(buf, cs * min(128, config.max_steps))
    chunk_cfg = dataclasses.replace(config, buffer_size=buf)
    n_chunks = -(-n // cs)
    pad = n_chunks * cs - n
    dev = origins.device
    o = torch.cat([origins, torch.zeros(pad, 3, dtype=origins.dtype, device=dev)])
    d = torch.cat([viewdirs, torch.tensor([[0.0, 0.0, 1.0]], device=dev).expand(pad, 3)])
    times = None if time is None else torch.full((cs,), float(time), device=dev)
    rgbs, opacities, depths = [], [], []
    for i in range(n_chunks):
        out, _ = render_rays(params, model_config, grid, o[i * cs:(i + 1) * cs],
                             d[i * cs:(i + 1) * cs], aabb, chunk_cfg, background,
                             device=device, field=field, times=times)
        rgbs.append(out.rgb)
        opacities.append(out.opacity)
        depths.append(out.depth)
    return (torch.cat(rgbs)[:n], torch.cat(opacities)[:n], torch.cat(depths)[:n])
