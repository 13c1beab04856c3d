"""Voxel feature extraction from a trained NGP block, stage 2 (port of
dregnerf_tpu/extract/sample_grid.py).

  * every occupied voxel of the block's occupancy grid is sampled once,
    jittered inside its cell, and mapped to world space by the inverse
    contraction;
  * density mask: sigma > 0.7;
  * surface mask: for every training camera a ray is marched from the
    camera to the point (per-ray t_max, each ray's first 64 surviving
    steps) and S = max_t T*alpha is taken; S >= 0.5 for any camera. This
    camera x point pass is the hot loop: rays go in fixed-size chunks, the
    camera loop keeps a running max on the device, and the host reads one
    result per chunk;
  * color: the mean of query_rgb over 18 fixed view directions (with the
    reference table's x == y quirk); alpha = clip(1 - exp(-0.01 sigma)).

Artifacts: voxel_grid.pt [x, y, z, 7], voxel_mask.pt (flat indices),
voxel_point_cloud.ply, and the density_voxel_* variants, the same files
as the JAX package writes.
"""
from __future__ import annotations

import math
import os
from typing import Any, Dict

import numpy as np
import torch

from dregnerf_tpu_torch.device import resolve_device
from dregnerf_tpu_torch.io.ply import write_ply
from dregnerf_tpu_torch.models import ngp
from dregnerf_tpu_torch.ops.composite import surface_field_rows
from dregnerf_tpu_torch.ops.contraction import contract_inv
from dregnerf_tpu_torch.ops.occupancy import OccupancyGrid
from dregnerf_tpu_torch.ops.ray_march import march_rays_rows, row_sample_positions
from dregnerf_tpu_torch.render.renderer import RenderConfig

DELTA = 1e-2  # alpha step of the voxel features
DENSITY_THRESHOLD = 0.7
SURFACE_CUTOFF = 0.5


def fixed_viewing_directions() -> np.ndarray:
    """The reference's 18 directions [18, 3]. x and y are both
    cos(phi) * sin(theta), so they are not spread uniformly; kept as they
    are because the color statistics downstream depend on them."""
    phis = [math.pi / 3, 0.0, -math.pi]
    thetas = [k * math.pi / 3 for k in range(6)]
    return np.asarray([[math.cos(phi) * math.sin(theta), math.cos(phi) * math.sin(theta),
                        math.sin(theta)] for phi in phis for theta in thetas], np.float32)


def occupied_voxel_points(grid: OccupancyGrid, aabb: torch.Tensor, contraction: str,
                          generator: torch.Generator | None = None,
                          jitter: np.ndarray | torch.Tensor | None = None):
    """(world points [Np, 3] f32, flat cell indices [Np]) of the occupied
    voxels, jittered inside each cell by `jitter` [Np, 3] in [0, 1) when
    given, else by a draw from `generator` (a CPU generator). Under
    un_bounded_sphere, points outside the contracted unit ball are dropped."""
    binary = grid.binary.cpu().numpy()
    res = binary.shape[0]
    indices = np.nonzero(binary.reshape(-1))[0]
    coords = np.stack([indices // (res * res), (indices // res) % res, indices % res],
                      -1).astype(np.float32)
    if jitter is None:
        jitter = torch.rand(coords.shape, generator=generator)
    u = (coords + np.asarray(jitter, np.float32)) / res
    if contraction == "un_bounded_sphere":
        keep = np.linalg.norm(u - 0.5, axis=-1) < 0.5
        u, indices = u[keep], indices[keep]
    world = contract_inv(torch.as_tensor(u), aabb.detach().cpu(), contraction)
    return world.numpy(), indices


def make_surface_chunk_fn(params: Any, model_cfg: ngp.NGPConfig, grid: OccupancyGrid,
                          aabb: torch.Tensor, rcfg: RenderConfig, samples_per_ray: int = 64):
    """(origins, viewdirs, t_max) [chunk] on the device -> per-ray surface
    field S [chunk]. Each ray keeps its first `samples_per_ray` surviving
    steps (row layout), so a dense scene cannot starve later rays."""
    params = ngp.prepare_params(params, model_cfg)  # a CPU table packed once per fn

    @torch.no_grad()
    def call(origins, viewdirs, t_max):
        rows = march_rays_rows(origins, viewdirs, grid, aabb, rcfg.contraction,
                               rcfg.render_step_size, samples_per_ray, rcfg.max_steps,
                               rcfg.near_plane, rcfg.far_plane, t_max=t_max)
        pos, _ = row_sample_positions(rows, origins, viewdirs)
        sigma = ngp.query_density(params, pos.reshape(-1, 3), aabb,
                                  model_cfg).reshape(rows.valid.shape)
        return surface_field_rows(rows, torch.where(rows.valid, sigma, 0.0))

    return call


def compute_surface_mask(params: Any, model_cfg: ngp.NGPConfig, grid: OccupancyGrid,
                         aabb: torch.Tensor, rcfg: RenderConfig, points_world: np.ndarray,
                         camera_poses: np.ndarray, chunk: int = 8192,
                         buffer_size: int = 1 << 17, cutoff: float = SURFACE_CUTOFF,
                         samples_per_ray: int = 64, return_scores: bool = False,
                         mesh=None) -> np.ndarray:
    """[Np] bool: max over cameras of S >= cutoff (or the [Np] f32 scores).

    `chunk` is clamped to buffer_size // samples_per_ray rays, as in the
    JAX package. Runs on the device of `aabb`; one host read per chunk.
    With `mesh` (parallel/mesh.py, from --mesh_shape) the chunk is padded
    to a multiple of the mesh size, each rank takes its slice of the rays
    (parallel/extract_sharded.py), and one all_gather a chunk assembles
    the scores, which every rank returns."""
    np_pts = points_world.shape[0]
    chunk = max(1, min(chunk, buffer_size // max(samples_per_ray, 1)))
    if mesh is not None:
        from dregnerf_tpu_torch.parallel.extract_sharded import make_sharded_surface_fn

        chunk = -(-chunk // mesh.size) * mesh.size
        fn = make_sharded_surface_fn(mesh, params, model_cfg, grid, aabb, rcfg,
                                     samples_per_ray)
    else:
        fn = make_surface_chunk_fn(params, model_cfg, grid, aabb, rcfg, samples_per_ray)
    dev = aabb.device
    origins = torch.as_tensor(np.asarray(camera_poses, np.float32)[:, :3, 3], device=dev)
    points = torch.as_tensor(np.asarray(points_world, np.float32), device=dev)
    surface = np.zeros(np_pts, np.float32)
    for i in range(0, np_pts, chunk):
        pts = points[i:i + chunk]
        nn = pts.shape[0]
        acc = None
        for origin in origins:
            dirs = pts - origin[None]
            t_max = torch.linalg.norm(dirs, dim=-1)
            d = torch.zeros(chunk, 3, device=dev)
            t = torch.zeros(chunk, device=dev)
            d[:nn] = dirs / torch.clamp(t_max[:, None], min=1e-10)
            t[:nn] = t_max
            s = fn(origin.expand(chunk, 3), d, t)
            acc = s if acc is None else torch.maximum(acc, s)
        if mesh is not None:
            acc = mesh.all_gather_rows(acc)
        surface[i:i + nn] = acc[:nn].cpu().numpy()
    if return_scores:
        return surface
    return surface >= cutoff


@torch.no_grad()
def query_features(params: Any, model_cfg: ngp.NGPConfig, aabb: torch.Tensor,
                   points_world: np.ndarray, chunk: int = 1 << 16):
    """(rgb [Np, 3] mean over the 18 fixed directions, sigma [Np], alpha
    [Np]) at world points, in numpy."""
    params = ngp.prepare_params(params, model_cfg)
    dev = aabb.device
    dirs18 = torch.as_tensor(fixed_viewing_directions(), device=dev)
    np_pts = points_world.shape[0]
    rgbs = np.zeros((np_pts, 3), np.float32)
    sigmas = np.zeros(np_pts, np.float32)
    for i in range(0, np_pts, chunk):
        nn = min(chunk, np_pts - i)
        x = torch.zeros(chunk, 3, device=dev)
        x[:nn] = torch.as_tensor(points_world[i:i + nn], device=dev)
        sigma, feat = ngp.query_density(params, x, aabb, model_cfg, return_feat=True)
        rgb = torch.stack([ngp.query_rgb(params, d.expand(chunk, 3), feat, model_cfg)
                           for d in dirs18]).mean(dim=0)
        rgbs[i:i + nn] = rgb[:nn].cpu().numpy()
        sigmas[i:i + nn] = sigma.reshape(-1)[:nn].cpu().numpy()
    alphas = np.clip(1.0 - np.exp(-DELTA * sigmas), 0.0, 1.0)
    return rgbs, sigmas, alphas


def extraction_render_config(meta: Dict[str, Any]) -> RenderConfig:
    """The surface pass's render settings, from a checkpoint's meta (a
    missing or null near/far plane takes the renderer's default)."""
    return RenderConfig(contraction=meta["contraction_type"],
                        render_step_size=float(meta["render_step_size"]),
                        near_plane=float(meta.get("near_plane", 0.0) or 0.0),
                        far_plane=float(meta.get("far_plane", 1e10) or 1e10))


def extract_voxel_features(params: Any, model_cfg: ngp.NGPConfig, grid: OccupancyGrid,
                           meta: Dict[str, Any], generator: torch.Generator | None = None,
                           jitter: np.ndarray | torch.Tensor | None = None,
                           density_threshold: float = DENSITY_THRESHOLD,
                           surface_chunk: int = 8192, device=None,
                           mesh=None) -> Dict[str, np.ndarray]:
    """The whole extraction of one block (points, rgb, sigma, alpha,
    indices, density_mask, surface_mask, resolution), on `device` (default
    cuda), where `params` and `grid` must lie; the surface pass sharded
    over `mesh`'s ranks when given."""
    dev = resolve_device(device)
    if params["table"].device.type != dev.type or grid.binary.device.type != dev.type:
        raise ValueError(f"params on {params['table'].device}, grid on "
                         f"{grid.binary.device}, extraction device {dev}")
    aabb = torch.as_tensor(meta["aabb"], dtype=torch.float32, device=dev)
    rcfg = extraction_render_config(meta)
    points, indices = occupied_voxel_points(grid, aabb, rcfg.contraction, generator, jitter)
    surface_mask = compute_surface_mask(params, model_cfg, grid, aabb, rcfg, points,
                                        np.asarray(meta["camera_poses"], np.float32),
                                        chunk=surface_chunk, mesh=mesh)
    rgb, sigma, alpha = query_features(params, model_cfg, aabb, points)
    return {
        "points": points,
        "rgb": rgb,
        "sigma": sigma,
        "alpha": alpha,
        "indices": indices,
        "density_mask": sigma > density_threshold,
        "surface_mask": surface_mask,
        "resolution": np.asarray(grid.binary.shape),
    }


def _scatter_grid(res, indices, points, rgb, alpha) -> np.ndarray:
    grid = np.zeros((int(np.prod(res)), 7), np.float32)
    grid[indices, :3] = points
    grid[indices, 3:6] = rgb
    grid[indices, 6] = alpha
    return grid.reshape(*res, 7)


def save_voxel_artifacts(out_dir: str, extracted: Dict[str, np.ndarray]) -> list[str]:
    """Write the artifact set; returns the paths written."""
    os.makedirs(out_dir, exist_ok=True)
    res = extracted["resolution"]
    pts, rgb, alpha = extracted["points"], extracted["rgb"], extracted["alpha"]
    idx = extracted["indices"]
    dmask = extracted["density_mask"]
    smask = extracted["surface_mask"] & dmask
    written = []
    for name, m in [("density_voxel", dmask), ("voxel", smask)]:
        p, r, a, i = pts[m], rgb[m], alpha[m], idx[m]
        paths = [os.path.join(out_dir, f"{name}_{kind}") for kind in
                 ("point_cloud.ply", "grid.pt", "mask.pt")]
        write_ply(paths[0], p, r)
        torch.save(torch.from_numpy(_scatter_grid(res, i, p, r, a)), paths[1])
        torch.save(torch.from_numpy(i.astype(np.int64)), paths[2])
        written += paths
    return written
