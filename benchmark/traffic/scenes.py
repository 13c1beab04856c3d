"""The benchmark's scenes: clusters of spheres or boxes, rendered as a
block's training views or voxelised as a block's grid.

Everything here is made from the parameters of a workload file and a
seed, on the host (views) or on the device (grids). The shapes and the
ray tracer are a frozen copy of the port's fixture scene
(dregnerf_tpu_torch/datasets/fixtures.py: `random_spheres`,
`random_boxes`, `_trace`, `view_rays`, `render_views`), kept here so that
a change to the program cannot change the benchmark's inputs.
"""
from __future__ import annotations

import math

import numpy as np

LIGHT_DIR = np.array([0.5, 0.7, 0.5])


# ------------------------------------------------------------------ shapes

def random_spheres(seed: int, n_min: int = 3, n_max: int = 5):
    """n_min..n_max spheres (center, radius, albedo): one at the origin,
    the others around it."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(n_min, n_max + 1))
    shapes = [(np.zeros(3), float(rng.uniform(0.3, 0.45)), rng.uniform(0.15, 0.95, 3))]
    for _ in range(n - 1):
        d = rng.normal(size=3)
        d /= np.linalg.norm(d)
        shapes.append((d * rng.uniform(0.3, 0.55), float(rng.uniform(0.1, 0.28)),
                       rng.uniform(0.15, 0.95, 3)))
    return shapes


def random_boxes(seed: int, n_min: int = 3, n_max: int = 5):
    """n_min..n_max axis-aligned boxes (center, half extents [3], albedo)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(n_min, n_max + 1))
    shapes = [(np.zeros(3), rng.uniform(0.25, 0.45, 3), rng.uniform(0.15, 0.95, 3))]
    for _ in range(n - 1):
        d = rng.normal(size=3)
        d /= np.linalg.norm(d)
        shapes.append((d * rng.uniform(0.3, 0.55), rng.uniform(0.08, 0.25, 3),
                       rng.uniform(0.15, 0.95, 3)))
    return shapes


def shapes_of(family: str, seed: int):
    return {"spheres": random_spheres, "boxes": random_boxes}[family](seed)


# ------------------------------------------------------------------- views

def trace(origins: np.ndarray, dirs: np.ndarray, shapes) -> np.ndarray:
    """[N, 4] RGBA of the nearest hit with normal shading (spheres by the
    quadratic, boxes by the slab method)."""
    n = origins.shape[0]
    best_t = np.full(n, np.inf)
    rgba = np.zeros((n, 4), np.float32)
    for center, size, albedo in shapes:
        if np.ndim(size) == 0:
            radius = float(size)
            oc = origins - center
            b = np.sum(oc * dirs, axis=-1)
            c = np.sum(oc * oc, axis=-1) - radius**2
            disc = b * b - c
            t = -b - np.sqrt(np.maximum(disc, 0))
            hit = (disc > 0) & (t > 1e-3) & (t < best_t)
            p = origins[hit] + dirs[hit] * t[hit, None]
            normal = (p - center) / radius
        else:
            half = np.asarray(size, np.float64)
            inv = 1.0 / np.where(np.abs(dirs) > 1e-12, dirs, 1e-12)
            t0 = (center - half - origins) * inv
            t1 = (center + half - origins) * inv
            t = np.max(np.minimum(t0, t1), axis=-1)
            t_far = np.min(np.maximum(t0, t1), axis=-1)
            hit = (t_far > t) & (t > 1e-3) & (t < best_t)
            p = origins[hit] + dirs[hit] * t[hit, None]
            rel = (p - center) / half
            rows = np.arange(len(p))
            axis = np.argmax(np.abs(rel), axis=-1)
            normal = np.zeros_like(p)
            normal[rows, axis] = np.sign(rel[rows, axis])
        light = np.clip(normal @ LIGHT_DIR, 0.1, 1.0)
        rgba[hit, :3] = albedo[None] * (0.35 + 0.65 * light[:, None])
        rgba[hit, 3] = 1.0
        best_t[hit] = t[hit]
    return rgba


def _look_at(eye: np.ndarray) -> np.ndarray:
    """OpenGL camera-to-world looking at the origin, +z up."""
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, -fwd, eye
    return c2w


def render_views(shapes, num_views: int, image_size: int, camera_distance: float,
                 fov_x: float, seed: int):
    """(images [N, S, S, 4] uint8, c2w [N, 4, 4], K [3, 3]) of cameras on a
    ring of the upper hemisphere, each through every pixel centre."""
    rng = np.random.default_rng(seed)
    s = image_size
    focal = 0.5 * s / np.tan(0.5 * fov_x)
    x, y = np.meshgrid(np.arange(s), np.arange(s), indexing="xy")
    cam_dirs = np.stack([(x.ravel() - s / 2 + 0.5) / focal,
                         -(y.ravel() - s / 2 + 0.5) / focal, -np.ones(s * s)], -1)
    images, c2ws = [], []
    for i in range(num_views):
        theta = 2 * np.pi * i / num_views
        phi = 0.35 + 0.5 * rng.uniform()
        eye = camera_distance * np.array([np.cos(theta) * np.cos(phi),
                                          np.sin(theta) * np.cos(phi), np.sin(phi)])
        c2w = _look_at(eye)
        dirs = cam_dirs @ c2w[:3, :3].T
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        origins = np.tile(c2w[:3, 3], (dirs.shape[0], 1))
        images.append((trace(origins, dirs, shapes).reshape(s, s, 4) * 255).astype(np.uint8))
        c2ws.append(c2w)
    K = np.array([[focal, 0, s / 2], [0, focal, s / 2], [0, 0, 1]], np.float32)
    return np.stack(images), np.stack(c2ws), K


def block_views(scene: dict):
    """The views of a workload's `scene` entry."""
    shapes = shapes_of(scene["family"], scene["scene_seed"])
    return render_views(shapes, scene["views"], scene["image_size"],
                        scene["camera_distance"], scene["fov_x"], scene["scene_seed"])


# ------------------------------------------------------------------- grids

def rotation(axis, angle: float) -> np.ndarray:
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + math.sin(angle) * k + (1 - math.cos(angle)) * k @ k


def block_frame(rng: np.random.Generator, max_deg: float, max_trans: float) -> np.ndarray:
    """A random world-to-block rigid transform [4, 4]."""
    t = np.eye(4)
    t[:3, :3] = rotation(rng.normal(size=3), math.radians(rng.uniform(0.0, max_deg)))
    t[:3, 3] = rng.uniform(-max_trans, max_trans, 3)
    return t


def voxelise(shapes, world_to_block: np.ndarray, view_dir: np.ndarray, res: int,
             band: float, view_cut: float, device):
    """The grid [res, res, res, 7] (xyz in the block's frame, rgb, alpha)
    and flat mask [res^3] of one block over the box [-1, 1]^3 of its own
    frame: the voxels whose centre lies within `band` voxel widths of the
    scene's surface and on the block's side of the plane
    dot(x, view_dir) = -view_cut (the part of the scene its cameras see)."""
    import torch

    dev = torch.device(device)
    f64 = torch.float64
    vox = 2.0 / res
    idx = torch.arange(res, device=dev, dtype=f64)
    c = -1.0 + (idx + 0.5) * vox
    cx, cy, cz = torch.meshgrid(c, c, c, indexing="ij")
    centers = torch.stack([cx, cy, cz], -1).reshape(-1, 3)  # block frame
    inv = torch.as_tensor(np.linalg.inv(world_to_block), device=dev, dtype=f64)
    world = centers @ inv[:3, :3].T + inv[:3, 3]
    sdf = torch.full((world.shape[0],), math.inf, device=dev, dtype=f64)
    normal = torch.zeros_like(world)
    albedo = torch.zeros_like(world)
    for center, size, alb in shapes:
        ctr = torch.as_tensor(center, device=dev, dtype=f64)
        rel = world - ctr
        if np.ndim(size) == 0:
            d = rel.norm(dim=-1) - float(size)
            n = rel / rel.norm(dim=-1, keepdim=True).clamp(min=1e-9)
        else:
            half = torch.as_tensor(np.asarray(size), device=dev, dtype=f64)
            q = rel.abs() - half
            d = q.clamp(min=0).norm(dim=-1) + q.amax(dim=-1).clamp(max=0)
            axis = (rel.abs() / half).argmax(dim=-1)
            n = torch.zeros_like(rel)
            n.scatter_(1, axis[:, None], torch.sign(rel.gather(1, axis[:, None])))
        closer = d.abs() < sdf.abs()
        sdf = torch.where(closer, d, sdf)
        normal = torch.where(closer[:, None], n, normal)
        albedo = torch.where(closer[:, None], torch.as_tensor(alb, device=dev, dtype=f64),
                             albedo)
    seen = world @ torch.as_tensor(view_dir, device=dev, dtype=f64) > -view_cut
    mask = (sdf.abs() < band * vox) & seen
    light = (normal @ torch.as_tensor(LIGHT_DIR, device=dev, dtype=f64)).clamp(0.1, 1.0)
    rgb = albedo * (0.35 + 0.65 * light[:, None])
    alpha = 0.95 - 0.5 * sdf.abs() / (band * vox)
    grid = torch.cat([centers, rgb, alpha[:, None]], -1) * mask[:, None]
    return grid.to(torch.float32).reshape(res, res, res, 7).contiguous(), mask


def voxel_pair(scene: dict, scene_seed: int, res: int, device):
    """Two blocks of one scene, each voxelised in its own frame, and the
    ground-truth pose of block 1 from block 0 (T1 T0^-1, [4, 4] f32):
    ((grid0, mask0), (grid1, mask1), pose)."""
    shapes = shapes_of(scene["family"], scene_seed)
    rng = np.random.default_rng(scene_seed)
    frames = [block_frame(rng, scene["frame_max_deg"], scene["frame_max_trans"])
              for _ in range(2)]
    az = rng.uniform(0, 2 * np.pi)
    sep = math.radians(scene["view_separation_deg"])
    views = [np.array([math.cos(az + k * sep), math.sin(az + k * sep), 0.3]) for k in range(2)]
    blocks = [voxelise(shapes, f, v / np.linalg.norm(v), res, scene["band_voxels"],
                       scene["view_cut"], device) for f, v in zip(frames, views)]
    pose = (frames[1] @ np.linalg.inv(frames[0])).astype(np.float32)
    return blocks[0], blocks[1], pose
