"""Synthetic fixture scene (port of dregnerf_tpu/datasets/fixtures.py).

Ray-traces two colored spheres (or a random cluster of spheres or boxes,
`random_spheres` / `random_boxes`) from cameras on a sphere. `make_scene_data`
returns the scene in memory as the objaverse loader would read it;
`make_scene` writes it in the objaverse on-disk format (transforms.json +
RGBA PNGs, which needs imageio).
"""
from __future__ import annotations

import json
import os

import numpy as np

from dregnerf_tpu_torch.datasets.base import SceneData
from dregnerf_tpu_torch.datasets.objaverse import intrinsics, scene_from_arrays


def _look_at(eye: np.ndarray, target: np.ndarray, up: np.ndarray) -> np.ndarray:
    """OpenGL camera-to-world: -z forward, +y up."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = true_up
    c2w[:3, 2] = -fwd
    c2w[:3, 3] = eye
    return c2w


SPHERES = [
    # (center, radius, albedo)
    (np.array([0.0, 0.0, 0.0]), 0.45, np.array([0.9, 0.25, 0.2])),
    (np.array([0.45, 0.35, -0.2]), 0.22, np.array([0.2, 0.4, 0.95])),
]


def random_spheres(seed: int, n_min: int = 3, n_max: int = 5):
    """A random cluster of n_min..n_max spheres (center, radius, albedo):
    one at the origin, the others around it, from default_rng(seed)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(n_min, n_max + 1))
    spheres = [(np.zeros(3), float(rng.uniform(0.3, 0.45)), rng.uniform(0.15, 0.95, 3))]
    for _ in range(n - 1):
        d = rng.normal(size=3)
        d /= np.linalg.norm(d)
        spheres.append((d * rng.uniform(0.3, 0.55), float(rng.uniform(0.1, 0.28)),
                        rng.uniform(0.15, 0.95, 3)))
    return spheres


def random_boxes(seed: int, n_min: int = 3, n_max: int = 5):
    """A random cluster of n_min..n_max axis-aligned boxes (center,
    half_extents [3], albedo), the second geometry family; `_trace` tells
    the families apart by the half-extent being a vector."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(n_min, n_max + 1))
    boxes = [(np.zeros(3), rng.uniform(0.25, 0.45, 3), rng.uniform(0.15, 0.95, 3))]
    for _ in range(n - 1):
        d = rng.normal(size=3)
        d /= np.linalg.norm(d)
        boxes.append((d * rng.uniform(0.3, 0.55), rng.uniform(0.08, 0.25, 3),
                      rng.uniform(0.15, 0.95, 3)))
    return boxes


def _trace(origins: np.ndarray, dirs: np.ndarray, spheres=None) -> np.ndarray:
    """[N, 4] RGBA of the nearest hit, with normal shading. Shapes are
    (center, radius, albedo) spheres or (center, half_extents [3], albedo)
    axis-aligned boxes (slab method); default `SPHERES`."""
    n = origins.shape[0]
    best_t = np.full(n, np.inf)
    rgba = np.zeros((n, 4), np.float32)
    light_dir = np.array([0.5, 0.7, 0.5])
    for center, size, albedo in (SPHERES if spheres is None else spheres):
        if np.ndim(size) == 0:  # sphere
            radius = float(size)
            oc = origins - center
            b = np.sum(oc * dirs, axis=-1)
            c = np.sum(oc * oc, axis=-1) - radius**2
            disc = b * b - c
            t = -b - np.sqrt(np.maximum(disc, 0))
            hit = (disc > 0) & (t > 1e-3) & (t < best_t)
            p = origins[hit] + dirs[hit] * t[hit, None]
            normal = (p - center) / radius
        else:  # box: the entry face is the axis whose slab sets the entry t
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
        light = np.clip(normal @ light_dir, 0.1, 1.0)
        rgba[hit, :3] = albedo[None] * (0.35 + 0.65 * light[:, None])
        rgba[hit, 3] = 1.0
        best_t[hit] = t[hit]
    return rgba


def view_rays(c2w: np.ndarray, image_size: int, fov_x: float = 0.9):
    """(origins, unit directions) [image_size^2, 3] of a view from its
    camera-to-world c2w [4, 4], one ray through each pixel centre."""
    h = w = image_size
    focal = 0.5 * w / np.tan(0.5 * fov_x)
    x, y = np.meshgrid(np.arange(w), np.arange(h), indexing="xy")
    dx = (x.ravel() - w / 2 + 0.5) / focal
    dy = -(y.ravel() - h / 2 + 0.5) / focal
    cam_dirs = np.stack([dx, dy, -np.ones_like(dx)], -1)
    dirs = cam_dirs @ c2w[:3, :3].T
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return np.tile(c2w[:3, 3], (dirs.shape[0], 1)), dirs


def render_views(num_views: int = 30, image_size: int = 64,
                 camera_distance: float = 3.0, fov_x: float = 0.9, seed: int = 0,
                 spheres=None):
    """(images [N, H, W, 4] uint8, c2w [N, 4, 4] f64) of the fixture scene,
    or of the shapes `spheres` (see `_trace`)."""
    rng = np.random.default_rng(seed)
    h = w = image_size
    images, c2ws = [], []
    for i in range(num_views):
        theta = 2 * np.pi * i / num_views
        phi = 0.35 + 0.5 * rng.uniform()  # upper hemisphere
        eye = camera_distance * np.array(
            [np.cos(theta) * np.cos(phi), np.sin(theta) * np.cos(phi), np.sin(phi)])
        c2w = _look_at(eye, np.zeros(3), np.array([0.0, 0.0, 1.0]))
        origins, dirs = view_rays(c2w, image_size, fov_x)
        images.append((_trace(origins, dirs, spheres).reshape(h, w, 4) * 255).astype(np.uint8))
        c2ws.append(c2w)
    return np.stack(images), np.stack(c2ws)


def make_scene_data(split: str = "train", num_views: int = 30, image_size: int = 64,
                    camera_distance: float = 3.0, fov_x: float = 0.9,
                    seed: int = 0, spheres=None) -> SceneData:
    """The fixture scene's `split` in memory, as the objaverse loader reads
    it from `make_scene`'s files."""
    images, c2ws = render_views(num_views, image_size, camera_distance, fov_x, seed, spheres)
    K = intrinsics(image_size, image_size, fov_x)
    return scene_from_arrays(images, c2ws.astype(np.float32)[:, :3, :4], K, split,
                             "fixture_scene")


def make_scene(out_dir: str, num_views: int = 30, image_size: int = 64,
               camera_distance: float = 3.0, fov_x: float = 0.9, seed: int = 0,
               name: str = "fixture_scene", spheres=None) -> str:
    """Write <out_dir>/<name>/{transforms.json, r_*.png}; returns the subject dir."""
    import imageio.v2 as imageio

    subject = os.path.join(out_dir, name)
    os.makedirs(subject, exist_ok=True)
    images, c2ws = render_views(num_views, image_size, camera_distance, fov_x, seed, spheres)
    frames = []
    for i, (img, c2w) in enumerate(zip(images, c2ws)):
        imageio.imwrite(os.path.join(subject, f"r_{i}.png"), img)
        frames.append({"file_path": f"r_{i}", "transform_matrix": c2w.tolist()})
    with open(os.path.join(subject, "transforms.json"), "w") as f:
        json.dump({"camera_angle_x": fov_x, "frames": frames}, f)
    return subject
