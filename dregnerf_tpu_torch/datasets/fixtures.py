"""Synthetic fixture scene (port of dregnerf_tpu/datasets/fixtures.py).

Ray-traces two colored spheres from cameras on a sphere. `make_scene_data`
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


def _trace(origins: np.ndarray, dirs: np.ndarray) -> np.ndarray:
    """[N, 4] RGBA of the nearest sphere hit, with normal shading."""
    n = origins.shape[0]
    best_t = np.full(n, np.inf)
    rgba = np.zeros((n, 4), np.float32)
    light_dir = np.array([0.5, 0.7, 0.5])
    for center, radius, albedo in SPHERES:
        oc = origins - center
        b = np.sum(oc * dirs, axis=-1)
        c = np.sum(oc * oc, axis=-1) - radius**2
        disc = b * b - c
        t = -b - np.sqrt(np.maximum(disc, 0))
        hit = (disc > 0) & (t > 1e-3) & (t < best_t)
        p = origins[hit] + dirs[hit] * t[hit, None]
        normal = (p - center) / radius
        light = np.clip(normal @ light_dir, 0.1, 1.0)
        rgba[hit, :3] = albedo[None] * (0.35 + 0.65 * light[:, None])
        rgba[hit, 3] = 1.0
        best_t[hit] = t[hit]
    return rgba


def render_views(num_views: int = 30, image_size: int = 64,
                 camera_distance: float = 3.0, fov_x: float = 0.9, seed: int = 0):
    """(images [N, H, W, 4] uint8, c2w [N, 4, 4] f64) of the fixture scene."""
    rng = np.random.default_rng(seed)
    h = w = image_size
    focal = 0.5 * w / np.tan(0.5 * fov_x)
    images, c2ws = [], []
    for i in range(num_views):
        theta = 2 * np.pi * i / num_views
        phi = 0.35 + 0.5 * rng.uniform()  # upper hemisphere
        eye = camera_distance * np.array(
            [np.cos(theta) * np.cos(phi), np.sin(theta) * np.cos(phi), np.sin(phi)])
        c2w = _look_at(eye, np.zeros(3), np.array([0.0, 0.0, 1.0]))
        x, y = np.meshgrid(np.arange(w), np.arange(h), indexing="xy")
        dx = (x.ravel() - w / 2 + 0.5) / focal
        dy = -(y.ravel() - h / 2 + 0.5) / focal
        cam_dirs = np.stack([dx, dy, -np.ones_like(dx)], -1)
        dirs = cam_dirs @ c2w[:3, :3].T
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        origins = np.tile(c2w[:3, 3], (dirs.shape[0], 1))
        images.append((_trace(origins, dirs).reshape(h, w, 4) * 255).astype(np.uint8))
        c2ws.append(c2w)
    return np.stack(images), np.stack(c2ws)


def make_scene_data(split: str = "train", num_views: int = 30, image_size: int = 64,
                    camera_distance: float = 3.0, fov_x: float = 0.9,
                    seed: int = 0) -> SceneData:
    """The fixture scene's `split` in memory, as the objaverse loader reads
    it from `make_scene`'s files."""
    images, c2ws = render_views(num_views, image_size, camera_distance, fov_x, seed)
    K = intrinsics(image_size, image_size, fov_x)
    return scene_from_arrays(images, c2ws.astype(np.float32)[:, :3, :4], K, split,
                             "fixture_scene")


def make_scene(out_dir: str, num_views: int = 30, image_size: int = 64,
               camera_distance: float = 3.0, fov_x: float = 0.9, seed: int = 0,
               name: str = "fixture_scene") -> str:
    """Write <out_dir>/<name>/{transforms.json, r_*.png}; returns the subject dir."""
    import imageio.v2 as imageio

    subject = os.path.join(out_dir, name)
    os.makedirs(subject, exist_ok=True)
    images, c2ws = render_views(num_views, image_size, camera_distance, fov_x, seed)
    frames = []
    for i, (img, c2w) in enumerate(zip(images, c2ws)):
        imageio.imwrite(os.path.join(subject, f"r_{i}.png"), img)
        frames.append({"file_path": f"r_{i}", "transform_matrix": c2w.tolist()})
    with open(os.path.join(subject, "transforms.json"), "w") as f:
        json.dump({"camera_angle_x": fov_x, "frames": frames}, f)
    return subject
