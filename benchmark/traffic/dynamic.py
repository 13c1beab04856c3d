"""The benchmark's time-varying scene: spheres that move over t in [0, 1],
seen by a ring of cameras that each render one frame at its own time, as
D-NeRF's monocular scenes are.

Built from `scenes.py` without changing it: the spheres of
`random_spheres`, its ray tracer `trace`, `_look_at` through the camera
ring of `render_views` (whose poses are drawn by the ring's own loop, so
the same `scene_seed` gives the static cells' cameras), and the same
shading. Each sphere but the central one moves linearly from its centre
by a seeded offset of norm at most `max_offset`; with `random_spheres`'
centres within 0.55 of the origin and radii at most 0.28, a sphere moved
by at most 0.15 stays inside the ball of radius 0.98, so inside the box
[-1, 1]^3 at every t.
"""
from __future__ import annotations

import numpy as np

from benchmark.traffic import scenes

OFFSET_PURPOSE = 1  # the offsets' stream beside random_spheres' own (the scene seed)


def moving_spheres(seed: int, max_offset: float):
    """(spheres at t = 0, offsets [n, 3]): `random_spheres(seed)` and each
    sphere's displacement over t in [0, 1], zero for the central one."""
    shapes = scenes.random_spheres(seed)
    rng = np.random.default_rng([seed, OFFSET_PURPOSE])
    offsets = np.zeros((len(shapes), 3))
    for i in range(1, len(shapes)):
        d = rng.normal(size=3)
        offsets[i] = d / np.linalg.norm(d) * rng.uniform(0.0, max_offset)
    return shapes, offsets


def shapes_at(shapes, offsets: np.ndarray, t: float):
    """The spheres at time t: each centre moved by t times its offset."""
    return [(center + t * off, radius, albedo)
            for (center, radius, albedo), off in zip(shapes, offsets)]


def view_times(num_views: int) -> np.ndarray:
    """View i's time, i / (num_views - 1): one frame a time over [0, 1]."""
    return (np.arange(num_views) / max(num_views - 1, 1)).astype(np.float32)


def block_views(scene: dict):
    """(images [N, S, S, 4] uint8, c2w [N, 4, 4], K [3, 3], times [N] f32)
    of a workload's `scene` entry of family "moving_spheres"."""
    if scene["family"] != "moving_spheres":
        raise ValueError(f"not a dynamic scene family: {scene['family']!r}")
    shapes, offsets = moving_spheres(scene["scene_seed"], scene["max_offset"])
    n, s = scene["views"], scene["image_size"]
    # the ring's poses: render_views draws them view by view from the scene
    # seed whatever the image size, so one pixel a view gives them cheaply
    _, c2ws, _ = scenes.render_views(shapes, n, 1, scene["camera_distance"], scene["fov_x"],
                                     scene["scene_seed"])
    focal = 0.5 * s / np.tan(0.5 * scene["fov_x"])
    x, y = np.meshgrid(np.arange(s), np.arange(s), indexing="xy")
    cam_dirs = np.stack([(x.ravel() - s / 2 + 0.5) / focal,
                         -(y.ravel() - s / 2 + 0.5) / focal, -np.ones(s * s)], -1)
    times = view_times(n)
    images = []
    for c2w, t in zip(c2ws, times):
        dirs = cam_dirs @ c2w[:3, :3].T
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        origins = np.tile(c2w[:3, 3], (dirs.shape[0], 1))
        rgba = scenes.trace(origins, dirs, shapes_at(shapes, offsets, float(t)))
        images.append((rgba.reshape(s, s, 4) * 255).astype(np.uint8))
    K = np.array([[focal, 0, s / 2], [0, focal, s / 2], [0, 0, 1]], np.float32)
    return np.stack(images), c2ws, K, times
