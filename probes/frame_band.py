#!/usr/bin/env python3
"""Where the surface voxels of the two fixture blocks lie, against the
fixture's true spheres (the multi-block phase of chip_smoke.py).

  python3 probes/frame_band.py FRAMES MASK0 MASK1

FRAMES is a block split's world_frame_transforms.json and MASKk block k's
voxel_mask.pt (flat indices of the 128^3 grid over the +-1 box), as
chip_smoke.py's multi-block phase writes them. Prints, for each block,
its surface voxels' median distance (in voxel widths, mapped back to the
world frame) from the nearest sphere surface and their share within 1.5
widths; then the frame check's share under T1 T0^-1 and under the swapped
T0 T1^-1 at 2, 3 and 4 widths; then the share at 2 widths if each block's
surface were the sphere shells that its cameras see (a shell voxel's
centre within half a width of a surface and outside the other sphere;
seen where the first sphere a camera's ray to it hits lies within 1.5
widths of it). Runs on the CPU; imports nothing of JAX or of the JAX
package.
"""
from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RES = 128
WIDTH = 2.0 / RES


def centres(np, idx):
    ijk = np.stack([idx // (RES * RES), (idx // RES) % RES, idx % RES], -1)
    return (ijk + 0.5) * WIDTH - 1.0


def nearest(np, a, b):
    from scipy.spatial import cKDTree

    return cKDTree(b).query(a)[0]


def visible_shells(np, eyes_by_block):
    from dregnerf_tpu_torch.datasets.fixtures import SPHERES

    c = (np.arange(RES) + 0.5) * WIDTH - 1.0
    pts = np.stack(np.meshgrid(c, c, c, indexing="ij"), -1).reshape(-1, 3)
    shell = np.zeros(len(pts), bool)
    for centre, r, _ in SPHERES:
        shell |= np.abs(np.linalg.norm(pts - centre, axis=1) - r) < WIDTH / 2
    for centre, r, _ in SPHERES:
        shell &= np.linalg.norm(pts - centre, axis=1) > r - 0.75 * WIDTH
    pts = pts[shell]
    seen = []
    for eyes in eyes_by_block:
        vis = np.zeros(len(pts), bool)
        for e in eyes:
            v = pts - e
            dist = np.linalg.norm(v, axis=1)
            d = v / dist[:, None]
            hit = np.full(len(pts), np.inf)
            for centre, r, _ in SPHERES:
                oc = e - centre
                b = d @ oc
                disc = b * b - (oc @ oc - r * r)
                t = -b - np.sqrt(np.maximum(disc, 0))
                hit = np.where((disc > 0) & (t > 1e-3) & (t < hit), t, hit)
            vis |= np.abs(hit - dist) < 1.5 * WIDTH
        seen.append(pts[vis])
    return seen


def main(argv) -> int:
    import numpy as np
    import torch

    from dregnerf_tpu_torch.datasets.base import cluster_cameras
    from dregnerf_tpu_torch.datasets.fixtures import SPHERES, render_views

    frames_path, *mask_paths = argv
    with open(frames_path) as f:
        frames = {int(k): np.asarray(v, np.float64) for k, v in json.load(f).items()}
    pts = [centres(np, torch.load(p).numpy()) for p in mask_paths]
    for k, p in enumerate(pts):
        world = (np.linalg.inv(frames[k])[:3] @ np.c_[p, np.ones(len(p))].T).T
        d = np.min([np.abs(np.linalg.norm(world - c, axis=1) - r) for c, r, _ in SPHERES], 0)
        print(f"block {k}: {len(p)} surface voxels, median {np.median(d) / WIDTH:.2f} widths "
              f"from the spheres' surface, {np.mean(d <= 1.5 * WIDTH):.4f} within 1.5")
    for name, m in (("T1 T0^-1", frames[1] @ np.linalg.inv(frames[0])),
                    ("T0 T1^-1", frames[0] @ np.linalg.inv(frames[1]))):
        d = nearest(np, pts[0] @ m[:3, :3].T + m[:3, 3], pts[1])
        print(f"{name}: shares within 2, 3, 4 widths "
              f"{[round(float(np.mean(d <= r * WIDTH)), 4) for r in (2, 3, 4)]}")
    _, c2w = render_views(36, 2)
    labels = cluster_cameras(c2w[:, :3, :4].astype(np.float32), 2)
    seen = visible_shells(np, [c2w[labels == k, :3, 3] for k in (0, 1)])
    print(f"visible shells: {len(seen[0])} and {len(seen[1])} voxels, share within 2 widths "
          f"{np.mean(nearest(np, seen[0], seen[1]) <= 2 * WIDTH):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
