"""Objaverse loader, single block (port of dregnerf_tpu/datasets/objaverse.py).

`<root>/<subject_id>/transforms.json` with `camera_angle_x` and frames of
`{file_path, transform_matrix}`; RGBA PNGs at `file_path + ".png"`; every
20th view is the test split; OpenGL cameras, synthetic RGBA. Multi-block
splitting (KMeans) is still to be ported.
"""
from __future__ import annotations

import json
import os
from typing import List

import numpy as np

from dregnerf_tpu_torch.datasets.base import SceneData, split_indices

VAL_INTERVAL = 20
OPENGL = True
SYNTHETIC = True


def intrinsics(width: int, height: int, camera_angle_x: float) -> np.ndarray:
    focal = 0.5 * width / np.tan(0.5 * float(camera_angle_x))
    return np.array([[focal, 0, width / 2], [0, focal, height / 2], [0, 0, 1]],
                    np.float32)


def _load_renderings(root: str, subject_id: str, factor: int = 1):
    import imageio.v2 as imageio  # only needed when reading from disk

    data_dir = os.path.join(root, subject_id)
    with open(os.path.join(data_dir, "transforms.json")) as f:
        meta = json.load(f)
    images, camtoworlds = [], []
    for frame in meta["frames"]:
        images.append(imageio.imread(os.path.join(data_dir, frame["file_path"] + ".png")))
        camtoworlds.append(np.asarray(frame["transform_matrix"], np.float32))
    images = np.stack(images)
    camtoworlds = np.stack(camtoworlds)[:, :3, :4]
    if factor > 1:
        images = images[:, ::factor, ::factor]
    h, w = images.shape[1:3]
    return images, camtoworlds, intrinsics(w, h, meta["camera_angle_x"])


def scene_from_arrays(images, camtoworlds, K, split: str,
                      subject_id: str = "") -> SceneData:
    sel = split_indices(images.shape[0], split, VAL_INTERVAL)
    return SceneData(images=images[sel], camtoworlds=camtoworlds[sel], K=K,
                     opengl=OPENGL, synthetic=SYNTHETIC, subject_id=subject_id,
                     split=split)


def load_blocks(root: str, subject_id: str, split: str, factor: int = 1,
                multi_blocks: bool = False, num_blocks: int = 1) -> List[SceneData]:
    if multi_blocks:
        raise NotImplementedError(
            "multi-block splitting is not ported yet (ROADMAP.md queue 1)")
    images, camtoworlds, K = _load_renderings(root, subject_id, factor)
    return [scene_from_arrays(images, camtoworlds, K, split, subject_id)]
