"""NeRF-synthetic (blender) loader: per-split transforms_{split}.json
(copy of dregnerf_tpu/datasets/nerf_synthetic.py, images decoded lazily).

Format parity with the reference (conerf/datasets/nerf_synthetic.py):
800x800 RGBA, OpenGL cameras, `transforms_train/test.json`.
"""
from __future__ import annotations

import json
import os
from typing import List

import numpy as np

from dregnerf_tpu_torch.datasets.base import SceneData, make_blocks

OPENGL = True
SYNTHETIC = True


def _load_renderings(root: str, subject_id: str, split: str, factor: int = 1):
    import imageio.v2 as imageio  # decoded only when reading from disk

    data_dir = os.path.join(root, subject_id)
    with open(os.path.join(data_dir, f"transforms_{split}.json")) as f:
        meta = json.load(f)
    images, camtoworlds = [], []
    for frame in meta["frames"]:
        fname = os.path.join(data_dir, frame["file_path"] + ".png")
        images.append(imageio.imread(fname))
        camtoworlds.append(np.asarray(frame["transform_matrix"], np.float32))
    images = np.stack(images)
    camtoworlds = np.stack(camtoworlds)[:, :3, :4]
    if factor > 1:
        images = images[:, ::factor, ::factor]
    h, w = images.shape[1:3]
    focal = 0.5 * w / np.tan(0.5 * float(meta["camera_angle_x"]))
    K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]], np.float32)
    return images, camtoworlds, K


def load_blocks(
    root: str,
    subject_id: str,
    split: str,
    factor: int = 1,
    multi_blocks: bool = False,
    num_blocks: int = 1,
) -> List[SceneData]:
    images, camtoworlds, K = _load_renderings(root, subject_id, split, factor)
    if multi_blocks:
        return make_blocks(
            os.path.join(root, subject_id), images, camtoworlds, K, split,
            num_blocks, 20, OPENGL, SYNTHETIC, subject_id,
        )
    return [
        SceneData(
            images=images,
            camtoworlds=camtoworlds,
            K=K,
            opengl=OPENGL,
            synthetic=SYNTHETIC,
            subject_id=subject_id,
            split=split,
        )
    ]
