"""ScanNeRF loader: per-split json with explicit fl/c intrinsics (copy of
dregnerf_tpu/datasets/scannerf.py, images decoded lazily).

Format parity with conerf/datasets/scan_nerf.py:16-110: `<scene>/<split>.json`
with fl_x/fl_y/cx/cy + frames (file_path + ".png"); test split decimated
10x; OpenGL cameras; synthetic RGBA; 1440x1080.
"""
from __future__ import annotations

import json
import os
from typing import List

import numpy as np

from dregnerf_tpu_torch.datasets.base import SceneData, make_blocks

OPENGL = True
SYNTHETIC = True
NEAR, FAR = 2.0, 6.0


def _load_renderings(root: str, subject_id: str, split: str, factor: int = 1):
    import imageio.v2 as imageio  # decoded only when reading from disk

    data_dir = os.path.join(root, subject_id)
    split_file = split if os.path.exists(
        os.path.join(data_dir, f"{split}.json")
    ) else ("train_all" if "train" in split else "test_all")
    with open(os.path.join(data_dir, f"{split_file}.json")) as f:
        meta = json.load(f)
    frames = meta["frames"]
    if "train" not in split:
        frames = frames[::10]
    images, camtoworlds = [], []
    for frame in frames:
        images.append(imageio.imread(os.path.join(data_dir, frame["file_path"] + ".png")))
        camtoworlds.append(np.asarray(frame["transform_matrix"], np.float32))
    images = np.stack(images)
    camtoworlds = np.stack(camtoworlds)[:, :3, :4]
    if factor > 1:
        images = images[:, ::factor, ::factor]
    K = np.array(
        [
            [float(meta["fl_x"]) / factor, 0, float(meta["cx"]) / factor],
            [0, float(meta["fl_y"]) / factor, float(meta["cy"]) / factor],
            [0, 0, 1],
        ],
        np.float32,
    )
    return images, camtoworlds, K


def load_blocks(root, subject_id, split, factor=1, multi_blocks=False, num_blocks=1) -> List[SceneData]:
    images, camtoworlds, K = _load_renderings(root, subject_id, split, factor)
    if multi_blocks:
        return make_blocks(
            os.path.join(root, subject_id), images, camtoworlds, K, split,
            num_blocks, 20, OPENGL, SYNTHETIC, subject_id,
        )
    return [
        SceneData(images=images, camtoworlds=camtoworlds, K=K, opengl=OPENGL,
                  synthetic=SYNTHETIC, subject_id=subject_id, split=split,
                  near=NEAR, far=FAR)
    ]
