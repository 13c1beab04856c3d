"""Synthetic-NSVF loader: pose/rgb txt files + bbox.txt (copy of
dregnerf_tpu/datasets/nsvf.py, images decoded lazily).

Format parity with conerf/datasets/nsvf.py:16-124: `intrinsics.txt` (focal
first value), `pose/*.txt` 4x4 c2w (prefix 0_=train, 1_=val, 2_=test),
`rgb/*` images, `bbox.txt` scene bounds; OpenCV camera; synthetic RGBA.
"""
from __future__ import annotations

import os
from typing import List

import numpy as np

from dregnerf_tpu_torch.datasets.base import SceneData, make_blocks

OPENGL = False
SYNTHETIC = True
NEAR, FAR = 2.0, 6.0


def _split_prefix(files, split):
    if split == "train":
        sel = [f for f in files if f.startswith("0_")]
    elif split == "val":
        sel = [f for f in files if f.startswith("1_")]
    else:
        sel = [f for f in files if f.startswith("2_")]
        if not sel:
            sel = [f for f in files if f.startswith("1_")]
    return sel


def _load_renderings(root: str, subject_id: str, split: str, factor: int = 1):
    import imageio.v2 as imageio  # decoded only when reading from disk

    data_dir = os.path.join(root, subject_id)
    with open(os.path.join(data_dir, "intrinsics.txt")) as f:
        focal = float(f.readline().split()[0])
    pose_files = _split_prefix(sorted(os.listdir(os.path.join(data_dir, "pose"))), split)
    image_files = _split_prefix(sorted(os.listdir(os.path.join(data_dir, "rgb"))), split)
    assert len(pose_files) == len(image_files)
    images, camtoworlds = [], []
    for img_f, pose_f in zip(image_files, pose_files):
        images.append(imageio.imread(os.path.join(data_dir, "rgb", img_f)))
        camtoworlds.append(
            np.loadtxt(os.path.join(data_dir, "pose", pose_f)).astype(np.float32)
        )
    images = np.stack(images)
    camtoworlds = np.stack(camtoworlds)[:, :3, :4]
    if factor > 1:
        images = images[:, ::factor, ::factor]
        focal /= factor
    h, w = images.shape[1:3]
    K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]], np.float32)
    return images, camtoworlds, K


def load_aabb(root: str, subject_id: str) -> np.ndarray:
    return np.loadtxt(os.path.join(root, subject_id, "bbox.txt")).astype(np.float32)[:6]


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
