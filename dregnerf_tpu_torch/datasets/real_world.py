"""Real-world (LLFF / mipnerf-360) loader via COLMAP sparse models (copy
of dregnerf_tpu/datasets/real_world.py, images decoded lazily).

Format parity with conerf/datasets/real_world.py:28-192: COLMAP model at
`<scene>/sparse/0`, images under `images/` (or `images_{factor}/`), OpenCV
cameras, real (3-channel) data, test split every 8th image (llff
convention), train the rest.
"""
from __future__ import annotations

import os
from typing import List

import numpy as np

from dregnerf_tpu_torch.datasets.base import SceneData, make_blocks
from dregnerf_tpu_torch.utils.colmap import read_model

OPENGL = False
SYNTHETIC = False
TEST_EVERY = 8


def _load_colmap(
    root: str, subject_id: str, split: str, factor: int = 1,
    test_every: int = TEST_EVERY,
):
    import imageio.v2 as imageio  # decoded only when reading from disk

    data_dir = os.path.join(root, subject_id)
    model = read_model(os.path.join(data_dir, "sparse", "0"))

    image_dir = os.path.join(data_dir, f"images_{factor}" if factor > 1 else "images")
    if not os.path.isdir(image_dir):
        image_dir = os.path.join(data_dir, "images")

    items = sorted(model.images.items(), key=lambda kv: kv[1].name)
    images, camtoworlds = [], []
    K = None
    for _, im in items:
        cam = model.cameras[im.camera_id]
        if K is None:
            K = cam.K.astype(np.float32)
            actual = imageio.imread(os.path.join(image_dir, im.name))
            scale = actual.shape[1] / cam.width
            K[:2] *= scale
        images.append(imageio.imread(os.path.join(image_dir, im.name))[..., :3])
        camtoworlds.append(im.cam_to_world()[:3, :4].astype(np.float32))
    images = np.stack(images)
    camtoworlds = np.stack(camtoworlds)

    idx = np.arange(len(images))
    sel = idx[idx % test_every == 0] if split == "test" else idx[idx % test_every != 0]
    return images[sel], camtoworlds[sel], K, model


def load_blocks(root, subject_id, split, factor=1, multi_blocks=False, num_blocks=1) -> List[SceneData]:
    images, camtoworlds, K, _ = _load_colmap(root, subject_id, split, factor)
    if multi_blocks:
        return make_blocks(
            os.path.join(root, subject_id), images, camtoworlds, K, split,
            num_blocks, 20, OPENGL, SYNTHETIC, subject_id,
        )
    return [
        SceneData(images=images, camtoworlds=camtoworlds, K=K, opengl=OPENGL,
                  synthetic=SYNTHETIC, subject_id=subject_id, split=split)
    ]
