"""D-NeRF synthetic loader, time-stamped blender scenes (copy of
dregnerf_tpu/datasets/dnerf_synthetic.py, images decoded lazily).

`transforms_{split}.json` whose frames carry a `time` in [0, 1]; OpenGL
cameras, synthetic RGBA, near/far 2/6. Every frame of the split's file is
read (no split of its own), and `multi_blocks` is ignored, as in the JAX
package. The per-frame times ride in `DNeRFSceneData.timestamps`, which
the trainer hands to the D-NeRF field.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional

import numpy as np

from dregnerf_tpu_torch.datasets.base import SceneData

OPENGL = True
SYNTHETIC = True
NEAR, FAR = 2.0, 6.0


@dataclasses.dataclass
class DNeRFSceneData(SceneData):
    timestamps: Optional[np.ndarray] = None  # [N] f32 in [0, 1]


def _load_renderings(root: str, subject_id: str, split: str, factor: int = 1):
    import imageio.v2 as imageio  # decoded only when reading from disk

    data_dir = os.path.join(root, subject_id)
    with open(os.path.join(data_dir, f"transforms_{split}.json")) as f:
        meta = json.load(f)
    images, camtoworlds, times = [], [], []
    for frame in meta["frames"]:
        images.append(imageio.imread(os.path.join(data_dir, frame["file_path"] + ".png")))
        camtoworlds.append(np.asarray(frame["transform_matrix"], np.float32))
        times.append(float(frame.get("time", 0.0)))
    images = np.stack(images)
    camtoworlds = np.stack(camtoworlds)[:, :3, :4]
    if factor > 1:
        images = images[:, ::factor, ::factor]
    h, w = images.shape[1:3]
    focal = 0.5 * w / np.tan(0.5 * float(meta["camera_angle_x"]))
    K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]], np.float32)
    return images, camtoworlds, K, np.asarray(times, np.float32)


def scene_from_arrays(images: np.ndarray, camtoworlds: np.ndarray, K: np.ndarray,
                      timestamps: np.ndarray, split: str = "train",
                      subject_id: str = "") -> DNeRFSceneData:
    """A scene in memory, as `load_blocks` returns it from files."""
    return DNeRFSceneData(
        images=images, camtoworlds=camtoworlds, K=K, opengl=OPENGL, synthetic=SYNTHETIC,
        subject_id=subject_id, split=split, near=NEAR, far=FAR,
        timestamps=np.asarray(timestamps, np.float32))


def load_blocks(root: str, subject_id: str, split: str, factor: int = 1,
                multi_blocks: bool = False, num_blocks: int = 1) -> List[SceneData]:
    images, camtoworlds, K, times = _load_renderings(root, subject_id, split, factor)
    return [scene_from_arrays(images, camtoworlds, K, times, split, subject_id)]
