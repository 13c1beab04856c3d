"""Dataset core (copy of the parts of dregnerf_tpu/datasets/base.py the
port needs): the SceneData container, the train/test split, and the
world_frame_transforms.json reader and writer (the reference's schema:
{block_id: 4x4}, so registration ground truth crosses between packages)."""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass
class SceneData:
    """One (block of a) scene, host-side."""

    images: np.ndarray  # [N, H, W, C] uint8 (C=4 synthetic, 3 real)
    camtoworlds: np.ndarray  # [N, 3, 4] f32
    K: np.ndarray  # [3, 3] f32
    opengl: bool
    synthetic: bool  # RGBA alpha-composited over a background color
    subject_id: str = ""
    split: str = "train"
    block_id: Optional[int] = None
    near: float = 0.0
    far: float = 1e10

    @property
    def num_images(self) -> int:
        return self.images.shape[0]

    @property
    def height(self) -> int:
        return self.images.shape[1]

    @property
    def width(self) -> int:
        return self.images.shape[2]


def split_indices(n: int, split: str, val_interval: int) -> np.ndarray:
    idx = np.arange(n)
    if split == "test":
        return idx[idx % val_interval == 0]
    return idx[idx % val_interval != 0]


def read_world_frame_transforms(data_dir: str) -> Optional[Dict[int, np.ndarray]]:
    """world_frame_transforms.json in `data_dir`: {block_id: [4, 4] f32}, or
    None without the file."""
    path = os.path.join(data_dir, "world_frame_transforms.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        data = json.load(f)
    out = {int(k): np.asarray(v, np.float32) for k, v in data.items()}
    if not out:
        raise ValueError(f"Invalid transformation file: {path}")
    return out


def save_world_frame_transforms(data_dir: str, transforms: Dict[int, np.ndarray]) -> None:
    path = os.path.join(data_dir, "world_frame_transforms.json")
    data = {str(k): np.asarray(v).tolist() for k, v in transforms.items()}
    with open(path, "w") as f:
        f.write(json.dumps(data, indent=4))
