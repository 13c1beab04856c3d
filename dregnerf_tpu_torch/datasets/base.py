"""Dataset core (copy of the parts of dregnerf_tpu/datasets/base.py the
port needs): the SceneData container and the train/test split."""
from __future__ import annotations

import dataclasses
from typing import Optional

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
