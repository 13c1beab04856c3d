"""Dataset core (copy of dregnerf_tpu/datasets/base.py): the SceneData
container, the train/test split, the world_frame_transforms.json reader
and writer (the reference's schema: {block_id: 4x4}, so registration
ground truth crosses between packages), and multi-block splitting: the
cameras clustered into blocks by k-means (sklearn's labels, from
`datasets/kmeans.py`), a random world frame per block, saved once and
read on every later split, and the `--dataset` dispatch. Spectral
clustering (`cluster_cameras(method="Spectral")`) is sklearn's, from
`datasets/spectral.py`."""
from __future__ import annotations

import dataclasses
import importlib
import json
import os
from typing import Dict, List, Optional

import numpy as np

from dregnerf_tpu_torch.datasets.kmeans import kmeans_labels
from dregnerf_tpu_torch.datasets.spectral import spectral_labels


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


def random_se3_np(rng: np.random.Generator, trans_clamp: float = 0.2) -> np.ndarray:
    """Random 4x4 world-frame change: a rotation from a normalised Gaussian
    quaternion, a translation of clamped Gaussians (float64)."""
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    rot = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )
    t = np.clip(rng.normal(size=3) * trans_clamp, -trans_clamp, trans_clamp)
    out = np.eye(4)
    out[:3, :3] = rot
    out[:3, 3] = t
    return out


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


def cluster_cameras(camtoworlds: np.ndarray, num_clusters: int,
                    method: str = "KMeans") -> np.ndarray:
    """Block label of each camera: its centre clustered as sklearn's
    KMeans(n_init=10, random_state=0) or SpectralClustering(random_state=0,
    assign_labels="discretize") labels it."""
    if method == "KMeans":
        return kmeans_labels(camtoworlds[:, :3, 3], num_clusters)
    if method == "Spectral":
        return spectral_labels(camtoworlds[:, :3, 3], num_clusters)
    raise ValueError(f"unknown clustering method: {method}")


def apply_world_frame(c2w: np.ndarray, se3: np.ndarray) -> np.ndarray:
    """Left-multiply a 4x4 SE(3) onto [N, 3, 4] (or [N, 4, 4]) poses; f32 [N, 3, 4]."""
    homo = np.concatenate(
        [c2w[:, :3, :4], np.tile(np.array([[[0, 0, 0, 1.0]]]), (c2w.shape[0], 1, 1))],
        axis=1,
    )
    return (se3[None] @ homo)[:, :3, :4].astype(np.float32)


def make_blocks(data_dir: str, images: np.ndarray, camtoworlds: np.ndarray, K: np.ndarray,
                split: str, num_blocks: int, val_interval: int, opengl: bool,
                synthetic: bool, subject_id: str, seed: int = 0, near: float = 0.0,
                far: float = 1e10) -> List[SceneData]:
    """Cluster the cameras into blocks, give each block its world frame
    (drawn from default_rng(seed) and saved to `data_dir` on the first
    call, read back on every later one), then carve the train/test split
    inside each block."""
    labels = cluster_cameras(camtoworlds, num_blocks)
    transforms = read_world_frame_transforms(data_dir)
    fresh = transforms is None
    if fresh:
        rng = np.random.default_rng(seed)
        transforms = {}
    blocks = []
    for block_id in sorted(set(int(label) for label in labels)):
        ids = np.sort(np.where(labels == block_id)[0])
        ids_split = ids[split_indices(len(ids), split, val_interval)]
        if fresh:
            transforms[block_id] = random_se3_np(rng)
        blocks.append(SceneData(
            images=images[ids_split],
            camtoworlds=apply_world_frame(camtoworlds[ids_split], transforms[block_id]),
            K=K, opengl=opengl, synthetic=synthetic, subject_id=subject_id, split=split,
            block_id=block_id, near=near, far=far))
    if fresh:
        save_world_frame_transforms(data_dir, transforms)
    return blocks


# CLI name (and alias) -> loader module under dregnerf_tpu_torch.datasets
DATASET_MODULES: Dict[str, str] = {
    "objaverse": "objaverse",
    "nerf_synthetic": "nerf_synthetic",
    "blender": "nerf_synthetic",
    "Synthetic_NSVF": "nsvf",
    "nsvf": "nsvf",
    "scannerf": "scannerf",
    "dtu": "mvs",
    "BlendedMVS": "mvs",
    "blendedmvs": "mvs",
    "mvs": "mvs",
    "nerf_llff_data": "real_world",
    "llff": "real_world",
    "mipnerf_360": "real_world",
    "mipnerf360": "real_world",
    "real_world": "real_world",
    "Hypersim": "hypersim",
    "hypersim": "hypersim",
    "dnerf": "dnerf_synthetic",
}


def dataset_module(dataset: str):
    """Resolve a CLI --dataset value (or alias) to its loader module."""
    try:
        name = DATASET_MODULES[dataset]
    except KeyError:
        raise ValueError(
            f"unknown dataset: {dataset!r} (known: {sorted(DATASET_MODULES)})") from None
    return importlib.import_module(f"dregnerf_tpu_torch.datasets.{name}")


def load_scene_blocks(dataset: str, root: str, subject_id: str, split: str, factor: int = 1,
                      multi_blocks: bool = False, num_blocks: int = 1) -> List[SceneData]:
    """One SceneData per block of `subject_id` (a one-element list without
    multi_blocks), through the loader of `dataset`."""
    return dataset_module(dataset).load_blocks(root, subject_id, split, factor, multi_blocks,
                                               num_blocks)
