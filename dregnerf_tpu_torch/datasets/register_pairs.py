"""NeRF-pair registration dataset, host side (port of
dregnerf_tpu/datasets/register_pairs.py; the same numpy code, so the same
seed gives the same items).

Scenes come from the objaverse.json split and the obj_id_names.json map
(copies under datasets/register/). Each item is two blocks of a scene,
their voxel_grid.pt [R, R, R, 7] and voxel_mask.pt (expanded to a flat
bool [R^3] mask in ix*R^2 + iy*R + iz order), and the ground-truth pose
tgt_T @ inv(src_T) from world_frame_transforms.json. The train split
jitters the masked xyz (sigma 0.005, clip 0.05), perturbs one side by a
centroid-centred random SE(3) (std 0.1) with the pose updated, and swaps
the sides at random with the pose inverted. Decoded blocks sit in an LRU
cache; items get copies. `get_raw` returns the cached arrays with the
per-side transforms instead, and `device_augment` applies the jitter and
the transform on the grid's device (the trainer's device-cached path).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from dregnerf_tpu_torch.datasets.base import read_world_frame_transforms

JSON_DIR = os.path.join(os.path.dirname(__file__), "register")


def _load_torch_artifact(path: str) -> np.ndarray:
    return torch.load(path, map_location="cpu", weights_only=True).numpy()


def load_split_subjects(json_dir: str, dataset: str, split: str) -> List[str]:
    """objaverse.json + obj_id_names.json -> subject names of `split`."""
    json_dir = json_dir or JSON_DIR
    with open(os.path.join(json_dir, "objaverse.json")) as f:
        splits = json.load(f)
    names = splits.get(dataset, splits.get("objaverse"))[split]
    if dataset == "objaverse":
        with open(os.path.join(json_dir, "obj_id_names.json")) as f:
            id_to_name = json.load(f)
        names = [id_to_name.get(i, i) for i in names]
    return names


def _first_existing(*paths: str) -> Optional[str]:
    for p in paths:
        if os.path.exists(p):
            return p
    return None


def load_scene_meta(root_fp: str, subject_id: str, model_dir: str = "nerf_models"):
    """Block paths and world-frame transforms of one scene; None unless it
    has at least two complete blocks."""
    raw_data_dir = os.path.join(root_fp, "images", subject_id)
    block_model_dir = os.path.join(root_fp, model_dir, subject_id)
    if not os.path.isdir(block_model_dir):
        return None
    transforms = read_world_frame_transforms(raw_data_dir)
    if transforms is None:  # also accept transforms stored next to the models
        transforms = read_world_frame_transforms(block_model_dir)
    if transforms is None:
        return None
    meta = {"scene": subject_id, "blocks": []}
    for k in sorted(transforms):
        block_dir = os.path.join(block_model_dir, f"block_{k}")
        paths = {
            "transform": transforms[k],
            "model_path": _first_existing(
                os.path.join(block_dir, "model", "model.ckpt"),
                os.path.join(block_dir, "model.ckpt"),
                os.path.join(block_dir, "model.pth"),
            ),
            "voxel_grid_path": os.path.join(block_dir, "voxel_grid.pt"),
            "voxel_mask_path": os.path.join(block_dir, "voxel_mask.pt"),
            "voxel_ply_path": os.path.join(block_dir, "voxel_point_cloud.ply"),
        }
        if not (paths["model_path"] and os.path.exists(paths["voxel_grid_path"])
                and os.path.exists(paths["voxel_mask_path"])):
            return None
        meta["blocks"].append(paths)
    return meta if len(meta["blocks"]) >= 2 else None


def _se3_small(rng: np.random.Generator, std: float) -> np.ndarray:
    from scipy.linalg import expm

    xi = rng.normal(size=6) * std
    omega, v = xi[:3], xi[3:]
    hat = np.array([[0, -omega[2], omega[1]], [omega[2], 0, -omega[0]],
                    [-omega[1], omega[0], 0]])
    out = np.eye(4)
    out[:3, :3] = expm(hat)
    out[:3, 3] = v
    return out


class NeRFRegDataset:
    """`dataset[i]` is a numpy dict: src_grid/tgt_grid [R, R, R, 7] f32,
    src_mask/tgt_mask flat bool [R^3], pose [4, 4] f32, the blocks' model
    and point-cloud paths, scene, index and block_list."""

    def __init__(self, root_fp: str, dataset: str = "objaverse", json_dir: str = "",
                 subject_id: Optional[str] = None, split: str = "train",
                 model_dir: str = "nerf_models", seed: int = 0, cache_blocks: int = 64):
        self.split = split
        self.rng = np.random.default_rng(seed)
        self.jitter_scale, self.jitter_clip = 0.005, 0.05
        self.perturb_std = 0.1
        self.meta: List[Dict] = []
        self.cache_blocks = cache_blocks
        self._block_cache: Dict[str, tuple] = {}
        self.fixed_order = None  # a (src, tgt, ...) block order for every item

        if subject_id is not None:
            m = load_scene_meta(root_fp, subject_id, model_dir)
            if m:
                self.meta.append(m)
        else:
            dataset_dir = os.path.join(root_fp, dataset)
            for s in load_split_subjects(json_dir, dataset, split):
                m = load_scene_meta(dataset_dir, s, model_dir)
                if m:
                    self.meta.append(m)
        print(f"Loaded {len(self.meta)} {split} scenes.")

    def __len__(self) -> int:
        return len(self.meta)

    def _load_block_raw(self, paths: Dict):
        """(grid, mask, masked-xyz centroid) of one block, LRU-cached; the
        arrays are shared, so callers that mutate must copy."""
        key = paths["voxel_grid_path"]
        hit = self._block_cache.pop(key, None)
        if hit is None:
            grid = _load_torch_artifact(key).astype(np.float32)
            mask_idx = _load_torch_artifact(paths["voxel_mask_path"]).astype(np.int64)
            r = grid.shape[0]
            mask = np.zeros(r * r * r, bool)
            mask[mask_idx] = True
            centroid = grid.reshape(-1, 7)[mask, :3].mean(axis=0)
            hit = (grid, mask, centroid)
        self._block_cache[key] = hit  # re-inserted: most recently used
        while len(self._block_cache) > max(self.cache_blocks, 1):
            self._block_cache.pop(next(iter(self._block_cache)))
        return hit

    def _load_block(self, paths: Dict):
        grid, mask, _ = self._load_block_raw(paths)
        return grid.copy(), mask.copy()

    def get_raw(self, index: int) -> Dict:
        """The unaugmented cached arrays (shared: do not mutate) and an `aug`
        dict of per-side 4x4 transforms for an augmentation on the device;
        the random swap and the pose update happen here."""
        scene = self.meta[index]
        blocks = list(range(len(scene["blocks"])))
        self.rng.shuffle(blocks)
        src_b, tgt_b = scene["blocks"][blocks[0]], scene["blocks"][blocks[1]]
        src_grid, src_mask, src_c = self._load_block_raw(src_b)
        tgt_grid, tgt_mask, tgt_c = self._load_block_raw(tgt_b)
        src_T = np.asarray(src_b["transform"], np.float64)
        tgt_T = np.asarray(tgt_b["transform"], np.float64)
        pose = (tgt_T @ np.linalg.inv(src_T)).astype(np.float32)

        p_src = np.eye(4, dtype=np.float32)
        p_tgt = np.eye(4, dtype=np.float32)
        jitter = self.split == "train"
        if self.split == "train":
            perturb = _se3_small(self.rng, self.perturb_std)
            perturb_source = self.rng.random() > 0.5
            centroid = src_c if perturb_source else tgt_c
            center = np.eye(4)
            center[:3, 3] = -centroid
            p = (np.linalg.inv(center) @ perturb @ center).astype(np.float32)
            if perturb_source:
                pose = (pose.astype(np.float64)
                        @ np.linalg.inv(p.astype(np.float64))).astype(np.float32)
                p_src = p
            else:
                pose = (p.astype(np.float64) @ pose.astype(np.float64)).astype(np.float32)
                p_tgt = p

        data = {
            "src_grid": src_grid, "tgt_grid": tgt_grid,
            "src_mask": src_mask, "tgt_mask": tgt_mask,
            "src_nerf_path": src_b["model_path"], "tgt_nerf_path": tgt_b["model_path"],
            "src_ply_path": src_b.get("voxel_ply_path", ""),
            "tgt_ply_path": tgt_b.get("voxel_ply_path", ""),
            "src_cache_key": src_b["voxel_grid_path"],
            "tgt_cache_key": tgt_b["voxel_grid_path"],
            "pose": pose, "scene": scene["scene"], "index": index,
            "block_list": blocks[:2],
            "aug": {"p_src": p_src, "p_tgt": p_tgt, "jitter": jitter},
        }
        if self.split == "train" and self.rng.random() > 0.5:
            for k in ("grid", "mask", "nerf_path", "ply_path", "cache_key"):
                data[f"src_{k}"], data[f"tgt_{k}"] = data[f"tgt_{k}"], data[f"src_{k}"]
            data["aug"]["p_src"], data["aug"]["p_tgt"] = (data["aug"]["p_tgt"],
                                                          data["aug"]["p_src"])
            data["pose"] = np.linalg.inv(data["pose"].astype(np.float64)).astype(np.float32)
        return data

    def __getitem__(self, index: int) -> Dict:
        scene = self.meta[index]
        blocks = list(range(len(scene["blocks"])))
        if self.fixed_order is not None:
            blocks = list(self.fixed_order) + [b for b in blocks if b not in self.fixed_order]
        else:
            self.rng.shuffle(blocks)
        src_b, tgt_b = scene["blocks"][blocks[0]], scene["blocks"][blocks[1]]

        src_grid, src_mask = self._load_block(src_b)
        tgt_grid, tgt_mask = self._load_block(tgt_b)
        src_T = np.asarray(src_b["transform"], np.float64)
        tgt_T = np.asarray(tgt_b["transform"], np.float64)
        pose = (tgt_T @ np.linalg.inv(src_T)).astype(np.float32)

        data = {
            "src_grid": src_grid, "tgt_grid": tgt_grid,
            "src_mask": src_mask, "tgt_mask": tgt_mask,
            "src_nerf_path": src_b["model_path"], "tgt_nerf_path": tgt_b["model_path"],
            "src_ply_path": src_b.get("voxel_ply_path", ""),
            "tgt_ply_path": tgt_b.get("voxel_ply_path", ""),
            "pose": pose, "scene": scene["scene"], "index": index,
            "block_list": blocks[:2],
        }
        if self.split == "train":
            self._points_jitter(data, "src")
            self._points_jitter(data, "tgt")
            self._rigid_perturb(data)
            self._random_swap(data)
        else:  # eval grids come back unmodified, keyed by their artifact
            data["src_cache_key"] = src_b["voxel_grid_path"]
            data["tgt_cache_key"] = tgt_b["voxel_grid_path"]
        return data

    # ---------------------------------------------------------- augmentations
    def _points_jitter(self, data: Dict, side: str) -> None:
        grid, mask = data[f"{side}_grid"], data[f"{side}_mask"]
        xyz = grid.reshape(-1, 7)[:, :3]
        noise = np.clip(self.rng.normal(size=(int(mask.sum()), 3)) * self.jitter_scale,
                        -self.jitter_clip, self.jitter_clip).astype(np.float32)
        xyz[mask] += noise

    def _rigid_perturb(self, data: Dict) -> None:
        perturb = _se3_small(self.rng, self.perturb_std)
        perturb_source = self.rng.random() > 0.5
        side = "src" if perturb_source else "tgt"
        grid, mask = data[f"{side}_grid"], data[f"{side}_mask"]
        xyz = grid.reshape(-1, 7)[:, :3]
        centroid = xyz[mask].mean(axis=0)
        center = np.eye(4)
        center[:3, 3] = -centroid
        p = np.linalg.inv(center) @ perturb @ center
        if perturb_source:
            data["pose"] = (data["pose"] @ np.linalg.inv(p)).astype(np.float32)
        else:
            data["pose"] = (p @ data["pose"]).astype(np.float32)
        xyz[mask] = (xyz[mask] @ p[:3, :3].T + p[:3, 3]).astype(np.float32)

    def _random_swap(self, data: Dict) -> None:
        if self.rng.random() > 0.5:
            for k in ("grid", "mask", "nerf_path", "ply_path"):
                data[f"src_{k}"], data[f"tgt_{k}"] = data[f"tgt_{k}"], data[f"src_{k}"]
            data["pose"] = np.linalg.inv(data["pose"]).astype(np.float32)


def device_augment(grid: torch.Tensor, mask: torch.Tensor, p: torch.Tensor,
                   noise: torch.Tensor | None = None, jitter_scale: float = 0.005,
                   jitter_clip: float = 0.05) -> torch.Tensor:
    """The train augmentation of one side on the grid's device (pairs with
    `get_raw`): the masked xyz jitter, clip(noise * jitter_scale, +-clip),
    then the centroid-conjugated rigid transform `p` [4, 4] of the masked
    xyz; rgb, alpha and unmasked rows are untouched. grid [R, R, R, 7],
    mask flat [R^3] bool, noise [R^3, 3] standard normal (the caller draws
    it, from a torch.Generator on the device in the trainer). noise=None or
    jitter_scale=0 skips the jitter."""
    r3 = mask.shape[0]
    flat = grid.reshape(r3, 7)
    xyz = flat[:, :3]
    if noise is not None and jitter_scale != 0:
        xyz = xyz + torch.clamp(noise * jitter_scale, -jitter_clip, jitter_clip) * mask[:, None]
    warped = xyz @ p[:3, :3].T + p[:3, 3]
    xyz = torch.where(mask[:, None], warped, xyz)
    return torch.cat([xyz, flat[:, 3:]], dim=-1).reshape(grid.shape)
