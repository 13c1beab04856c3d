"""Hypersim loader — native HDF5 layout and COLMAP fallback (copy of
dregnerf_tpu/datasets/hypersim.py; images and h5py imported lazily).

Format parity with the reference conerf/datasets/hypersim.py:
  * COLMAP path (reference hypersim.py:85-186): sparse model at
    `<scene>/sparse/0` + bbox.txt, images under `images/`, OpenCV cameras,
    val_interval 30.
  * NATIVE path: the Hypersim release layout itself —
    `_detail/cam_XX/camera_keyframe_positions.hdf5` +
    `camera_keyframe_orientations.hdf5` (world-from-camera rotations,
    camera looks down -z with +y up: OpenGL convention), frames under
    `images/scene_cam_XX_final_preview/frame.NNNN.tonemap.jpg` (the
    tonemap naming the reference's `_get_all_image_names` helper scans,
    hypersim.py:50-58), asset-to-meter scale from
    `_detail/metadata_scene.csv`, intrinsics from the dataset's standard
    60-degree horizontal FOV.

Auto-detect: the native path is used when `<scene>/_detail/` exists.
"""
from __future__ import annotations

import csv
import math
import os
import re
from typing import List

import numpy as np

from dregnerf_tpu_torch.datasets.base import SceneData, make_blocks
from dregnerf_tpu_torch.datasets.real_world import _load_colmap

OPENGL = False  # COLMAP-export path (reference OPENGL_CAMERA = False)
SYNTHETIC = False
VAL_INTERVAL = 30  # reference hypersim.py:141,196
FOV_X = math.pi / 3.0  # Hypersim standard horizontal FOV


def _meters_per_asset_unit(detail_dir: str) -> float:
    path = os.path.join(detail_dir, "metadata_scene.csv")
    if not os.path.exists(path):
        return 1.0
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            if row.get("parameter_name") == "meters_per_asset_unit":
                return float(row["parameter_value"])
    return 1.0


def _camera_names(detail_dir: str) -> list[str]:
    """cam_XX dirs (reference `_collect_camera_names`, hypersim.py:30-37)."""
    return sorted(
        d
        for d in os.listdir(detail_dir)
        if d.startswith("cam_") and os.path.isdir(os.path.join(detail_dir, d))
    )


def _tonemap_frames(frame_dir: str) -> tuple[list[str], list[int]]:
    """frame.NNNN.tonemap.* files + ids (reference `_get_all_image_names`,
    hypersim.py:50-58: image_id = filename[6:10])."""
    names, ids = [], []
    for f in os.listdir(frame_dir):
        m = re.match(r"frame\.(\d{4})\.tonemap\.", f)
        if m:
            names.append(os.path.join(frame_dir, f))
            ids.append(int(m.group(1)))
    order = np.argsort(names)
    return [names[i] for i in order], [ids[i] for i in order]


def _load_native(root: str, subject_id: str, split: str, factor: int = 1):
    import imageio.v2 as imageio  # decoded only when reading from disk

    import h5py

    data_dir = os.path.join(root, subject_id)
    detail_dir = os.path.join(data_dir, "_detail")
    scale = _meters_per_asset_unit(detail_dir)

    images, camtoworlds = [], []
    for cam in _camera_names(detail_dir):
        with h5py.File(
            os.path.join(detail_dir, cam, "camera_keyframe_positions.hdf5"), "r"
        ) as f:
            positions = np.asarray(f["dataset"], np.float64) * scale  # [N, 3]
        with h5py.File(
            os.path.join(detail_dir, cam, "camera_keyframe_orientations.hdf5"),
            "r",
        ) as f:
            orientations = np.asarray(f["dataset"], np.float64)  # [N, 3, 3]

        frame_dir = os.path.join(
            data_dir, "images", f"scene_{cam}_final_preview"
        )
        if not os.path.isdir(frame_dir):
            continue
        paths, frame_ids = _tonemap_frames(frame_dir)
        for p, fid in zip(paths, frame_ids):
            img = imageio.imread(p)[..., :3]
            c2w = np.concatenate(
                [orientations[fid], positions[fid][:, None]], axis=1
            ).astype(np.float32)
            images.append(img)
            camtoworlds.append(c2w)

    images = np.stack(images)
    camtoworlds = np.stack(camtoworlds)
    h, w = images.shape[1:3]
    fx = w / (2.0 * math.tan(FOV_X / 2.0))
    K = np.array(
        [[fx, 0, w / 2.0], [0, fx, h / 2.0], [0, 0, 1]], np.float32
    )
    K[:2] /= factor

    idx = np.arange(len(images))
    sel = (
        idx[idx % VAL_INTERVAL == 0]
        if split == "test"
        else idx[idx % VAL_INTERVAL != 0]
    )
    return images[sel], camtoworlds[sel], K


def load_aabb(root: str, subject_id: str):
    p = os.path.join(root, subject_id, "sparse", "0", "bbox.txt")
    if os.path.exists(p):
        return np.loadtxt(p).astype(np.float32)[:6]
    return None


def load_blocks(root, subject_id, split, factor=1, multi_blocks=False, num_blocks=1) -> List[SceneData]:
    native = os.path.isdir(os.path.join(root, subject_id, "_detail"))
    if native:
        images, camtoworlds, K = _load_native(root, subject_id, split, factor)
        opengl = True  # Hypersim native orientations look down -z, +y up
    else:
        images, camtoworlds, K, _ = _load_colmap(
            root, subject_id, split, factor, test_every=VAL_INTERVAL
        )
        opengl = OPENGL
    if multi_blocks:
        return make_blocks(
            os.path.join(root, subject_id), images, camtoworlds, K, split,
            num_blocks, VAL_INTERVAL, opengl, SYNTHETIC, subject_id,
        )
    return [
        SceneData(images=images, camtoworlds=camtoworlds, K=K, opengl=opengl,
                  synthetic=SYNTHETIC, subject_id=subject_id, split=split)
    ]
