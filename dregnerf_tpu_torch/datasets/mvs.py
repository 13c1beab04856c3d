"""DTU / BlendedMVS loader — native MVS layout and COLMAP fallback (copy
of dregnerf_tpu/datasets/mvs.py, images decoded lazily).

Format parity with the reference conerf/datasets/mvs.py:
  * NATIVE path (`_load_mvs`, reference mvs.py:208-334): the DTU /
    BlendedMVS on-disk layout — `images/`, per-image `cams/<name>_cam.txt`
    (extrinsic 4x4 on lines 1-4, intrinsic 3x3 on lines 7-9, depth range
    on line 11), optional `rendered_depth_maps/<name>.pfm`. Scene scale is
    normalized so the first camera's depth_min maps to 5 (reference
    read_cam_file:244), and near/far come from the scaled depth range.
  * COLMAP path (reference mvs.py:85-205): sparse model + bbox.txt, the
    same machinery as real_world but with val_interval 30.

Auto-detect: the native path is used when `<scene>/cams/` exists.
"""
from __future__ import annotations

import os
import re
from typing import List

import numpy as np

from dregnerf_tpu_torch.datasets.base import SceneData, make_blocks
from dregnerf_tpu_torch.datasets.real_world import _load_colmap

OPENGL = False
SYNTHETIC = False
NEAR, FAR = 0.02, 500.0  # reference mvs.py:338-339 class defaults
VAL_INTERVAL = 30  # reference mvs.py:163,292

_IMG_EXTS = (".png", ".PNG", ".jpg", ".JPG", ".jpeg", ".JPEG")


def read_pfm(filename: str) -> tuple[np.ndarray, float]:
    """Read a PFM depth/color map (reference mvs.py:24-60)."""
    with open(filename, "rb") as f:
        header = f.readline().decode("utf-8").rstrip()
        if header == "PF":
            color = True
        elif header == "Pf":
            color = False
        else:
            raise ValueError("Not a PFM file.")
        dim_match = re.match(r"^(\d+)\s(\d+)\s*$", f.readline().decode("utf-8"))
        if not dim_match:
            raise ValueError("Malformed PFM header.")
        width, height = map(int, dim_match.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    return np.flipud(data.reshape(shape)), scale


def read_cam_file(filename: str, scale_factor: float | None):
    """Parse one `<name>_cam.txt` (reference mvs.py:229-255).

    Returns (K [3,3], extrinsic w2c [4,4] with scaled translation,
    depth_min, depth_max, scale_factor). The first camera pins
    scale_factor = 5 / depth_min.
    """
    with open(filename) as f:
        lines = [line.rstrip() for line in f.readlines()]
    extrinsics = np.fromstring(
        " ".join(lines[1:5]), dtype=np.float32, sep=" "
    ).reshape(4, 4)
    intrinsics = np.fromstring(
        " ".join(lines[7:10]), dtype=np.float32, sep=" "
    ).reshape(3, 3)
    depth_min = float(lines[11].split()[0])
    depth_max = float(lines[11].split()[-1])
    if scale_factor is None:
        scale_factor = 5.0 / depth_min
    depth_min *= scale_factor
    depth_max *= scale_factor
    extrinsics = extrinsics.copy()
    extrinsics[:3, 3] *= scale_factor
    return intrinsics, extrinsics, depth_min, depth_max, scale_factor


def build_proj_mats(pose_files: list[str]):
    """Per-image K + c2w from the cam files (reference mvs.py:208-226)."""
    all_K, c2w = [], []
    scale_factor = None
    depth_min = depth_max = None
    for pose_file in pose_files:
        K, ext, depth_min, depth_max, scale_factor = read_cam_file(
            pose_file, scale_factor
        )
        all_K.append(K)
        c2w.append(np.linalg.inv(ext))
    return np.stack(all_K), np.stack(c2w), depth_min, depth_max


def _load_mvs(root: str, subject_id: str, split: str, factor: int = 1):
    """Native DTU/BlendedMVS layout (reference mvs.py:263-334)."""
    import imageio.v2 as imageio  # decoded only when reading from disk

    data_dir = os.path.join(root, subject_id)
    image_dir = os.path.join(data_dir, "images")
    camera_dir = os.path.join(data_dir, "cams")

    image_files = sorted(
        os.path.join(image_dir, f)
        for f in os.listdir(image_dir)
        if f.endswith(_IMG_EXTS)
    )
    pose_files = [
        os.path.join(
            camera_dir, os.path.splitext(os.path.basename(f))[0] + "_cam.txt"
        )
        for f in image_files
    ]
    all_K, camtoworlds, depth_min, depth_max = build_proj_mats(pose_files)
    K = all_K[0].astype(np.float32).copy()
    K[:2, :] /= factor

    images = np.stack([imageio.imread(p)[..., :3] for p in image_files])
    camtoworlds = camtoworlds[:, :3, :4].astype(np.float32)

    idx = np.arange(len(images))
    sel = (
        idx[idx % VAL_INTERVAL == 0]
        if split == "test"
        else idx[idx % VAL_INTERVAL != 0]
    )
    return images[sel], camtoworlds[sel], K, depth_min, depth_max


def load_aabb(root: str, subject_id: str):
    p = os.path.join(root, subject_id, "sparse", "0", "bbox.txt")
    if os.path.exists(p):
        return np.loadtxt(p).astype(np.float32)[:6]
    return None


def load_blocks(root, subject_id, split, factor=1, multi_blocks=False, num_blocks=1) -> List[SceneData]:
    native = os.path.isdir(os.path.join(root, subject_id, "cams"))
    if native:
        images, camtoworlds, K, near, far = _load_mvs(root, subject_id, split, factor)
    else:
        images, camtoworlds, K, _ = _load_colmap(
            root, subject_id, split, factor, test_every=VAL_INTERVAL
        )
        near, far = NEAR, FAR
    if multi_blocks:
        return make_blocks(
            os.path.join(root, subject_id), images, camtoworlds, K, split,
            num_blocks, VAL_INTERVAL, OPENGL, SYNTHETIC, subject_id,
            near=near, far=far,
        )
    return [
        SceneData(images=images, camtoworlds=camtoworlds, K=K, opengl=OPENGL,
                  synthetic=SYNTHETIC, subject_id=subject_id, split=split,
                  near=near, far=far)
    ]
