"""Novel-view synthesis and video export for registration evaluation (port
of dregnerf_tpu/render/novel_views.py).

Render a NeRF checkpoint from a list of poses (optionally moved by a
registration pose), write PNG frames and depth arrays, put the src and tgt
renders side by side, and assemble an mp4 with ffmpeg when it is on PATH.
PNGs are written and read by utils/png.py: the card's machine has no
imageio.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import subprocess
from typing import Optional

import numpy as np
import torch

from dregnerf_tpu_torch.datasets.pose_only import NeRFPoseOnlyDataset
from dregnerf_tpu_torch.device import resolve_device
from dregnerf_tpu_torch.render.renderer import render_image_chunked
from dregnerf_tpu_torch.runtime.ngp_trainer import load_field_from_checkpoint
from dregnerf_tpu_torch.utils.png import read_png, write_png
from dregnerf_tpu_torch.utils.visualization import colorize_np


def synthesize_novel_views(
    ckpt_path: str,
    poses: np.ndarray,
    out_dir: str,
    dataset: str = "objaverse",
    factor: int = 4,
    transform: Optional[np.ndarray] = None,
    chunk_size: int = 8192,
    device=None,
) -> list:
    """Render each pose from the checkpointed NeRF on `device` (default
    cuda) over a white background: frame_%04d.png and depth_%04d.npy in
    `out_dir`; returns the frame paths."""
    dev = resolve_device(device)
    params, grid, meta, model_cfg, render_cfg = load_field_from_checkpoint(ckpt_path, dev)
    render_cfg = dataclasses.replace(render_cfg, chunk_size=chunk_size)
    poses = np.asarray(poses, np.float32)[:, :3, :4]
    if transform is not None:
        t = np.asarray(transform, np.float64)
        homo = np.concatenate(
            [poses, np.tile(np.array([[[0, 0, 0, 1.0]]]), (len(poses), 1, 1))], axis=1)
        t4 = np.eye(4)
        t4[:3, :4] = t[:3, :4]
        poses = (t4 @ homo)[:, :3, :4].astype(np.float32)

    ds = NeRFPoseOnlyDataset(poses, dataset, factor, device=dev)
    os.makedirs(out_dir, exist_ok=True)
    aabb = torch.tensor(meta["aabb"], dtype=torch.float32, device=dev)
    background = torch.ones(3, device=dev)
    paths = []
    for i in range(len(ds)):
        rays = ds[i]
        rgb, _, depth = render_image_chunked(
            params, model_cfg, grid, rays.origins.reshape(-1, 3), rays.viewdirs.reshape(-1, 3),
            aabb, render_cfg, background, device=dev)
        img = np.clip(rgb.cpu().numpy().reshape(ds.height, ds.width, 3), 0, 1)
        p = os.path.join(out_dir, f"frame_{i:04d}.png")
        write_png(p, (img * 255).astype(np.uint8))
        paths.append(p)
        np.save(os.path.join(out_dir, f"depth_{i:04d}.npy"),
                depth.cpu().numpy().reshape(ds.height, ds.width))
    return paths


def render_pair_views(
    src_ckpt: str,
    tgt_ckpt: str,
    poses: np.ndarray,
    pose_src_to_tgt: Optional[np.ndarray],
    out_dir: str,
    prefix: str,
    dataset: str = "objaverse",
    factor: int = 8,
    chunk_size: int = 8192,
    fps: int = 4,
    device=None,
) -> Optional[str]:
    """Fused-scene render: the SRC NeRF at `poses` (src frame) and the TGT
    NeRF at the same cameras mapped into the tgt frame by `pose_src_to_tgt`
    (None: unaligned, the same poses in both frames); side-by-side
    [src rgb | src depth | tgt rgb | tgt depth] frames and an mp4.

    Returns the mp4 path, or None without ffmpeg (the frames are written)."""
    src_dir = os.path.join(out_dir, f"{prefix}_src_images")
    tgt_dir = os.path.join(out_dir, f"{prefix}_tgt_images")
    pair_dir = os.path.join(out_dir, f"{prefix}_images")
    os.makedirs(pair_dir, exist_ok=True)

    src_frames = synthesize_novel_views(src_ckpt, poses, src_dir, dataset, factor, None,
                                        chunk_size, device)
    tgt_frames = synthesize_novel_views(tgt_ckpt, poses, tgt_dir, dataset, factor,
                                        pose_src_to_tgt, chunk_size, device)
    for i, (sp, tp) in enumerate(zip(src_frames, tgt_frames)):
        src_rgb = np.asarray(read_png(sp), np.float32) / 255.0
        tgt_rgb = np.asarray(read_png(tp), np.float32) / 255.0
        src_d = colorize_np(np.load(os.path.join(src_dir, f"depth_{i:04d}.npy")))
        tgt_d = colorize_np(np.load(os.path.join(tgt_dir, f"depth_{i:04d}.npy")))
        pair = np.concatenate([src_rgb, src_d, tgt_rgb, tgt_d], axis=1)
        write_png(os.path.join(pair_dir, f"frame_{i:04d}.png"),
                  (np.clip(pair, 0, 1) * 255).astype(np.uint8))
    mp4 = os.path.join(out_dir, f"{prefix}_src_tgt_rgb_depth.mp4")
    ok = frames_to_video(pair_dir, mp4, fps=fps)
    return mp4 if ok else None


def frames_to_video(frame_dir: str, out_path: str, fps: int = 24) -> bool:
    """PNG frames -> mp4 through ffmpeg; False when ffmpeg is not on PATH or
    fails."""
    if shutil.which("ffmpeg") is None:
        return False
    cmd = [
        "ffmpeg", "-y", "-framerate", str(fps),
        "-pattern_type", "glob", "-i", os.path.join(frame_dir, "frame_*.png"),
        "-c:v", "libx264", "-pix_fmt", "yuv420p", out_path,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
