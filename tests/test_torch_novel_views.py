"""The port's novel-view rendering against the JAX package on the CPU:
pose-only rays (datasets/pose_only.py), synthesize_novel_views and
render_pair_views (render/novel_views.py) on blocks the JAX package wrote,
the jet colormap, the PNG writer, frames_to_video and the evaluator's orbit.

Tolerances: intrinsics equal and rays within 1e-6; the rendered f32 images
within 1e-5 of their max, depths within 1e-5 of theirs, PNG pixels within
1 (a truncation to uint8 can move a pixel by one step); pair frames as
torch_views_common.assert_pair_frames_match states; colorize_np bit for
bit.

The JAX renders go through its per-chunk jit (`image_dispatch="hostloop"`):
the same computation as its default lax.map, compiled once for all images.
"""
import os
import shutil
import subprocess

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eval_nerf_regtr as jeval
from dregnerf_tpu.datasets import pose_only as jpo
from dregnerf_tpu.geometry import cameras as jcameras
from dregnerf_tpu.render import novel_views as jnv
from dregnerf_tpu.render import renderer as jrenderer
from dregnerf_tpu.utils import visualization as jvis
from dregnerf_tpu_torch import eval_nerf_regtr as pev
from dregnerf_tpu_torch.datasets import pose_only as ppo
from dregnerf_tpu_torch.render import novel_views as pnv
from dregnerf_tpu_torch.utils import png
from dregnerf_tpu_torch.utils import visualization as pvis
from torch_views_common import (  # noqa: F401 (fixtures)
    assert_pair_frames_match, camera_ring, jax_hostloop, one_torch_thread, save_jax_block)

_jit_image_rays = jax.jit(jcameras.image_rays, static_argnums=(2, 3, 4))
DATASETS = ["objaverse", "nerf_synthetic", "scannerf", "dtu", "BlendedMVS", "unknown_name"]
FACTORS = [1, 4, 8, 16]


@pytest.fixture(scope="module")
def blocks(tmp_path_factory):
    root = tmp_path_factory.mktemp("views")
    return [save_jax_block(str(root / f"block_{k}.ckpt"), seed=k) for k in (0, 1)]


@pytest.mark.parametrize("dataset", DATASETS)
def test_intrinsics_and_pose_only_rays_match_jax(dataset):
    pose = camera_ring(3, phase=0.7)
    for factor in FACTORS:
        K, h, w, opengl = ppo.intrinsics_for(dataset, factor)
        jK, jh, jw, jopengl = jpo.intrinsics_for(dataset, factor)
        assert (h, w, opengl) == (jh, jw, jopengl) and K.dtype == jK.dtype == np.float32
        np.testing.assert_array_equal(K, jK)
        if dataset == "unknown_name":  # objaverse's cameras, checked under that name
            continue
        got = ppo.NeRFPoseOnlyDataset(pose, dataset, factor, device="cpu")
        want = jpo.NeRFPoseOnlyDataset(pose, dataset, factor)
        assert len(got) == len(want) == 3
        # what want[2] computes, jitted: one compile a shape instead of one an op
        rays, jrays = got[2], _jit_image_rays(jnp.asarray(want.K), jnp.asarray(want.poses[2]),
                                              want.height, want.width, want.opengl)
        assert rays.origins.shape == (h, w, 3)
        for a, b in ((rays.origins, jrays.origins), (rays.viewdirs, jrays.viewdirs)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    if dataset == "objaverse":
        K, h, w, _ = ppo.intrinsics_for(dataset, 8)
        assert (h, w) == (100, 100) and np.isclose(K[0, 0], 875 / 8)


def test_pose_only_dataset_runs_on_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ppo.NeRFPoseOnlyDataset(camera_ring(1))


def _spy(monkeypatch, module, name):
    """Record each (rgb, depth) the wrapped render returns."""
    real, seen = getattr(module, name), []

    def spy(*args, **kwargs):
        rgb, opacity, depth = real(*args, **kwargs)
        seen.append(tuple(x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
                          for x in (rgb, depth)))
        return rgb, opacity, depth

    monkeypatch.setattr(module, name, spy)
    return seen


def test_synthesize_novel_views_matches_jax(blocks, tmp_path, monkeypatch, one_torch_thread):
    """Both packages render a JAX-written block from 2 poses moved by a
    transform, at factor 16 (50 x 50): the f32 images, the PNGs (also read
    back by imageio, and the port's bytes by its own reader) and the depths."""
    poses = camera_ring(2, phase=0.4)
    transform = np.eye(4)
    transform[:3, :3] = [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]
    transform[:3, 3] = [0.05, -0.1, 0.02]
    jseen = _spy(monkeypatch, jrenderer, "render_image_chunked")
    pseen = _spy(monkeypatch, pnv, "render_image_chunked")
    want = jnv.synthesize_novel_views(blocks[0], poses, str(tmp_path / "j"), factor=16,
                                      transform=transform)
    got = pnv.synthesize_novel_views(blocks[0], poses, str(tmp_path / "p"), factor=16,
                                     transform=transform, device="cpu")
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want] == \
        ["frame_0000.png", "frame_0001.png"]
    assert len(jseen) == len(pseen) == 2
    for (jrgb, jdepth), (prgb, pdepth) in zip(jseen, pseen):
        assert prgb.shape == (2500, 3) and pdepth.shape == (2500,)
        np.testing.assert_allclose(prgb, jrgb, rtol=0, atol=1e-5 * np.abs(jrgb).max())
        np.testing.assert_allclose(pdepth, jdepth, rtol=0, atol=1e-5 * np.abs(jdepth).max())
    for i, (p, j) in enumerate(zip(got, want)):
        pixels, jpixels = imageio.imread(p), imageio.imread(j)
        assert pixels.shape == (50, 50, 3) and pixels.dtype == np.uint8
        np.testing.assert_array_equal(png.read_png(p), pixels)
        assert np.abs(pixels.astype(int) - jpixels).max() <= 1
        assert 0.05 < (pixels < 250).any(-1).mean() < 0.95  # the frame shows the block
        d, jd = (np.load(os.path.join(os.path.dirname(x), f"depth_{i:04d}.npy")) for x in (p, j))
        assert d.shape == (50, 50) and d.dtype == jd.dtype == np.float32
        np.testing.assert_allclose(d, jd, rtol=0, atol=1e-5 * np.abs(jd).max())


def test_render_pair_views_matches_jax(blocks, tmp_path, one_torch_thread):
    poses = camera_ring(3, phase=0.2)
    transform = np.eye(4)[:3]
    transform[:, 3] = [0.1, 0.0, -0.05]
    got = pnv.render_pair_views(blocks[0], blocks[1], poses, transform, str(tmp_path / "p"),
                                "aligned", device="cpu")
    want = jnv.render_pair_views(blocks[0], blocks[1], poses, transform, str(tmp_path / "j"),
                                 "aligned")
    assert (got is None) == (want is None) == (shutil.which("ffmpeg") is None)
    assert_pair_frames_match(str(tmp_path / "p"), str(tmp_path / "j"), "aligned", 3)


@pytest.mark.parametrize("case", ["plain", "mask", "range", "mask_range", "nan", "empty_mask"])
def test_colorize_np_matches_jax(case):
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(31, 47)) * 4).astype(np.float32)
    mask = rng.uniform(size=x.shape) < 0.5
    kw = {"plain": {}, "mask": {"mask": mask}, "range": {"value_range": (-2.0, 3.0)},
          "mask_range": {"mask": mask, "value_range": (0.0, 1.0)}, "nan": {},
          "empty_mask": {"mask": np.zeros_like(mask)}}[case]
    if case == "nan":
        x[4, 5] = np.nan
        x[0, :3] = [0.0, 1.0, 1.0]
    got, want = pvis.colorize_np(x, **kw), jvis.colorize_np(x, **kw)
    assert got.dtype == want.dtype == np.float32 and got.shape == (31, 47, 3)
    np.testing.assert_array_equal(got, want)


def test_jet_table_is_matplotlibs():
    import matplotlib

    cmap = matplotlib.colormaps["jet"]
    x = np.linspace(0, 1, 4097, dtype=np.float32)
    np.testing.assert_array_equal(pvis.colorize_np(x[None], value_range=(0.0, 1.0))[0],
                                  cmap(x)[:, :3].astype(np.float32))
    np.testing.assert_array_equal(pvis.colorize_np(x[None], "viridis")[0],
                                  jvis.colorize_np(x[None], "viridis")[0])


def test_depth_visualization_and_colorbar_match_jax():
    depth = np.random.default_rng(5).uniform(0.5, 4.0, (40, 30)).astype(np.float32)
    depth[:3] = 0.0
    for minmax in (None, (1.0, 3.0)):
        got, rng_got = pvis.visualize_depth_numpy(depth, minmax)
        want, rng_want = jvis.visualize_depth_numpy(depth, minmax)
        np.testing.assert_array_equal(got, want)
        assert rng_got == rng_want
    np.testing.assert_array_equal(pvis.colorize_with_colorbar(depth, label="depth"),
                                  jvis.colorize_with_colorbar(depth, label="depth"))


def test_port_png_bytes_decode_to_the_pixels_jax_writes(tmp_path):
    """JAX writes a frame through imageio; the port writes the same pixels
    with its own encoder: imageio decodes the port's file to JAX's pixels."""
    img = np.random.default_rng(0).uniform(size=(37, 53, 3)).astype(np.float32)
    pixels = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    imageio.imwrite(tmp_path / "jax.png", pixels)
    png.write_png(str(tmp_path / "port.png"), pixels)
    jax_pixels = imageio.imread(tmp_path / "jax.png")
    np.testing.assert_array_equal(imageio.imread(tmp_path / "port.png"), jax_pixels)
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "port.png")), jax_pixels)
    with pytest.raises(ValueError, match="uint8"):
        png.write_png(str(tmp_path / "bad.png"), img)


@pytest.mark.parametrize("ffmpeg", [None, "/usr/bin/ffmpeg"])
def test_frames_to_video(ffmpeg, tmp_path, monkeypatch):
    """Without ffmpeg on PATH both return False; with it, both run the same
    command and return True."""
    calls = []

    def run(cmd, **kwargs):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(shutil, "which", lambda name: ffmpeg if name == "ffmpeg" else None)
    monkeypatch.setattr(subprocess, "run", run)
    got = pnv.frames_to_video(str(tmp_path), str(tmp_path / "v.mp4"), fps=4)
    want = jnv.frames_to_video(str(tmp_path), str(tmp_path / "v.mp4"), fps=4)
    assert got == want == (ffmpeg is not None)
    assert len(calls) == (2 if ffmpeg else 0)
    if ffmpeg:
        assert calls[0] == calls[1] and calls[0][0] == "ffmpeg"


def test_orbit_poses_match_jax():
    got = pev.RegEvaluator._orbit_poses()
    assert got.shape == (12, 4, 4)
    np.testing.assert_array_equal(got, jeval.RegEvaluator._orbit_poses())
    np.testing.assert_array_equal(pev.RegEvaluator._orbit_poses(5),
                                  jeval.RegEvaluator._orbit_poses(5))


def test_tv_loss_matches_jax():
    x = np.random.default_rng(2).normal(size=(2, 3, 9, 11)).astype(np.float32)
    got = pvis.tv_loss(torch.from_numpy(x), 0.5)
    want = jvis.tv_loss(jnp.asarray(x), 0.5)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
