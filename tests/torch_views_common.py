"""Tiny NGP blocks written by the JAX package for the port's novel-view
tests (tests/test_torch_novel_views.py, test_torch_reg_eval.py), built as
tests/test_torch_extract.py builds its block: a JAX `init_ngp` at 2
levels x 2^10 rows, the table scaled x1000 and the density head x160, a
random 16^3 occupancy grid, no training. The MLPs are narrowed and the
march is cut to VIEW_MAX_STEPS steps of VIEW_STEP so that a 100 x 100
render stays cheap on the CPU. The box is moved off the origin by a few
hundredths so that the central rays of cameras that look at the origin
do not run along the occupancy grid's voxel planes, where the two
packages' float orders may put a sample on either side (a tie, not a
difference). Not a test module."""
import dataclasses
import os

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dregnerf_tpu.models import ngp as jngp
from dregnerf_tpu.ops.packed_grid import PackedGridConfig as JGrid
from dregnerf_tpu.runtime import checkpoint as jckpt
from dregnerf_tpu.runtime import ngp_trainer as JT

RES = 16
GRID = dict(n_levels=2, log2_table_size=10, base_resolution=4, per_level_scale=2.0)
VIEW_MAX_STEPS = 8
VIEW_STEP = 0.3
AABB = [-1.02, -0.97, -1.01, 0.98, 1.03, 0.99]


def camera_ring(n, radius=3.0, height=0.5, phase=0.0):
    """n camera-to-world [3, 4] poses on a ring, each looking at the origin
    (OpenGL axes: the camera looks down its -z)."""
    poses = []
    for i in range(n):
        th = phase + 2 * np.pi * i / n
        eye = np.array([radius * np.cos(th), radius * np.sin(th), height])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        poses.append(np.stack([right, up, -fwd, eye], axis=1))
    return np.stack(poses).astype(np.float32)


def save_jax_block(path, seed=0):
    """Write the block's checkpoint with the JAX checkpoint writer."""
    jcfg = jngp.NGPConfig(grid=JGrid(**GRID), geo_feat_dim=7, hidden_dim=16, sh_degree=2,
                          compute_dtype=jnp.float32)
    params = jngp.init_ngp(jax.random.PRNGKey(seed), jcfg)
    params["table"] = params["table"] * 1000.0
    params["density_mlp"][1] = params["density_mlp"][1].at[:, 0].multiply(160.0)
    rng = np.random.default_rng(seed)
    binary = np.ones((RES,) * 3, bool)
    meta = {"aabb": AABB, "unbounded": False,
            "grid_resolution": RES, "contraction_type": "aabb", "near_plane": 0.0,
            "far_plane": 1e10, "render_step_size": VIEW_STEP, "max_march_steps": VIEW_MAX_STEPS,
            "camera_poses": camera_ring(4).tolist(), "block_id": seed, "field": "ngp",
            "model_config": jngp.config_to_meta(jcfg), "step": 64}
    state = {"model": params,
             "occupancy": {"occs": rng.uniform(size=RES**3).astype(np.float32),
                           "binary": binary}}
    jckpt.save_checkpoint(path, state, meta)
    return path


@pytest.fixture(autouse=True)
def jax_hostloop(monkeypatch):
    """The JAX package renders through its per-chunk jit
    (`image_dispatch="hostloop"`): the same computation as its default
    lax.map, compiled once for all images instead of once an image."""
    real = JT.load_field_from_checkpoint

    def load(path):
        params, grid, meta, mc, rc = real(path)
        return params, grid, meta, mc, dataclasses.replace(rc, image_dispatch="hostloop")

    monkeypatch.setattr(JT, "load_field_from_checkpoint", load)


@pytest.fixture
def one_torch_thread():
    """A render runs many short torch ops on 10^4 rays. On cores shared by
    several test processes, torch's intra-op pool then spends most of its
    time waiting on its own threads (a renders-heavy test ran ten times
    slower under load than alone), so such a test runs torch on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jet_index(depth):
    x = np.asarray(depth, np.float32)
    norm = np.clip((x - float(x.min())) / max(float(x.max()) - float(x.min()), 1e-9), 0, 1)
    return np.minimum((norm * np.float32(256)).astype(int), 255)


def assert_pair_frames_match(port_dir, jax_dir, prefix, n):
    """src, tgt and pair frames of one tag: the rgb within 1, the depths
    within 1e-4 of their max (over 24 renders of 10^4 rays, one saturated
    ray's depth was seen 3e-5 off), a pair frame's depth halves within 1
    where both depths take the same jet entry and on neighbouring entries
    elsewhere."""
    for i in range(n):
        frames = {}
        for side in ("src", "tgt"):
            sub = f"{prefix}_{side}_images"
            got = imageio.imread(os.path.join(port_dir, sub, f"frame_{i:04d}.png")).astype(int)
            want = imageio.imread(os.path.join(jax_dir, sub, f"frame_{i:04d}.png")).astype(int)
            assert got.shape == (100, 100, 3) and np.abs(got - want).max() <= 1, (sub, i)
            d = np.load(os.path.join(port_dir, sub, f"depth_{i:04d}.npy"))
            jd = np.load(os.path.join(jax_dir, sub, f"depth_{i:04d}.npy"))
            np.testing.assert_allclose(d, jd, rtol=0, atol=1e-4 * np.abs(jd).max())
            frames[side] = (_jet_index(d), _jet_index(jd))
        pair = imageio.imread(os.path.join(port_dir, f"{prefix}_images", f"frame_{i:04d}.png"))
        jpair = imageio.imread(os.path.join(jax_dir, f"{prefix}_images", f"frame_{i:04d}.png"))
        assert pair.shape == jpair.shape == (100, 400, 3)
        diff = np.abs(pair.astype(int) - jpair).max(-1)
        assert diff[:, :100].max() <= 1 and diff[:, 200:300].max() <= 1, (prefix, i)
        for side, cols in (("src", slice(100, 200)), ("tgt", slice(300, 400))):
            idx, jidx = frames[side]
            same = idx == jidx
            assert diff[:, cols][same].max(initial=0) <= 1, (prefix, side, i)
            assert np.abs(idx - jidx).max() <= 1 and same.mean() > 0.99, (prefix, side, i)
