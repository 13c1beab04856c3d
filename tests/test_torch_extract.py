"""Port parity for stage 2: voxel extraction (extract/sample_grid.py), the
artifact writer and the evaluator (eval_ngp_nerf.py) against the JAX
package, on one tiny block built and saved by the JAX package and loaded
by the port, with JAX's jitter draw handed to the port.

Tolerances: points 1e-6; rgb, sigma, alpha and the surface scores 1e-5
(f32 everywhere, sums in another order); the masks equal wherever the
score lies more than 1e-4 from its threshold; the written grids equal;
the evaluator's metrics within 1e-4 relative."""
import json
import math
import os
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dregnerf_tpu.extract import sample_grid as jsg
from dregnerf_tpu.io.ply import read_ply as jread_ply
from dregnerf_tpu.models import ngp as jngp
from dregnerf_tpu.ops.packed_grid import PackedGridConfig as JGrid
from dregnerf_tpu.render.renderer import RenderConfig as JRenderConfig
from dregnerf_tpu.runtime import checkpoint as jckpt
from dregnerf_tpu.runtime import ngp_trainer as JT
from dregnerf_tpu_torch import eval_ngp_nerf as teval
from dregnerf_tpu_torch.datasets import fixtures as tfix
from dregnerf_tpu_torch.extract import sample_grid as tsg
from dregnerf_tpu_torch.io.ply import read_ply, write_ply
from dregnerf_tpu_torch.render.renderer import RenderConfig as TRenderConfig
from dregnerf_tpu_torch.runtime import ngp_trainer as TT
from dregnerf_tpu_torch.runtime.config import config_parser as tconfig_parser

RES = 16
AABB = [-1.0, -1.0, -1.0, 1.0, 1.0, 1.0]
GRID = dict(n_levels=2, log2_table_size=10, base_resolution=4, per_level_scale=2.0)
NEAR = 1e-4  # how close to a threshold a score may lie and flip its mask


def _save_jax_block(path):
    """A tiny f32 block written by the JAX checkpoint writer: 2^10-row
    tables scaled x1000, a density head scaled x160 so that sigma spans the
    thresholds, a 16^3 grid with random occupancy, 6 cameras."""
    jcfg = jngp.NGPConfig(grid=JGrid(**GRID), compute_dtype=jnp.float32)
    params = jngp.init_ngp(jax.random.PRNGKey(0), jcfg)
    params["table"] = params["table"] * 1000.0
    params["density_mlp"][1] = params["density_mlp"][1].at[:, 0].multiply(160.0)
    rng = np.random.default_rng(0)
    binary = rng.uniform(size=(RES,) * 3) < 0.3
    cams = tfix.make_scene_data("train", num_views=6, image_size=8).camtoworlds
    meta = {"aabb": AABB, "unbounded": False, "grid_resolution": RES,
            "contraction_type": "aabb", "near_plane": 0.0, "far_plane": 1e10,
            "render_step_size": 2 * math.sqrt(3) / 128, "max_march_steps": 128,
            "camera_poses": np.asarray(cams).tolist(), "block_id": 0, "field": "ngp",
            "model_config": jngp.config_to_meta(jcfg), "step": 64}
    state = {"model": params,
             "occupancy": {"occs": rng.uniform(size=RES**3).astype(np.float32),
                           "binary": binary}}
    jckpt.save_checkpoint(path, state, meta)


@pytest.fixture(scope="module")
def block(tmp_path_factory):
    root = tmp_path_factory.mktemp("block")
    path = str(root / "model" / "model.ckpt")
    _save_jax_block(path)
    jp, jgrid, jmeta, jmc, _ = JT.load_field_from_checkpoint(path)
    tp, tgrid, tmeta, tmc, _ = TT.load_field_from_checkpoint(path, device="cpu")
    key = jax.random.PRNGKey(5)
    n_occ = int(np.asarray(jgrid.binary).sum())
    jitter = np.asarray(jax.random.uniform(key, (n_occ, 3)))  # occupied_voxel_points' draw
    jext = jsg.extract_voxel_features(jp, jmc, jgrid, jmeta, key)
    text = tsg.extract_voxel_features(tp, tmc, tgrid, tmeta, jitter=jitter, device="cpu")
    # the surface scores themselves, at the chunking extraction uses
    rcfg_j = JRenderConfig(contraction="aabb", render_step_size=jmeta["render_step_size"])
    rcfg_t = TRenderConfig(contraction="aabb", render_step_size=tmeta["render_step_size"])
    cams = np.asarray(jmeta["camera_poses"], np.float32)
    jscores = jsg.compute_surface_mask(jp, jmc, jgrid, jnp.asarray(AABB), rcfg_j,
                                       jext["points"], cams, return_scores=True)
    tscores = tsg.compute_surface_mask(tp, tmc, tgrid, torch.tensor(AABB), rcfg_t,
                                       text["points"], cams, return_scores=True)
    return types.SimpleNamespace(root=root, path=path, jext=jext, text=text,
                                 jscores=jscores, tscores=tscores)


def test_points_and_features_match_jax(block):
    j, t = block.jext, block.text
    assert t["points"].shape == j["points"].shape and len(t["points"]) > 500
    np.testing.assert_array_equal(t["indices"], j["indices"])
    np.testing.assert_array_equal(t["resolution"], j["resolution"])
    np.testing.assert_allclose(t["points"], j["points"], rtol=0, atol=1e-6)
    for name in ("rgb", "sigma", "alpha"):
        np.testing.assert_allclose(t[name], j[name], rtol=1e-5, atol=1e-5, err_msg=name)
    far = np.abs(j["sigma"] - tsg.DENSITY_THRESHOLD) > NEAR
    np.testing.assert_array_equal(t["density_mask"][far], j["density_mask"][far])
    assert 0 < t["density_mask"].sum() < len(t["density_mask"])


def test_surface_scores_and_mask_match_jax(block):
    j, t = block.jext, block.text
    np.testing.assert_allclose(block.tscores, block.jscores, rtol=0, atol=1e-5)
    far = np.abs(block.jscores - tsg.SURFACE_CUTOFF) > NEAR
    np.testing.assert_array_equal(t["surface_mask"][far], j["surface_mask"][far])
    np.testing.assert_array_equal(t["surface_mask"], block.tscores >= tsg.SURFACE_CUTOFF)
    both = t["surface_mask"] & t["density_mask"]
    assert 0 < both.sum() < t["density_mask"].sum()


def test_voxel_artifacts_equal_the_jax_writer(block, tmp_path):
    """Both writers on the same extraction: equal grids, masks and PLYs."""
    jsg.save_voxel_artifacts(str(tmp_path / "jax"), block.jext)
    written = tsg.save_voxel_artifacts(str(tmp_path / "port"), block.jext)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.path.basename(p) for p in written) == names == sorted(
        os.listdir(tmp_path / "port"))
    for name in names:
        a, b = tmp_path / "jax" / name, tmp_path / "port" / name
        if name.endswith(".pt"):
            ta, tb = torch.load(a), torch.load(b)
            assert ta.dtype == tb.dtype and torch.equal(ta, tb), name
        else:
            assert a.read_bytes() == b.read_bytes(), name
    grid = torch.load(tmp_path / "port" / "voxel_grid.pt")
    assert grid.shape == (RES, RES, RES, 7)


def test_ply_round_trip_and_jax_reader(tmp_path):
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(50, 3))
    cols = rng.uniform(size=(50, 3))
    write_ply(str(tmp_path / "a.ply"), pts, cols)
    for reader in (read_ply, jread_ply):
        p, c = reader(str(tmp_path / "a.ply"))
        np.testing.assert_array_equal(p, pts)
        np.testing.assert_array_equal(c, (np.clip(cols, 0, 1) * 255).astype(np.uint8))


def test_fixed_viewing_directions_match_jax():
    got = tsg.fixed_viewing_directions()
    np.testing.assert_array_equal(got, jsg.fixed_viewing_directions())
    np.testing.assert_array_equal(got[:, 0], got[:, 1])  # the reference's x == y quirk


def _eval_config(**kw):
    return types.SimpleNamespace(seed=0, sample_budget=1 << 14, max_march_steps=128,
                                 test_chunk_size=512, image_dispatch="", device="cpu", **kw)


def test_evaluator_metrics_match_jax(block, tmp_path, monkeypatch):
    """Evaluator.evaluate() of both packages on the same block and test
    views (32 px, the smallest the LPIPS taps take)."""
    monkeypatch.setenv("DREG_LPIPS_WEIGHTS", str(tmp_path / "absent.npz"))
    scene = tfix.make_scene_data("test", num_views=2, image_size=32)
    dirs = {}
    for pkg in ("jax", "port"):
        dirs[pkg] = tmp_path / pkg
        shutil.copytree(block.root, dirs[pkg])
    want = JT_evaluator(_eval_config(), str(dirs["jax"]), scene).evaluate()
    got = teval.Evaluator(_eval_config(), str(dirs["port"]), scene).evaluate()
    assert sorted(got) == sorted(want) and got["lpips"] is None
    assert got["num_views"] == want["num_views"] == scene.num_images
    for name in ("psnr", "ssim", "lpips_rand_alex"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4, err_msg=name)
    with open(dirs["port"] / "eval" / "metrics.json") as f:
        assert json.load(f) == got


def JT_evaluator(config, model_dir, scene):
    """The root eval_ngp_nerf.py's Evaluator (a script of the JAX package)."""
    import importlib.util

    path = os.path.join(os.path.dirname(__file__), "..", "eval_ngp_nerf.py")
    spec = importlib.util.spec_from_file_location("jax_eval_ngp_nerf", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.Evaluator(config, model_dir, scene)


def test_cli_twin_evaluates_and_extracts(block, tmp_path, monkeypatch):
    """python -m dregnerf_tpu_torch.eval_ngp_nerf on a scene on disk and a
    block directory: metrics.json and the voxel artifacts."""
    monkeypatch.setenv("DREG_LPIPS_WEIGHTS", str(tmp_path / "absent.npz"))
    data = str(tmp_path / "data")
    tfix.make_scene(data, num_views=4, image_size=32)
    shutil.copytree(block.root, tmp_path / "out" / "tiny")
    teval.main(["--dataset", "objaverse", "--root_dir", data, "--scene", "fixture_scene", "--factor", "1",
                "--out_dir", str(tmp_path / "out"), "--expname", "tiny", "--device", "cpu",
                "--test_chunk_size", "512", "--max_march_steps", "128"])
    exp = tmp_path / "out" / "tiny"
    with open(exp / "eval" / "metrics.json") as f:
        metrics = json.load(f)
    assert metrics["num_views"] >= 1 and math.isfinite(metrics["psnr"])
    for kind in ("density_voxel", "voxel"):
        for suffix in ("point_cloud.ply", "grid.pt", "mask.pt"):
            assert (exp / f"{kind}_{suffix}").exists()
    assert torch.load(exp / "voxel_grid.pt").shape == (RES, RES, RES, 7)
    assert tconfig_parser([]).device is None  # the CLI runs on cuda unless asked
