"""The port's registration dataset, checkpoint reading and evaluation CLI
against the JAX package, on the CPU, on a two-block R = 16 fixture scene."""
import json
import os
import shutil
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import eval_nerf_regtr as jax_eval_cli
from dregnerf_tpu.datasets import register_pairs as jrp
from dregnerf_tpu.render import novel_views as jnv
from dregnerf_tpu.runtime import checkpoint as jckpt
from dregnerf_tpu_torch import eval_nerf_regtr as pev
from dregnerf_tpu_torch.datasets import register_pairs as prp
from dregnerf_tpu_torch.datasets.base import save_world_frame_transforms
from dregnerf_tpu_torch.io.ply import write_ply
from dregnerf_tpu_torch.models import regtr as pregtr
from dregnerf_tpu_torch.runtime.config import config_parser
from dregnerf_tpu_torch.runtime.reg_trainer import make_reg_model, to_device
from torch_views_common import assert_pair_frames_match, save_jax_block
from torch_views_common import jax_hostloop, one_torch_thread  # noqa: F401 (fixtures)

R = 16


def _rigid(angle_deg, axis, trans):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    a = np.deg2rad(angle_deg)
    out = np.eye(4)
    out[:3, :3] = np.eye(3) + np.sin(a) * k + (1 - np.cos(a)) * k @ k
    out[:3, 3] = trans
    return out


def _write_scene(root, subject, seed, transforms_next_to_models=False):
    """Two blocks: block 1 is block 0 with its occupied xyz mapped by T."""
    rng = np.random.default_rng(seed)
    grid = np.zeros((R, R, R, 7), np.float32)
    ii = np.unique(rng.integers(2, R - 2, size=(300, 3)), axis=0)
    flat = ii[:, 0] * R * R + ii[:, 1] * R + ii[:, 2]
    grid.reshape(-1, 7)[flat, :3] = (ii + 0.5) / R * 2.0 - 1.0
    grid.reshape(-1, 7)[flat, 3:6] = rng.uniform(size=(len(flat), 3))
    grid.reshape(-1, 7)[flat, 6] = 1.0
    T = _rigid(30.0, [1.0, 1.0, 0.3], [0.1, 0.0, 0.05])
    moved = grid.copy()
    xyz = moved.reshape(-1, 7)[flat, :3]
    moved.reshape(-1, 7)[flat, :3] = (xyz @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    model_dir = os.path.join(root, "nerf_models", subject)
    for b, g in enumerate((grid, moved)):
        block_dir = os.path.join(model_dir, f"block_{b}")
        os.makedirs(block_dir)
        torch.save(torch.from_numpy(g), os.path.join(block_dir, "voxel_grid.pt"))
        torch.save(torch.from_numpy(flat.astype(np.int64)), os.path.join(block_dir, "voxel_mask.pt"))
        write_ply(os.path.join(block_dir, "voxel_point_cloud.ply"),
                  g.reshape(-1, 7)[flat, :3], g.reshape(-1, 7)[flat, 3:6])
        with open(os.path.join(block_dir, "model.ckpt"), "wb"):
            pass  # a placeholder: stage 3 reads only the voxel artifacts
    where = model_dir if transforms_next_to_models else os.path.join(root, "images", subject)
    os.makedirs(where, exist_ok=True)
    save_world_frame_transforms(where, {0: np.eye(4), 1: T})
    return T


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """<root>/objaverse holds the first train and the first test subject
    of the split JSONs; <root>/single holds one more scene."""
    root = tmp_path_factory.mktemp("reg_scenes")
    names = {s: prp.load_split_subjects("", "objaverse", s)[0] for s in ("train", "test")}
    for i, (split, name) in enumerate(names.items()):
        _write_scene(os.path.join(root, "objaverse"), name, seed=i,
                     transforms_next_to_models=split == "test")
    T = _write_scene(os.path.join(root, "single"), "fixture", seed=7)
    return str(root), names, T


def test_split_jsons_are_copies():
    here = os.path.dirname(jrp.__file__)
    for name in ("objaverse.json", "obj_id_names.json"):
        with open(os.path.join(here, "register", name), "rb") as a, \
                open(os.path.join(prp.JSON_DIR, name), "rb") as b:
            assert a.read() == b.read()
    for split in ("train", "test"):
        assert prp.load_split_subjects("", "objaverse", split) == \
            jrp.load_split_subjects("", "objaverse", split)


def _assert_items_equal(a, b):
    assert set(a) == set(b)
    for k, v in a.items():
        if k == "aug":
            for kk in v:
                np.testing.assert_array_equal(v[kk], b[k][kk])
        elif isinstance(v, np.ndarray):
            assert v.dtype == b[k].dtype, k
            np.testing.assert_array_equal(v, b[k], err_msg=k)
        else:
            assert v == b[k], k


@pytest.mark.parametrize("split", ["train", "test"])
def test_dataset_matches_jax(scenes, split):
    """Same seed, same items: grids, masks, pose, block order, paths; the
    train split's jitter, perturbation and swap draw the same numbers."""
    root, _, _ = scenes
    kw = dict(json_dir="", split=split, seed=3)
    want = jrp.NeRFRegDataset(os.path.join(root), "objaverse", **kw)
    got = prp.NeRFRegDataset(os.path.join(root), "objaverse", **kw)
    assert len(got) == len(want) == 1
    for _ in range(4):
        _assert_items_equal(want[0], got[0])
        _assert_items_equal(want.get_raw(0), got.get_raw(0))


def test_dataset_single_scene_pose(scenes):
    root, _, T = scenes
    ds = prp.NeRFRegDataset(os.path.join(root, "single"), subject_id="fixture", split="test",
                            seed=0)
    ds.fixed_order = (0, 1)
    item = ds[0]
    np.testing.assert_allclose(item["pose"], T.astype(np.float32), atol=1e-6)
    assert item["block_list"] == [0, 1]
    assert item["src_grid"].shape == (R, R, R, 7) and item["src_mask"].shape == (R ** 3,)


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A RegTrainer-layout checkpoint written by the JAX package's
    runtime/checkpoint.py (default-width model, d 64 to keep it small)."""
    cfg = config_parser(["--position_embedding_dim", "64"])
    model = make_reg_model(cfg)
    rng = np.random.default_rng(11)
    tree = pregtr.random_jax_params(model, rng)
    w = rng.normal(size=(64, 64)).astype(np.float32)
    path = str(tmp_path_factory.mktemp("reg_ckpt") / "model.ckpt")
    jckpt.save_checkpoint(path, {"params": {"model": tree, "infonce_W": w}}, {"step": 5})
    return path, tree, w


def test_jax_checkpoint_loads_into_the_port(jax_checkpoint):
    path, tree, w = jax_checkpoint
    got_tree, got_w, meta = pev.load_reg_checkpoint(path)
    assert meta["step"] == 5
    np.testing.assert_array_equal(got_w, w)
    for (p, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                              jax.tree_util.tree_flatten_with_path(got_tree)[0]):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(p))


def test_port_checkpoint_loads_into_jax(jax_checkpoint, tmp_path):
    path, tree, w = jax_checkpoint
    out = str(tmp_path / "port.ckpt")
    pev.save_reg_checkpoint(out, tree, w, {"step": 6})
    template = {"params": {"model": jax.tree_util.tree_map(np.zeros_like, tree),
                           "infonce_W": np.zeros_like(w)}}
    state, meta = jckpt.load_checkpoint(out, template)
    assert meta["step"] == 6
    np.testing.assert_array_equal(np.asarray(state["params"]["infonce_W"]), w)
    np.testing.assert_array_equal(
        np.asarray(state["params"]["model"]["decoder"]["q_proj"]["kernel"]),
        tree["decoder"]["q_proj"]["kernel"])


def _assert_written_as_jax_writes(eval_dir, tmp_path):
    """metrics_test.json and fgr_metrics_test.json hold what JAX's
    RegEvaluator._agg_and_write writes for the same per-scene entries: the
    same keys, and aggregates from the same `agg`."""
    import importlib.util

    path = os.path.join(os.path.dirname(__file__), "..", "eval_nerf_regtr.py")
    spec = importlib.util.spec_from_file_location("jax_eval_nerf_regtr", path)
    jax_eval = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_eval)

    with open(eval_dir / "metrics_test.json") as f:
        metrics = json.load(f)
    with open(eval_dir / "fgr_metrics_test.json") as f:
        fgr = json.load(f)
    jax_dir = tmp_path / "jax_written"
    jax_dir.mkdir()
    jax_eval.RegEvaluator._agg_and_write(SimpleNamespace(output_dir=str(jax_dir)),
                                   metrics["per_scene"], fgr["per_scene"])
    for name, got in (("metrics_test.json", metrics), ("fgr_metrics_test.json", fgr)):
        with open(jax_dir / name) as f:
            assert json.load(f) == got, name
    for entry in fgr["per_scene"].values():
        assert set(entry) == {"R_error_deg", "t_error", "time", "winner"}
        assert set(entry["winner"]) == {"method", "voxel", "dir", "score"}
    assert fgr["aggregate"]["num_pairs"] == len(fgr["per_scene"]) == 1
    return metrics, fgr


def test_eval_cli_writes_metrics_and_matches_the_model(scenes, jax_checkpoint, tmp_path):
    """`python -m dregnerf_tpu_torch.eval_nerf_regtr --device cpu` on the
    JAX-written checkpoint, at the default bf16: metrics_test.json, the
    classical baseline's fgr_metrics_test.json in JAX's layout, and the
    per-scene files, with the pose of the port model called directly."""
    root, _, T = scenes
    path, tree, _ = jax_checkpoint
    argv = ["--root_dir", os.path.join(root, "single"), "--scene", "fixture",
            "--out_dir", str(tmp_path), "--expname", "reg", "--ckpt_path", path,
            "--position_embedding_dim", "64", "--device", "cpu"]
    metrics = pev.main(argv)
    eval_dir = tmp_path / "reg" / "eval"
    with open(eval_dir / "metrics_test.json") as f:
        assert json.load(f) == json.loads(json.dumps(metrics))
    assert metrics["aggregate"]["num_pairs"] == 1
    assert not any(k.endswith("_icp") or k.startswith("icp_")
                   for k in metrics["per_scene"]["fixture"])
    _assert_written_as_jax_writes(eval_dir, tmp_path)
    scene_dir = eval_dir / "fixture"
    for name in ("transformation_est.json", "pose_est.pt", "pose_gt.pt", "src_unaligned.ply",
                 "src_aligned.ply", "tgt.ply", "src_xyz.ply", "tgt_kp_warped.ply",
                 "all_src_xyz.ply", "noisy_point_cloud_pred.ply", "point_cloud_gt.ply"):
        assert (scene_dir / name).exists(), name
    with open(scene_dir / "transformation_est.json") as f:
        written = json.load(f)

    # the same item, the same weights, the model called directly
    cfg = config_parser(argv)
    ds = prp.NeRFRegDataset(cfg.root_dir, subject_id="fixture", split="test", seed=cfg.seed)
    item = ds[0]
    model = make_reg_model(cfg, torch.bfloat16)
    model.load_state_dict(pregtr.params_from_jax(tree, model))
    with torch.no_grad():
        pose = model(to_device(item, torch.device("cpu")))["pose"][-1].numpy()
    np.testing.assert_array_equal(np.asarray(written["pose_est"], np.float32), pose)
    np.testing.assert_allclose(written["pose_gt"], item["pose"][:3, :4])
    rot = pose[:, :3]
    np.testing.assert_allclose(rot @ rot.T, np.eye(3), atol=1e-5)
    assert torch.load(scene_dir / "pose_est.pt").shape == (3, 4)


def test_eval_cli_icp_refine_polishes_the_pose(scenes, jax_checkpoint, tmp_path):
    """`--icp_refine --device cpu`: the per-scene *_icp keys hold the
    errors of icp_refine run on the model's pose (as JAX's evaluator runs
    it), the aligned cloud takes the refined pose, and the baseline's
    winner is refined too."""
    from dregnerf_tpu_torch.geometry import se3
    from dregnerf_tpu_torch.io.ply import read_ply
    from dregnerf_tpu_torch.registration.icp import icp_refine

    root, _, _ = scenes
    path, _, _ = jax_checkpoint
    argv = ["--root_dir", os.path.join(root, "single"), "--scene", "fixture",
            "--out_dir", str(tmp_path), "--expname", "reg", "--ckpt_path", path,
            "--position_embedding_dim", "64", "--device", "cpu", "--icp_refine"]
    pev.main(argv)
    eval_dir = tmp_path / "reg" / "eval"
    metrics, _ = _assert_written_as_jax_writes(eval_dir, tmp_path)
    entry = metrics["per_scene"]["fixture"]
    assert {"R_error_icp_deg", "t_error_icp", "icp_rms", "icp_inliers", "icp_time"} <= set(entry)

    scene_dir = eval_dir / "fixture"
    with open(scene_dir / "transformation_est.json") as f:
        written = json.load(f)
    ds = prp.NeRFRegDataset(os.path.join(root, "single"), subject_id="fixture", split="test",
                            seed=config_parser(argv).seed)
    item = ds[0]
    src, src_cols = read_ply(item["src_ply_path"])
    tgt, tgt_cols = read_ply(item["tgt_ply_path"])
    refined, rms, cnt = icp_refine(src, tgt, np.asarray(written["pose_est"], np.float32),
                                   voxel_size=2.0 / 128 * 2, src_colors=src_cols,
                                   tgt_colors=tgt_cols, device="cpu")
    rre, rte = se3.pose_error(torch.from_numpy(refined), torch.from_numpy(
        np.asarray(written["pose_gt"], np.float32)))
    assert (entry["R_error_icp_deg"], entry["t_error_icp"]) == (float(rre), float(rte))
    assert (entry["icp_rms"], entry["icp_inliers"]) == (rms, cnt)
    aligned, _ = read_ply(str(scene_dir / "src_aligned.ply"))
    np.testing.assert_allclose(aligned, src @ refined[:, :3].T + refined[:, 3], atol=1e-5)


@pytest.mark.parametrize("flag", ["--render_videos"])
def test_eval_refuses_unported_options(scenes, jax_checkpoint, flag, tmp_path, jax_hostloop,
                                      one_torch_thread):
    """The option that once raised here now runs: `--render_videos --device
    cpu` on the fixture pair with two JAX-written NGP blocks as its NeRFs
    writes, for gt, aligned and unaligned, the 12 src, tgt and pair frames
    and the depths that JAX's render_pair_views writes for the same
    checkpoints, orbit and poses (torch_views_common.assert_pair_frames_match),
    and the mp4 exactly when ffmpeg is on PATH."""
    root, _, _ = scenes
    path, _, _ = jax_checkpoint
    scene_root = tmp_path / "scene"
    shutil.copytree(os.path.join(root, "single"), scene_root)
    blocks = [save_jax_block(str(scene_root / "nerf_models" / "fixture" / f"block_{k}" /
                                 "model.ckpt"), seed=k) for k in (0, 1)]
    pev.main(["--root_dir", str(scene_root), "--scene", "fixture", "--out_dir",
              str(tmp_path / "out"), "--expname", "reg", "--ckpt_path", path,
              "--position_embedding_dim", "64", "--device", "cpu", flag])
    scene_dir = tmp_path / "out" / "reg" / "eval" / "fixture"
    with open(scene_dir / "transformation_est.json") as f:
        written = json.load(f)
    ds = prp.NeRFRegDataset(str(scene_root), subject_id="fixture", split="test",
                            seed=config_parser([]).seed)
    src, tgt = (ds[0][f"{side}_nerf_path"] for side in ("src", "tgt"))
    assert sorted((src, tgt)) == sorted(blocks)
    jax_dir = tmp_path / "jax"
    for tag, transform in (("gt", written["pose_gt"]), ("aligned", written["pose_est"]),
                           ("unaligned", None)):
        want = jnv.render_pair_views(src, tgt, jax_eval_cli.RegEvaluator._orbit_poses(),
                                     None if transform is None else np.asarray(transform),
                                     str(jax_dir), tag, "objaverse", factor=8)
        for sub in ("src_images", "tgt_images", "images"):
            assert len(list((scene_dir / f"{tag}_{sub}").glob("frame_*.png"))) == 12
        assert (scene_dir / f"{tag}_src_tgt_rgb_depth.mp4").exists() == (want is not None) \
            == (shutil.which("ffmpeg") is not None)
        assert_pair_frames_match(str(scene_dir), str(jax_dir), tag, 12)


def test_eval_runs_on_cuda_unless_asked_for_the_cpu(scenes, monkeypatch, tmp_path):
    root, _, _ = scenes
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = config_parser(["--out_dir", str(tmp_path)])
    ds = prp.NeRFRegDataset(os.path.join(root, "single"), subject_id="fixture", split="test")
    with pytest.raises(RuntimeError, match="CUDA"):
        pev.RegEvaluator(cfg, ds)
