"""The port's multi-block pipeline end to end on the CPU (twin of
tests/test_pipeline_e2e.py): `train_ngp_nerf.main --multi_blocks` splits an
on-disk fixture scene into two camera blocks, each in its own world frame,
and trains one NGP block in each; `eval_ngp_nerf.main` evaluates and
extracts both; the port's and the JAX package's NeRFRegDataset then read
the pair from that layout (<R>/images/<subject>, <R>/nerf_models/<subject>)
and give the same items, with the pose of the frames the port wrote.

As the JAX test shrinks its model, the trainer's encoder here has 4
levels of 2^12-row tables (base resolution 4, scale 2) instead of 2^19
rows, so that 200 steps a block run in seconds on the CPU and leave
surface voxels to extract; every other setting is the CLI's."""
import functools
import json
import math
import os

import numpy as np
import pytest
import torch

from dregnerf_tpu.datasets import register_pairs as jrp
from dregnerf_tpu_torch import eval_ngp_nerf, train_ngp_nerf
from dregnerf_tpu_torch.datasets import fixtures as tfix
from dregnerf_tpu_torch.datasets import register_pairs as prp
from dregnerf_tpu_torch.datasets.base import (
    apply_world_frame,
    read_world_frame_transforms,
    split_indices,
)
from dregnerf_tpu_torch.datasets.kmeans import kmeans_labels
from dregnerf_tpu_torch.ops.packed_grid import PackedGridConfig
from dregnerf_tpu_torch.runtime import ngp_trainer
from dregnerf_tpu_torch.runtime.checkpoint import load_checkpoint

SUBJECT, VIEWS, SIZE, RES, STEPS = "fixture_scene", 24, 32, 16, 200


def _flags(root):
    return ["--dataset", "objaverse", "--root_dir", os.path.join(root, "images"),
            "--scene", SUBJECT, "--out_dir", os.path.join(root, "nerf_models"),
            "--expname", SUBJECT, "--factor", "1", "--aabb=-1.0,-1.0,-1.0,1.0,1.0,1.0",
            "--sample_budget", str(1 << 12), "--max_march_steps", "64",
            "--grid_resolution", str(RES), "--init_num_rays", "256", "--max_num_rays", "1024",
            "--test_chunk_size", "1024", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one intra-op thread while the module runs: its trainers run
    many short ops on a few hundred rays, and on cores shared by several
    test processes torch's thread pool then spends most of its time
    waiting on its own threads (the pipeline fixture took 27 s alone and
    over 500 s in a loaded six-process run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("e2e"))
    tfix.make_scene(os.path.join(root, "images"), num_views=VIEWS, image_size=SIZE)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ngp_trainer, "PackedGridConfig", functools.partial(
            PackedGridConfig, log2_table_size=12, base_resolution=4, per_level_scale=2.0))
        train_ngp_nerf.main(_flags(root) + [
            "--multi_blocks", "--min_num_blocks", "2", "--max_num_blocks", "2",
            "--max_iterations", str(STEPS), "--n_checkpoint", str(STEPS),
            "--n_tensorboard", "1000", "--n_validation", "1000000", "--no_bf16"])
    eval_ngp_nerf.main(_flags(root))
    models = os.path.join(root, "nerf_models", SUBJECT)
    return root, [os.path.join(models, f"block_{k}") for k in range(2)]


def test_each_block_trains_in_its_own_frame(pipeline):
    """Two blocks, the frames saved once next to the images, and each
    block's checkpoint holding its training cameras in its frame."""
    root, blocks = pipeline
    assert sorted(os.listdir(os.path.dirname(blocks[0]))) == ["block_0", "block_1"]
    frames = read_world_frame_transforms(os.path.join(root, "images", SUBJECT))
    assert sorted(frames) == [0, 1]
    for T in frames.values():
        assert T.shape == (4, 4)
        np.testing.assert_allclose(T[:3, :3] @ T[:3, :3].T, np.eye(3), atol=1e-6)
        np.testing.assert_allclose(np.linalg.det(T[:3, :3]), 1.0, atol=1e-6)
        np.testing.assert_array_equal(T[3], [0, 0, 0, 1])
    _, c2w = tfix.render_views(VIEWS, 2)
    c2w = c2w.astype(np.float32)[:, :3, :4]
    labels = kmeans_labels(c2w[:, :3, 3], 2)
    for k, block in enumerate(blocks):
        _, meta = load_checkpoint(os.path.join(block, "model", "model.ckpt"))
        assert meta["step"] == STEPS and meta["block_id"] == k
        ids = np.flatnonzero(labels == k)
        ids = ids[split_indices(len(ids), "train", 20)]
        np.testing.assert_allclose(np.asarray(meta["camera_poses"], np.float32),
                                   apply_world_frame(c2w[ids], frames[k].astype(np.float64)),
                                   rtol=0, atol=1e-6)


def test_each_block_is_evaluated_and_extracted(pipeline):
    _, blocks = pipeline
    for block in blocks:
        with open(os.path.join(block, "eval", "metrics.json")) as f:
            metrics = json.load(f)
        assert metrics["num_views"] == 1 and math.isfinite(metrics["psnr"])
        grid = torch.load(os.path.join(block, "voxel_grid.pt"))
        assert grid.shape == (RES, RES, RES, 7) and bool(torch.isfinite(grid).all())
        assert torch.load(os.path.join(block, "voxel_mask.pt")).numel() > 0
        for name in ("voxel_point_cloud.ply", "density_voxel_grid.pt",
                     "density_voxel_mask.pt", "density_voxel_point_cloud.ply"):
            assert os.path.exists(os.path.join(block, name)), name


@pytest.mark.parametrize("split", ["train", "test"])
def test_pair_dataset_matches_jax_on_the_ports_layout(pipeline, split):
    """The JAX package's NeRFRegDataset reads the port's layout as the
    port's does: equal items (grids, masks, poses, block order, the train
    split's augmentation draws), and the pose of the written frames."""
    root, _ = pipeline
    want = jrp.NeRFRegDataset(root, subject_id=SUBJECT, split=split, seed=3)
    got = prp.NeRFRegDataset(root, subject_id=SUBJECT, split=split, seed=3)
    assert len(got) == len(want) == 1
    frames = read_world_frame_transforms(os.path.join(root, "images", SUBJECT))
    for _ in range(3):
        a, b = want[0], got[0]
        assert set(a) == set(b)
        for key, value in a.items():
            if isinstance(value, np.ndarray):
                assert value.dtype == b[key].dtype, key
                np.testing.assert_array_equal(b[key], value, err_msg=key)
            elif key == "aug":
                for name in value:
                    np.testing.assert_array_equal(b[key][name], value[name], err_msg=name)
            else:
                assert b[key] == value, key
        assert b["src_mask"].sum() > 0 and b["tgt_mask"].sum() > 0
    item = prp.NeRFRegDataset(root, subject_id=SUBJECT, split="test", seed=0)[0]
    src, tgt = item["block_list"]
    np.testing.assert_allclose(
        item["pose"], frames[tgt].astype(np.float64) @ np.linalg.inv(frames[src]),
        rtol=0, atol=1e-6)


def test_fleet_is_not_ported(tmp_path):
    """--multi_blocks --fleet (which once raised here) trains both blocks of
    the on-disk scene together: each block's checkpoint at the last step
    with its block id, its training cameras in its frame and its Adam
    count; --fleet --field vanilla is refused (JAX's fleet runs the NGP
    field's functions on any field and fails)."""
    root = str(tmp_path)
    tfix.make_scene(os.path.join(root, "images"), num_views=VIEWS, image_size=SIZE)
    steps = 8
    flags = _flags(root) + ["--multi_blocks", "--fleet", "--min_num_blocks", "2",
                            "--max_num_blocks", "2", "--max_iterations", str(steps),
                            "--n_tensorboard", "4", "--no_bf16"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ngp_trainer, "PackedGridConfig", functools.partial(
            PackedGridConfig, log2_table_size=12, base_resolution=4, per_level_scale=2.0))
        train_ngp_nerf.main(flags)
    frames = read_world_frame_transforms(os.path.join(root, "images", SUBJECT))
    for k in range(2):
        flat, meta = load_checkpoint(os.path.join(root, "nerf_models", SUBJECT, f"block_{k}",
                                                  "model", "model.ckpt"))
        assert meta["step"] == steps and meta["block_id"] == k
        assert int(flat["optimizer::0/count"]) == steps
        assert np.isfinite(flat["model::table"]).all()
        T = frames[k]
        np.testing.assert_allclose(np.linalg.det(np.asarray(T)[:3, :3]), 1.0, atol=1e-6)
    with pytest.raises(ValueError, match="NGP fields only"):
        train_ngp_nerf.main(flags + ["--field", "vanilla"])
