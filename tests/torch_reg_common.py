"""Shared fixtures and helpers of the port's registration-training tests
(tests/test_torch_reg_train.py, test_torch_reg_checkpoint.py,
test_torch_reg_exact.py): a two-block R = 16 scene like the JAX tests',
trainers of both packages with the same weights, and tiny NGP blocks.
Not a test module."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dregnerf_tpu.models import regtr as jregtr
from dregnerf_tpu.runtime import checkpoint as jckpt
from dregnerf_tpu.runtime import reg_trainer as JRT
from dregnerf_tpu.runtime.config import config_parser as jax_config
from dregnerf_tpu_torch.datasets.base import save_world_frame_transforms
from dregnerf_tpu_torch.datasets.register_pairs import NeRFRegDataset
from dregnerf_tpu_torch.io.ply import write_ply
from dregnerf_tpu_torch.models.regtr import NeRFRegTr, params_to_jax
from dregnerf_tpu_torch.runtime import reg_trainer as PRT
from dregnerf_tpu_torch.runtime.config import config_parser as port_config

R = 16
SMALL = dict(backbone="resnet18", d_model=64, num_layers=2, num_heads=4, dim_feedforward=128,
             max_input_points=512, num_tokens=128, max_points=100, num_downsample=3)
TINY = dict(backbone="resnet18", d_model=32, num_layers=1, num_heads=2, dim_feedforward=64,
            max_input_points=256, num_tokens=64, max_points=50, num_downsample=2)
FLAGS = ["--no_bf16", "--robust_loss", "--n_tensorboard", "5", "--n_validation", "1000",
         "--n_checkpoint", "1000", "--epochs", "6"]
LOSS_KEYS = ("overlap", "nerf_cont", "feature", "feature_matches", "corr")


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """At most 2 torch threads while a module of these tests runs: the
    tier-1 run puts 6 test processes on the cores, and the port's CPU
    training steps slowed 11x under that oversubscription at torch's
    default of one thread per core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _rigid(rng):
    q = rng.normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    out = np.eye(4)
    out[:3, :3] = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                   [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                   [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]]
    out[:3, 3] = np.clip(rng.normal(scale=0.1, size=3), -0.2, 0.2)
    return out


@pytest.fixture(scope="module")
def pair_root(tmp_path_factory):
    """Two blocks of one scene, as the JAX tests build them: an asymmetric
    shell and a blob voxelized at R = 16 in two random world frames."""
    root = str(tmp_path_factory.mktemp("regtrain"))
    rng = np.random.default_rng(0)
    sph = rng.normal(size=(800, 3))
    sph /= np.linalg.norm(sph, axis=1, keepdims=True)
    base = np.vstack([sph * [0.5, 0.3, 0.2],
                      rng.normal(size=(200, 3)) * 0.05 + [0.45, 0.25, 0.1]])
    transforms = {0: _rigid(rng), 1: _rigid(rng)}
    for k, T in transforms.items():
        block = os.path.join(root, "nerf_models", "test_scene", f"block_{k}")
        os.makedirs(block)
        pts = base @ T[:3, :3].T + T[:3, 3]
        idx3 = np.clip(((pts + 1.5) / 3.0 * R).astype(int), 0, R - 1)
        flat = np.unique(idx3[:, 0] * R * R + idx3[:, 1] * R + idx3[:, 2])
        grid = np.zeros((R ** 3, 7), np.float32)
        ijk = np.stack([flat // (R * R), (flat // R) % R, flat % R], -1)
        grid[flat, :3] = (ijk + 0.5) / R * 3.0 - 1.5
        grid[flat, 3:6] = rng.uniform(size=(len(flat), 3))
        grid[flat, 6] = 1.0
        torch.save(torch.from_numpy(grid.reshape(R, R, R, 7)),
                   os.path.join(block, "voxel_grid.pt"))
        torch.save(torch.from_numpy(flat.astype(np.int64)), os.path.join(block, "voxel_mask.pt"))
        write_ply(os.path.join(block, "voxel_point_cloud.ply"), grid[flat, :3], grid[flat, 3:6])
        with open(os.path.join(block, "model.ckpt"), "wb"):
            pass  # the grid path never reads the NeRF
    os.makedirs(os.path.join(root, "images", "test_scene"))
    save_world_frame_transforms(os.path.join(root, "images", "test_scene"), transforms)
    return root


def datasets(root, seed=1):
    return (NeRFRegDataset(root, subject_id="test_scene", split="train", seed=seed),
            NeRFRegDataset(root, subject_id="test_scene", split="test", seed=seed))


def fixed_item(root, order=(0, 1)):
    ds = NeRFRegDataset(root, subject_id="test_scene", split="test", seed=0)
    ds.fixed_order = order
    return ds[0]


def shape_flags(shape):
    """The config flags that match a model shape's width and levels."""
    return ["--position_embedding_dim", str(shape["d_model"]), "--num_downsample",
            str(shape["num_downsample"])]


def port_trainer(root, out, extra=(), shape=TINY, seed=1):
    cfg = port_config(FLAGS + shape_flags(shape) + ["--root_dir", root, "--out_dir", out,
                                                    "--expname", "reg", *extra])
    return PRT.RegTrainer(cfg, *datasets(root, seed), model=NeRFRegTr(**shape), device="cpu")


def jax_params(port):
    return {"model": jax.tree_util.tree_map(jnp.asarray, params_to_jax(port.model)),
            "infonce_W": jnp.asarray(np.array(port.infonce_W.detach()))}


def jax_trainer(root, out, params, extra=(), shape=TINY):
    """A JAX RegTrainer with the given parameters, assembled as the JAX
    package's own tests assemble it (no init compile)."""
    cfg = jax_config(FLAGS + shape_flags(shape) + ["--root_dir", root, "--out_dir", out,
                                                   "--expname", "jreg", "--compilation_cache",
                                                   "", *extra])
    tr = JRT.RegTrainer.__new__(JRT.RegTrainer)
    tr.config = cfg
    tr.train_dataset, tr.val_dataset = datasets(root)
    tr.output_dir = os.path.join(out, "jreg")
    os.makedirs(tr.output_dir, exist_ok=True)
    tr.ckpt_manager = jckpt.CheckpointManager(os.path.join(tr.output_dir, "model"))
    tr.aabb = jnp.asarray(cfg.aabb, jnp.float32)
    tr.model = jregtr.NeRFRegTr(dtype=jnp.float32, **shape)
    tr.grid_resolution = R
    tr.params = params
    tr.setup_optimizer()
    tr.iteration = 0
    tr._log_file = open(os.path.join(tr.output_dir, "log.txt"), "a")
    tr._step_fn = tr._make_step_fn()
    return tr


def jbatch(item):
    return {k: jnp.asarray(item[k]) for k in PRT.BATCH_KEYS}


def snapshot(tr):
    opt = tr.optimizer
    return [x.clone() for x in (opt.flat, opt.mu, opt.nu, opt.count, opt.schedule_count)]


def restore(tr, snap):
    opt = tr.optimizer
    for x, s in zip((opt.flat, opt.mu, opt.nu, opt.count, opt.schedule_count), snap):
        x.copy_(s)


def assert_params_close(got_tree, want_tree, atol, what=""):
    got, want = _flat(got_tree), _flat(want_tree)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol, err_msg=f"{what} {k}")


# One step from the same state on the same pair: each updated parameter
# within 3e-4 of JAX's (Adam normalizes each gradient element, so an
# element whose gradient is at the level of the two packages' summation
# noise can move by up to 2 lr = 2e-4 either way), and 99.9 % of them
# within 1e-6
STEP_ATOL, STEP_TIGHT, STEP_SHARE = 3e-4, 1e-6, 0.999


def assert_step_agrees(port_tree, jax_tree):
    got, want = _flat(port_tree), _flat(jax.tree_util.tree_map(np.asarray, jax_tree))
    assert got.keys() == want.keys()
    close = total = 0
    for k, w in want.items():
        d = np.abs(got[k] - w)
        assert d.max() <= STEP_ATOL, (k, d.max())
        close += int((d <= STEP_TIGHT).sum())
        total += d.size
    assert close >= STEP_SHARE * total, close / total


def port_params_tree(tr):
    return {"model": params_to_jax(tr.model), "infonce_W": np.array(tr.infonce_W.detach())}


def _ngp_checkpoint(path, log2_table_size=8, seed=0, n_cameras=5):
    """A tiny NGP block written by the JAX package: a 2-level packed grid
    whose table is scaled up until about half of the points in the box
    score S >= 0.5, a random 16^3 occupancy grid (70 % occupied) and
    `n_cameras` cameras around the box."""
    from dregnerf_tpu.models import ngp as jngp
    from dregnerf_tpu.ops.packed_grid import PackedGridConfig

    cfg = jngp.NGPConfig(grid=PackedGridConfig(n_levels=2, log2_table_size=log2_table_size),
                         compute_dtype=jnp.float32)
    params = jngp.init_ngp(jax.random.PRNGKey(seed), cfg)
    params["table"] = params["table"] * 1e5
    rng = np.random.default_rng(seed)
    binary = rng.random((16,) * 3) < 0.7
    cams = []
    for k in range(n_cameras):
        a = 2 * np.pi * k / n_cameras
        cams.append(np.concatenate([np.eye(3), [[3 * np.cos(a)], [3 * np.sin(a)], [0.5]]], 1))
    meta = {"aabb": [-1.0, -1.0, -1.0, 1.0, 1.0, 1.0], "contraction_type": "aabb",
            "render_step_size": 0.05, "near_plane": 0.0, "far_plane": 1e10,
            "camera_poses": [c.tolist() for c in cams], "field": "ngp",
            "model_config": jngp.config_to_meta(cfg)}
    jckpt.save_checkpoint(path, {"model": params, "occupancy": {
        "occs": jnp.zeros(16 ** 3), "binary": jnp.asarray(binary)}}, meta)
    return path

