"""What the CUDA-graph tests share (test_torch_step_graph.py,
test_torch_ngp_graph.py, test_torch_reg_graph.py): the CPU stand-in for a
step graph's capture, and each trainer at a tiny size. Imports no JAX: the
card runs those files with --noconftest."""
import contextlib
from types import SimpleNamespace

import numpy as np
import torch

from dregnerf_tpu_torch.datasets import fixtures
from dregnerf_tpu_torch.models import ngp
from dregnerf_tpu_torch.models.regtr import NeRFRegTr
from dregnerf_tpu_torch.ops.hash_encoding import HashGridConfig
from dregnerf_tpu_torch.ops.packed_grid import PackedGridConfig
from dregnerf_tpu_torch.runtime import ngp_trainer, step_graph
from dregnerf_tpu_torch.runtime.config import config_parser
from dregnerf_tpu_torch.runtime.reg_trainer import RegTrainer


def eager_capture(body, state, pool=None):
    """The capture's stand-in off the card: the warm-up, then a "graph" whose
    replay runs the body into the static output and puts the kernels'
    launch counters back (a real replay runs no Python, so no wrapper
    counts it)."""
    out = step_graph.warm_up(body, state)

    def replay():
        before = ngp_trainer.launches()
        out.copy_(body())
        for name, (fn, attr) in ngp_trainer.launch_counters().items():
            setattr(fn, attr, before[name])

    return SimpleNamespace(replay=replay), out


@contextlib.contextmanager
def graph_on_cpu(mp, captures=None):
    """Step graphs engage on the CPU (through the monkeypatch `mp`), the
    size of each capture's state recorded in `captures`."""

    def record(body, state, pool=None):
        if captures is not None:
            captures.append(len(state))
        return eager_capture(body, state, pool)

    mp.setattr(step_graph, "DEVICE_TYPES", ("cpu",))
    mp.setattr(step_graph, "capture", record)
    yield captures


def tiny_ngp_trainer(out, encoder="packed", device="cpu", extra=()):
    """An NGP trainer at the CLI defaults on a 2-level grid: the packed one
    with the bf16 table gradient and the run-length backward at level 0, or
    a 2-level xor-hash grid (`--encoder xor_hash`); "packed_wrapped" is a
    packed grid of 3 levels of 4 features, the last two wrapped into 2^10
    rows, as the L8F4 layout's fine levels are."""
    cfg = config_parser(["--expname", "tiny", "--out_dir", str(out), "--watchdog_s", "0",
                         "--aabb=-1.0,-1.0,-1.0,1.0,1.0,1.0", "--sample_budget", "2048",
                         "--max_march_steps", "64", "--grid_resolution", "16",
                         "--init_num_rays", "32", "--max_num_rays", "256",
                         "--encoder", "xor_hash" if encoder == "xor_hash" else "packed",
                         *extra])
    tr = ngp_trainer.NGPTrainer(cfg, fixtures.make_scene_data("train", num_views=4,
                                                              image_size=16), device=device)
    if encoder == "packed":
        grid = PackedGridConfig(n_levels=2, log2_table_size=10, base_resolution=4,
                                per_level_scale=2.0, grad_accum="bf16",
                                rle_step_u=tr.model_config.grid.rle_step_u)
    elif encoder == "packed_wrapped":
        grid = PackedGridConfig(n_levels=3, n_features=4, log2_table_size=10, base_resolution=4,
                                per_level_scale=4.0, grad_accum="bf16",
                                rle_step_u=tr.model_config.grid.rle_step_u)
    else:
        grid = HashGridConfig(n_levels=2, log2_table_size=10, base_resolution=4,
                              per_level_scale=2.0)
    tr.model_config = ngp.NGPConfig(grid=grid, compute_dtype=torch.bfloat16)
    tr.init_params(torch.Generator(device=device).manual_seed(0))
    tr.setup_optimizer()
    return tr


R = 16
TINY = dict(backbone="resnet18", d_model=32, num_layers=1, num_heads=2, dim_feedforward=64,
            max_input_points=256, num_tokens=64, max_points=50, num_downsample=2)


def _block(rng):
    """An R^3 grid of 300 random occupied voxels and its flat mask."""
    grid = np.zeros((R, R, R, 7), np.float32)
    ii = rng.integers(2, R - 2, size=(300, 3))
    flat = ii[:, 0] * R * R + ii[:, 1] * R + ii[:, 2]
    grid.reshape(-1, 7)[flat, :3] = (ii + 0.5) / R * 2.0 - 1.0
    grid.reshape(-1, 7)[flat, 3:] = rng.uniform(size=(300, 4))
    mask = np.zeros(R ** 3, bool)
    mask[flat] = True
    return grid, mask


def _rigid(rng, std):
    """A small random rigid transform [4, 4] f32."""
    q = np.concatenate([[1.0], rng.normal(scale=std, size=3)])
    w, x, y, z = q / np.linalg.norm(q)
    out = np.eye(4)
    out[:3, :3] = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                   [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                   [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]]
    out[:3, 3] = rng.normal(scale=std, size=3)
    return out.astype(np.float32)


class Pairs:
    """Two blocks, as the trainer's dataset (it reads the grid resolution
    and the jitter) and as a source of device-cached items (get_raw's
    layout: cache keys and an `aug` dict)."""

    jitter_scale, jitter_clip = 0.005, 0.05

    def __init__(self, seed=0):
        rng = np.random.default_rng(seed)
        self.blocks = [_block(rng), _block(rng)]

    def __len__(self):
        return 1

    def __getitem__(self, i):
        return self.host_item(np.eye(4, dtype=np.float32))

    def host_item(self, pose):
        (g0, m0), (g1, m1) = self.blocks
        return {"src_grid": g0, "src_mask": m0, "tgt_grid": g1, "tgt_mask": m1, "pose": pose}

    def items(self, n, seed=1, jitter=True):
        """n device-cached items with random poses and perturbations."""
        rng = np.random.default_rng(seed)
        out = []
        for k in range(n):
            p = _rigid(rng, 0.1)
            item = {**self.host_item(_rigid(rng, 0.3)), "src_cache_key": "b0",
                    "tgt_cache_key": "b1",
                    "aug": {"p_src": p if k % 2 else np.eye(4, dtype=np.float32),
                            "p_tgt": np.eye(4, dtype=np.float32) if k % 2 else p,
                            "jitter": jitter}}
            out.append(item)
        return out


def tiny_reg_trainer(out, device="cpu", shape=TINY, bf16=False):
    """(a RegTrainer at the tiny width `shape` on R^3 grids, its Pairs)."""
    cfg = config_parser(["--position_embedding_dim", str(shape["d_model"]),
                         "--num_downsample", str(shape["num_downsample"]),
                         "--out_dir", str(out), "--expname", "reg", "--watchdog_s", "0",
                         *([] if bf16 else ["--no_bf16"])])
    ds = Pairs()
    dtype = torch.bfloat16 if bf16 else torch.float32
    return RegTrainer(cfg, ds, ds, model=NeRFRegTr(**shape, dtype=dtype), device=device), ds
