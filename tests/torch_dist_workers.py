"""Rank workers of tests/test_torch_parallel.py. Each worker runs in a
process of its own, one per rank, under a gloo group whose store is a
file in the test's temporary directory (so parallel test processes never
share a port), at one torch thread. Imports torch, numpy and the port
only; the JAX references are computed by the test module. Not a test
module."""
from __future__ import annotations

import functools
import multiprocessing
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

from dregnerf_tpu_torch.datasets.base import SceneData
from dregnerf_tpu_torch.ops import occupancy as tocc
from dregnerf_tpu_torch.ops.packed_grid import PackedGridConfig
from dregnerf_tpu_torch.runtime import ngp_trainer as TT
from dregnerf_tpu_torch.runtime.config import config_parser

GRID = dict(n_levels=2, log2_table_size=10, base_resolution=4, per_level_scale=2.0)
STEPS = 64  # march steps of the tiny trainers
BUFFER = 1 << 12  # their sample budget


def flags(out, extra=()):
    """The tiny NGP trainer's flags: f32 MLPs and the K1 (pallas) f32 table
    gradient, so that the port and JAX sum in f32."""
    return ["--dataset", "objaverse", "--expname", "p", "--out_dir", out,
            "--aabb=-1.0,-1.0,-1.0,1.0,1.0,1.0", "--max_iterations", "100",
            "--sample_budget", str(BUFFER), "--max_march_steps", str(STEPS),
            "--grid_resolution", "16", "--init_num_rays", "128", "--max_num_rays", "1024",
            "--n_tensorboard", "1000", "--n_validation", "1000000", "--n_checkpoint", "1000000",
            "--no_bf16", "--grad_accum", "pallas", "--no-rle_backward", "--device", "cpu",
            *extra]


def start_ranks(target, world: int, store_dir: str, args=()) -> list:
    """target(rank, world, *args) in `world` spawned processes under one gloo
    group; returns the processes, for join_ranks."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(target, rank, world, store_dir, args))
             for rank in range(world)]
    for p in procs:
        p.start()
    return procs


def join_ranks(procs: list, store_dir: str, timeout: float = 150.0) -> list:
    """Each rank's result. A rank that fails, or that has not ended after
    `timeout` seconds (a hung collective), fails the call and every rank
    is stopped."""
    try:
        for p in procs:
            p.join(timeout)
            if p.is_alive():
                raise RuntimeError(f"a rank of {len(procs)} had not ended after {timeout} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    for rank, p in enumerate(procs):
        if p.exitcode != 0:
            err = os.path.join(store_dir, f"err_{rank}.txt")
            text = open(err).read() if os.path.exists(err) else ""
            raise RuntimeError(f"rank {rank} exited with {p.exitcode}:\n{text}")
    return [torch.load(os.path.join(store_dir, f"out_{rank}.pt"), weights_only=False)
            for rank in range(len(procs))]


def _entry(target, rank, world, store_dir, args):
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store_dir}/store",
                                world_size=world, rank=rank)
        out = target(rank, world, *args)
        dist.barrier()
        torch.save(out, os.path.join(store_dir, f"out_{rank}.pt"))
    except BaseException:
        with open(os.path.join(store_dir, f"err_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def scene(seed: int, views: int = 8, size: int = 16) -> SceneData:
    from dregnerf_tpu_torch.datasets.fixtures import make_scene_data

    return make_scene_data("train", num_views=views, image_size=size, seed=seed)


def draws_of(d: dict) -> TT.StepDraws:
    return TT.StepDraws(*(torch.as_tensor(d[k]) for k in TT.StepDraws._fields))


def set_state(trainer, params_np, occs, binary) -> None:
    """The trainer's field and grid from JAX's numpy arrays, with plain SGD
    (learning rate: the trainer's schedule) in place of Adam, so that the
    parameters carry the gradients themselves: Adam normalizes each element
    and would hide a gradient's scale (a sum where a mean belongs)."""
    trainer.params = TT.ngp.params_from_jax(params_np, "cpu")
    for p in TT.ngp.parameters(trainer.params):
        p.requires_grad_(True)
    trainer.optimizer = torch.optim.SGD(TT.ngp.parameters(trainer.params), lr=trainer.lr_at(0))
    trainer.grid = tocc.occupancy_from_numpy(occs, binary, "cpu")


def params_copy(tree):
    """A copy of a params_to_numpy tree (whose arrays share the tensors'
    memory, which later steps update in place)."""
    return {k: [a.copy() for a in v] if isinstance(v, list) else v.copy()
            for k, v in tree.items()}


def snapshot(trainer) -> dict:
    return {"params": params_copy(TT.ngp.params_to_numpy(trainer.params)),
            "occs": trainer.grid.occs.numpy().copy(), "binary": trainer.grid.binary.numpy().copy()}


def tiny_grid(fn):
    """Run fn with the trainers' packed grid at GRID's size (the tests'
    CPU width), as the other trainer tests shrink it."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        real = TT.PackedGridConfig
        TT.PackedGridConfig = functools.partial(PackedGridConfig, **GRID)
        try:
            return fn(*args, **kwargs)
        finally:
            TT.PackedGridConfig = real
    return wrapped


@tiny_grid
def fleet_run(rank: int, world: int, out: str, data: dict) -> dict:
    """FleetNGPTrainer on data["seeds"] blocks (--mesh_shape world when
    world > 1: this rank's blocks only), each block's state set to
    data["init"][k], then data["schedule"]: ("occ", step, draws by block)
    or ("step", step, draws by block). Returns the blocks trained here and
    each block's state after every entry."""
    from dregnerf_tpu_torch.parallel.fleet import fleet_occ_update, fleet_train_step
    from dregnerf_tpu_torch.runtime.fleet_trainer import FleetNGPTrainer

    extra = ["--mesh_shape", str(world)] if world > 1 else []
    cfg = config_parser(flags(out, extra))
    scenes = [scene(s) for s in data["seeds"]]
    dirs = [os.path.join(out, f"block_{k}") for k in range(len(scenes))]
    fleet = FleetNGPTrainer(cfg, scenes, [None] * len(scenes), dirs)
    for k, t in zip(fleet.blocks, fleet.trainers):
        set_state(t, *data["init"][k])
    states = []
    for op, step, draws in data["schedule"]:
        mine = [draws[k] for k in fleet.blocks]
        if op == "occ":
            fleet_occ_update(fleet.trainers, step,
                             [{n: torch.as_tensor(v) for n, v in d.items()} for d in mine])
        else:
            fleet_train_step(fleet.trainers, step, cfg.init_num_rays, [draws_of(d) for d in mine])
        states.append([snapshot(t) for t in fleet.trainers])
    if data.get("save"):
        for t in fleet.trainers:
            t.save_checkpoint(len(data["schedule"]))
    return {"blocks": fleet.blocks, "devices": [str(t.device) for t in fleet.trainers],
            "states": states}


@tiny_grid
def dp_run(rank: int, world: int, out: str, data: dict) -> dict:
    """NGPTrainer under --mesh_shape world with the initial state
    data["init"]: the sharded surface pass, `sharded_attention` and the
    cross-encoder's sp switch on data's inputs, then each step of
    data["steps"] on this rank's draws; with data["reg"], the registration
    DP step too."""
    from dregnerf_tpu_torch.extract.sample_grid import compute_surface_mask
    from dregnerf_tpu_torch.parallel.extract_sharded import make_sharded_surface_fn
    from dregnerf_tpu_torch.parallel.sp_attention import sharded_attention

    cfg = config_parser(flags(out, ["--mesh_shape", str(world)]))
    trainer = TT.NGPTrainer(cfg, scene(0), None, output_dir=os.path.join(out, "dp"))
    mesh = trainer.mesh
    set_state(trainer, *data["init"])
    result = {"metrics": [], "states": [], "device": str(trainer.device)}

    s = data["surface"]
    aabb = trainer.aabb
    rcfg = trainer.render_config
    result["scores"] = compute_surface_mask(
        trainer.params, trainer.model_config, trainer.grid, aabb, rcfg, s["points"],
        s["cameras"], chunk=s["chunk"], buffer_size=s["buffer"], return_scores=True, mesh=mesh)
    fn = make_sharded_surface_fn(mesh, trainer.params, trainer.model_config, trainer.grid,
                                 aabb, rcfg)
    result["shard_scores"] = mesh.all_gather_rows(
        fn(*(torch.as_tensor(s["rays"][k]) for k in ("origins", "viewdirs", "t_max")))).numpy()

    a = data["attention"]
    q, k, v, qv, kv = (mesh.shard(torch.as_tensor(a[n])) for n in ("q", "k", "v", "qv", "kv"))
    result["attention"] = mesh.all_gather_rows(
        sharded_attention(mesh, q, k, v, qv, kv, num_heads=a["heads"])).numpy()
    result["encoder"] = encoder_run(mesh, data["encoder"])

    for step, draws in data["steps"]:
        m = trainer.train_iteration(step, draws=draws_of(draws[rank]))
        result["metrics"].append({k: float(m[k]) for k in ("loss", "psnr", "n_samples",
                                                            "alive_rays")})
        result["states"].append(snapshot(trainer))
    if data.get("reg"):
        result["reg"] = reg_run(mesh, out, data["reg"])
    return result


def dp_and_fleet_run(rank: int, world: int, out: str, data: dict, fleet_data: dict) -> dict:
    return {"dp": dp_run(rank, world, out, data),
            "fleet": fleet_run(rank, world, os.path.join(out, "fleet"), fleet_data)}


def encoder_run(mesh, e: dict) -> dict:
    """TransformerCrossEncoder(sp_mesh=mesh) with e's flax weights: the
    outputs on the full inputs, and the gradient of sum(outputs * e["cot"])
    with respect to its parameters and inputs."""
    from dregnerf_tpu_torch.models import regtr as pregtr
    from dregnerf_tpu_torch.models.transformer import TransformerCrossEncoder

    model = TransformerCrossEncoder(*e["shape"], sp_mesh=mesh)
    model.load_state_dict(pregtr.params_from_jax(e["tree"], model))
    inputs = [torch.as_tensor(e[n]) for n in ("src", "tgt", "sv", "tv", "spos", "tpos")]
    for i in (0, 1):
        inputs[i].requires_grad_(True)
    outs = model(*inputs)
    loss = sum((o * torch.as_tensor(c)).sum() for o, c in zip(outs, e["cot"]))
    loss.backward()
    return {"out": [o.detach().numpy() for o in outs],
            "grads": {n: p.grad.numpy() for n, p in model.named_parameters()},
            "input_grads": [inputs[i].grad.numpy() for i in (0, 1)]}


def reg_run(mesh, out: str, r: dict) -> dict:
    """RegTrainer under --mesh_shape at r's small width: one DP step per
    entry of r["steps"] (a pair for each rank, this rank's taken); the flat
    parameters and the metrics after each."""
    from dregnerf_tpu_torch.models.regtr import NeRFRegTr
    from dregnerf_tpu_torch.runtime.reg_trainer import RegTrainer

    cfg = config_parser(r["flags"] + ["--out_dir", out, "--expname", "reg",
                                      "--mesh_shape", str(mesh.size)])
    tr = RegTrainer(cfg, [r["steps"][0][0]], [], model=NeRFRegTr(**r["shape"]))
    steps = []
    for items in r["steps"]:
        m = tr.train_iteration(items[mesh.rank])
        steps.append({"metrics": {k: float(v) for k, v in m.items()},
                      "flat": tr.optimizer.flat.numpy().copy(),
                      "count": int(tr.optimizer.count)})
    return {"steps": steps, "device": str(tr.device)}


def pair_item(rng: np.random.Generator, res: int = 16) -> dict:
    """A registration pair at resolution `res`: an ellipsoid shell and a blob
    voxelized in the src frame and under a random rigid pose."""
    sph = rng.normal(size=(600, 3))
    sph /= np.linalg.norm(sph, axis=1, keepdims=True)
    base = np.vstack([sph * [0.5, 0.3, 0.2], rng.normal(size=(150, 3)) * 0.05 + [0.4, 0.2, 0.1]])
    angle = rng.uniform(0.2, 0.6)
    c, s = np.cos(angle), np.sin(angle)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    pose[:3, 3] = rng.uniform(-0.1, 0.1, 3)

    def voxelize(pts):
        ijk = np.clip(((pts + 1.5) / 3.0 * res).astype(int), 0, res - 1)
        flat = np.unique(ijk[:, 0] * res * res + ijk[:, 1] * res + ijk[:, 2])
        grid = np.zeros((res ** 3, 7), np.float32)
        cells = np.stack([flat // (res * res), (flat // res) % res, flat % res], -1)
        grid[flat, :3] = (cells + 0.5) / res * 3.0 - 1.5
        grid[flat, 3:6] = rng.uniform(size=(len(flat), 3))
        grid[flat, 6] = 1.0
        mask = np.zeros(res ** 3, bool)
        mask[flat] = True
        return grid.reshape(res, res, res, 7), mask

    src_grid, src_mask = voxelize(base)
    tgt_grid, tgt_mask = voxelize(base @ pose[:3, :3].T + pose[:3, 3])
    return {"src_grid": src_grid, "tgt_grid": tgt_grid, "src_mask": src_mask,
            "tgt_mask": tgt_mask, "pose": pose}
