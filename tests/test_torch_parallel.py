"""Port parity of parallel/ (torch.distributed) against the JAX package's
shard_map functions on the conftest's virtual-device mesh.

The port's ranks are processes under gloo on the CPU
(tests/torch_dist_workers.py), two or four; JAX's devices are the
conftest's virtual CPU devices. Every random draw is JAX's: the fleet's
per-block keys fold_in(fold_in(key, device), local block) split 5 (and
split 4 in the occupancy update), the data-parallel step's
fold_in(fold_in(key, step), device), are reproduced here and handed to the
port as explicit draws. JAX's fleet, surface pass, attention and sp
switch run over two devices and are the reference of the port at one,
two and four ranks (each block's and each row's result is the same
function of its inputs on any of these layouts); JAX's registration DP
step compiles in a spawned process while the ranks run. The trainers are tiny (2 levels of 2^10 rows, f32
MLPs, the f32 K1 table gradient, 16^3 grid, 64 march steps).

Tolerances:
  * the trainers step with SGD on both sides (optax.sgd and torch's; see
    torch_dist_workers.set_state), so a parameter's change from its start
    is -lr times the sum of its gradients: each leaf's change within 1e-4
    of its max change (the gradients' tolerance in
    tests/test_torch_trainer.py) plus 1e-7, a few f32 ulps of a weight
    under 1, in which the change itself is rounded;
  * the occupancy grid: occs within 1e-6 plus 1e-5 relative, binary exact;
  * losses 1e-5 relative, sample counts exact;
  * surface scores within 1e-5 (as the JAX package's own test), masks
    exact; attention and the cross-encoder within 1e-5; the sp switch's
    gradients within 1e-5 of the largest gradient of the model against
    local attention's (key biases have a zero gradient in exact
    arithmetic, so their own max is noise);
  * registration: each parameter within 3e-4 of JAX's after the step and
    99.9 % within 1e-6 (tests/torch_reg_common.py); metrics 1e-4
    relative;
  * ranks: equal bit for bit.
"""
import math
import multiprocessing
import os
import pickle
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_dist_workers as W
from dregnerf_tpu.models import ngp as jngp
from dregnerf_tpu.models import regtr as jregtr
from dregnerf_tpu.models import transformer as jtr
from dregnerf_tpu.ops import occupancy as jocc
from dregnerf_tpu.ops.packed_grid import PackedGridConfig as JGrid
from dregnerf_tpu.parallel import fleet as jfleet
from dregnerf_tpu.parallel.extract_sharded import make_sharded_surface_fn
from dregnerf_tpu.parallel.mesh import make_mesh
from dregnerf_tpu.parallel.ngp_dp import make_dp_train_step
from dregnerf_tpu.parallel.regtr_dp import make_dp_reg_step
from dregnerf_tpu.parallel.sp_attention import sharded_attention
from dregnerf_tpu.extract.sample_grid import compute_surface_mask
from dregnerf_tpu.render.renderer import RenderConfig as JRenderConfig
from dregnerf_tpu.runtime import ngp_trainer as JT
from dregnerf_tpu_torch.models import regtr as pregtr
from dregnerf_tpu_torch.models.regtr import NeRFRegTr
from dregnerf_tpu_torch.models.transformer import TransformerCrossEncoder
from dregnerf_tpu_torch.parallel import mesh as pmesh
from dregnerf_tpu_torch.runtime.config import config_parser
from dregnerf_tpu_torch.runtime.reg_trainer import RegTrainer
from torch_reg_common import assert_step_agrees, port_params_tree

LR = 1e-2
AABB = np.array([-1.0, -1.0, -1.0, 1.0, 1.0, 1.0], np.float32)
N_RAYS = 128  # the tiny trainer's --init_num_rays
N_OCC = 16 ** 3 // 4  # min(R^3 // 4, 2^17) at R = 16
# the JAX package's own DP registration test's model and R = 8 grids (the
# smallest that compiles in under a minute on the CPU)
REG_SHAPE = dict(backbone="resnet18", d_model=32, num_layers=1, num_heads=2,
                 dim_feedforward=64, max_input_points=64, num_tokens=32, max_points=16,
                 num_downsample=2)
REG_R = 8
REG_FLAGS = ["--no_bf16", "--robust_loss", "--device", "cpu", "--n_tensorboard", "1000",
             "--n_validation", "1000", "--n_checkpoint", "1000", "--position_embedding_dim",
             str(REG_SHAPE["d_model"]), "--num_downsample", str(REG_SHAPE["num_downsample"])]


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """At most 2 torch threads in this process while the module runs (its
    ranks run at one each): a six-process pytest run (`-n 6`) shares the
    cores, and oversubscribed torch threads slow every one of them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def replicated(mesh, tree):
    """tree on every device of `mesh`, laid out as the jitted steps return
    their state, so that feeding a step's output back does not recompile."""
    from jax.sharding import NamedSharding, PartitionSpec

    return jax.device_put(tree, NamedSharding(mesh, PartitionSpec()))


def jcfg():
    return jngp.NGPConfig(grid=JGrid(**W.GRID, grad_accum="pallas"), compute_dtype=jnp.float32)


def jrcfg(buffer_size=W.BUFFER):
    return JRenderConfig(render_step_size=2 * math.sqrt(3) / W.STEPS, buffer_size=buffer_size,
                         max_steps=W.STEPS, march_compaction="capped", k_cap=W.STEPS)


def joptimizer():
    return optax.sgd(LR)


def init_params(seed):
    p = jngp.init_ngp(jax.random.PRNGKey(seed), jcfg())
    p["table"] = p["table"] * 1000.0
    return jax.tree_util.tree_map(np.asarray, p)


def step_draws(key, n_img, n, H=16, W_=16):
    kimg, kx, ky, kbg, kmarch = jax.random.split(key, 5)
    return {k: np.array(v) for k, v in dict(
        img_id=jax.random.randint(kimg, (n,), 0, n_img), x=jax.random.randint(kx, (n,), 0, W_),
        y=jax.random.randint(ky, (n,), 0, H), bg=jax.random.uniform(kbg, (3,)),
        jitter=jax.random.uniform(kmarch, (n, 1))).items()}


def occ_draws(key, binary, warmup):
    """update_grid's draws under `key`, for a grid whose binary is `binary`."""
    k_sel, k_occ, k_j1, _ = jax.random.split(key, 4)
    n_cells = binary.size
    if warmup:
        return {"noise": np.array(jax.random.uniform(k_j1, (n_cells, 3), minval=-0.5,
                                                     maxval=0.5))}
    total = int(binary.sum())
    return {k: np.array(v) for k, v in dict(
        uniform_idx=jax.random.randint(k_sel, (N_OCC,), 0, n_cells),
        occ_rank=jax.random.randint(k_occ, (N_OCC,), 0, max(total, 1)),
        noise=jax.random.uniform(k_j1, (2 * N_OCC, 3), minval=-0.5, maxval=0.5)).items()}


def assert_train_close(got, want, start):
    """Parameter trees after SGD steps from `start`: see the module
    docstring."""
    leaves = zip(*(jax.tree_util.tree_leaves(t) for t in (got, want, start)))
    for i, (g, w, s) in enumerate(leaves):
        dg, dw = np.asarray(g) - np.asarray(s), np.asarray(w) - np.asarray(s)
        np.testing.assert_allclose(dg, dw, rtol=0, atol=1e-4 * np.abs(dw).max() + 1e-7,
                                   err_msg=f"leaf {i}")


def assert_grid_close(got, want):
    np.testing.assert_allclose(got["occs"], np.asarray(want.occs).reshape(-1), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(got["binary"], np.asarray(want.binary))


# ------------------------------------------------------------------- fleet

def jax_fleet(n_dev, seeds, schedule):
    """JAX's fleet (make_fleet_train_step, make_fleet_occ_update) over
    n_dev virtual devices on the blocks of `seeds`; schedule entries
    ("occ"|"step", step, key). Returns (the port's schedule with each
    block's draws, the JAX states by entry and block)."""
    mesh = make_mesh(n_dev)
    scenes = [W.scene(s) for s in seeds]
    n = len(seeds)
    layout = [(b // -(-n // n_dev), b % -(-n // n_dev)) for b in range(n)]
    params = [init_params(k + 1) for k in range(n)]
    opt = joptimizer()
    params_B = jfleet.stack_blocks(mesh, params)
    opt_B = jfleet.stack_blocks(mesh, [opt.init(p) for p in params])
    grid_B = jfleet.stack_blocks(mesh, [jocc.init_grid(16) for _ in range(n)])
    images_B = jfleet.stack_blocks(mesh, [s.images for s in scenes])
    c2ws_B = jfleet.stack_blocks(mesh, [s.camtoworlds for s in scenes])
    K_B = jfleet.stack_blocks(mesh, [s.K for s in scenes])
    n_img_B = jfleet.stack_blocks(mesh, [np.int32(s.num_images) for s in scenes])
    step = jfleet.make_fleet_train_step(mesh, opt, jcfg(), jrcfg(), jnp.asarray(AABB), (16, 16),
                                        N_RAYS)
    occ = jfleet.make_fleet_occ_update(mesh, jcfg(), jnp.asarray(AABB),
                                       2 * math.sqrt(3) / W.STEPS, n_samples=N_OCC)
    pack = jfleet.make_fleet_pack_regions(mesh)
    port_schedule, states = [], []
    regions_B = None
    with mesh:
        for op, it, key in schedule:
            keys = [jax.random.fold_in(jax.random.fold_in(key, d), i) for d, i in layout]
            if op == "occ":
                binaries = [np.asarray(g.binary) for g in jfleet.unstack_blocks(grid_B, n)]
                warm = it < JT.OCC_WARMUP_STEPS
                draws = [occ_draws(k, b, warm) for k, b in zip(keys, binaries)]
                grid_B = occ[warm](grid_B, params_B, key)
                regions_B = pack(grid_B.binary)
            else:
                draws = [step_draws(k, s.num_images, N_RAYS) for k, s in zip(keys, scenes)]
                params_B, opt_B, _ = step(params_B, opt_B, grid_B, regions_B, images_B, c2ws_B,
                                          K_B, n_img_B, key)
            port_schedule.append((op, it, draws))
            states.append(list(zip(jfleet.unstack_blocks(params_B, n),
                                   jfleet.unstack_blocks(grid_B, n))))
    init = [(p, np.zeros(16 ** 3, np.float32), np.zeros((16,) * 3, bool)) for p in params]
    return {"seeds": list(seeds), "init": init, "schedule": port_schedule}, states


SCHEDULE = [("occ", 0), ("step", 0), ("step", 1), ("occ", 256), ("step", 2)]


def schedule_keys(seed):
    key = jax.random.PRNGKey(seed)
    return [(op, it, jax.random.fold_in(key, i)) for i, (op, it) in enumerate(SCHEDULE)]


def assert_fleet_matches(got_states, got_blocks, want_states, init):
    for got, want in zip(got_states, want_states):
        for k, g in zip(got_blocks, got):
            wp, wg = want[k]
            assert_train_close(g["params"], wp, init[k][0])
            assert_grid_close(g, wg)


@pytest.fixture(scope="module")
def jax_fleet_two_devices():
    """JAX's fleet of two blocks on two devices, and its draws: the
    reference of the port's fleet on one device and over two ranks (each
    block's result depends on its draws only, not on where it trains)."""
    return jax_fleet(2, (1, 2), schedule_keys(9))


@pytest.fixture(scope="module")
def fleet_one_device(tmp_path_factory, jax_fleet_two_devices):
    data, want = jax_fleet_two_devices
    out = str(tmp_path_factory.mktemp("fleet1"))
    got = W.fleet_run(0, 1, out, dict(data, save=True))
    return data, want, got, out


def test_fleet_two_blocks_on_one_device_match_jax(fleet_one_device):
    data, want, got, _ = fleet_one_device
    assert got["blocks"] == [0, 1] and got["devices"] == ["cpu", "cpu"]
    assert_fleet_matches(got["states"], got["blocks"], want, data["init"])


def test_fleet_blocks_are_independent(fleet_one_device, tmp_path):
    """Block 0 of the two-block fleet == block 0 trained alone on its own
    draws: bit for bit."""
    data, _, pair, _ = fleet_one_device
    solo = dict(data, seeds=data["seeds"][:1], init=data["init"][:1],
                schedule=[(op, it, d[:1]) for op, it, d in data["schedule"]])
    got = W.fleet_run(0, 1, str(tmp_path), solo)
    for a, b in zip(got["states"], pair["states"]):
        for x, y in zip(jax.tree_util.tree_leaves(a[0]), jax.tree_util.tree_leaves(b[0])):
            np.testing.assert_array_equal(x, y)


def test_fleet_checkpoint_loads_in_jax(fleet_one_device):
    _, _, got, out = fleet_one_device
    final = got["states"][-1]
    for k in (0, 1):
        path = os.path.join(out, f"block_{k}", "model", "model.ckpt")
        params, grid, meta, model_cfg, _ = JT.load_field_from_checkpoint(path)
        assert meta["step"] == len(SCHEDULE) and meta["field"] == "ngp"
        np.testing.assert_array_equal(np.asarray(grid.binary), final[k]["binary"])
        for a, b in zip(jax.tree_util.tree_leaves(params),
                        jax.tree_util.tree_leaves(final[k]["params"])):
            np.testing.assert_array_equal(np.asarray(a), b)


def test_fleet_pads_an_uneven_block_count():
    """3 blocks on 2 devices: JAX pads the stack to 4 with a replica of the
    last and shards it contiguously; the port puts blocks 0 and 1 on
    device 0 and block 2 on device 1, and trains no replica."""
    from dregnerf_tpu_torch.parallel.fleet import block_layout

    mesh = make_mesh(2)
    stacked = jfleet.stack_blocks(mesh, [{"a": np.full(2, float(i))} for i in range(3)])
    shards = sorted(((s.index[0].start or 0), np.asarray(s.data)[:, 0].tolist())
                    for s in stacked["a"].addressable_shards)
    per_device = [rows for _, rows in shards]
    assert per_device == [[0.0, 1.0], [2.0, 2.0]]
    layout = block_layout(3, 2)
    assert layout == [(0, 0), (0, 1), (1, 0)]
    assert [[float(b) for b, (d, _) in enumerate(layout) if d == dev] for dev in (0, 1)] == \
        [row[:len([1 for d, _ in layout if d == dev])] for dev, row in enumerate(per_device)]


def test_fleet_refuses_other_fields_and_mixed_sizes(tmp_path):
    """JAX's fleet calls the NGP field's functions whatever --field says, so
    a vanilla field fails in its first step; the port refuses it at once.
    Blocks of different image sizes are refused by both."""
    from dregnerf_tpu_torch.runtime.fleet_trainer import FleetNGPTrainer

    out = str(tmp_path)
    scenes = [W.scene(1), W.scene(2)]
    with pytest.raises(ValueError, match="NGP fields only"):
        FleetNGPTrainer(config_parser(W.flags(out, ["--field", "vanilla"])), scenes,
                        [None, None], [out, out])
    with pytest.raises(ValueError, match="resolution"):
        FleetNGPTrainer(config_parser(W.flags(out)), [scenes[0], W.scene(2, size=8)],
                        [None, None], [out, out])


# --------------------------------------------------------- gloo ranks (2, 4)

def dp_inputs(world, seed=11):
    """The inputs of a dp_run job over `world` ranks: the tiny trainer's
    state, each rank's draws of three steps (JAX's), the surface pass's
    points and rays, attention's and the cross-encoder's inputs."""
    scene = W.scene(0)
    params = init_params(3)
    binary = np.random.default_rng(0).uniform(size=(16,) * 3) < 0.6
    key = jax.random.PRNGKey(seed)
    n = N_RAYS // world
    steps = [(s, [step_draws(jax.random.fold_in(jax.random.fold_in(key, s), d),
                             scene.num_images, n) for d in range(world)])
             for s in (1, 2, 3)]  # no occupancy update, no ray-bucket feedback
    rng = np.random.default_rng(1)
    pts = rng.uniform(-0.8, 0.8, (100, 3)).astype(np.float32)
    cams = np.eye(4, dtype=np.float32)[None].repeat(2, 0)
    cams[0, :3, 3] = [0, 0, 3.0]
    cams[1, :3, 3] = [3.0, 0, 0]
    origin = np.array([0.0, 0.0, 3.0], np.float32)
    d = pts[:64] - origin
    t_max = np.linalg.norm(d, axis=-1)
    rays = {"origins": np.tile(origin, (64, 1)), "viewdirs": d / t_max[:, None], "t_max": t_max}
    a = {n: rng.normal(size=(64, 32)).astype(np.float32) for n in ("q", "k", "v")}
    a.update(qv=np.arange(64) < 50, kv=np.arange(64) < 40, heads=4)
    shape = (2, 32, 4, 64)
    e = {"tree": pregtr.random_jax_params(TransformerCrossEncoder(*shape), rng), "shape": shape}
    e.update({n: rng.normal(size=(1, 64, 32)).astype(np.float32)
              for n in ("src", "tgt", "spos", "tpos")})
    e.update(sv=np.arange(64)[None] < 50, tv=np.arange(64)[None] < 40)
    e["cot"] = [rng.normal(size=(2, 1, 64, 32)).astype(np.float32) for _ in range(2)]
    return {"init": (params, np.zeros(16 ** 3, np.float32), binary), "steps": steps,
            "surface": {"points": pts, "cameras": cams, "chunk": 64, "buffer": 1 << 13,
                        "rays": rays},
            "attention": a, "encoder": e, "seed": seed}


def dp_expected(world, data):
    """make_dp_train_step's three steps on dp_inputs' draws over a
    `world`-device mesh."""
    mesh = make_mesh(world)
    scene = W.scene(0)
    params, _, binary = data["init"]
    grid = jocc.init_grid(16)._replace(binary=jnp.asarray(binary))
    opt = joptimizer()
    key = jax.random.PRNGKey(data["seed"])
    step = make_dp_train_step(mesh, opt, jcfg(), jrcfg(), jnp.asarray(AABB), (16, 16),
                              num_rays_per_device=N_RAYS // world)
    jp, jo = replicated(mesh, (params, opt.init(params)))
    want = []
    with mesh:
        for i, _ in data["steps"]:
            jp, jo, m = step(jp, jo, grid, None, jnp.asarray(scene.images),
                             jnp.asarray(scene.camtoworlds), jnp.asarray(scene.K), key,
                             np.int32(i))
            want.append((jax.tree_util.tree_map(np.asarray, jp),
                         {k: float(v) for k, v in m.items()}))
    return {"train": want, "init": params}


def sharded_expected(data):
    """JAX's make_sharded_surface_fn, compute_surface_mask(mesh=),
    sharded_attention and the cross-encoder under its sp_mesh on dp_inputs'
    inputs, over two devices: the reference of the port at 2 and 4 ranks
    (the inputs do not depend on the world size, and each output row is
    the same function of them on any mesh that divides the rows)."""
    mesh = make_mesh(2)
    params, _, binary = data["init"]
    grid = jocc.init_grid(16)._replace(binary=jnp.asarray(binary))
    aabb = jnp.asarray(AABB)
    s, a, e = data["surface"], data["attention"], data["encoder"]
    rays = [jnp.asarray(s["rays"][k]) for k in ("origins", "viewdirs", "t_max")]
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    sp = jtr.TransformerCrossEncoder(num_layers=2, d_model=32, num_heads=4, dim_feedforward=64,
                                     sp_mesh=mesh)
    with mesh:
        fn = make_sharded_surface_fn(mesh, jcfg(), aabb, jrcfg(), 1 << 12)
        shard = np.asarray(fn(jparams, grid, *rays))
        scores = compute_surface_mask(jparams, jcfg(), grid, aabb, jrcfg(), s["points"],
                                      s["cameras"], chunk=s["chunk"], buffer_size=s["buffer"],
                                      mesh=mesh, return_scores=True)
        attention = np.asarray(sharded_attention(
            mesh, *(jnp.asarray(a[n]) for n in ("q", "k", "v", "qv", "kv")), num_heads=4))
        encoder = [np.asarray(x) for x in sp.apply(
            {"params": e["tree"]}, *(jnp.asarray(e[n]) for n in ("src", "tgt", "sv", "tv",
                                                                  "spos", "tpos")))]
    return {"scores": scores, "shard_scores": shard, "attention": attention,
            "encoder": encoder, "encoder_inputs": e}


def reg_inputs(tmp_path, world=2):
    """Two registration DP steps over `world` pairs (the second with a NaN in
    one pair's colours), and a port trainer with the ranks' initial
    weights (the config's seed)."""
    rng = np.random.default_rng(4)
    items = [W.pair_item(rng, REG_R) for _ in range(world)]
    bad = [dict(it) for it in items]
    grid = bad[-1]["src_grid"].copy()
    occupied = np.argwhere(bad[-1]["src_mask"].reshape((REG_R,) * 3))[0]
    grid[tuple(occupied)][3] = np.nan
    bad[-1]["src_grid"] = grid
    cfg = config_parser(REG_FLAGS + ["--out_dir", str(tmp_path), "--expname", "ref"])
    port = RegTrainer(cfg, items, [], model=NeRFRegTr(**REG_SHAPE))
    return {"flags": REG_FLAGS, "shape": REG_SHAPE, "steps": [items, bad]}, port


def reg_expected(world, data, tree, lr, aabb):
    """make_dp_reg_step's two steps on reg_inputs' pairs from the port
    trainer's weights `tree` (port_params_tree), at its lr and aabb."""
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    mesh = make_mesh(world)
    schedule = optax.piecewise_constant_schedule(lr, {34000 * (i + 1): 0.5 for i in range(4)})
    opt = optax.chain(optax.clip_by_global_norm(0.1), optax.adamw(schedule, weight_decay=1e-4))
    step = make_dp_reg_step(mesh, jregtr.NeRFRegTr(dtype=jnp.float32, **REG_SHAPE), opt,
                            jnp.asarray(aabb, jnp.float32), REG_R, robust=True)
    params, ostate = replicated(mesh, (params, opt.init(params)))
    want = []
    with mesh:
        for its in data["steps"]:
            batch = {k: jnp.asarray(np.stack([it[k] for it in its]))
                     for k in ("src_grid", "tgt_grid", "src_mask", "tgt_mask", "pose")}
            params, ostate, m = step(params, ostate, batch)
            want.append((jax.tree_util.tree_map(np.asarray, params),
                         {k: float(v) for k, v in m.items()}))
    return want


def _pickled(path, fn, *args):
    """fn(*args), pickled to `path` (the target of a spawned process; a
    failure leaves its traceback in path + '.err')."""
    try:
        result = fn(*args)
    except BaseException:
        with open(path + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise
    with open(path, "wb") as f:
        pickle.dump(result, f)


def _unpickled(proc, path, timeout=300.0):
    proc.join(timeout)
    if proc.is_alive():
        proc.kill()
        proc.join()
    if proc.exitcode != 0:
        err = open(path + ".err").read() if os.path.exists(path + ".err") else ""
        raise RuntimeError(f"{path}: exit code {proc.exitcode}\n{err}")
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def rank_runs(tmp_path_factory, jax_fleet_two_devices):
    """The four-rank job (the DP step, surface pass, attention, the sp
    switch) and the two-rank job (those, the registration DP step and the
    two-block fleet) run while JAX's references are computed here."""
    tmp2, tmp4 = (str(tmp_path_factory.mktemp(f"ranks{w}")) for w in (2, 4))
    fdata, fwant = jax_fleet_two_devices
    data = {w: dp_inputs(w) for w in (2, 4)}
    data[2]["reg"], port = reg_inputs(tmp2, 2)
    reg_path = os.path.join(tmp2, "reg_expected.pkl")
    reg = multiprocessing.get_context("spawn").Process(
        target=_pickled, args=(reg_path, reg_expected, 2, data[2]["reg"], port_params_tree(port),
                               port.config.lr, port.config.aabb))
    reg.start()  # JAX's registration DP step compiles for about 40 s: in a process of its own
    procs = {4: W.start_ranks(W.dp_run, 4, tmp4, (tmp4, data[4])),
             2: W.start_ranks(W.dp_and_fleet_run, 2, tmp2, (tmp2, data[2], fdata))}
    try:
        shared = sharded_expected(data[2])
        expected = {w: dict(dp_expected(w, data[w]), **shared) for w in (2, 4)}
    finally:
        try:
            results = {w: W.join_ranks(procs[w], tmp) for w, tmp in ((2, tmp2), (4, tmp4))}
        finally:
            reg_want = _unpickled(reg, reg_path)
    expected[2]["reg"], expected[2]["reg_port"] = reg_want, port
    return results, expected, (fdata, fwant)


@pytest.fixture(scope="module")
def two_ranks(rank_runs):
    results, expected, fleet = rank_runs
    return results[2], expected[2], fleet


def _ranks(request, world):
    results, expected, _ = request.getfixturevalue("rank_runs")
    return [r["dp"] if world == 2 else r for r in results[world]], expected[world]


@pytest.mark.parametrize("world", [2, 4])
def test_dp_step_matches_jax(request, world):
    """Three data-parallel steps: every rank's parameters against
    make_dp_train_step's, the summed counts and mean loss, and the ranks
    equal bit for bit."""
    results, expected = _ranks(request, world)
    assert [r["device"] for r in results] == ["cpu"] * world
    for i, (want_params, want_m) in enumerate(expected["train"]):
        for r in results:
            got = r["metrics"][i]
            assert got["n_samples"] == want_m["n_samples"] > 0
            assert got["alive_rays"] == want_m["alive_rays"]
            np.testing.assert_allclose(got["loss"], want_m["loss"], rtol=1e-5)
            np.testing.assert_allclose(got["psnr"], want_m["psnr"], rtol=1e-5)
            assert_train_close(r["states"][i]["params"], want_params, expected["init"])
        for r in results[1:]:
            for a, b in zip(jax.tree_util.tree_leaves(r["states"][i]),
                            jax.tree_util.tree_leaves(results[0]["states"][i])):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_surface_pass_matches_jax(request, world):
    results, expected = _ranks(request, world)
    for r in results:
        np.testing.assert_allclose(r["shard_scores"], expected["shard_scores"], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(r["scores"], expected["scores"], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(r["scores"] >= 0.5, expected["scores"] >= 0.5)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_attention_matches_jax(request, world):
    results, expected = _ranks(request, world)
    for r in results:
        np.testing.assert_allclose(r["attention"], expected["attention"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_cross_encoder_sp_switch_matches_jax(request, world):
    """TransformerCrossEncoder(sp_mesh=...) against JAX's with the same
    flax weights; its gradients (parameters and inputs) against the port's
    local attention, whole on every rank."""
    results, expected = _ranks(request, world)
    local = TransformerCrossEncoder(2, 32, 4, 64)
    data = expected["encoder_inputs"]
    local.load_state_dict(pregtr.params_from_jax(data["tree"], local))
    inputs = [torch.as_tensor(data[n]) for n in ("src", "tgt", "sv", "tv", "spos", "tpos")]
    for i in (0, 1):
        inputs[i].requires_grad_(True)
    outs = local(*inputs)
    sum((o * torch.as_tensor(c)).sum() for o, c in zip(outs, data["cot"])).backward()
    for r in results:
        enc = r["encoder"]
        for got, want in zip(enc["out"], expected["encoder"]):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        scale = max(np.abs(p.grad.numpy()).max() for p in local.parameters())
        for name, p in local.named_parameters():
            np.testing.assert_allclose(enc["grads"][name], p.grad.numpy(), rtol=0,
                                       atol=1e-5 * scale, err_msg=name)
        for i in (0, 1):
            g = inputs[i].grad.numpy()
            np.testing.assert_allclose(enc["input_grads"][i], g, rtol=0,
                                       atol=1e-5 * np.abs(g).max())


def test_reg_dp_step_matches_jax(two_ranks):
    """One registration DP step over two ranks against make_dp_reg_step,
    then a step whose second pair holds a NaN: skipped on both ranks, in
    JAX too, with every parameter and the count unchanged."""
    results, expected, _ = two_ranks
    (want0, m0), (want1, m1) = expected["reg"]
    port = expected["reg_port"]
    assert m0["skipped_nonfinite"] == 0.0 and m1["skipped_nonfinite"] == 1.0
    for r in results:
        reg = r["dp"]["reg"]
        first, second = reg["steps"]
        for k in ("total", "overlap", "nerf_cont", "feature", "corr", "R_error", "t_error"):
            np.testing.assert_allclose(first["metrics"][k], m0[k], rtol=1e-4, err_msg=k)
        assert first["metrics"]["skipped_nonfinite"] == 0.0 and first["count"] == 1
        port.optimizer.flat.copy_(torch.as_tensor(first["flat"]))
        assert_step_agrees(port_params_tree(port), want0)
        assert second["metrics"]["skipped_nonfinite"] == 1.0 and second["count"] == 1
        np.testing.assert_array_equal(second["flat"], first["flat"])
    np.testing.assert_array_equal(results[0]["dp"]["reg"]["steps"][0]["flat"],
                                  results[1]["dp"]["reg"]["steps"][0]["flat"])


def test_fleet_over_two_ranks_matches_jax(two_ranks):
    """Two blocks under --mesh_shape 2: rank 0 trains block 0, rank 1 block
    1, each against make_fleet_train_step and make_fleet_occ_update on two
    devices (an uneven count: test_fleet_pads_an_uneven_block_count)."""
    results, _, (data, want) = two_ranks
    assert [r["fleet"]["blocks"] for r in results] == [[0], [1]]
    for r in results:
        assert_fleet_matches(r["fleet"]["states"], r["fleet"]["blocks"], want, data["init"])


# ------------------------------------------------------------------- mesh

def test_mesh_from_config():
    """'' and a product of 1 give no mesh; a mesh larger than the world
    (here one process, no group) raises, as does a model axis over 1; a
    one-rank mesh is a valid mesh whose collectives are identities."""
    def cfg(spec):
        return config_parser(["--mesh_shape", spec, "--device", "cpu"])

    assert pmesh.make_mesh_from_config(cfg("")) is None
    assert pmesh.make_mesh_from_config(cfg("1")) is None
    assert pmesh.make_mesh_from_config(cfg("1,1")) is None
    with pytest.raises(ValueError, match="world of 2 processes"):
        pmesh.make_mesh_from_config(cfg("2"))
    with pytest.raises(ValueError, match="model axis"):
        pmesh.make_mesh_from_config(cfg("2,2"))
    mesh = pmesh.make_mesh(1, device="cpu")
    assert (mesh.size, mesh.rank, mesh.device.type) == (1, 0, "cpu")
    x = torch.arange(6.0)
    assert torch.equal(mesh.all_reduce_sum_(x.clone()), x)
    assert torch.equal(mesh.all_gather_rows(x), x) and torch.equal(mesh.shard(x), x)


def test_mesh_shape_is_honoured_by_the_entry_points(tmp_path):
    """--mesh_shape 2 in a one-process run: the NGP trainer, the evaluator
    and the registration trainer each build the mesh and refuse the world
    that does not fit it (JAX raises when the mesh needs more devices
    than it sees); the registration trainer keeps JAX's refusals."""
    from dregnerf_tpu_torch.eval_ngp_nerf import Evaluator
    from dregnerf_tpu_torch.runtime.ngp_trainer import NGPTrainer

    out = str(tmp_path)
    cfg = config_parser(W.flags(out, ["--mesh_shape", "2"]))
    with pytest.raises(ValueError, match="world of 2 processes"):
        NGPTrainer(cfg, W.scene(0), None)
    with pytest.raises(ValueError, match="world of 2 processes"):
        Evaluator(cfg, out, W.scene(0))
    items = [W.pair_item(np.random.default_rng(0), REG_R)]
    for extra, match in ((["--mesh_shape", "2"], "world of 2 processes"),
                         (["--mesh_shape", "2", "--visibility", "exact"], "visibility exact"),
                         (["--mesh_shape", "2", "--reg_batch_size", "2"], "reg_batch_size")):
        with pytest.raises(ValueError, match=match):
            RegTrainer(config_parser(REG_FLAGS + ["--out_dir", out] + extra), items, [],
                       model=NeRFRegTr(**REG_SHAPE))
