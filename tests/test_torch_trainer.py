"""Port parity for the slice as a whole: one training step against a JAX
reference built from the JAX package's public functions with the draws
`_make_step_fn` makes, Adam and the LR schedule against optax, a tiny
CPU training run, checkpoints crossing between the packages both ways,
the device policy, the fixture data and the CLI twin."""
import math
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dregnerf_tpu.datasets import fixtures as jfix
from dregnerf_tpu.datasets.base import load_scene_blocks
from dregnerf_tpu.geometry.cameras import rays_from_pixels
from dregnerf_tpu.models import ngp as jngp
from dregnerf_tpu.ops import occupancy as jocc
from dregnerf_tpu.ops.packed_grid import PackedGridConfig as JGrid
from dregnerf_tpu.render.renderer import RenderConfig as JRenderConfig
from dregnerf_tpu.render.renderer import render_rays as jrender_rays
from dregnerf_tpu.runtime import ngp_trainer as JT
from dregnerf_tpu.runtime.config import config_parser as jconfig_parser
from dregnerf_tpu.utils.metrics import mse_to_psnr
from dregnerf_tpu_torch import train_ngp_nerf as tcli
from dregnerf_tpu_torch.datasets import fixtures as tfix
from dregnerf_tpu_torch.models import ngp as tngp
from dregnerf_tpu_torch.ops import occupancy as tocc
from dregnerf_tpu_torch.ops.packed_grid import PackedGridConfig as TGrid
from dregnerf_tpu_torch.render import renderer as trender
from dregnerf_tpu_torch.runtime import ngp_trainer as TT
from dregnerf_tpu_torch.runtime.config import config_parser as tconfig_parser

GRID = dict(n_levels=2, log2_table_size=10, base_resolution=4, per_level_scale=2.0)
AABB = [-1.0, -1.0, -1.0, 1.0, 1.0, 1.0]


def _tiny_argv(out, steps=120):
    return ["--dataset", "objaverse", "--expname", "tiny", "--out_dir", out,
            "--factor", "1", "--aabb=-1.0,-1.0,-1.0,1.0,1.0,1.0",
            "--max_iterations", str(steps), "--sample_budget", str(1 << 12),
            "--max_march_steps", "128", "--grid_resolution", "32",
            "--init_num_rays", "256", "--max_num_rays", "1024",
            "--n_tensorboard", "1000", "--n_validation", "1000000",
            "--n_checkpoint", str(steps), "--no_bf16", "--grad_accum", "pallas",
            "--no-rle_backward"]


def _shrink(trainer, seed=0):
    """Swap the full-size default model for a tiny one (CPU speed)."""
    trainer.model_config = tngp.NGPConfig(grid=TGrid(**GRID, grad_accum="pallas"),
                                          compute_dtype=torch.float32)
    trainer.params = tngp.init_ngp(trainer.model_config, torch.Generator().manual_seed(seed))
    for p in tngp.parameters(trainer.params):
        p.requires_grad_(True)
    trainer.setup_optimizer()


def test_one_step_matches_jax_reference():
    scene = tfix.make_scene_data("train", num_views=8, image_size=24)
    jcfg = jngp.NGPConfig(grid=JGrid(**GRID, grad_accum="pallas"), compute_dtype=jnp.float32)
    tcfg = tngp.NGPConfig(grid=TGrid(**GRID, grad_accum="pallas"), compute_dtype=torch.float32)
    jparams = jngp.init_ngp(jax.random.PRNGKey(0), jcfg)
    jparams["table"] = jparams["table"] * 1000.0
    binary = np.random.default_rng(0).uniform(size=(16,) * 3) < 0.6
    jgrid = jocc.init_grid(16)._replace(binary=jnp.asarray(binary))
    steps = 64
    rkw = dict(render_step_size=2 * math.sqrt(3) / steps, buffer_size=1 << 12,
               max_steps=steps, march_compaction="capped", k_cap=min(512, steps))
    num_rays, aabb = 256, np.asarray(AABB, np.float32)
    images, c2ws, K = scene.images, scene.camtoworlds, scene.K
    H, W = scene.height, scene.width

    # the draws of ngp_trainer._make_step_fn at step 5
    key = jax.random.fold_in(jax.random.PRNGKey(3), 5)
    kimg, kx, ky, kbg, kmarch = jax.random.split(key, 5)
    img_id = jax.random.randint(kimg, (num_rays,), 0, images.shape[0])
    x = jax.random.randint(kx, (num_rays,), 0, W)
    y = jax.random.randint(ky, (num_rays,), 0, H)
    bg = jax.random.uniform(kbg, (3,))
    jitter = jax.random.uniform(kmarch, (num_rays, 1))  # march_rays' stratified draw

    def jloss(p):
        rgba = jnp.asarray(images)[img_id, y, x].astype(jnp.float32) / 255.0
        pixels = rgba[:, :3] * rgba[:, 3:4] + bg * (1.0 - rgba[:, 3:4])
        rays = rays_from_pixels(x, y, jnp.asarray(K), jnp.asarray(c2ws)[img_id], True)
        out, aux = jrender_rays(p, jcfg, jgrid, rays.origins, rays.viewdirs,
                                jnp.asarray(aabb), JRenderConfig(**rkw), background=bg,
                                stratified=True, key=kmarch)
        alive = (aux["ray_counts"] > 0).astype(jnp.float32)
        n_alive = jnp.maximum(jnp.sum(alive), 1.0)
        loss = jnp.sum(JT.huber(out.rgb - pixels) * alive[:, None]) / (n_alive * 3.0)
        sq = jnp.sum((out.rgb - pixels) ** 2 * alive[:, None]) / (n_alive * 3.0)
        return loss, (aux["n_samples"], sq)

    (loss, (n_samples, sq)), grads = jax.value_and_grad(jloss, has_aux=True)(jparams)

    tparams = tngp.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    for p in tngp.parameters(tparams):
        p.requires_grad_(True)
    draws = TT.StepDraws(*(torch.as_tensor(np.array(a)) for a in (img_id, x, y, bg, jitter)))
    tloss, metrics = TT.step_loss(
        tparams, tcfg, trender.RenderConfig(**rkw),
        tocc.occupancy_from_numpy(np.zeros(16**3), binary), torch.as_tensor(aabb),
        torch.as_tensor(images), torch.as_tensor(c2ws), torch.as_tensor(K), draws,
        synthetic=True, opengl=True)
    tloss.backward()

    assert int(metrics["n_samples"]) == int(n_samples) > 0
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=1e-4)
    np.testing.assert_allclose(metrics["psnr"].item(), float(mse_to_psnr(sq)), rtol=1e-4)
    jg = jax.tree_util.tree_map(np.asarray, grads)
    want_all = [jg["table"], *jg["density_mlp"], *jg["color_mlp"]]
    for i, (p, want) in enumerate(zip(tngp.parameters(tparams), want_all)):
        scale = np.abs(want).max()
        assert scale > 0
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=f"gradient {i}")


@pytest.mark.parametrize("max_steps", [2, 8, 100, 20000])
def test_multistep_lr_matches_optax(max_steps):
    sched = JT.multistep_lr(1e-2, max_steps)
    lr = TT.multistep_lr(1e-2, max_steps)
    for i in sorted({0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 49, 50, 74, 75, 89, 90, 91,
                     max_steps // 2, max_steps // 2 - 1, int(max_steps * 0.9)}):
        np.testing.assert_allclose(lr(i), float(sched(i)), rtol=1e-6, err_msg=str(i))


def test_adam_updates_match_optax():
    """The trainer's Adam (lr 1e-2, eps 1e-15, multistep schedule) against
    optax.adam on the same gradients, across the schedule's boundaries."""
    rng = np.random.default_rng(0)
    shapes = {"table": [(6, 4)], "density_mlp": [(4, 3), (3, 2)],
              "color_mlp": [(5, 3), (3, 3), (3, 3)]}
    init = {k: [rng.normal(size=s).astype(np.float32) for s in v] for k, v in shapes.items()}
    init["table"] = init["table"][0]
    max_steps = 8
    stub = types.SimpleNamespace(config=types.SimpleNamespace(max_iterations=max_steps),
                                 params=tngp.params_from_jax(init))
    for p in tngp.parameters(stub.params):
        p.requires_grad_(True)
    TT.NGPTrainer.setup_optimizer(stub)
    opt = optax.adam(JT.multistep_lr(1e-2, max_steps), eps=1e-15)
    jparams = jax.tree_util.tree_map(jnp.asarray, init)
    state = opt.init(jparams)
    for step in range(max_steps):
        g = {k: [rng.normal(size=s).astype(np.float32) for s in v] for k, v in shapes.items()}
        g["table"] = g["table"][0]
        updates, state = opt.update(jax.tree_util.tree_map(jnp.asarray, g), state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, gp in zip(tngp.parameters(stub.params),
                         [g["table"], *g["density_mlp"], *g["color_mlp"]]):
            p.grad = torch.as_tensor(gp)
        TT.NGPTrainer.apply_gradients(stub, step)
    want = tngp.params_to_numpy(tngp.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams)))
    got = tngp.params_to_numpy(stub.params)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("torch_out"))
    scene = tfix.make_scene_data("train", num_views=24, image_size=48)
    val = tfix.make_scene_data("test", num_views=24, image_size=48)
    cfg = tconfig_parser(_tiny_argv(out))
    trainer = TT.NGPTrainer(cfg, scene, val, device="cpu")
    _shrink(trainer)
    before = trainer.validate(0)
    trainer.train()
    return trainer, cfg, before


def test_tiny_run_learns(trained):
    trainer, _, before = trained
    after = trainer.validate(120)
    assert after > 14.0 and after > before + 3.0, (before, after)
    frac = trainer.grid.binary.float().mean().item()
    assert 0.0 < frac < 0.9


def test_port_checkpoint_loads_in_jax(trained):
    trainer, cfg, _ = trained
    path = os.path.join(cfg.out_dir, cfg.expname, "model", "model.ckpt")
    params, grid, meta, model_cfg, _ = JT.load_field_from_checkpoint(path)
    assert meta["step"] == 120 and model_cfg.grid.grad_accum == "pallas"
    np.testing.assert_array_equal(np.asarray(grid.binary), trainer.grid.binary.numpy())
    x = np.random.default_rng(0).uniform(-1, 1, (300, 3)).astype(np.float32)
    want = jngp.query_density(params, jnp.asarray(x), jnp.asarray(AABB), model_cfg)
    with torch.no_grad():
        got = tngp.query_density(trainer.params, torch.as_tensor(x),
                                 trainer.aabb, trainer.model_config)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_port_resumes_from_its_checkpoint(trained):
    trainer, cfg, _ = trained
    fresh = TT.NGPTrainer(cfg, trainer.scene, trainer.val_scene, device="cpu")
    _shrink(fresh, seed=1)
    assert fresh.load_checkpoint() == 120
    assert fresh.num_rays == trainer.num_rays
    for a, b in zip(tngp.parameters(fresh.params), tngp.parameters(trainer.params)):
        torch.testing.assert_close(a.detach(), b.detach(), rtol=0, atol=0)
    state = fresh.optimizer.state[tngp.parameters(fresh.params)[0]]
    assert float(state["step"]) == 120.0


def test_jax_checkpoint_loads_in_port(tmp_path):
    root = str(tmp_path / "data")
    jfix.make_scene(root, num_views=8, image_size=16)
    scene = load_scene_blocks("objaverse", root, "fixture_scene", "train")[0]
    jcfg = jconfig_parser(_tiny_argv(str(tmp_path / "out")) + ["--compilation_cache", ""])
    jtrainer = JT.NGPTrainer(jcfg, scene)
    small = jngp.NGPConfig(grid=JGrid(**GRID), compute_dtype=jnp.float32)
    params = jngp.init_ngp(jax.random.PRNGKey(1), small)
    params["table"] = params["table"] * 1000.0
    jtrainer.model_config = small
    jtrainer.state.params = params
    jtrainer.state.opt_state = jtrainer.optimizer.init(params)
    binary = np.random.default_rng(2).uniform(size=(16,) * 3) < 0.4
    jtrainer.state.grid = jocc.init_grid(16)._replace(binary=jnp.asarray(binary))
    jtrainer.save_checkpoint(7)
    path = os.path.join(jtrainer.output_dir, "model", "model.ckpt")

    tparams, tgrid, meta, tcfg, rcfg = TT.load_field_from_checkpoint(path, device="cpu")
    assert meta["step"] == 7 and rcfg.max_steps == 128
    np.testing.assert_array_equal(tgrid.binary.numpy(), binary)
    x = np.random.default_rng(0).uniform(-1, 1, (300, 3)).astype(np.float32)
    want = jngp.query_density(params, jnp.asarray(x), jnp.asarray(AABB), small)
    got = tngp.query_density(tparams, torch.as_tensor(x), torch.tensor(AABB), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_entry_points_refuse_the_cpu_unless_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = tfix.make_scene_data("train", num_views=4, image_size=8)
    cfg = tconfig_parser(_tiny_argv(str(tmp_path)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.NGPTrainer(cfg, scene)
    grid = tocc.init_grid(16)
    params = tngp.init_ngp(tngp.NGPConfig(grid=TGrid(**GRID)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trender.render_rays(params, tngp.NGPConfig(grid=TGrid(**GRID)), grid,
                            torch.zeros(4, 3), torch.ones(4, 3) / math.sqrt(3),
                            torch.tensor(AABB), trender.RenderConfig())
    assert TT.NGPTrainer(cfg, scene, device="cpu").device.type == "cpu"


def test_fixture_scene_matches_the_jax_loader(tmp_path):
    """The in-memory fixture equals what the JAX objaverse loader reads
    from the JAX fixture's files, for both splits."""
    jfix.make_scene(str(tmp_path), num_views=24, image_size=16)
    for split in ("train", "test"):
        want = load_scene_blocks("objaverse", str(tmp_path), "fixture_scene", split)[0]
        got = tfix.make_scene_data(split, num_views=24, image_size=16)
        np.testing.assert_array_equal(got.images, want.images)
        np.testing.assert_allclose(got.camtoworlds, want.camtoworlds, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got.K, want.K, rtol=1e-6)
        assert (got.opengl, got.synthetic) == (want.opengl, want.synthetic)


def test_cli_twin_trains_from_disk(tmp_path):
    root = str(tmp_path / "data")
    tfix.make_scene(root, num_views=8, image_size=16)
    argv = ["--root_dir", root, "--scene", "fixture_scene", "--device", "cpu",
            *_tiny_argv(str(tmp_path / "out"), steps=2)]
    with pytest.raises(NotImplementedError, match="ROADMAP"):  # the bf16 default
        tcli.main([a for a in argv if a not in ("pallas", "--grad_accum")])
    tcli.main(argv)
    assert os.path.exists(os.path.join(str(tmp_path / "out"), "tiny", "model", "model.ckpt"))
