"""Port parity for the vanilla and D-NeRF fields (models/mlp_nerf.py,
models/fields.py), their rendering with times (render/renderer.py), one
training step of `--field vanilla` and `--field dnerf` (runtime/
ngp_trainer.py) and their checkpoints, against the JAX package, at small
widths on numpy-seeded inputs with JAX's init carried across by
params_from_jax.

Tolerances: posenc within 1e-6 absolute; in f32 every output within 1e-5
of its max |value|, and in bf16 within 2e-2 (a bf16 ulp is 2^-8 relative,
and the packages round each layer's input after f32 sums that differ in
their last bits); renders (f32): equal sample counts, rgb/opacity/depth within
1e-5 of their max; a training step: equal sample counts, loss and PSNR 1e-4
relative, each gradient leaf within 2e-2 of its max |value| in bf16 and in
f32 within 1e-4 (vanilla; measured 3.8e-6) or 5e-4 (D-NeRF; measured
1.0e-4 on the warp and the first trunk layers: the warped x enters
posenc at frequencies up to 2^(L-1), which scale its rounding
differences); checkpoints: parameters and Adam moments bit for bit."""
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dregnerf_tpu.datasets import dnerf_synthetic as jdnerf
from dregnerf_tpu.geometry.cameras import rays_from_pixels
from dregnerf_tpu.models import fields as jfields
from dregnerf_tpu.models import mlp_nerf as jmlp
from dregnerf_tpu.ops import occupancy as jocc
from dregnerf_tpu.render.renderer import RenderConfig as JRenderConfig
from dregnerf_tpu.render.renderer import render_image_chunked as jrender_image_chunked
from dregnerf_tpu.render.renderer import render_rays as jrender_rays
from dregnerf_tpu.runtime import checkpoint as jckpt
from dregnerf_tpu.runtime import ngp_trainer as JT
from dregnerf_tpu.runtime.config import config_parser as jconfig_parser
from dregnerf_tpu.utils.metrics import mse_to_psnr
from dregnerf_tpu_torch import eval_ngp_nerf as teval
from dregnerf_tpu_torch import train_ngp_nerf as tcli
from dregnerf_tpu_torch.datasets import dnerf_synthetic as tdnerf
from dregnerf_tpu_torch.datasets import fixtures as tfix
from dregnerf_tpu_torch.models import fields as tfields
from dregnerf_tpu_torch.models import mlp_nerf as tmlp
from dregnerf_tpu_torch.ops import occupancy as tocc
from dregnerf_tpu_torch.render import renderer as trender
from dregnerf_tpu_torch.runtime import ngp_trainer as TT
from dregnerf_tpu_torch.runtime.checkpoint import leaves_with_paths
from dregnerf_tpu_torch.runtime.config import config_parser as tconfig_parser

# small widths: a 6-deep trunk (the skip after layer 3), a 2-layer warp
SMALL = dict(net_depth=6, net_width=32, net_width_condition=16, posenc_xyz=4, posenc_dir=2,
             warp_depth=2, warp_width=16, posenc_time=2)
AABB = [-1.0, -1.0, -1.0, 1.0, 1.0, 1.0]
# the trainers' widths: JAX's load_field_from_checkpoint fills a template
# of the default depths and encodings, so only the widths shrink
NARROW = dict(net_width=16, net_width_condition=8, warp_width=8)
STEPS = 64  # march steps of the render and step tests
TOL = {False: 1e-5, True: 2e-2}  # f32, bf16: of the max |value|


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """At most 2 torch threads: the tier-1 run puts several test processes
    on the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _configs(field, bf16=False, widths=SMALL):
    small = dict(widths, warp=field == "dnerf")
    jdtype, tdtype = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    return (jmlp.VanillaNeRFConfig(**small, compute_dtype=jdtype),
            tmlp.VanillaNeRFConfig(**small, compute_dtype=tdtype))


def _params(field, jcfg, seed=0):
    jp = jfields.get_field(field).init(jax.random.PRNGKey(seed), jcfg)
    return jp, tmlp.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _close(got, want, tol, label=""):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    scale = np.abs(want).max()
    assert scale > 0, label
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=label)


@pytest.mark.parametrize("num_freqs", [0, 1, 4, 10])
def test_posenc_matches_jax(num_freqs):
    x = np.random.default_rng(0).uniform(-2, 2, (5, 7, 3)).astype(np.float32)
    for include in (True, False):
        want = np.asarray(jmlp.posenc(jnp.asarray(x), num_freqs, include))
        got = tmlp.posenc(torch.as_tensor(x), num_freqs, include).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("field", ["vanilla", "dnerf"])
def test_init_matches_jax_layout(field):
    """The same tree of the same shapes as JAX's init at full width, He
    bounds, zero biases, and params_from_jax / params_to_numpy round trip."""
    jcfg = jmlp.VanillaNeRFConfig(warp=field == "dnerf")
    tcfg = tmlp.VanillaNeRFConfig(warp=field == "dnerf")
    jp = jmlp.init_vanilla_nerf(jax.random.PRNGKey(0), jcfg)
    tp = tmlp.init_vanilla_nerf(tcfg, torch.Generator().manual_seed(0), "cpu")
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
    numpy_tree = tmlp.params_to_numpy(tp)
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), numpy_tree) == shapes
    assert (shapes["trunk"][4]["w"][0], shapes["trunk"][0]["w"][0]) == (256 + 63, 63)
    for path, leaf in leaves_with_paths(tp).items():
        if path.endswith("b"):
            assert not leaf.any(), path
        else:
            assert leaf.abs().max() <= math.sqrt(6.0 / leaf.shape[0]), path
    back = tmlp.params_from_jax(numpy_tree, "cpu")
    for (k, a), (k2, b) in zip(leaves_with_paths(back).items(), leaves_with_paths(tp).items()):
        assert k == k2 and torch.equal(a, b)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("field", ["vanilla", "dnerf"])
def test_field_functions_match_jax(field, bf16):
    """forward, query_density (with and without a time, and its features),
    query_rgb and warp_points of the registry's field, on 512 points in and
    beyond the aabb (the strict selector on the un-warped x)."""
    jcfg, tcfg = _configs(field, bf16)
    jp, tp = _params(field, jcfg)
    jf, tf = jfields.get_field(field), tfields.get_field(field)
    rng = np.random.default_rng(1)
    x = rng.uniform(-1.2, 1.2, (512, 3)).astype(np.float32)
    x[:4] = [[1.0, 0.0, 0.0], [0.0, -1.0, 0.5], [0.99, 0.99, 0.99], [0.0, 0.0, 0.0]]
    d = rng.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = rng.uniform(0, 1, (512, 1)).astype(np.float32)
    aabb = np.asarray(AABB, np.float32)
    J = lambda a: jnp.asarray(a)  # noqa: E731
    T = torch.as_tensor
    tol = TOL[bf16]
    for kw_j, kw_t, label in (({}, {}, "no time"), ({"t": J(t)}, {"t": T(t)}, "time")):
        jd, jfeat = jf.query_density(jp, J(x), J(aabb), jcfg, return_feat=True, **kw_j)
        td, tfeat = tf.query_density(tp, T(x), T(aabb), tcfg, return_feat=True, **kw_t)
        _close(td, jd, tol, f"density {label}")
        _close(tfeat, jfeat, tol, f"feat {label}")
        assert (td[:2] == 0).all() and (td[2:4] > 0).all()  # on the box's faces: outside
        jrgb, jsig = jf.forward(jp, J(x), J(d), J(aabb), jcfg, **kw_j)
        trgb, tsig = tf.forward(tp, T(x), T(d), T(aabb), tcfg, **kw_t)
        _close(trgb, jrgb, tol, f"rgb {label}")
        _close(tsig, jsig, tol, f"sigma {label}")
    _close(tf.query_rgb(tp, T(d), tfeat, tcfg), jf.query_rgb(jp, J(d), jfeat, jcfg), tol, "rgb")
    if field == "dnerf":
        want = jmlp.warp_points(jp, J(x), J(t), jcfg)
        got = tmlp.warp_points(tp, T(x), T(t), tcfg)
        _close(got - T(x), np.asarray(want) - x, tol, "warp offset")
        # the time moves the density: the warp is live
        assert not torch.equal(tf.query_density(tp, T(x), T(aabb), tcfg, t=T(t)),
                               tf.query_density(tp, T(x), T(aabb), tcfg))
    else:  # no warp: a time changes nothing
        assert torch.equal(tf.query_density(tp, T(x), T(aabb), tcfg, t=T(t)),
                           tf.query_density(tp, T(x), T(aabb), tcfg))


def test_registry_matches_jax():
    assert sorted(tfields.FIELD_REGISTRY) == sorted(jfields.FIELD_REGISTRY)
    for name in ("vanilla", "dnerf"):
        params = {"trunk": []}
        assert tfields.get_field(name).prepare_params(params, None) is params
    assert tfields.get_field("ngp").forward is trender.ngp.forward
    with pytest.raises(ValueError, match="unknown field family"):
        tfields.get_field("nope")


def _grid(res=16, seed=0):
    binary = np.random.default_rng(seed).uniform(size=(res,) * 3) < 0.6
    return (jocc.init_grid(res)._replace(binary=jnp.asarray(binary)),
            tocc.occupancy_from_numpy(np.zeros(res**3), binary, "cpu"))


@pytest.mark.parametrize("compaction", ["capped", "rows"])
@pytest.mark.parametrize("field", ["vanilla", "dnerf"])
def test_render_rays_with_times_matches_jax(field, compaction):
    """render_rays(field=, times=) with stratified jitter drawn by JAX's
    marcher from its key and handed to the port, on the packed (capped)
    and the rows path; and render_image_chunked at one time."""
    jcfg, tcfg = _configs(field)
    jp, tp = _params(field, jcfg)
    jgrid, tgrid = _grid()
    n = 96
    rng = np.random.default_rng(3)
    origins = rng.uniform(-3.0, -2.5, (n, 3)).astype(np.float32)
    viewdirs = -origins / np.linalg.norm(origins, axis=-1, keepdims=True)
    times = rng.uniform(0, 1, n).astype(np.float32)
    rkw = dict(render_step_size=2 * math.sqrt(3) / STEPS, buffer_size=n * 24, max_steps=STEPS,
               march_compaction=compaction, k_cap=STEPS, chunk_size=32)
    key = jax.random.PRNGKey(7)
    jitter = np.asarray(jax.random.uniform(key, (n, 1)))  # the marchers' stratified draw
    bg = np.array([0.2, 0.5, 0.9], np.float32)
    jout, jaux = jrender_rays(jp, jcfg, jgrid, jnp.asarray(origins), jnp.asarray(viewdirs),
                              jnp.asarray(AABB), JRenderConfig(**rkw), background=jnp.asarray(bg),
                              stratified=True, key=key, field=jfields.get_field(field),
                              times=jnp.asarray(times))
    tout, taux = trender.render_rays(tp, tcfg, tgrid, torch.as_tensor(origins),
                                     torch.as_tensor(viewdirs), torch.tensor(AABB),
                                     trender.RenderConfig(**rkw), background=torch.as_tensor(bg),
                                     stratified=True, jitter=torch.tensor(jitter), device="cpu",
                                     field=tfields.get_field(field), times=torch.as_tensor(times))
    assert int(taux["n_samples"]) == int(jaux["n_samples"]) > n
    np.testing.assert_array_equal(taux["ray_counts"].numpy(), np.asarray(jaux["ray_counts"]))
    for name in ("rgb", "opacity", "depth"):
        _close(getattr(tout, name), getattr(jout, name), 1e-5, name)
    # a whole image at one time
    jrgb, _, jdepth = jrender_image_chunked(
        jp, jcfg, jgrid, jnp.asarray(origins), jnp.asarray(viewdirs), jnp.asarray(AABB),
        JRenderConfig(**dict(rkw, march_compaction="rows")), jnp.ones(3),
        field=jfields.get_field(field), time=0.25)
    trgb, _, tdepth = trender.render_image_chunked(
        tp, tcfg, tgrid, torch.as_tensor(origins), torch.as_tensor(viewdirs), torch.tensor(AABB),
        trender.RenderConfig(**dict(rkw, march_compaction="rows")), torch.ones(3), device="cpu",
        field=tfields.get_field(field), time=0.25)
    _close(trgb, jrgb, 1e-5, "image rgb")
    _close(tdepth, jdepth, 1e-5, "image depth")


def _one_step(field, bf16):
    """One training step of both packages on the same weights, grid and
    draws (those of JAX's _make_step_fn at step 5), the port's through
    step_loss with the field and the scene's timestamps."""
    scene = tfix.make_scene_data("train", num_views=8, image_size=24)
    timestamps = (np.arange(8) / 7.0).astype(np.float32) if field == "dnerf" else None
    jcfg, tcfg = _configs(field, bf16)
    jp, tp = _params(field, jcfg)
    jgrid, tgrid = _grid()
    rkw = dict(render_step_size=2 * math.sqrt(3) / STEPS, buffer_size=1 << 12,
               max_steps=STEPS, march_compaction="capped", k_cap=STEPS)
    num_rays, aabb = 256, np.asarray(AABB, np.float32)
    images, c2ws, K = scene.images, scene.camtoworlds, scene.K
    key = jax.random.fold_in(jax.random.PRNGKey(3), 5)
    kimg, kx, ky, kbg, kmarch = jax.random.split(key, 5)
    img_id = jax.random.randint(kimg, (num_rays,), 0, images.shape[0])
    x = jax.random.randint(kx, (num_rays,), 0, scene.width)
    y = jax.random.randint(ky, (num_rays,), 0, scene.height)
    bg = jax.random.uniform(kbg, (3,))
    jitter = jax.random.uniform(kmarch, (num_rays, 1))

    def jloss(p):
        rgba = jnp.asarray(images)[img_id, y, x].astype(jnp.float32) / 255.0
        pixels = rgba[:, :3] * rgba[:, 3:4] + bg * (1.0 - rgba[:, 3:4])
        rays = rays_from_pixels(x, y, jnp.asarray(K), jnp.asarray(c2ws)[img_id], True)
        out, aux = jrender_rays(
            p, jcfg, jgrid, rays.origins, rays.viewdirs, jnp.asarray(aabb), JRenderConfig(**rkw),
            background=bg, stratified=True, key=kmarch, field=jfields.get_field(field),
            times=None if timestamps is None else jnp.asarray(timestamps)[img_id])
        alive = (aux["ray_counts"] > 0).astype(jnp.float32)
        n_alive = jnp.maximum(jnp.sum(alive), 1.0)
        loss = jnp.sum(JT.huber(out.rgb - pixels) * alive[:, None]) / (n_alive * 3.0)
        sq = jnp.sum((out.rgb - pixels) ** 2 * alive[:, None]) / (n_alive * 3.0)
        return loss, (aux["n_samples"], sq)

    (loss, (n_samples, sq)), grads = jax.value_and_grad(jloss, has_aux=True)(jp)
    leaves = leaves_with_paths(tp)
    for p in leaves.values():
        p.requires_grad_(True)
    draws = TT.StepDraws(*(torch.as_tensor(np.array(a)) for a in (img_id, x, y, bg, jitter)))
    tloss, metrics = TT.step_loss(
        tp, tcfg, trender.RenderConfig(**rkw), tgrid, torch.as_tensor(aabb),
        torch.as_tensor(images), torch.as_tensor(c2ws), torch.as_tensor(K), draws,
        synthetic=True, opengl=True, field=tfields.get_field(field),
        timestamps=None if timestamps is None else torch.as_tensor(timestamps))
    tloss.backward()
    return (float(loss), int(n_samples), float(mse_to_psnr(sq)), jckpt._flatten(grads),
            tloss.item(), int(metrics["n_samples"]), metrics["psnr"].item(),
            {k: p.grad for k, p in leaves.items()})


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("field", ["vanilla", "dnerf"])
def test_one_step_matches_jax(field, bf16):
    loss, n_samples, psnr, grads, tloss, tn_samples, tpsnr, tgrads = _one_step(field, bf16)
    assert tn_samples == n_samples > 0
    np.testing.assert_allclose(tloss, loss, rtol=1e-4)
    np.testing.assert_allclose(tpsnr, psnr, rtol=1e-4)
    assert sorted(tgrads) == sorted(grads)
    assert any(k.startswith("warp") for k in grads) == (field == "dnerf")
    tol = 2e-2 if bf16 else {"vanilla": 1e-4, "dnerf": 5e-4}[field]
    for k, want in grads.items():
        _close(tgrads[k], want, tol, k)


def _tiny_argv(out, field, steps, bf16=False, n_validation=1000000):
    return ["--dataset", "dnerf" if field == "dnerf" else "objaverse", "--expname", field,
            "--out_dir", out, "--factor", "1", "--aabb=-1.0,-1.0,-1.0,1.0,1.0,1.0",
            "--max_iterations", str(steps), "--sample_budget", str(1 << 12),
            "--max_march_steps", "64", "--grid_resolution", "16", "--init_num_rays", "256",
            "--max_num_rays", "512", "--n_tensorboard", "1000",
            "--n_validation", str(n_validation), "--n_checkpoint", str(steps),
            "--field", field, "--test_chunk_size", "256"] + ([] if bf16 else ["--no_bf16"])


def _dnerf_scene(pkg, num_views=8, image_size=16):
    scene = tfix.make_scene_data("train", num_views=num_views, image_size=image_size)
    times = (np.arange(scene.num_images) / max(scene.num_images - 1, 1)).astype(np.float32)
    if pkg == "port":
        return tdnerf.scene_from_arrays(scene.images, scene.camtoworlds, scene.K, times)
    return jdnerf.DNeRFSceneData(images=scene.images, camtoworlds=scene.camtoworlds, K=scene.K,
                                 opengl=True, synthetic=True, near=2.0, far=6.0,
                                 timestamps=times)


def _port_trainer(out, field, steps, seed=0):
    trainer = TT.NGPTrainer(tconfig_parser(_tiny_argv(out, field, steps)), _dnerf_scene("port"),
                            device="cpu")
    trainer.model_config = _configs(field, widths=NARROW)[1]
    trainer.init_params(torch.Generator().manual_seed(seed))
    trainer.setup_optimizer()
    return trainer


def _jax_trainer(out, field, steps):
    cfg = jconfig_parser(_tiny_argv(out, field, steps) + ["--compilation_cache", ""])
    trainer = JT.NGPTrainer(cfg, _dnerf_scene("jax"))
    trainer.model_config = _configs(field, widths=NARROW)[0]
    trainer.params = trainer.field.init(jax.random.PRNGKey(1), trainer.model_config)
    trainer.opt_state = trainer.optimizer.init(trainer.params)
    trainer.state.params, trainer.state.opt_state = trainer.params, trainer.opt_state
    trainer._step_fns = {}
    trainer.__dict__.pop("_occ_update_fns", None)
    return trainer


def _adam_state(trainer):
    """{path: (mu, nu)} and the count of the port trainer's Adam."""
    leaves = leaves_with_paths(trainer.params)
    state = {k: trainer.optimizer.state[p] for k, p in leaves.items()}
    return ({k: (s["exp_avg"].numpy(), s["exp_avg_sq"].numpy()) for k, s in state.items()},
            int(next(iter(state.values()))["step"]))


@pytest.mark.parametrize("field", ["vanilla", "dnerf"])
def test_port_checkpoint_loads_and_resumes_in_jax(tmp_path, field):
    """3 port steps, saved: JAX's load_field_from_checkpoint gives the
    port's parameters bit for bit, and JAX's trainer resumes from it with
    the port's Adam moments and count in optax's layout."""
    trainer = _port_trainer(str(tmp_path), field, 3)
    trainer.train()
    path = os.path.join(trainer.output_dir, "model", "model.ckpt")
    params, _, meta, model_cfg, _ = JT.load_field_from_checkpoint(path)
    assert meta["field"] == field and meta["model_config"] == {"warp": field == "dnerf",
                                                               "bf16": False}
    assert model_cfg.warp == (field == "dnerf") and model_cfg.compute_dtype == jnp.float32
    want = {k: p.detach().numpy() for k, p in leaves_with_paths(trainer.params).items()}
    got = jckpt._flatten(params)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k

    jtrainer = _jax_trainer(str(tmp_path), field, 3)
    assert jtrainer.load_checkpoint() == 3
    adam, count = jckpt._flatten(jtrainer.state.opt_state), _adam_state(trainer)[1]
    assert count == 3 and int(adam["0/count"]) == int(adam["1/count"]) == 3
    for k, (mu, nu) in _adam_state(trainer)[0].items():
        assert np.array_equal(adam[f"0/mu/{k}"], mu) and np.array_equal(adam[f"0/nu/{k}"], nu), k
    for k, v in jckpt._flatten(jtrainer.state.params).items():
        assert np.array_equal(v, want[k]), k


@pytest.mark.parametrize("field", ["vanilla", "dnerf"])
def test_jax_checkpoint_loads_and_resumes_in_port(tmp_path, field):
    """2 JAX steps, saved: the port's load_field_from_checkpoint gives its
    parameters bit for bit, and the port's trainer resumes with its Adam
    moments and count, then trains on."""
    jtrainer = _jax_trainer(str(tmp_path), field, 2)
    jtrainer.train()
    path = os.path.join(jtrainer.output_dir, "model", "model.ckpt")
    want = jckpt._flatten(jtrainer.state.params)
    params, grid, meta, model_cfg, rcfg = TT.load_field_from_checkpoint(path, device="cpu")
    assert model_cfg.warp == (field == "dnerf") and model_cfg.compute_dtype == torch.float32
    assert rcfg.max_steps == 64 and tuple(grid.binary.shape) == (16,) * 3
    got = leaves_with_paths(params)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k].numpy(), want[k]), k

    trainer = _port_trainer(str(tmp_path), field, 4, seed=5)
    assert trainer.load_checkpoint() == 2
    adam = jckpt._flatten(jtrainer.state.opt_state)
    moments, count = _adam_state(trainer)
    assert count == 2
    for k, (mu, nu) in moments.items():
        assert np.array_equal(mu, adam[f"0/mu/{k}"]) and np.array_equal(nu, adam[f"0/nu/{k}"]), k
    for k, p in leaves_with_paths(trainer.params).items():
        assert np.array_equal(p.detach().numpy(), want[k]), k
    trainer.train()  # steps 2 and 3 from the resumed state
    assert _adam_state(trainer)[1] == 4


def test_cli_twin_trains_dnerf_and_the_evaluator_refuses_it(tmp_path):
    """python -m dregnerf_tpu_torch.train_ngp_nerf --dataset dnerf --field
    dnerf at the full width (8x256, bf16) trains, validates at the val
    view's time and checkpoints; the evaluator (NGP fields only, as the
    JAX package's) raises a ValueError naming the field."""
    root = str(tmp_path / "data")
    subject = tfix.make_scene(root, num_views=6, image_size=16)
    with open(os.path.join(subject, "transforms.json")) as f:
        meta = json.load(f)
    for i, frame in enumerate(meta["frames"]):
        frame["time"] = i / 5
    for split in ("train", "test"):
        with open(os.path.join(subject, f"transforms_{split}.json"), "w") as f:
            json.dump(meta, f)
    argv = _tiny_argv(str(tmp_path / "out"), "dnerf", 2, bf16=True, n_validation=2)
    tcli.main(["--root_dir", root, "--scene", "fixture_scene", "--device", "cpu", *argv])
    exp = tmp_path / "out" / "dnerf"
    path = str(exp / "model" / "model.ckpt")
    params, _, meta, model_cfg, _ = TT.load_field_from_checkpoint(path, device="cpu")
    assert meta["step"] == 2 and meta["field"] == "dnerf"
    assert model_cfg == tmlp.VanillaNeRFConfig(warp=True, compute_dtype=torch.bfloat16)
    assert params["trunk"][0]["w"].shape == (63, 256) and len(params["warp"]) == 4
    with open(exp / "log.jsonl") as f:
        vals = [json.loads(line) for line in f if "val/psnr" in line]
    assert len(vals) == 1 and math.isfinite(vals[0]["val/psnr"])
    scene = tdnerf.load_blocks(root, "fixture_scene", "test")[0]
    with pytest.raises(ValueError, match="'dnerf'"):
        teval.Evaluator(tconfig_parser(["--device", "cpu"]), str(exp), scene)


def test_field_flag_matches_jax():
    for argv in ([], ["--field", "vanilla"], ["--field", "dnerf"]):
        assert tconfig_parser(argv).field == jconfig_parser(argv).field
    with pytest.raises(SystemExit):
        tconfig_parser(["--field", "mlp"])
