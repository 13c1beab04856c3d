"""Port parity: the capped and row marchers, the compositors and
render_rays against the JAX package, with the jitter drawn by jax.random
as the JAX marcher draws it and handed to the port. Integer fields exact,
times within 1e-5, composites within 2e-5."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dregnerf_tpu.models import ngp as jngp
from dregnerf_tpu.ops import composite as jcomp
from dregnerf_tpu.ops import occupancy as jocc
from dregnerf_tpu.ops import ray_march as jmarch
from dregnerf_tpu.ops.packed_grid import PackedGridConfig as JGrid
from dregnerf_tpu.render import renderer as jrender
from dregnerf_tpu_torch.models import ngp as tngp
from dregnerf_tpu_torch.ops import composite as tcomp
from dregnerf_tpu_torch.ops import occupancy as tocc
from dregnerf_tpu_torch.ops import ray_march as tmarch
from dregnerf_tpu_torch.ops.packed_grid import PackedGridConfig as TGrid
from dregnerf_tpu_torch.render import renderer as trender

RES, STEPS, RAYS = 32, 128, 200
STEP = 2.0 * math.sqrt(3.0) / STEPS  # the trainer's diag / max_steps convention
AABB = np.array([-1.0, -1, -1, 1, 1, 1], np.float32)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    binary = rng.uniform(size=(RES,) * 3) < 0.3
    o = rng.normal(size=(RAYS, 3))
    o = (3.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)).astype(np.float32)
    target = rng.uniform(-0.9, 0.9, (RAYS, 3))
    target[:20] = 5.0 * rng.normal(size=(20, 3))  # some rays miss the box
    d = target - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    jitter = np.asarray(jax.random.uniform(jax.random.PRNGKey(7), (RAYS, 1)))
    jgrid = jocc.init_grid(RES)._replace(binary=jnp.asarray(binary))
    tgrid = tocc.occupancy_from_numpy(np.zeros(RES**3, np.float32), binary)
    return jgrid, tgrid, o, d, jitter


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("buffer_size,k_cap", [(1 << 13, 64), (1 << 10, 128)])
def test_capped_march_matches_jax(scene, buffer_size, k_cap):
    jgrid, tgrid, o, d, jitter = scene
    want = jmarch.march_rays(jnp.asarray(o), jnp.asarray(d), jgrid, jnp.asarray(AABB),
                             "aabb", STEP, buffer_size, STEPS, stratified=True,
                             key=jax.random.PRNGKey(7), compaction="capped", k_cap=k_cap)
    got = tmarch.march_rays(_t(o), _t(d), tgrid, _t(AABB), "aabb", STEP, buffer_size,
                            STEPS, jitter=_t(jitter), k_cap=k_cap)
    assert int(got.num_samples) == int(want.num_samples) > 0
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.ray_id.numpy(), np.asarray(want.ray_id))
    np.testing.assert_allclose(got.t_start.numpy(), np.asarray(want.t_start), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.t_end.numpy(), np.asarray(want.t_end), rtol=0, atol=1e-5)
    jp, jd = jmarch.sample_positions(want, jnp.asarray(o), jnp.asarray(d))
    tp, td = tmarch.sample_positions(got, _t(o), _t(d))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-5)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-6)


def test_row_march_matches_jax(scene):
    jgrid, tgrid, o, d, jitter = scene
    want = jmarch.march_rays_rows(jnp.asarray(o), jnp.asarray(d), jgrid, jnp.asarray(AABB),
                                  "aabb", STEP, 24, STEPS, stratified=True,
                                  key=jax.random.PRNGKey(7))
    got = tmarch.march_rays_rows(_t(o), _t(d), tgrid, _t(AABB), "aabb", STEP, 24, STEPS,
                                 jitter=_t(jitter))
    assert int(got.num_samples) == int(want.num_samples) > 0
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.t_start.numpy(), np.asarray(want.t_start), rtol=0, atol=1e-5)
    jp, _ = jmarch.row_sample_positions(want, jnp.asarray(o), jnp.asarray(d))
    tp, _ = tmarch.row_sample_positions(got, _t(o), _t(d))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-5)


def test_unbounded_contraction_raises_in_marcher(scene):
    _, tgrid, o, d, _ = scene
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmarch.march_rays(_t(o), _t(d), tgrid, _t(AABB), "un_bounded_sphere", STEP,
                          1 << 12, STEPS)


def test_packed_composite_matches_jax(scene):
    jgrid, _, o, d, _ = scene
    packed = jmarch.march_rays(jnp.asarray(o), jnp.asarray(d), jgrid, jnp.asarray(AABB),
                               "aabb", STEP, 1 << 13, STEPS, compaction="capped", k_cap=64)
    rng = np.random.default_rng(1)
    b = packed.t_start.shape[0]
    # the transmittance is one f32 cumsum over the whole buffer, so the two
    # packages' summation orders drift apart as the buffer's total optical
    # depth grows (ROADMAP.md queue 3); keep it moderate here
    sigmas = rng.uniform(0.0, 2.0, b).astype(np.float32)
    rgbs = rng.uniform(size=(b, 3)).astype(np.float32)
    bg = np.array([0.2, 0.5, 0.9], np.float32)
    want = jcomp.composite(packed, jnp.asarray(rgbs), jnp.asarray(sigmas), jnp.asarray(bg))
    tpacked = tmarch.PackedSamples(
        ray_id=_t(packed.ray_id).long(), t_start=_t(packed.t_start),
        t_end=_t(packed.t_end), valid=_t(packed.valid), num_samples=_t(packed.num_samples),
        num_rays=packed.num_rays)
    got = tcomp.composite(tpacked, _t(rgbs), _t(sigmas), _t(bg))
    for field in ("rgb", "opacity", "depth", "weights", "transmittance", "alphas"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)), rtol=0, atol=2e-5,
                                   err_msg=field)


def test_row_composite_matches_jax(scene):
    jgrid, _, o, d, _ = scene
    rows = jmarch.march_rays_rows(jnp.asarray(o), jnp.asarray(d), jgrid, jnp.asarray(AABB),
                                  "aabb", STEP, 24, STEPS)
    rng = np.random.default_rng(2)
    sigmas = rng.uniform(0.0, 60.0, (RAYS, 24)).astype(np.float32)
    rgbs = rng.uniform(size=(RAYS, 24, 3)).astype(np.float32)
    bg = np.array([1.0, 1.0, 1.0], np.float32)
    want = jcomp.composite_rows(rows, jnp.asarray(rgbs), jnp.asarray(sigmas), jnp.asarray(bg))
    trows = tmarch.RowSamples(t_start=_t(rows.t_start), dt=rows.dt, valid=_t(rows.valid),
                              num_samples=_t(rows.num_samples))
    got = tcomp.composite_rows(trows, _t(rgbs), _t(sigmas), _t(bg))
    for field in ("rgb", "opacity", "depth", "weights", "transmittance", "alphas"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)), rtol=0, atol=2e-5,
                                   err_msg=field)


@pytest.mark.parametrize("compaction", ["capped", "rows"])
def test_render_rays_matches_jax(scene, compaction):
    """The whole render (marcher, f32 field, compositor) with carried weights."""
    jgrid, tgrid, o, d, jitter = scene
    grid_kw = dict(n_levels=2, log2_table_size=10, base_resolution=4, per_level_scale=2.0)
    jcfg = jngp.NGPConfig(grid=JGrid(**grid_kw), compute_dtype=jnp.float32)
    tcfg = tngp.NGPConfig(grid=TGrid(**grid_kw), compute_dtype=torch.float32)
    jparams = jngp.init_ngp(jax.random.PRNGKey(3), jcfg)
    jparams["table"] = jparams["table"] * 1000.0
    tparams = tngp.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    rcfg_kw = dict(render_step_size=STEP, buffer_size=1 << 12, max_steps=STEPS,
                   march_compaction=compaction, k_cap=64)
    bg = np.array([1.0, 1.0, 1.0], np.float32)
    want, waux = jrender.render_rays(jparams, jcfg, jgrid, jnp.asarray(o), jnp.asarray(d),
                                     jnp.asarray(AABB), jrender.RenderConfig(**rcfg_kw),
                                     background=jnp.asarray(bg), stratified=True,
                                     key=jax.random.PRNGKey(7))
    got, taux = trender.render_rays(tparams, tcfg, tgrid, _t(o), _t(d), _t(AABB),
                                    trender.RenderConfig(**rcfg_kw), background=_t(bg),
                                    stratified=True, jitter=_t(jitter), device="cpu")
    assert int(taux["n_samples"]) == int(waux["n_samples"])
    np.testing.assert_array_equal(taux["ray_counts"].numpy(), np.asarray(waux["ray_counts"]))
    for field in ("rgb", "opacity", "depth"):
        np.testing.assert_allclose(getattr(got, field).detach().numpy(),
                                   np.asarray(getattr(want, field)), rtol=0, atol=2e-5,
                                   err_msg=field)


def test_render_image_chunked_matches_jax(scene):
    """Chunked image render (rows marcher, padded last chunk)."""
    jgrid, tgrid, o, d, _ = scene
    grid_kw = dict(n_levels=2, log2_table_size=10, base_resolution=4, per_level_scale=2.0)
    jcfg = jngp.NGPConfig(grid=JGrid(**grid_kw), compute_dtype=jnp.float32)
    tcfg = tngp.NGPConfig(grid=TGrid(**grid_kw), compute_dtype=torch.float32)
    jparams = jngp.init_ngp(jax.random.PRNGKey(4), jcfg)
    jparams["table"] = jparams["table"] * 1000.0
    tparams = tngp.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    rcfg = dict(render_step_size=STEP, buffer_size=1 << 12, max_steps=STEPS, chunk_size=64)
    bg = np.ones(3, np.float32)
    want = jrender.render_image_chunked(jparams, jcfg, jgrid, jnp.asarray(o), jnp.asarray(d),
                                        jnp.asarray(AABB), jrender.RenderConfig(**rcfg),
                                        jnp.asarray(bg), eval_buffer_size=64 * 32)
    got = trender.render_image_chunked(tparams, tcfg, tgrid, _t(o), _t(d), _t(AABB),
                                       trender.RenderConfig(**rcfg), _t(bg),
                                       eval_buffer_size=64 * 32, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=2e-5)
