"""Port parity: the capped, compact, quota and row marchers (aabb and un_bounded_sphere,
with and without a per-ray t_max), the compositors, the surface field and
render_rays against the JAX package, with the jitter drawn by jax.random
as the JAX marcher draws it and handed to the port. Integer fields exact,
times within 1e-5 (1e-6 where stated), composites within 2e-5."""
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
    tgrid = tocc.occupancy_from_numpy(np.zeros(RES**3, np.float32), binary, "cpu")
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


@pytest.mark.parametrize("compaction,buffer_size", [
    ("compact", 1 << 14), ("compact", 1 << 10), ("quota", 1 << 13), ("quota", 1 << 10)])
def test_compact_and_quota_march_match_jax(scene, compaction, buffer_size):
    """The global-rank ("compact") and per-ray quota ("quota") packings
    against JAX's march_rays with the same jitter: equal ray ids, validity
    and counts, t_start within 1e-6. At 2^10 slots the compact buffer
    overflows and most rays hold more survivors than the quota's 5 slots;
    at 2^13 some rays still exceed the quota's 40."""
    jgrid, tgrid, o, d, jitter = scene
    want = jmarch.march_rays(jnp.asarray(o), jnp.asarray(d), jgrid, jnp.asarray(AABB),
                             "aabb", STEP, buffer_size, STEPS, stratified=True,
                             key=jax.random.PRNGKey(7), compaction=compaction)
    got = tmarch.march_rays(_t(o), _t(d), tgrid, _t(AABB), "aabb", STEP, buffer_size,
                            STEPS, jitter=_t(jitter), compaction=compaction)
    per_ray = tmarch.march_rays(_t(o), _t(d), tgrid, _t(AABB), "aabb", STEP, 1 << 16, STEPS,
                                jitter=_t(jitter), compaction="compact")
    survivors = torch.bincount(per_ray.ray_id, minlength=RAYS + 1)[:RAYS]
    if compaction == "compact":
        assert (int(survivors.sum()) > buffer_size) == (buffer_size == 1 << 10)
    else:
        assert int((survivors > buffer_size // RAYS).sum()) > 0
    assert int(got.num_samples) == int(want.num_samples) > 0
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.ray_id.numpy(), np.asarray(want.ray_id))
    np.testing.assert_allclose(got.t_start.numpy(), np.asarray(want.t_start), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.t_end.numpy(), np.asarray(want.t_end), rtol=0, atol=1e-6)
    jp, _ = jmarch.sample_positions(want, jnp.asarray(o), jnp.asarray(d))
    tp, _ = tmarch.sample_positions(got, _t(o), _t(d))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-5)


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


def _shell_grid(radius_cells):
    """Occupied cells only far from the centre: a shell of the grid."""
    c = (np.arange(RES) + 0.5) - RES / 2
    r = np.sqrt(c[:, None, None] ** 2 + c[None, :, None] ** 2 + c[None, None, :] ** 2)
    return r > radius_cells


@pytest.mark.parametrize("occupied", ["shell", "none"])
@pytest.mark.parametrize("marcher", ["capped", "rows"])
def test_unbounded_contraction_matches_jax(scene, marcher, occupied):
    """Under un_bounded_sphere, steps 4x coarser than the step convention
    make groups span more than the 8-cell region, so far cells read
    occupied in JAX. With no cell occupied, every sample comes from that
    conservative read; with a shell occupied, it adds to the real ones.
    Equal sample sets, t_start within 1e-6."""
    _, _, o, d, jitter = scene
    binary = _shell_grid(10.0) if occupied == "shell" else np.zeros((RES,) * 3, bool)
    jgrid = jocc.init_grid(RES)._replace(binary=jnp.asarray(binary))
    tgrid = tocc.occupancy_from_numpy(np.zeros(RES**3, np.float32), binary, "cpu")
    step = 4.0 * STEP
    if marcher == "rows":
        want = jmarch.march_rays_rows(jnp.asarray(o), jnp.asarray(d), jgrid, jnp.asarray(AABB),
                                      "un_bounded_sphere", step, 48, STEPS, stratified=True,
                                      key=jax.random.PRNGKey(7))
        got = tmarch.march_rays_rows(_t(o), _t(d), tgrid, _t(AABB), "un_bounded_sphere",
                                     step, 48, STEPS, jitter=_t(jitter))
    else:
        want = jmarch.march_rays(jnp.asarray(o), jnp.asarray(d), jgrid, jnp.asarray(AABB),
                                 "un_bounded_sphere", step, 1 << 13, STEPS, stratified=True,
                                 key=jax.random.PRNGKey(7), compaction="capped", k_cap=64)
        got = tmarch.march_rays(_t(o), _t(d), tgrid, _t(AABB), "un_bounded_sphere", step,
                                1 << 13, STEPS, jitter=_t(jitter), k_cap=64)
        np.testing.assert_array_equal(got.ray_id.numpy(), np.asarray(want.ray_id))
    assert int(got.num_samples) == int(want.num_samples) > 0
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.t_start.numpy(), np.asarray(want.t_start), rtol=0, atol=1e-6)


@pytest.mark.parametrize("marcher", ["capped", "rows"])
def test_t_max_march_matches_jax(scene, marcher):
    """A per-ray far cut, as the surface pass of extraction marches from a
    camera to a point: equal sample sets, t_start within 1e-5."""
    jgrid, tgrid, o, d, jitter = scene
    t_max = np.random.default_rng(5).uniform(2.0, 4.5, RAYS).astype(np.float32)
    if marcher == "rows":
        want = jmarch.march_rays_rows(jnp.asarray(o), jnp.asarray(d), jgrid, jnp.asarray(AABB),
                                      "aabb", STEP, 24, STEPS, t_max=jnp.asarray(t_max))
        got = tmarch.march_rays_rows(_t(o), _t(d), tgrid, _t(AABB), "aabb", STEP, 24, STEPS,
                                     t_max=_t(t_max))
        full = tmarch.march_rays_rows(_t(o), _t(d), tgrid, _t(AABB), "aabb", STEP, 24, STEPS)
    else:
        want = jmarch.march_rays(jnp.asarray(o), jnp.asarray(d), jgrid, jnp.asarray(AABB),
                                 "aabb", STEP, 1 << 13, STEPS, t_max=jnp.asarray(t_max),
                                 compaction="capped", k_cap=64)
        got = tmarch.march_rays(_t(o), _t(d), tgrid, _t(AABB), "aabb", STEP, 1 << 13, STEPS,
                                t_max=_t(t_max), k_cap=64)
        full = tmarch.march_rays(_t(o), _t(d), tgrid, _t(AABB), "aabb", STEP, 1 << 13, STEPS,
                                 k_cap=64)
    assert 0 < int(got.num_samples) == int(want.num_samples) < int(full.num_samples)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.t_start.numpy(), np.asarray(want.t_start), rtol=0, atol=1e-5)


def test_surface_field_rows_matches_jax(scene):
    """S = max_k T_k alpha_k per ray, within 1e-6."""
    jgrid, _, o, d, _ = scene
    rows = jmarch.march_rays_rows(jnp.asarray(o), jnp.asarray(d), jgrid, jnp.asarray(AABB),
                                  "aabb", STEP, 24, STEPS)
    sigmas = np.random.default_rng(6).uniform(0.0, 60.0, (RAYS, 24)).astype(np.float32)
    want = jcomp.surface_field_rows(rows, jnp.asarray(sigmas))
    trows = tmarch.RowSamples(t_start=_t(rows.t_start), dt=rows.dt, valid=_t(rows.valid),
                              num_samples=_t(rows.num_samples))
    got = tcomp.surface_field_rows(trows, _t(sigmas))
    assert got.shape == (RAYS,) and float(got.max()) > 0.1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


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


def test_quota_composite_gradient_is_finite(scene):
    """A quota buffer leaves padding between rays. JAX's packed
    transmittance bases that padding by the last ray, exp overflows, and
    the gradient through its where is NaN (a fault of the reference); the
    port's forward equals JAX's and its gradient equals the gradient of
    JAX's row compositor on the same samples (quota's samples are the row
    marcher's), within 1e-5 of its max; zero on padding."""
    jgrid, tgrid, o, d, jitter = scene
    k = 40
    aabb = jnp.asarray(AABB)
    packed = jmarch.march_rays(jnp.asarray(o), jnp.asarray(d), jgrid, aabb, "aabb", STEP,
                               RAYS * k, STEPS, compaction="quota")
    rows = jmarch.march_rays_rows(jnp.asarray(o), jnp.asarray(d), jgrid, aabb, "aabb", STEP,
                                  k, STEPS)
    np.testing.assert_array_equal(np.asarray(packed.valid).reshape(RAYS, k),
                                  np.asarray(rows.valid))
    # a moderate optical depth, as in test_packed_composite_matches_jax: the
    # buffer-wide cumsums of the two packages drift apart as it grows
    sigmas = np.random.default_rng(3).uniform(0.0, 2.0, RAYS * k).astype(np.float32)
    rgbs = np.random.default_rng(4).uniform(size=(RAYS * k, 3)).astype(np.float32)
    bg = jnp.ones(3)

    def jpacked(s):
        return jcomp.composite(packed, jnp.asarray(rgbs), s, bg).rgb.sum()

    def jrows(s):
        return jcomp.composite_rows(rows, jnp.asarray(rgbs).reshape(RAYS, k, 3),
                                    s.reshape(RAYS, k), bg).rgb.sum()

    jgrad_packed = np.asarray(jax.grad(jpacked)(jnp.asarray(sigmas)))
    assert np.isnan(jgrad_packed).any()  # the reference's fault
    want = np.asarray(jax.grad(jrows)(jnp.asarray(sigmas))).reshape(-1)
    tpacked = tmarch.march_rays(_t(o), _t(d), tgrid, _t(AABB), "aabb", STEP, RAYS * k, STEPS,
                                compaction="quota")
    ts = _t(sigmas).requires_grad_(True)
    out = tcomp.composite(tpacked, _t(rgbs), ts, _t(np.ones(3, np.float32)))
    np.testing.assert_allclose(out.rgb.detach().numpy(), np.asarray(
        jcomp.composite(packed, jnp.asarray(rgbs), jnp.asarray(sigmas), bg).rgb),
        rtol=0, atol=2e-5)
    out.rgb.sum().backward()
    got = ts.grad.numpy()
    assert np.isfinite(got).all() and (got[~tpacked.valid.numpy()] == 0).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


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
    tparams = tngp.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
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
    tparams = tngp.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
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
