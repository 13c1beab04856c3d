"""Port parity: the packed-grid encoder (forward through K2p's plain
version, and the table gradient under every grad_accum, with and without
the run-length backward, through K1's and K1p's plain versions on the
CPU) against the JAX package, plus the config meta round trip."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dregnerf_tpu.models import ngp as jngp
from dregnerf_tpu.ops import packed_grid as JPG
from dregnerf_tpu_torch.models import ngp as tngp
from dregnerf_tpu_torch.ops import packed_grid as TPG

CONFIGS = {
    # two dense levels (tests/test_ray_march.py's bf16/pallas accumulator size)
    "dense": dict(n_levels=2, log2_table_size=10, base_resolution=4, per_level_scale=2.0),
    # a dense level then two levels wrapped into 2^10 rows
    "wrapped": dict(n_levels=3, log2_table_size=10, base_resolution=4, per_level_scale=4.0),
}


def _inputs(cfg_kw, seed=0):
    rng = np.random.default_rng(seed)
    cfg = JPG.PackedGridConfig(**cfg_kw)
    table = rng.uniform(-0.1, 0.1, (cfg.total_rows, cfg.n_features)).astype(np.float32)
    x = rng.uniform(-0.05, 1.05, (512, 3)).astype(np.float32)  # some outside [0, 1]
    return table, x


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_encode_forward_matches_jax(name):
    kw = CONFIGS[name]
    table, x = _inputs(kw)
    jcfg, tcfg = JPG.PackedGridConfig(**kw), TPG.PackedGridConfig(**kw)
    want = JPG.packed_encode(JPG.pack_table(jnp.asarray(table), jcfg), jnp.asarray(x), jcfg)
    got = TPG.packed_encode(TPG.pack_table(torch.as_tensor(table), tcfg),
                            torch.as_tensor(x), tcfg)
    assert got.shape == (512, tcfg.out_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("accum", ["pallas", "f32"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_table_gradient_matches_jax(name, accum):
    """dV of sum(encode^2), the port against jax.grad with the same
    accumulator (pallas: K1 against the Pallas kernel in interpret mode)."""
    kw = dict(CONFIGS[name], grad_accum=accum)
    table, x = _inputs(kw, seed=1)
    jcfg, tcfg = JPG.PackedGridConfig(**kw), TPG.PackedGridConfig(**kw)

    def jloss(v):
        return jnp.sum(JPG.packed_encode(JPG.pack_table(v, jcfg), jnp.asarray(x), jcfg) ** 2)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(table)))
    v = torch.as_tensor(table).requires_grad_(True)
    (TPG.packed_encode(TPG.pack_table(v, tcfg), torch.as_tensor(x), tcfg) ** 2).sum().backward()
    assert v.grad.dtype == torch.float32
    np.testing.assert_allclose(v.grad.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_config_meta_round_trips_between_packages():
    tcfg = tngp.NGPConfig(grid=TPG.PackedGridConfig(grad_accum="pallas"),
                          compute_dtype=torch.float32)
    meta = json.loads(json.dumps(tngp.config_to_meta(tcfg)))
    assert tngp.config_from_meta(meta) == tcfg
    jcfg = jngp.config_from_meta(meta)  # the JAX package accepts the port's meta
    assert dataclasses.asdict(jcfg.grid) == dataclasses.asdict(tcfg.grid)
    assert jcfg.compute_dtype == jnp.float32
    assert json.loads(json.dumps(jngp.config_to_meta(jcfg))) == meta
    # and the reverse: a JAX default config (bf16 accumulator, RLE step)
    jdef = jngp.NGPConfig(grid=JPG.PackedGridConfig(grad_accum="bf16", rle_step_u=0.003))
    back = tngp.config_from_meta(json.loads(json.dumps(jngp.config_to_meta(jdef))))
    assert dataclasses.asdict(back.grid) == dataclasses.asdict(jdef.grid)
    assert back.compute_dtype == torch.bfloat16


def _ray_points(n_rays=16, n_steps=32, step=0.01, seed=2):
    """Ray-ordered sample positions, as a marcher emits them: coarse
    levels see runs of equal slots."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(0.1, 0.9, (n_rays, 1, 3))
    d = rng.normal(size=(n_rays, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.arange(n_steps)[None, :, None] * step
    return np.clip(o + d * t, 0.0, 1.0).reshape(-1, 3).astype(np.float32)


def _level_slots(cfg, x, level):
    """The slots of one level, as packed_encode computes them."""
    scale = cfg.level_scales()[level]
    res = int(cfg.level_resolutions()[level])
    cell = np.clip(np.floor(x * scale + 0.5).astype(np.int64), 0, res - 2)
    lin = cell[:, 0] * res * res + cell[:, 1] * res + cell[:, 2]
    return lin & ((1 << cfg.log2_table_size) - 1) if cfg.level_wrapped()[level] else lin


BF16_ACCUM = ("bf16", "sorted_bf16")


@pytest.mark.parametrize("points", ["random", "rays_fit", "rays_no_rle"])
@pytest.mark.parametrize("accum", ["f32", "sorted", "pallas", "bf16", "sorted_bf16"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_every_backward_matches_jax(name, accum, points, monkeypatch):
    """dV of sum(encode^2) for every grad_accum, with the run-length
    backward on (rle_step_u = 0.01: every level of "dense" and level 0 of
    "wrapped" take it) or off. "random" points overflow max_runs, so the
    RLE levels take the direct-scatter fallback; ray-ordered points fit.

    Tolerances: f32 accumulators 1e-5 of max |dV|. bf16 accumulators, per
    packed-table slot hit k times by rows of cotangent g: 2^-7 (k + 1)
    sum|g|, one bf16 rounding step of each of the k + 1 roundings (the k
    addends and the k adds), since the two packages' cotangents differ by
    f32 rounding and may round to neighbouring bf16 values; plus 1e-6 of
    sum|g| over all rows for the f32 cumsum of the run sums. The slot
    bound is carried to dV through the transpose of pack_table."""
    rle_u = 0.0 if points == "rays_no_rle" else 0.01
    kw = dict(CONFIGS[name], grad_accum=accum, rle_step_u=rle_u)
    table, _ = _inputs(CONFIGS[name], seed=1)
    x = (np.random.default_rng(3).uniform(size=(512, 3)).astype(np.float32)
         if points == "random" else _ray_points())
    jcfg, tcfg = JPG.PackedGridConfig(**kw), TPG.PackedGridConfig(**kw)
    if rle_u:  # level 0 takes RLE; its run count fits max_runs on rays only
        slots = _level_slots(jcfg, x, 0)
        n_runs = 1 + int(np.sum(slots[1:] != slots[:-1]))
        max_runs = int(2.0 * len(x) / JPG.rle_expected_run(jcfg, 0))
        assert JPG.rle_expected_run(jcfg, 0) >= JPG.RLE_MIN_RUN
        assert (n_runs <= max_runs) == (points == "rays_fit"), (n_runs, max_runs)

    def jloss(v):
        return jnp.sum(JPG.packed_encode(JPG.pack_table(v, jcfg), jnp.asarray(x), jcfg) ** 2)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(table)))
    seen = {}  # level -> (slot, g, table_rows) of its backward
    real_level_backward = TPG.level_backward

    def spy(config, level, n):
        scatter = real_level_backward(config, level, n)

        def recorded(slot, g, table_rows):
            seen[level] = (slot.long(), g, table_rows)
            return scatter(slot, g, table_rows)
        return recorded

    monkeypatch.setattr(TPG, "level_backward", spy)
    v = torch.as_tensor(table).requires_grad_(True)
    (TPG.packed_encode(TPG.pack_table(v, tcfg), torch.as_tensor(x), tcfg) ** 2).sum().backward()
    assert v.grad.dtype == torch.float32 and len(seen) == tcfg.n_levels
    got = v.grad.numpy()
    if accum not in BF16_ACCUM:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
        return
    total = sum(float(g.abs().sum()) for _, g, _ in seen.values())
    slot_tol = []
    for slot, g, rows in (seen[level] for level in range(tcfg.n_levels)):
        k = torch.bincount(slot, minlength=rows).to(torch.float32)[:, None]
        abs_sum = torch.zeros(rows, g.shape[1]).index_add_(0, slot, g.abs())
        slot_tol.append(2.0**-7 * (k + 1.0) * abs_sum + 1e-6 * total)
    vt = torch.zeros_like(v).requires_grad_(True)
    sum((p * t).sum() for p, t in zip(TPG.pack_table(vt, tcfg), slot_tol)).backward()
    tol = vt.grad.numpy()
    err = np.abs(got - want)
    assert np.all(err <= tol), float((err / np.maximum(tol, 1e-30)).max())
