"""Port parity: both packed-grid encoders, the packed-table path
(`packed_encode` over `pack_table`, its row gather K2p's plain version)
and the vertex-table path (`vertex_encode`, K2's plain versions), forward
and table gradient under every grad_accum, with and without the
run-length backward, through K1's and K1p's plain versions on the CPU,
against the JAX package; K2's unpack against pack_table's placement; the
config meta round trip."""
import dataclasses
import functools
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


ENCODERS = ["packed", "vertex"]


def _encode(encoder, table, x, cfg):
    """The port's encoder `encoder` on a vertex table."""
    if encoder == "packed":
        return TPG.packed_encode(TPG.pack_table(table, cfg), x, cfg)
    return TPG.vertex_encode(table, x, cfg)


def _points(kw, key):
    if key == "outside":  # some outside [0, 1]
        return _inputs(kw, seed=1)[1]
    if key == "random":
        return np.random.default_rng(3).uniform(size=(512, 3)).astype(np.float32)
    return _ray_points()


@functools.lru_cache(maxsize=None)
def _jax_grad(kw_items, x_key):
    """jax.grad of sum(encode^2) over the seed-1 vertex table at the points
    `x_key`, once for both of the port's encoders."""
    kw = dict(kw_items)
    table, _ = _inputs(kw, seed=1)
    x = _points(kw, x_key)
    jcfg = JPG.PackedGridConfig(**kw)

    def jloss(v):
        return jnp.sum(JPG.packed_encode(JPG.pack_table(v, jcfg), jnp.asarray(x), jcfg) ** 2)

    return np.asarray(jax.grad(jloss)(jnp.asarray(table)))


@pytest.mark.parametrize("encoder", ENCODERS)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_encode_forward_matches_jax(name, encoder):
    kw = CONFIGS[name]
    table, x = _inputs(kw)
    jcfg, tcfg = JPG.PackedGridConfig(**kw), TPG.PackedGridConfig(**kw)
    want = JPG.packed_encode(JPG.pack_table(jnp.asarray(table), jcfg), jnp.asarray(x), jcfg)
    got = _encode(encoder, torch.as_tensor(table), torch.as_tensor(x), tcfg)
    assert got.shape == (512, tcfg.out_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("encoder", ENCODERS)
@pytest.mark.parametrize("accum", ["pallas", "f32"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_table_gradient_matches_jax(name, accum, encoder):
    """dV of sum(encode^2), the port against jax.grad with the same
    accumulator (pallas: K1 against the Pallas kernel in interpret mode)."""
    kw = dict(CONFIGS[name], grad_accum=accum)
    table, x = _inputs(kw, seed=1)
    tcfg = TPG.PackedGridConfig(**kw)
    want = _jax_grad(tuple(sorted(kw.items())), "outside")
    v = torch.as_tensor(table).requires_grad_(True)
    (_encode(encoder, v, torch.as_tensor(x), tcfg) ** 2).sum().backward()
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


@pytest.mark.parametrize("encoder", ENCODERS)
@pytest.mark.parametrize("points", ["random", "rays_fit", "rays_no_rle"])
@pytest.mark.parametrize("accum", ["f32", "sorted", "pallas", "bf16", "sorted_bf16"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_every_backward_matches_jax(name, accum, points, encoder, monkeypatch):
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
    x_key = "random" if points == "random" else "rays"
    x = _points(kw, x_key)
    jcfg, tcfg = JPG.PackedGridConfig(**kw), TPG.PackedGridConfig(**kw)
    if rle_u:  # level 0 takes RLE; its run count fits max_runs on rays only
        slots = _level_slots(jcfg, x, 0)
        n_runs = 1 + int(np.sum(slots[1:] != slots[:-1]))
        max_runs = int(2.0 * len(x) / JPG.rle_expected_run(jcfg, 0))
        assert JPG.rle_expected_run(jcfg, 0) >= JPG.RLE_MIN_RUN
        assert (n_runs <= max_runs) == (points == "rays_fit"), (n_runs, max_runs)

    want = _jax_grad(tuple(sorted(kw.items())), x_key)
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
    (_encode(encoder, v, torch.as_tensor(x), tcfg) ** 2).sum().backward()
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


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_k2_unpack_inverts_pack_table_placement(name):
    """Each vertex row sits in 8 packed slots (one a corner), so K2's plain
    unpack of pack_table(V) gives 8 V exactly (integer rows: exact sums);
    and the vertex rows of K2's slots are the packed rows the gather of
    the packed path reads."""
    cfg = TPG.PackedGridConfig(**CONFIGS[name])
    rng = np.random.default_rng(4)
    v = torch.as_tensor(rng.integers(-1000, 1000, (cfg.total_rows, cfg.n_features))
                        .astype(np.float32))
    assert torch.equal(TPG.k2_unpack_plain(list(TPG.pack_table(v, cfg)), cfg), 8 * v)
    x = torch.as_tensor(_inputs(CONFIGS[name])[1])
    slots, _ = TPG.k2_rows_plain(x, torch.ones(x.shape[0], cfg.out_dim), cfg)
    rows = TPG.vertex_rows(slots.t().long(), cfg)  # [N, L, 8]
    for l, p in enumerate(TPG.pack_table(v, cfg)):
        assert torch.equal(v[rows[:, l]], p[slots[l].long()].reshape(-1, 8, cfg.n_features))


def test_k2_share_reads_kernel_launches_over_encoder_calls():
    """benchmark/metrics/k2_share.py over the store's `packed.*` counters:
    the plain path counts the call and no launch (a launch on the card is
    counted here by hand); silent without a trace, units, encoder calls or
    a device kernel in the trace."""
    from types import SimpleNamespace

    from benchmark.metrics import k2_share
    from dregnerf_tpu_torch.runtime import profiling

    card = SimpleNamespace(kernel_s={"void packed_grid_fwd<8>(float const*)": 1e-3})
    cpu = SimpleNamespace(kernel_s={"aten::mm": 1e-3})
    cfg = TPG.PackedGridConfig(**CONFIGS["dense"])
    table, x = (torch.as_tensor(a) for a in _inputs(CONFIGS["dense"]))
    profiling.reset()
    try:
        assert k2_share.read({"units": 2}, card) is None
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            TPG.vertex_encode(table, x, cfg)
            TPG.packed_encode(TPG.pack_table(table, cfg), x, cfg)
            profiling.count("packed.kernel_calls", 1)
        assert profiling.snapshot()["counters"] == {"packed.encode_calls": 2,
                                                    "packed.kernel_calls": 1}
        assert k2_share.read({"units": 2}, card) == 50.0
        assert k2_share.read({"units": 2}, cpu) is None
        assert k2_share.read({"units": 0}, card) is None
        assert k2_share.read({"units": 2}, None) is None
    finally:
        profiling.reset()


def test_vertex_encode_refuses_what_k2_does_not_take():
    cfg = TPG.PackedGridConfig(**CONFIGS["wrapped"])
    table, x = (torch.as_tensor(a) for a in _inputs(CONFIGS["wrapped"]))
    with pytest.raises(ValueError, match="no gradient to the positions"):
        TPG.vertex_encode(table, x.clone().requires_grad_(True), cfg)
    with pytest.raises(TypeError, match="float32"):
        TPG.vertex_encode(table.double(), x, cfg)
    with pytest.raises(TypeError, match="total_rows"):
        TPG.vertex_encode(table[1:], x, cfg)
    with pytest.raises(ValueError, match="features"):
        TPG.vertex_encode(table[:, :3].contiguous(), x,
                          TPG.PackedGridConfig(**CONFIGS["wrapped"], n_features=3))
