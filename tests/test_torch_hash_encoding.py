"""Port parity for the xor-hash NGP encoder (ops/hash_encoding.py) and the
NGP field's encoder dispatch (models/ngp.py) against the JAX package, on
numpy-seeded inputs, with JAX's weights carried across by params_from_jax.

Tolerances: the config tables and the corner rows equal; hash_encode and
its table gradient within 1e-6 of their max |value| (f32; the 8-corner
sums and the scatter's adds run in another order); the hash NGP's density,
features and rgb within 1e-5 of their max in f32 and 2e-2 in bf16 (a bf16
ulp is 2^-8 relative, and the packages round the MLPs' inputs after f32
sums that differ in their last bits)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dregnerf_tpu.models import ngp as jngp
from dregnerf_tpu.ops import hash_encoding as JH
from dregnerf_tpu.ops.packed_grid import PackedGridConfig as JGrid
from dregnerf_tpu_torch.models import ngp as tngp
from dregnerf_tpu_torch.ops import hash_encoding as TH
from dregnerf_tpu_torch.ops.packed_grid import PackedGridConfig as TGrid

# the default (dense levels 0-4, hashed 5-15); JAX's own test block (4
# levels of 2^11 rows: 16^3 > 2^11, every level hashed); 4 levels of 2^13
# rows (levels 0 dense, 1-3 hashed)
CONFIGS = {"default": {}, "L4_T11": dict(n_levels=4, log2_table_size=11),
           "L4_T13": dict(n_levels=4, log2_table_size=13)}
AABB = [-1.0, -1.0, -1.0, 1.0, 1.0, 1.0]


def _points(n, seed=0, lo=-0.05, hi=1.05):
    return np.random.default_rng(seed).uniform(lo, hi, (n, 3)).astype(np.float32)


def _corner_coords(config, x):
    """hash_encode's clamped integer corners [N, L, 8, 3], in numpy."""
    pos = x[:, None, :] * config.level_scales()[None, :, None] + 0.5
    grid = np.floor(pos).astype(np.int64)[:, :, None, :] + JH._CORNERS[None, None]
    return np.clip(grid, 0, config.level_resolutions()[None, :, None, None] - 1)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_tables_equal_jax(name):
    j, t = JH.HashGridConfig(**CONFIGS[name]), TH.HashGridConfig(**CONFIGS[name])
    assert (t.table_size, t.out_dim) == (j.table_size, j.out_dim)
    np.testing.assert_array_equal(t.level_scales(), j.level_scales())
    assert t.level_scales().dtype == j.level_scales().dtype == np.float32
    np.testing.assert_array_equal(t.level_resolutions(), j.level_resolutions())
    np.testing.assert_array_equal(t.level_is_dense(), j.level_is_dense())


def test_configs_cover_dense_and_hashed_levels():
    dense = {k: TH.HashGridConfig(**v).level_is_dense().tolist() for k, v in CONFIGS.items()}
    assert dense["default"] == [True] * 5 + [False] * 11
    assert dense["L4_T11"] == [False] * 4
    assert dense["L4_T13"] == [True] + [False] * 3


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_corner_indices_equal_jax(name):
    """The rows of every corner, clamped or not, equal JAX's uint32 ones."""
    j, t = JH.HashGridConfig(**CONFIGS[name]), TH.HashGridConfig(**CONFIGS[name])
    coords = _corner_coords(j, _points(4096))
    want = np.asarray(JH._corner_indices(j, jnp.asarray(coords.astype(np.int32))))
    got = TH._corner_indices(t, torch.as_tensor(coords)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < t.n_levels * t.table_size


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_hash_encode_and_table_gradient_match_jax(name):
    """2048 points in [-0.05, 1.05]^3 (the clamp is exercised), a table
    uniform in (-1, 1), a random cotangent."""
    j, t = JH.HashGridConfig(**CONFIGS[name]), TH.HashGridConfig(**CONFIGS[name])
    rng = np.random.default_rng(1)
    x = _points(2048)
    table = rng.uniform(-1, 1, (j.n_levels * j.table_size, j.n_features)).astype(np.float32)
    want, vjp = jax.vjp(lambda tab: JH.hash_encode(tab, jnp.asarray(x), j), jnp.asarray(table))
    g = rng.normal(size=want.shape).astype(np.float32)
    (want_grad,) = vjp(jnp.asarray(g))
    tt = torch.as_tensor(table).requires_grad_(True)
    got = TH.hash_encode(tt, torch.as_tensor(x), t)
    got.backward(torch.as_tensor(g))
    assert got.shape == (2048, t.out_dim) and got.dtype == torch.float32
    for a, b in ((got.detach().numpy(), np.asarray(want)),
                 (tt.grad.numpy(), np.asarray(want_grad))):
        scale = np.abs(b).max()
        assert scale > 0
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 * scale)


def test_hash_encode_keeps_batch_dims():
    t = TH.HashGridConfig(**CONFIGS["L4_T11"])
    table = TH.init_hash_table(t, torch.Generator().manual_seed(0), "cpu")
    x = torch.as_tensor(_points(24).reshape(2, 3, 4, 3))
    out = TH.hash_encode(table, x, t)
    assert out.shape == (2, 3, 4, t.out_dim)
    torch.testing.assert_close(out.reshape(-1, t.out_dim),
                               TH.hash_encode(table, x.reshape(-1, 3), t))


def test_init_hash_table():
    t = TH.HashGridConfig(**CONFIGS["L4_T11"])
    table = TH.init_hash_table(t, torch.Generator().manual_seed(0), "cpu")
    assert table.shape == (4 << 11, 2) and table.dtype == torch.float32
    assert table.abs().max() < 1e-4 and table.std() > 1e-5
    again = TH.init_hash_table(t, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(table, again)


def test_init_hash_table_refuses_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TH.init_hash_table(TH.HashGridConfig(**CONFIGS["L4_T11"]))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["L4_T11", "L4_T13"])
def test_hash_ngp_query_density_and_forward_match_jax(name, bf16):
    """JAX's init_ngp weights (table x 1000 so that the grid matters), 1024
    world points in the aabb and beyond it, unit view directions."""
    jcfg = jngp.NGPConfig(grid=JH.HashGridConfig(**CONFIGS[name]),
                          compute_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    tcfg = tngp.NGPConfig(grid=TH.HashGridConfig(**CONFIGS[name]),
                          compute_dtype=torch.bfloat16 if bf16 else torch.float32)
    jp = jngp.init_ngp(jax.random.PRNGKey(0), jcfg)
    jp["table"] = jp["table"] * 1000.0
    tp = tngp.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    assert tngp.prepare_params(tp, tcfg) is tp  # a hash grid is not packed
    rng = np.random.default_rng(2)
    x = rng.uniform(-1.1, 1.1, (1024, 3)).astype(np.float32)
    d = rng.normal(size=(1024, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    aabb = np.asarray(AABB, np.float32)
    jd, jf = jngp.query_density(jp, jnp.asarray(x), jnp.asarray(aabb), jcfg, return_feat=True)
    jrgb, jsig = jngp.forward(jp, jnp.asarray(x), jnp.asarray(d), jnp.asarray(aabb), jcfg)
    td, tf = tngp.query_density(tp, torch.as_tensor(x), torch.as_tensor(aabb), tcfg,
                                return_feat=True)
    trgb, tsig = tngp.forward(tp, torch.as_tensor(x), torch.as_tensor(d), torch.as_tensor(aabb),
                              tcfg)
    tol = 2e-2 if bf16 else 1e-5
    for label, got, want in (("density", td, jd), ("feat", tf, jf), ("rgb", trgb, jrgb),
                             ("sigma", tsig, jsig)):
        want = np.asarray(want, np.float32)
        scale = np.abs(want).max()
        assert scale > 0, label
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol * scale, err_msg=label)
    assert (td.numpy() == 0).any()  # points outside the box


@pytest.mark.parametrize("grid", ["packed", "xor_hash"])
def test_config_meta_round_trips_both_ways(grid):
    """config_to_meta of each package reads back through the other's
    config_from_meta into the same config."""
    if grid == "packed":
        jcfg = jngp.NGPConfig(grid=JGrid(), compute_dtype=jnp.float32, unbounded=True)
        tcfg = tngp.NGPConfig(grid=TGrid(), compute_dtype=torch.float32, unbounded=True)
    else:
        jcfg = jngp.NGPConfig(grid=JH.HashGridConfig(n_levels=4, log2_table_size=11))
        tcfg = tngp.NGPConfig(grid=TH.HashGridConfig(n_levels=4, log2_table_size=11))
    jmeta, tmeta = jngp.config_to_meta(jcfg), tngp.config_to_meta(tcfg)
    assert tmeta == jmeta and tmeta["encoder"] == grid
    assert tngp.config_from_meta(jmeta) == tcfg
    assert jngp.config_from_meta(tmeta) == jcfg


def test_hash_ngp_init_matches_jax_layout():
    jcfg = jngp.NGPConfig(grid=JH.HashGridConfig(n_levels=4, log2_table_size=11))
    tcfg = tngp.NGPConfig(grid=TH.HashGridConfig(n_levels=4, log2_table_size=11))
    jp = jngp.init_ngp(jax.random.PRNGKey(0), jcfg)
    tp = tngp.init_ngp(tcfg, torch.Generator().manual_seed(0), "cpu")
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), tngp.params_to_numpy(tp)) == shapes
    assert tp["table"].abs().max() < 1e-4
