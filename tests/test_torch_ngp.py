"""Port parity: the NGP field with weights carried over from the JAX
package (`params_from_jax`): density, features and rgb, in f32 (rtol 1e-5)
and at the bf16 default (atol 2e-2)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dregnerf_tpu.models import ngp as jngp
from dregnerf_tpu.ops.packed_grid import PackedGridConfig as JGrid
from dregnerf_tpu_torch.models import ngp as tngp
from dregnerf_tpu_torch.ops.packed_grid import PackedGridConfig as TGrid

GRID = dict(n_levels=2, log2_table_size=10, base_resolution=4, per_level_scale=2.0)


def _models(bf16: bool, unbounded: bool = False):
    jcfg = jngp.NGPConfig(grid=JGrid(**GRID), unbounded=unbounded,
                          compute_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    tcfg = tngp.NGPConfig(grid=TGrid(**GRID), unbounded=unbounded,
                          compute_dtype=torch.bfloat16 if bf16 else torch.float32)
    jparams = jngp.init_ngp(jax.random.PRNGKey(0), jcfg)
    jparams["table"] = jparams["table"] * 1000.0  # O(0.1) features
    params_np = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, tngp.params_from_jax(params_np, "cpu")


def _points(n=400, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.1, 1.1, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return x, d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("bf16,unbounded", [(False, False), (False, True), (True, False)])
def test_query_density_and_forward_match_jax(bf16, unbounded):
    jcfg, tcfg, jparams, tparams = _models(bf16, unbounded)
    x, d = _points()
    aabb = np.array([-1.0, -1, -1, 1, 1, 1], np.float32)
    jd, jf = jngp.query_density(jparams, jnp.asarray(x), jnp.asarray(aabb), jcfg,
                                return_feat=True)
    jrgb, _ = jngp.forward(jparams, jnp.asarray(x), jnp.asarray(d), jnp.asarray(aabb), jcfg)
    td, tf = tngp.query_density(tparams, torch.as_tensor(x), torch.as_tensor(aabb), tcfg,
                                return_feat=True)
    trgb, td2 = tngp.forward(tparams, torch.as_tensor(x), torch.as_tensor(d),
                             torch.as_tensor(aabb), tcfg)
    tol = dict(rtol=0, atol=2e-2) if bf16 else dict(rtol=1e-5, atol=1e-6)
    for got, want in [(td, jd), (tf, jf), (trgb, jrgb), (td2, jd)]:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def test_out_of_box_density_is_zero():
    _, tcfg, _, tparams = _models(False)
    x = torch.tensor([[1.5, 0.0, 0.0], [0.0, -1.2, 0.3], [0.1, 0.2, 0.3]])
    d = tngp.query_density(tparams, x, torch.tensor([-1.0, -1, -1, 1, 1, 1]), tcfg)
    assert d[0].item() == 0.0 and d[1].item() == 0.0 and d[2].item() > 0.0


def test_params_round_trip_through_numpy():
    _, tcfg, jparams, tparams = _models(False)
    back = tngp.params_to_numpy(tparams)
    flat_j = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jparams))
    flat_t = jax.tree_util.tree_leaves(back)
    assert len(flat_j) == len(flat_t) == 6
    for a, b in zip(flat_j, flat_t):
        np.testing.assert_array_equal(a, b)
    fresh = tngp.init_ngp(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert [a.shape for a in jax.tree_util.tree_leaves(tngp.params_to_numpy(fresh))] == [
        a.shape for a in flat_j]
