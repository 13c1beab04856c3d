"""Port parity: occupancy updates in warmup and steady mode, with the
draws (cells, ranks, jitter) made by jax.random exactly as the JAX
`update_grid` makes them and handed to the port: occs within 1e-6,
binary exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dregnerf_tpu.ops import occupancy as jocc
from dregnerf_tpu_torch.ops import occupancy as tocc

RES = 16
N_CELLS = RES**3


def _field_j(u):
    return 0.05 * jnp.exp(-20.0 * jnp.sum((u - jnp.array([0.4, 0.5, 0.6])) ** 2, -1))


def _field_t(u):
    return 0.05 * torch.exp(-20.0 * ((u - torch.tensor([0.4, 0.5, 0.6])) ** 2).sum(-1))


def _compare(got, want):
    np.testing.assert_allclose(got.occs.numpy(), np.asarray(want.occs), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.binary.numpy(), np.asarray(want.binary))


def _warm(key):
    grid = jocc.init_grid(RES)
    want = jocc.update_grid(grid, key, _field_j, warmup=True)
    k_j1 = jax.random.split(key, 4)[2]
    noise = jax.random.uniform(k_j1, (N_CELLS, 3), minval=-0.5, maxval=0.5)
    got = tocc.update_grid(tocc.init_grid(RES), _field_t, warmup=True,
                           noise=torch.as_tensor(np.array(noise)))
    return want, got


def test_warmup_update_matches_jax():
    want, got = _warm(jax.random.PRNGKey(0))
    assert 0 < int(np.asarray(want.binary).sum()) < N_CELLS
    _compare(got, want)


@pytest.mark.parametrize("empty", [False, True])
def test_steady_update_matches_jax(empty):
    start, _ = _warm(jax.random.PRNGKey(0))
    if empty:  # no occupied cell: the resample falls back to uniform cells
        start = start._replace(binary=jnp.zeros_like(start.binary))
    key, n = jax.random.PRNGKey(5), 300
    want = jocc.update_grid(start, key, _field_j, warmup=False, n_samples=n)
    k_sel, k_occ, k_j1, _ = jax.random.split(key, 4)
    total = int(np.asarray(start.binary).sum())
    draws = dict(
        uniform_idx=jax.random.randint(k_sel, (n,), 0, N_CELLS),
        occ_rank=jax.random.randint(k_occ, (n,), 0, max(total, 1)),
        noise=jax.random.uniform(k_j1, (2 * n, 3), minval=-0.5, maxval=0.5))
    got = tocc.update_grid(
        tocc.occupancy_from_numpy(np.asarray(start.occs), np.asarray(start.binary)),
        _field_t, warmup=False, n_samples=n,
        **{k: torch.as_tensor(np.array(v)) for k, v in draws.items()})
    _compare(got, want)


def test_generator_draws_and_query_binary():
    """Draws from a torch.Generator stay in range; query_binary == JAX's."""
    start, _ = _warm(jax.random.PRNGKey(0))
    grid = tocc.occupancy_from_numpy(np.asarray(start.occs), np.asarray(start.binary))
    g = torch.Generator().manual_seed(0)
    out = tocc.update_grid(grid, _field_t, warmup=False, n_samples=500, generator=g)
    assert out.occs.shape == (N_CELLS,) and out.binary.shape == (RES,) * 3
    u = np.random.default_rng(0).uniform(-0.1, 1.1, (1000, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tocc.query_binary(grid, torch.as_tensor(u)).numpy(),
        np.asarray(jocc.query_binary(start, jnp.asarray(u))))
