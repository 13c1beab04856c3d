"""Run-length scatter (ops/rle.py) against dregnerf_tpu/ops/rle.py: the run
segment sums, and the scatters with f32 (K1) and bf16 (K1p) accumulators,
one case within max_runs and one that overflows it (the safe scatter then
takes the direct-scatter fallback).

Tolerances: n_runs and the slots of the used runs exact. Run sums are
differences of one f32 cumsum, whose rounding differs between the
packages: 1e-6 of max |cumsum|. The f32 scatters add a few run sums per
slot: 1e-5 of max |cumsum|. The bf16 scatters of the run sums: per slot
hit by k runs, 2^-7 k sum|run sums| (a run sum that differs in its last
f32 bits may round each of the k adds to the neighbouring bf16 value),
plus the f32 term. The bf16 fallback scatters the same rows in the same
order in both packages: bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dregnerf_tpu.ops import rle as jrle
from dregnerf_tpu_torch.ops import rle as trle

N, TABLE, W = 4096, 64, 8


def _coherent(seed=0):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 20, N)
    slots = rng.integers(0, TABLE, N)
    idx = np.repeat(slots, lengths)[:N].astype(np.int32)
    vals = rng.normal(size=(N, W)).astype(np.float32)
    n_runs = 1 + int(np.sum(idx[1:] != idx[:-1]))
    return idx, vals, n_runs


def _max_runs(case, n_runs):
    return n_runs + 10 if case == "fits" else n_runs // 2


@pytest.mark.parametrize("case", ["fits", "overflow"])
def test_segment_sum_matches_jax(case):
    idx, vals, n_true = _coherent()
    max_runs = _max_runs(case, n_true)
    j_idx, j_sum, j_n = jrle.run_length_segment_sum(jnp.asarray(idx), jnp.asarray(vals), max_runs)
    t_idx, t_sum, t_n = trle.run_length_segment_sum(torch.as_tensor(idx), torch.as_tensor(vals),
                                                    max_runs)
    assert int(t_n) == int(j_n) == n_true
    used = min(n_true, max_runs)
    assert t_idx.dtype == torch.int32 and t_idx.shape == (max_runs,)
    np.testing.assert_array_equal(t_idx.numpy()[:used], np.asarray(j_idx)[:used])
    assert (t_idx.numpy()[used:] == trle.PAD_SLOT).all()  # JAX pads with slot 0
    scale = np.abs(np.cumsum(vals, axis=0)).max()
    np.testing.assert_allclose(t_sum.numpy(), np.asarray(j_sum), rtol=0, atol=1e-6 * scale)
    assert not t_sum.numpy()[used:].any()


@pytest.mark.parametrize("safe", [False, True])
@pytest.mark.parametrize("case", ["fits", "overflow"])
def test_f32_scatter_matches_jax(case, safe):
    idx, vals, n_true = _coherent(1)
    max_runs = _max_runs(case, n_true)
    jfn = jrle.rle_scatter_add_safe if safe else jrle.rle_scatter_add
    tfn = trle.rle_scatter_add_safe if safe else trle.rle_scatter_add
    want = np.asarray(jfn(jnp.zeros((TABLE, W)), jnp.asarray(idx), jnp.asarray(vals), max_runs))
    got = tfn(torch.as_tensor(idx), torch.as_tensor(vals), max_runs, TABLE, "f32")
    assert got.dtype == torch.float32
    scale = np.abs(np.cumsum(vals, axis=0)).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * scale)
    if safe or case == "fits":  # every row counted
        direct = torch.zeros(TABLE, W).index_add_(0, torch.as_tensor(idx).long(),
                                                  torch.as_tensor(vals))
        np.testing.assert_allclose(got.numpy(), direct.numpy(), rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("safe", [False, True])
@pytest.mark.parametrize("case", ["fits", "overflow"])
def test_bf16_scatter_matches_jax(case, safe):
    idx, vals, n_true = _coherent(2)
    max_runs = _max_runs(case, n_true)
    jfn = jrle.rle_scatter_add_safe if safe else jrle.rle_scatter_add
    tfn = trle.rle_scatter_add_safe if safe else trle.rle_scatter_add
    want = np.asarray(jfn(jnp.zeros((TABLE, W), jnp.bfloat16), jnp.asarray(idx),
                          jnp.asarray(vals), max_runs), np.float32)
    got = tfn(torch.as_tensor(idx), torch.as_tensor(vals), max_runs, TABLE, "bf16")
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    if safe and case == "overflow":  # the fallback: the direct bf16 scatter
        np.testing.assert_array_equal(got, want)
        return
    run_idx, run_sum, _ = trle.run_length_segment_sum(torch.as_tensor(idx),
                                                      torch.as_tensor(vals), max_runs)
    keep = run_idx >= 0
    slots = run_idx[keep].long()
    k = torch.bincount(slots, minlength=TABLE).float()[:, None].numpy()
    abs_sum = torch.zeros(TABLE, W).index_add_(0, slots, run_sum[keep].abs()).numpy()
    scale = np.abs(np.cumsum(vals, axis=0)).max()
    tol = 2.0**-7 * k * abs_sum + 1e-5 * scale
    assert np.all(np.abs(got - want) <= tol)
