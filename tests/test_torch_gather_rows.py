"""Kernel K2p (ops/gather_rows.py): the plain version against JAX's row
gather `table[idx]`, bit for bit, at the widths the encoder and the
Pallas probe use; the CPU dispatch and the input checks. The kernel itself
is tested in test_torch_kernels_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dregnerf_tpu_torch.ops.gather_rows import gather_rows, gather_rows_plain


@pytest.mark.parametrize("width", [16, 32, 64])
@pytest.mark.parametrize("runs", [False, True])
def test_plain_matches_jax_gather_bitwise(width, runs):
    rng = np.random.default_rng(width)
    table = rng.normal(size=(4096, width)).astype(np.float32)
    if runs:
        idx = np.repeat(rng.integers(0, 4096, 100), 37)[:3000]
    else:
        idx = rng.integers(0, 4096, 3000)
    idx = idx.astype(np.int32)
    want = np.asarray(jnp.asarray(table)[jnp.asarray(idx)])
    got = gather_rows_plain(torch.as_tensor(table), torch.as_tensor(idx))
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_wrapper_takes_plain_version_and_counts_no_launch():
    rng = np.random.default_rng(1)
    table = torch.as_tensor(rng.normal(size=(64, 8)).astype(np.float32))
    idx = torch.as_tensor(rng.integers(0, 64, 100).astype(np.int32))
    before = gather_rows.launches
    out = gather_rows(table, idx)
    assert gather_rows.launches == before
    assert torch.equal(out, table[idx.long()])


@pytest.mark.parametrize("table,idx,err", [
    (torch.zeros(8, 4), torch.zeros(3, dtype=torch.int64), TypeError),
    (torch.zeros(8, 4, dtype=torch.float64), torch.zeros(3, dtype=torch.int32), TypeError),
    (torch.zeros(8, 6), torch.zeros(3, dtype=torch.int32), ValueError),
    (torch.zeros(4, 8).t(), torch.zeros(3, dtype=torch.int32), ValueError),
])
def test_wrapper_rejects_bad_inputs(table, idx, err):
    with pytest.raises(err):
        gather_rows(table, idx)
