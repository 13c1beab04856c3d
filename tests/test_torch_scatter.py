"""Kernel K1 (ops/scatter_add.py): the plain version against the JAX Pallas
`bucketed_scatter_add` (interpret mode on the CPU), the CPU dispatch, the
input checks. The kernel itself is tested in test_torch_kernels_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dregnerf_tpu.ops.pallas_scatter import bucketed_scatter_add
from dregnerf_tpu_torch.ops.scatter_add import scatter_add, scatter_add_plain


@pytest.mark.parametrize("table_rows,shard,chunk", [
    (4913, 1024, 64),  # table_rows not a multiple of the shard
    (4096, 512, 128),
    (300, 4096, 64),  # one shard, mostly empty rows
])
def test_plain_matches_pallas_bucketed_scatter(table_rows, shard, chunk):
    rng = np.random.default_rng(0)
    idx = rng.integers(0, table_rows, size=1000).astype(np.int32)
    src = rng.normal(size=(1000, 8)).astype(np.float32)
    want = bucketed_scatter_add(jnp.asarray(idx), jnp.asarray(src),
                                table_rows=table_rows, shard_rows=shard, chunk=chunk)
    got = scatter_add_plain(torch.as_tensor(idx), torch.as_tensor(src), table_rows)
    assert got.shape == (table_rows, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_cpu_wrapper_takes_plain_version_and_counts_no_launch():
    rng = np.random.default_rng(1)
    idx = torch.as_tensor(rng.integers(0, 64, 500).astype(np.int32))
    src = torch.as_tensor(rng.normal(size=(500, 16)).astype(np.float32))
    before = scatter_add.launches
    out = scatter_add(idx, src, 64)
    assert scatter_add.launches == before
    torch.testing.assert_close(out, scatter_add_plain(idx, src, 64), rtol=0, atol=0)


@pytest.mark.parametrize("idx,src,rows,err", [
    (torch.zeros(4, dtype=torch.int64), torch.zeros(4, 8), 8, TypeError),
    (torch.zeros(4, dtype=torch.int32), torch.zeros(4, 8, dtype=torch.float64), 8, TypeError),
    (torch.zeros(4, dtype=torch.int32), torch.zeros(5, 8), 8, ValueError),
    (torch.zeros(4, dtype=torch.int32), torch.zeros(4, 6), 8, ValueError),
    (torch.zeros(4, dtype=torch.int32), torch.zeros(8, 4).t(), 8, ValueError),
])
def test_wrapper_rejects_bad_inputs(idx, src, rows, err):
    with pytest.raises(err):
        scatter_add(idx, src, rows)


@pytest.mark.parametrize("take_alt", [False, True])
def test_cpu_wrapper_scatters_the_rows_its_flag_picks(take_alt):
    """With `alt`, the wrapper scatters the alternative rows when the flag
    is true and its own rows otherwise, exactly as the plain version of
    the rows picked."""
    rng = np.random.default_rng(2)
    idx = torch.as_tensor(rng.integers(-1, 64, 50).astype(np.int32))
    src = torch.as_tensor(rng.normal(size=(50, 8)).astype(np.float32))
    alt_idx = torch.as_tensor(rng.integers(0, 64, 300).astype(np.int32))
    alt_src = torch.as_tensor(rng.normal(size=(300, 8)).astype(np.float32))
    out = scatter_add(idx, src, 64, alt=(torch.tensor(take_alt), alt_idx, alt_src))
    want = scatter_add_plain(*((alt_idx, alt_src) if take_alt else (idx, src)), 64)
    torch.testing.assert_close(out, want, rtol=0, atol=0)


@pytest.mark.parametrize("flag,alt_src,err", [
    (torch.tensor(1), torch.zeros(3, 8), TypeError),  # the flag is not a bool
    (torch.tensor([True, False]), torch.zeros(3, 8), TypeError),  # nor one value
    (torch.tensor(True), torch.zeros(3, 4), ValueError),  # another width
    (torch.tensor(True), torch.zeros(2, 8), ValueError),  # rows and indices differ
])
def test_wrapper_rejects_bad_alternative_rows(flag, alt_src, err):
    alt = (flag, torch.zeros(3, dtype=torch.int32), alt_src)
    with pytest.raises(err):
        scatter_add(torch.zeros(4, dtype=torch.int32), torch.zeros(4, 8), 8, alt=alt)
