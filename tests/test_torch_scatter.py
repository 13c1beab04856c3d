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
