"""The port's CUDA kernels against their plain versions, on a CUDA device.

This file imports neither JAX nor the JAX package, so it runs on a machine
with only PyTorch and the CUDA toolkit:

  python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

Without a CUDA device every test skips (a CUDA kernel has no CPU mode).
"""
import pytest
import torch

from dregnerf_tpu_torch.ops.scatter_add import scatter_add, scatter_add_plain


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("table_rows", [4096, 1 << 19])
@pytest.mark.parametrize("coherent", [False, True])
def test_scatter_add_kernel_matches_plain(cuda_device, table_rows, coherent):
    """K1 at the main path's shapes (2^18 rows of 64 floats). Atomics sum in
    a varying order: tolerance 1e-5 of max |out|."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    n, w = 1 << 18, 64
    if coherent:  # runs of 16 equal slots, like marched samples
        starts = torch.randint(0, table_rows, (n // 16,), generator=g, device=cuda_device)
        idx = starts.repeat_interleave(16).to(torch.int32)
    else:
        idx = torch.randint(0, table_rows, (n,), generator=g, device=cuda_device,
                            dtype=torch.int32)
    src = torch.randn(n, w, generator=g, device=cuda_device)
    before = scatter_add.launches
    got = scatter_add(idx, src, table_rows)
    torch.cuda.synchronize()
    assert scatter_add.launches == before + 1
    want = scatter_add_plain(idx, src, table_rows)
    tol = 1e-5 * want.abs().max().item()
    assert (got - want).abs().max().item() <= tol


@pytest.mark.cuda
def test_scatter_add_kernel_skips_out_of_range_rows(cuda_device):
    idx = torch.tensor([0, 5, -1, 8, 3], dtype=torch.int32, device=cuda_device)
    src = torch.ones(5, 4, device=cuda_device)
    got = scatter_add(idx, src, 8).cpu()
    want = torch.zeros(8, 4)
    want[[0, 5, 3]] = 1.0
    assert torch.equal(got, want)
