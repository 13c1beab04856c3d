"""The port's CUDA kernels against their plain versions, on a CUDA device.

This file imports neither JAX nor the JAX package, so it runs on a machine
with only PyTorch and the CUDA toolkit:

  python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

Without a CUDA device every test skips (a CUDA kernel has no CPU mode).
"""
import math

import pytest
import torch

from dregnerf_tpu_torch.ops.gather_rows import gather_rows, gather_rows_plain
from dregnerf_tpu_torch.ops.scatter_add import (
    scatter_add,
    scatter_add_bf16,
    scatter_add_bf16_plain,
    scatter_add_plain,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _slots(table_rows, n, run, generator, device):
    """n slots in runs of `run` equal slots, like marched samples."""
    starts = torch.randint(0, table_rows, (-(-n // run),), generator=generator, device=device)
    return starts.repeat_interleave(run)[:n].to(torch.int32).contiguous()


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


@pytest.mark.cuda
@pytest.mark.parametrize("table_rows,run", [(4096, 1), (4096, 37), (1 << 19, 1), (1 << 19, 7)])
@pytest.mark.parametrize("w", [16, 32, 64])
@pytest.mark.parametrize("values", ["normal", "integers"])
def test_scatter_add_bf16_kernel_matches_plain_per_slot(cuda_device, table_rows, run, w,
                                                       values):
    """K1p at the main path's shapes, at the row widths 8F of the layouts
    L16F2, L8F4 and L4F8. The reductions add a slot's k rows in a varying
    order, each add rounding to bf16, so per slot the kernel is held to
    `_bf16_slot_bound` of the serial scatter on normal rows, and bit for bit
    on integer rows, whose adds are exact in any order: at 4096 rows a slot
    is hit about 64 (run 1) to 300 times (run 37), where the bound is wide,
    and a lost or repeated add still shows."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    n = 1 << 18
    idx = _slots(table_rows, n, run, g, cuda_device)
    if values == "integers":
        src = _integer_rows(n, w, g, cuda_device)
        _assert_partial_sums_exact(idx, src, table_rows)
    else:
        src = torch.randn(n, w, generator=g, device=cuda_device)
    before = scatter_add_bf16.launches
    got = scatter_add_bf16(idx, src, table_rows)
    torch.cuda.synchronize()
    assert scatter_add_bf16.launches == before + 1 and got.dtype == torch.bfloat16
    want = scatter_add_bf16_plain(idx, src, table_rows)
    if values == "integers":
        assert torch.equal(got, want)
    else:
        err = (got.float() - want.float()).abs()
        assert bool((err <= _bf16_slot_bound(idx, src, table_rows)).all()), float(err.max())


def _integer_rows(n, w, generator, device):
    """Rows of integers in {-1, 0, 1}, on which a bf16 scatter is exact."""
    return torch.randint(-1, 2, (n, w), generator=generator, device=device).float()


def _assert_partial_sums_exact(idx, src, table_rows):
    """Every partial sum of a slot's integer rows, in any order, lies within
    [-sum of its negative rows, sum of its positive rows]; within +-256 it is
    an integer that bf16 holds exactly, so every order of the adds ends on
    the same value."""
    keep = (idx >= 0) & (idx < table_rows)
    slot, rows = idx[keep].long(), src[keep]
    for part in (rows.clamp(min=0), (-rows).clamp(min=0)):
        reach = torch.zeros(table_rows, src.shape[1], device=src.device).index_add_(0, slot, part)
        assert reach.max().item() <= 256


@pytest.mark.cuda
def test_scatter_add_bf16_kernel_skips_out_of_range_rows(cuda_device):
    idx = torch.tensor([0, 5, -1, 8, 3, 1 << 20], dtype=torch.int32, device=cuda_device)
    src = torch.full((6, 8), 1.5, device=cuda_device)
    got = scatter_add_bf16(idx, src, 8).float().cpu()
    want = torch.zeros(8, 8)
    want[[0, 5, 3]] = 1.5
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("table_rows", [4096, 1 << 19])
@pytest.mark.parametrize("width", [16, 32, 64])
@pytest.mark.parametrize("run", [1, 37])
def test_gather_rows_kernel_equals_index_select(cuda_device, table_rows, width, run):
    """K2p copies rows: bit for bit index_select."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    n = 1 << 18
    table = torch.randn(table_rows, width, generator=g, device=cuda_device)
    idx = _slots(table_rows, n, run, g, cuda_device)
    before = gather_rows.launches
    got = gather_rows(table, idx)
    torch.cuda.synchronize()
    assert gather_rows.launches == before + 1
    assert torch.equal(got, gather_rows_plain(table, idx))


def _slot_hits(idx, src, table_rows):
    """(k, sum|src|) per slot, over the in-range rows."""
    keep = (idx >= 0) & (idx < table_rows)
    slot = idx[keep].long()
    k = torch.bincount(slot, minlength=table_rows).float()[:, None]
    abs_sum = torch.zeros(table_rows, src.shape[1], device=src.device).index_add_(
        0, slot, src[keep].abs())
    return k, abs_sum


def _bf16_slot_bound(idx, src, table_rows):
    """2 ((1 + 2^-8)^(k-1) - 1) sum|src| per slot hit k times: the farthest
    apart two orders of the slot's k - 1 rounded bf16 adds can end
    (test_torch_scatter_bf16.py)."""
    k, abs_sum = _slot_hits(idx, src, table_rows)
    return 2.0 * torch.expm1(math.log1p(2.0**-8) * (k - 1).clamp(min=0)) * abs_sum


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("take_alt", [False, True])
def test_scatter_kernels_scatter_the_rows_their_flag_picks(cuda_device, bf16, take_alt):
    """The run-length backward's shapes at level 0: 23,039 run rows (the
    last ones padded with slot -1) or, when the flag on the device is set,
    the 2^18 direct rows. One launch either way; the result is the plain
    version of the rows picked (K1: 1e-5 of max |out|; K1p: per slot)."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    n, runs, w, table_rows = 1 << 18, 23039, 64, 4096
    run_idx = _slots(table_rows, runs, 1, g, cuda_device)
    run_idx[runs // 3:] = -1
    run_src = torch.randn(runs, w, generator=g, device=cuda_device)
    idx = _slots(table_rows, n, 37, g, cuda_device)
    src = torch.randn(n, w, generator=g, device=cuda_device)
    alt = (torch.tensor(take_alt, device=cuda_device), idx, src)
    picked = (idx, src) if take_alt else (run_idx, run_src)
    kernel = scatter_add_bf16 if bf16 else scatter_add
    before = kernel.launches
    got = kernel(run_idx, run_src, table_rows, alt=alt)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    if bf16:
        err = (got.float() - scatter_add_bf16_plain(*picked, table_rows).float()).abs()
        assert bool((err <= _bf16_slot_bound(*picked, table_rows)).all()), float(err.max())
    else:
        want = scatter_add_plain(*picked, table_rows)
        assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("accum", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["fits", "overflow"])
def test_rle_safe_scatter_on_the_card_matches_the_cpu(cuda_device, accum, case):
    """ops/rle.py::rle_scatter_add_safe on the card against the CPU on the
    same rows, both branches of its device-side choice: f32 within 1e-5 of
    max |cumsum| (the run sums are differences of a cumsum, as in
    test_torch_rle.py); bf16 within 2^-7 k sum|rows| per slot of the rows
    scattered (the run sums differ in their last f32 bits between the
    devices, so an add may round to the neighbouring bf16 value), plus the
    f32 term."""
    from dregnerf_tpu_torch.ops import rle

    g = torch.Generator().manual_seed(4)
    n, w, table_rows = 1 << 16, 64, 4096
    idx = _slots(table_rows, n, 37, g, "cpu")
    vals = torch.randn(n, w, generator=g)
    n_runs = 1 + int((idx[1:] != idx[:-1]).sum())
    max_runs = n_runs + 5 if case == "fits" else n_runs // 2
    want = rle.rle_scatter_add_safe(idx, vals, max_runs, table_rows, accum).float()
    got = rle.rle_scatter_add_safe(idx.to(cuda_device), vals.to(cuda_device), max_runs,
                                   table_rows, accum).float().cpu()
    tol = 1e-5 * vals.cumsum(0).abs().max().item()
    if accum == "bf16":
        run_idx, run_sum, _ = rle.run_length_segment_sum(idx, vals, max_runs)
        rows = (run_idx, run_sum) if case == "fits" else (idx, vals)
        k, abs_sum = _slot_hits(*rows, table_rows)
        tol = 2.0**-7 * k * abs_sum + tol
    assert bool(((got - want).abs() <= tol).all()), float((got - want).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("values", ["normal", "integers"])
@pytest.mark.parametrize("case", ["fits", "overflow"])
def test_rle_bf16_scatter_with_its_device_count(cuda_device, case, values):
    """The run-length call as ops/rle.py makes it at level 0's shapes: the
    run sums bounded by the run count on the device, the direct rows as the
    alternative its flag picks on an overflow. One launch; the result is
    within the per-slot bound of the serial scatter of the rows picked (bit
    for bit on integer rows), and rle_scatter_add_safe gives it too."""
    from dregnerf_tpu_torch.ops import rle

    g = torch.Generator(device=cuda_device).manual_seed(5)
    n, w, table_rows = 1 << 18, 64, 4096
    idx = _slots(table_rows, n, 37, g, cuda_device)
    if values == "integers":
        vals = _integer_rows(n, w, g, cuda_device)
    else:
        vals = torch.randn(n, w, generator=g, device=cuda_device)
    n_true = 1 + int((idx[1:] != idx[:-1]).sum())
    max_runs = 3 * n_true if case == "fits" else n_true // 2
    run_idx, run_sum, n_runs = rle.run_length_segment_sum(idx, vals, max_runs)
    picked = (run_idx[:n_true], run_sum[:n_true]) if case == "fits" else (idx, vals)
    before = scatter_add_bf16.launches
    got = scatter_add_bf16(run_idx, run_sum.contiguous(), table_rows,
                           alt=(n_runs > max_runs, idx, vals), count=n_runs)
    safe = rle.rle_scatter_add_safe(idx, vals, max_runs, table_rows, "bf16")
    torch.cuda.synchronize()
    assert scatter_add_bf16.launches == before + 2
    want = scatter_add_bf16_plain(*picked, table_rows).float()
    bound = _bf16_slot_bound(*picked, table_rows)
    if values == "integers":
        _assert_partial_sums_exact(*picked, table_rows)
        bound = torch.zeros_like(bound)
    for out in (got, safe):
        err = (out.float() - want).abs()
        assert bool((err <= bound).all()), float(err.max())


@pytest.mark.cuda
def test_scatter_add_bf16_count_leaves_the_rows_past_it_unread(cuda_device):
    """Rows past the device count are never read: NaN rows there, at
    in-range slots, do not reach the table."""
    g = torch.Generator(device=cuda_device).manual_seed(6)
    n, w, table_rows, count = 23039, 64, 4096, 7085
    idx = _slots(table_rows, n, 1, g, cuda_device)
    src = torch.randn(n, w, generator=g, device=cuda_device)
    src[count:] = float("nan")
    got = scatter_add_bf16(idx, src, table_rows,
                           count=torch.tensor(count, device=cuda_device)).float()
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    want = scatter_add_bf16_plain(idx[:count], src[:count], table_rows).float()
    err = (got - want).abs()
    assert bool((err <= _bf16_slot_bound(idx[:count], src[:count], table_rows)).all())


def _hash_points(n, coherent, generator, device):
    """n points: in runs of 16 samples a ray at the training march's step
    (sqrt(3) / 1024 in the unit box), as the marcher hands them over, or
    uniform in [-0.05, 1.05]^3 (corners clamped at the faces)."""
    if not coherent:
        return torch.rand(n, 3, generator=generator, device=device) * 1.1 - 0.05
    starts = torch.rand(n // 16, 3, generator=generator, device=device) * 0.8 + 0.1
    dirs = torch.nn.functional.normalize(
        torch.randn(n // 16, 3, generator=generator, device=device), dim=-1)
    steps = torch.arange(16, device=device, dtype=torch.float32) * (math.sqrt(3) / 1024)
    return (starts[:, None] + dirs[:, None] * steps[None, :, None]).reshape(-1, 3).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("coherent", [False, True])
def test_hash_grid_kernel_matches_plain(cuda_device, coherent):
    """K6 at full width (2^18 points, HashGridConfig()) against the plain
    path on the card: the forward within 1e-6 of its max (equal corner
    rows, the 8-corner sums in another order), the table gradient within
    1e-5 of its max (atomics sum in a varying order), the gradient's support
    under dL/denc = 1 (weights >= 0) exactly the rows of hash_corners with a
    nonzero weight, and one launch each way."""
    from dregnerf_tpu_torch.ops import hash_encoding as H

    cfg = H.HashGridConfig()
    g = torch.Generator(device=cuda_device).manual_seed(6)
    x = _hash_points(1 << 18, coherent, g, cuda_device)
    table = (torch.rand(cfg.n_levels * cfg.table_size, 2, generator=g, device=cuda_device)
             * 2 - 1).requires_grad_(True)
    dout = torch.randn(x.shape[0], cfg.out_dim, generator=g, device=cuda_device)
    before = (H.hash_encode.launches, H.hash_encode.grad_launches)
    got = H.hash_encode(table, x, cfg)
    got.backward(dout)
    torch.cuda.synchronize()
    assert (H.hash_encode.launches, H.hash_encode.grad_launches) == (before[0] + 1,
                                                                     before[1] + 1)
    got_grad, table.grad = table.grad, None
    want = H.hash_encode_plain(table, x, cfg)
    want.backward(dout)
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()
    assert (got_grad - table.grad).abs().max() <= 1e-5 * table.grad.abs().max()
    table.grad = None
    rows, w = H.hash_corners(x, cfg)
    support = torch.zeros(table.shape[0], dtype=torch.bool, device=cuda_device)
    support[rows[w > 0]] = True
    ones = H.hash_encode(table, x, cfg)
    ones.backward(torch.ones_like(ones))
    assert torch.equal(table.grad.abs().sum(-1) > 0, support)


@pytest.mark.cuda
def test_hash_grid_spans_and_counters_on_the_card(cuda_device):
    """Under a profiler the store times `hash.encode` around K6's forward
    and `hash.encode_grad` around its backward, which autograd runs on its
    device thread, and counts the calls, the launches and the rows."""
    from dregnerf_tpu_torch.ops import hash_encoding as H
    from dregnerf_tpu_torch.runtime import profiling

    cfg = H.HashGridConfig(n_levels=4, log2_table_size=13)
    g = torch.Generator(device=cuda_device).manual_seed(7)
    x = _hash_points(4096, True, g, cuda_device)
    table = torch.zeros(4 << 13, 2, device=cuda_device, requires_grad=True)
    profiling.reset()
    with torch.profiler.profile():
        H.hash_encode(table, x, cfg).sum().backward()
    snap = profiling.snapshot()
    profiling.reset()
    for name in ("hash.encode", "hash.encode_grad"):
        assert snap["spans"][name]["calls"] == 1
        assert snap["spans"][name]["device_ms"] is not None
    assert snap["counters"] == {"hash.encode_calls": 1, "hash.kernel_calls": 1,
                                "hash.rows": 4096}
