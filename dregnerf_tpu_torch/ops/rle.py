"""Run-length compression of coherent scatter-adds (port of dregnerf_tpu/ops/rle.py).

Marched samples arrive ray-major with increasing t, so at a coarse
encoder level consecutive samples fall in the same cell: runs of equal
slots. Each run is summed first (differences of one f32 cumsum), and the
scatter then adds one row per run. Shapes are static: at most `max_runs`
runs are kept. Plain PyTorch on both devices; the scatter of the run sums
is kernel K1 (f32 accumulator) or K1p (bf16), `ops/scatter_add.py`.

Unlike the JAX package, which pads unused runs with slot 0 and zero rows,
the port pads them with slot `PAD_SLOT` (-1), which every scatter skips:
on the card, pad rows at slot 0 would pile their atomics onto one table
row. The scatters return a fresh table (the JAX functions add into a
given `acc`, which their callers pass as zeros).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from dregnerf_tpu_torch.ops.scatter_add import scatter_add, scatter_add_bf16
from dregnerf_tpu_torch.runtime import profiling

PAD_SLOT = -1
SCAN_BLOCK = 256  # rows of the first level of `cumsum_rows`


def cumsum_rows(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum over dim 0 of x [N, W] in two levels: within blocks
    of SCAN_BLOCK rows, then over the block totals. torch's dim-0 cumsum
    of a [2^18, 64] tensor on the card scans each column in one thread
    (95 ms a step on an H100, PERF.md); both levels here run a thread per
    (block, column)."""
    n, w = x.shape
    blocks = -(-n // SCAN_BLOCK)
    within = F.pad(x, (0, 0, 0, blocks * SCAN_BLOCK - n)).view(blocks, SCAN_BLOCK, w)
    within = within.cumsum(dim=1)
    offsets = F.pad(within[:-1, -1].cumsum(dim=0), (0, 0, 1, 0))  # exclusive, per block
    return (within + offsets[:, None]).view(blocks * SCAN_BLOCK, w)[:n]


def run_length_segment_sum(idx: torch.Tensor, vals: torch.Tensor, max_runs: int):
    """Sum rows of `vals` [N, W] over runs of consecutive equal `idx` [N].

    Returns (run_idx [max_runs] int32, the slot of each run and PAD_SLOT
    past n_runs; run_sum [max_runs, W] in vals' type, zero past n_runs;
    n_runs [] int64, the number of runs, which may exceed max_runs: runs
    past max_runs are dropped)."""
    n = idx.shape[0]
    dev = idx.device
    new = torch.ones(n, dtype=torch.bool, device=dev)  # run starts
    new[1:] = idx[1:] != idx[:-1]
    run_of = torch.cumsum(new.to(torch.int64), 0) - 1  # run id of each row
    n_runs = run_of[-1] + 1

    # compact run-start and run-end positions into buffers of max_runs + 1
    # rows: every row that is not a start (an end), and every run past
    # max_runs, writes to the last row, which is dropped
    elem = torch.arange(n, device=dev)
    kept = run_of < max_runs
    starts = torch.full((max_runs + 1,), n, dtype=torch.int64, device=dev)
    starts[torch.where(new & kept, run_of, max_runs)] = elem
    is_end = torch.ones(n, dtype=torch.bool, device=dev)
    is_end[:-1] = idx[1:] != idx[:-1]
    end = torch.full((max_runs + 1,), n - 1, dtype=torch.int64, device=dev)
    end[torch.where(is_end & kept, run_of, max_runs)] = elem
    starts, end = starts[:max_runs], end[:max_runs]

    # unused runs are the empty span [n, n - 1], whose difference is zero
    csum = cumsum_rows(vals.to(torch.float32))
    upper = csum[end.clamp(0, n - 1)]
    lower = torch.where((starts > 0)[:, None], csum[(starts - 1).clamp(0, n - 1)], 0.0)
    run_sum = (upper - lower).to(vals.dtype)

    valid = torch.arange(max_runs, device=dev) < n_runs
    run_idx = torch.where(valid, idx[starts.clamp(0, n - 1)].to(torch.int32), PAD_SLOT)
    run_sum = torch.where(valid[:, None], run_sum, 0.0)
    return run_idx.to(torch.int32), run_sum, n_runs


def _scatter_runs(accum: str, runs, n_runs: torch.Tensor, table_rows: int,
                  alt=None) -> torch.Tensor:
    """Scatter the run sums `runs` (run_idx, run_sum f32): K1 for "f32",
    which walks every row of the buffer and skips the pad rows; K1p for
    "bf16", which reads n_runs on the device and stops at the real runs."""
    if accum == "f32":
        return scatter_add(*runs, table_rows, alt=alt)
    if accum == "bf16":
        return scatter_add_bf16(*runs, table_rows, alt=alt, count=n_runs)
    raise ValueError(f"unknown accumulator {accum!r}")


def rle_scatter_add(idx: torch.Tensor, vals: torch.Tensor, max_runs: int,
                    table_rows: int, accum: str = "f32") -> torch.Tensor:
    """zeros[table_rows, W].at[idx].add(vals), with the runs summed first;
    equal to the direct scatter (up to the summation order) when max_runs
    bounds the run count. `accum` "f32" gives an f32 table (K1), "bf16" a
    bf16 table (K1p)."""
    run_idx, run_sum, n_runs = run_length_segment_sum(idx, vals, max_runs)
    return _scatter_runs(accum, (run_idx, run_sum.to(torch.float32).contiguous()), n_runs,
                         table_rows)


def rle_scatter_add_safe(idx: torch.Tensor, vals: torch.Tensor, max_runs: int,
                         table_rows: int, accum: str = "f32") -> torch.Tensor:
    """`rle_scatter_add`, or the direct scatter of `vals` when the run count
    exceeds max_runs, so max_runs may be a heuristic. The JAX package picks
    the branch with `lax.cond`; here one scatter gets both row sets and a
    flag on the device, and its kernel reads only the set the flag picks:
    no host read of n_runs and no copy of either set. Counters: `rle.calls`,
    and `rle.direct`, the calls whose flag sent the kernel to the direct
    rows."""
    run_idx, run_sum, n_runs = run_length_segment_sum(idx, vals, max_runs)
    runs = (run_idx, run_sum.to(torch.float32).contiguous())
    profiling.count("rle.calls", 1)
    if max_runs >= idx.shape[0]:  # n_runs <= n: the runs always fit
        return _scatter_runs(accum, runs, n_runs, table_rows)
    direct = (n_runs > max_runs, idx.to(torch.int32).contiguous(),
              vals.to(torch.float32).contiguous())
    profiling.count("rle.direct", direct[0])
    return _scatter_runs(accum, runs, n_runs, table_rows, alt=direct)
