"""Sum-scatters of rows into a fresh table: K1 (f32) and K1p (bf16).

K1, `scatter_add`: `zeros[T, W] f32 .index_add(idx, src)`. Replaces
dregnerf_tpu/ops/pallas_scatter.py::bucketed_scatter_add, the
table-gradient backward of every packed-grid encoder level under
grad_accum "f32", "sorted" and "pallas", and the scatter of the run sums
of a run-length-compressed level with an f32 accumulator. The kernel is
csrc/scatter_add.cu: one thread per (row, 4 floats), f32 atomics into the
table, no sort.

K1p, `scatter_add_bf16`: `zeros[T, W] bf16`, then `out[idx[i]] +=
bf16(src[i])` with a bf16 add, in the table's own type. Replaces
scripts/perf/probe_pallas_scatter.py::pallas_scatter_add, whose meaning
is JAX's `zeros(bf16).at[idx].add(src.astype(bf16))`: the backward of
grad_accum "bf16" and "sorted_bf16", and the scatter of the run sums of a
run-length-compressed level under "bf16". The kernel is
csrc/scatter_add_bf16.cu: one thread per (row, 8 features), one 16-byte
vector reduction of four bf16 pairs, a grid sized by the card, and an
optional row count read on the device (`count`).

Both are bounded by memory traffic: N * (4 + 4W) bytes of idx and src
read, the table written (4W or 2W bytes a row); the 2^19-row tables of
levels 1-3 do not fit in the H100's 50 MB L2. Rows whose index lies
outside [0, table_rows) are skipped by the kernels and the plain versions
alike (the run-length backward pads its unused runs with such an index).

Each wrapper launches its kernel for CUDA tensors (or raises) and takes
its plain version only for CPU tensors; `<wrapper>.launches` counts
kernel launches. Both take an optional second row set and a device flag
that picks it, decided inside the kernel: the run-length backward's
choice between its run sums and the direct scatter (`ops/rle.py`).
"""
from __future__ import annotations

import torch

from dregnerf_tpu_torch.ops.native import launch


def _in_range_or_dump(idx: torch.Tensor, table_rows: int) -> torch.Tensor:
    """idx as int64, with out-of-range indices sent to the extra row
    `table_rows` that scatter_add_plain allocates and drops."""
    slot = idx.long()
    return torch.where((slot >= 0) & (slot < table_rows), slot, table_rows)


def scatter_add_plain(idx: torch.Tensor, src: torch.Tensor,
                      table_rows: int) -> torch.Tensor:
    """Plain PyTorch version of K1: zeros([table_rows, W]).index_add_(0,
    idx, src), skipping rows whose index is out of range."""
    out = torch.zeros(table_rows + 1, src.shape[1], dtype=torch.float32,
                      device=src.device)
    out.index_add_(0, _in_range_or_dump(idx, table_rows), src.to(torch.float32))
    return out[:table_rows]


def scatter_add_bf16_plain(idx: torch.Tensor, src: torch.Tensor,
                           table_rows: int) -> torch.Tensor:
    """Plain PyTorch version of K1p, bit for bit JAX's serial bf16 scatter:
    each addend rounded to bf16, each add rounded to bf16, the adds of one
    slot in index order. (`index_add_` on a bf16 tensor sums in f32 and
    rounds once, which is another function.)

    Rows are stable-sorted by slot; the r-th row of every slot is added in
    round r, and the slots of one round are distinct."""
    w = src.shape[1]
    dev = src.device
    keep = (idx >= 0) & (idx < table_rows)  # skipped rows take no round
    slot = idx[keep].long()
    addend = src[keep].to(torch.bfloat16).to(torch.float32)  # bf16 values, exact in f32
    acc = torch.zeros(table_rows, w, dtype=torch.bfloat16, device=dev)
    n = slot.shape[0]
    if n == 0:
        return acc
    order = torch.argsort(slot, stable=True)
    sorted_slot = slot[order]
    pos = torch.arange(n, device=dev)
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = sorted_slot[1:] != sorted_slot[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values  # within its slot
    by_round = order[torch.argsort(rank, stable=True)]
    start = 0
    for count in torch.bincount(rank).tolist():
        rows = by_round[start:start + count]
        start += count
        s = slot[rows]
        acc[s] = (acc[s].to(torch.float32) + addend[rows]).to(torch.bfloat16)
    return acc


def _check_rows(idx: torch.Tensor, src: torch.Tensor, multiple: int) -> None:
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise TypeError(f"idx must be 1-D int32, got {idx.dtype} {tuple(idx.shape)}")
    if src.dtype != torch.float32 or src.dim() != 2:
        raise TypeError(f"src must be 2-D float32, got {src.dtype} {tuple(src.shape)}")
    if src.shape[0] != idx.shape[0]:
        raise ValueError(f"{idx.shape[0]} indices for {src.shape[0]} rows")
    if src.shape[1] % multiple:
        raise ValueError(f"row width must be a multiple of {multiple}, got {src.shape[1]}")
    if not (idx.is_contiguous() and src.is_contiguous()):
        raise ValueError("idx and src must be contiguous")


def _check(idx, src, table_rows: int, multiple: int, alt, count) -> None:
    """Every input of a wrapper, each checked once."""
    _check_rows(idx, src, multiple)
    if table_rows <= 0:
        raise ValueError(f"table_rows must be positive, got {table_rows}")
    dev = src.device
    if idx.device != dev:
        raise ValueError(f"idx on {idx.device}, src on {dev}")
    if alt is not None:
        take_alt, alt_idx, alt_src = alt
        _check_rows(alt_idx, alt_src, multiple)
        if take_alt.dtype != torch.bool or take_alt.numel() != 1:
            raise TypeError(f"the flag must be one bool, got {take_alt.dtype} "
                            f"{tuple(take_alt.shape)}")
        if not take_alt.device == alt_idx.device == alt_src.device == dev:
            raise ValueError("the alternative rows and their flag must lie on src's device")
        if alt_src.shape[1] != src.shape[1]:
            raise ValueError(f"alternative rows of width {alt_src.shape[1]}, not {src.shape[1]}")
    if count is not None:
        if count.dtype != torch.int64 or count.numel() != 1:
            raise TypeError(f"the row count must be one int64, got {count.dtype} "
                            f"{tuple(count.shape)}")
        if count.device != dev:
            raise ValueError(f"the row count on {count.device}, src on {dev}")


def _chosen(idx, src, alt, count):
    """The rows a wrapper scatters: alt's rows when its flag is set, else
    the first `count` rows of (idx, src) (all without a count). On the CPU
    the flag and the count are read on the host."""
    if alt is not None and bool(alt[0]):
        return alt[1], alt[2]
    if count is not None:
        n = min(max(int(count), 0), idx.shape[0])
        return idx[:n], src[:n]
    return idx, src


def _scatter(name: str, entry: str, multiple: int, dtype: torch.dtype, idx, src,
             table_rows: int, alt, count) -> torch.Tensor | None:
    """Check the inputs; on the CPU return None (the caller takes its plain
    version); on the card launch the kernel, which zeroes a fresh table and
    scatters into it."""
    _check(idx, src, table_rows, multiple, alt, count)
    if src.device.type == "cpu":
        return None
    if src.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {src.device}")
    take_alt, alt_idx, alt_src = alt if alt is not None else (None, None, None)
    if idx.shape[0] == 0 and (alt is None or alt_idx.shape[0] == 0):
        return torch.zeros(table_rows, src.shape[1], dtype=dtype, device=src.device)
    out = torch.empty(table_rows, src.shape[1], dtype=dtype, device=src.device)
    # the kernels read src and add into the table in 16-byte vectors
    aligned = [(src, 16), (out, 16)] + ([(alt_src, 16)] if alt is not None else [])
    launch(name, entry, src.device, idx, src, idx.shape[0], count, alt_idx, alt_src,
           0 if alt is None else alt_idx.shape[0], take_alt, out, src.shape[1], table_rows,
           aligned=aligned)
    return out


def scatter_add(idx: torch.Tensor, src: torch.Tensor, table_rows: int,
                alt=None) -> torch.Tensor:
    """K1: sum `src` rows [N, W] f32 (W % 4 == 0) into a new
    [table_rows, W] f32 table at rows `idx` [N] int32.

    `alt`, (take_alt [] or [1] bool, alt_idx [M] int32, alt_src [M, W] f32)
    on src's device: scatter those rows instead when take_alt is true, a
    choice the kernel makes on the device (no host read)."""
    out = _scatter("scatter_add", "scatter_add_f32", 4, torch.float32, idx, src, table_rows,
                   alt, None)
    if out is None:
        return scatter_add_plain(*_chosen(idx, src, alt, None), table_rows)
    scatter_add.launches += 1
    return out


def scatter_add_bf16(idx: torch.Tensor, src: torch.Tensor, table_rows: int,
                     alt=None, count: torch.Tensor | None = None) -> torch.Tensor:
    """K1p: add `src` rows [N, W] f32 (W % 8 == 0), each rounded to bf16,
    into a new [table_rows, W] bf16 table at rows `idx` [N] int32, with
    bf16 adds; `alt` as in `scatter_add`. `count`, one int64 on src's
    device: scatter only the first `count` rows (clamped to [0, N]), a
    bound the kernel reads on the device; it applies to (idx, src), not to
    alt's rows. Returns the bf16 table; callers cast it (the kernel adds a
    slot's rows in a varying order, so on the card the result agrees with
    the serial order within the rounding of each add)."""
    out = _scatter("scatter_add_bf16", "scatter_add_bf16", 8, torch.bfloat16, idx, src,
                   table_rows, alt, count)
    if out is None:
        return scatter_add_bf16_plain(*_chosen(idx, src, alt, count), table_rows)
    scatter_add_bf16.launches += 1
    return out


scatter_add.launches = 0
scatter_add_bf16.launches = 0
