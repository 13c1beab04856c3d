"""K1: f32 sum-scatter of rows into a fresh table, `zeros.index_add(idx, src)`.

Replaces dregnerf_tpu/ops/pallas_scatter.py::bucketed_scatter_add, the
table-gradient backward of every packed-grid encoder level under
grad_accum="pallas". The kernel is csrc/scatter_add.cu: one thread per
(row, 4 floats), f32 atomics into the table, no sort. It is bounded by
memory traffic, roughly N * (4 + 4W) bytes read plus the atomic
read-modify-writes and the table_rows * 4W bytes zeroed; the 128 MB
tables of levels 1-3 do not fit in the H100's 50 MB L2.

`scatter_add` launches the kernel for CUDA tensors (or raises) and takes
the plain version only for CPU tensors. `scatter_add.launches` counts
kernel launches.
"""
from __future__ import annotations

import torch


def scatter_add_plain(idx: torch.Tensor, src: torch.Tensor,
                      table_rows: int) -> torch.Tensor:
    """Plain PyTorch version: zeros([table_rows, W]).index_add_(0, idx, src).
    idx must lie in [0, table_rows)."""
    out = torch.zeros(table_rows, src.shape[1], dtype=torch.float32,
                      device=src.device)
    return out.index_add_(0, idx.long(), src.to(torch.float32))


def _check(idx: torch.Tensor, src: torch.Tensor, table_rows: int) -> None:
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise TypeError(f"idx must be 1-D int32, got {idx.dtype} {tuple(idx.shape)}")
    if src.dtype != torch.float32 or src.dim() != 2:
        raise TypeError(f"src must be 2-D float32, got {src.dtype} {tuple(src.shape)}")
    if src.shape[0] != idx.shape[0]:
        raise ValueError(f"{idx.shape[0]} indices for {src.shape[0]} rows")
    if src.shape[1] % 4:
        raise ValueError(f"row width must be a multiple of 4, got {src.shape[1]}")
    if not (idx.is_contiguous() and src.is_contiguous()):
        raise ValueError("idx and src must be contiguous")
    if idx.device != src.device:
        raise ValueError(f"idx on {idx.device}, src on {src.device}")
    if table_rows <= 0:
        raise ValueError(f"table_rows must be positive, got {table_rows}")


def scatter_add(idx: torch.Tensor, src: torch.Tensor,
                table_rows: int) -> torch.Tensor:
    """Sum `src` rows [N, W] f32 into a new [table_rows, W] f32 table at
    rows `idx` [N] int32 (in [0, table_rows); the kernel skips others)."""
    _check(idx, src, table_rows)
    if src.device.type == "cpu":
        return scatter_add_plain(idx, src, table_rows)
    if src.device.type != "cuda":
        raise ValueError(f"scatter_add runs on cuda or cpu, not {src.device}")
    from dregnerf_tpu_torch.ops.native import load_library

    lib = load_library("scatter_add")
    out = torch.zeros(table_rows, src.shape[1], dtype=torch.float32,
                      device=src.device)
    if idx.shape[0] == 0:
        return out
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.scatter_add_f32(idx.data_ptr(), src.data_ptr(),
                                  out.data_ptr(), idx.shape[0], src.shape[1],
                                  table_rows, stream)
    if err != 0:
        raise RuntimeError(f"scatter_add kernel launch failed: CUDA error {err}")
    scatter_add.launches += 1
    return out


scatter_add.launches = 0
