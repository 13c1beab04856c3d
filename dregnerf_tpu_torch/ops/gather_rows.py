"""K2p: row gather `table[idx]` of f32 rows.

Replaces scripts/perf/probe_pallas_gather.py::make_gather.<gather>, the
Pallas kernel that copies one table row per DMA with 16 in flight. Its
function is the forward of every packed-grid encoder level (one [8F]-float
row per point and level), in training, occupancy updates, rendering and
voxel extraction (ops/packed_grid.py).

The kernel is csrc/gather_rows.cu: one thread per (row, 4 floats), a
16-byte load of the table row and a coalesced 16-byte store, `idx` through
the read-only cache. It is bounded by memory traffic: 4N bytes of idx,
4NW bytes of rows read and 4NW written.

`gather_rows` launches the kernel for CUDA tensors (or raises) and takes
the plain version (`index_select`) only for CPU tensors;
`gather_rows.launches` counts kernel launches.
"""
from __future__ import annotations

import torch

from dregnerf_tpu_torch.ops.native import launch


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: table.index_select(0, idx)."""
    return table.index_select(0, idx.long())


def _check(table: torch.Tensor, idx: torch.Tensor) -> None:
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise TypeError(f"idx must be 1-D int32, got {idx.dtype} {tuple(idx.shape)}")
    if table.dtype != torch.float32 or table.dim() != 2:
        raise TypeError(f"table must be 2-D float32, got {table.dtype} {tuple(table.shape)}")
    if table.shape[1] % 4:
        raise ValueError(f"row width must be a multiple of 4, got {table.shape[1]}")
    if not (idx.is_contiguous() and table.is_contiguous()):
        raise ValueError("idx and table must be contiguous")
    if idx.device != table.device:
        raise ValueError(f"idx on {idx.device}, table on {table.device}")


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows `idx` [N] int32 (in [0, T)) of `table` [T, W] f32 (W % 4 == 0):
    [N, W] f32."""
    _check(table, idx)
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"gather_rows runs on cuda or cpu, not {table.device}")
    out = torch.empty(idx.shape[0], table.shape[1], dtype=torch.float32,
                      device=table.device)
    if idx.shape[0] == 0:
        return out
    launch("gather_rows", "gather_rows_f32", table.device, table, idx, out, idx.shape[0],
           table.shape[1], table.shape[0], aligned=((table, 16), (out, 16)))
    gather_rows.launches += 1
    return out


gather_rows.launches = 0
