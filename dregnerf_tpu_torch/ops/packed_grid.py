"""Packed-row multiresolution grid encoding (port of dregnerf_tpu/ops/packed_grid.py).

Every level is a (possibly modulo-wrapped) dense vertex grid with linear
slot index slot = (x*res^2 + y*res + z) mod T_l. The 8 corners of a cell
sit at 8 static slot offsets, so a packed table P[t] = concat_o V[(t+o) mod T]
(8 rolls of the vertex table V) gives every corner of a point in ONE
[8*F] row per level; trilinear weights then blend them.

The row gather of every level is kernel K2p (`ops/gather_rows.py`). The
table-gradient backward follows `PackedGridConfig.grad_accum`, as in the
JAX package:
  * "f32", "sorted", "pallas": an exact f32 sum-scatter, kernel K1
    (`ops/scatter_add.py`); the three differ only in summation order;
  * "bf16", "sorted_bf16": a bf16-accumulating scatter, kernel K1p (the
    stable sort of "sorted_bf16" keeps each slot's order, so the JAX
    results of the two are equal);
  * a level whose expected run of equal slots (`rle_expected_run`) is at
    least RLE_MIN_RUN, when `rle_step_u > 0`: the run-length backward of
    `ops/rle.py`, accumulating in bf16 only under grad_accum "bf16" and in
    f32 for every other value, "sorted_bf16" included (JAX's own rule).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from dregnerf_tpu_torch.device import resolve_device
from dregnerf_tpu_torch.ops.gather_rows import gather_rows
from dregnerf_tpu_torch.ops.rle import rle_scatter_add_safe
from dregnerf_tpu_torch.ops.scatter_add import scatter_add, scatter_add_bf16

RLE_MIN_RUN = 4.0  # expected steps per cell below which RLE cannot win
_RLE_SAFETY = 2.0  # heuristic max_runs = safety * expected runs


@dataclasses.dataclass(frozen=True)
class PackedGridConfig:
    """Default layout L4F8: 4 levels x 8 features, 2^19-row tables."""

    n_levels: int = 4
    n_features: int = 8
    log2_table_size: int = 19
    base_resolution: int = 16
    per_level_scale: float = 5.66
    grad_accum: str = "f32"
    rle_step_u: float = 0.0

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features

    def level_scales(self) -> np.ndarray:
        return np.array(
            [self.base_resolution * self.per_level_scale**l - 1.0
             for l in range(self.n_levels)],
            np.float32,
        )

    def level_resolutions(self) -> np.ndarray:
        return (np.ceil(self.level_scales()) + 1.0).astype(np.int64)

    def level_table_sizes(self) -> np.ndarray:
        """T_l: full dense size when it fits, else 2^log2_table_size."""
        res = self.level_resolutions()
        t_max = 1 << self.log2_table_size
        return np.where(res**3 <= t_max, res**3, t_max).astype(np.int64)

    def level_wrapped(self) -> np.ndarray:
        res = self.level_resolutions()
        return (res**3) > (1 << self.log2_table_size)

    def level_offsets(self) -> np.ndarray:
        sizes = self.level_table_sizes()
        return np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)

    @property
    def total_rows(self) -> int:
        return int(self.level_table_sizes().sum())


def init_packed_grid(config: PackedGridConfig, generator: torch.Generator | None = None,
                     device: torch.device | str | None = None) -> torch.Tensor:
    """Vertex table V: [total_rows, F], uniform(-1e-4, 1e-4), on `device`
    (cuda unless given; raises without CUDA)."""
    u = torch.rand(config.total_rows, config.n_features, generator=generator,
                   device=resolve_device(device), dtype=torch.float32)
    return u * 2e-4 - 1e-4


# corner order (dx, dy, dz) with dz fastest: offsets 0,1,B,B+1,A,A+1,A+B,A+B+1
_CORNERS = np.stack(
    np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"), axis=-1
).reshape(8, 3).astype(np.int64)


def rle_expected_run(config: PackedGridConfig, level: int) -> float:
    """Expected consecutive samples per cell at `level` for a march with
    normalized step `config.rle_step_u` (diagonal worst case)."""
    if config.rle_step_u <= 0.0:
        return 0.0
    scale = float(config.level_scales()[level])
    return 1.0 / (config.rle_step_u * scale * 1.7320508)


def _scatter_bf16_as_f32(idx, g, table_rows):
    return scatter_add_bf16(idx, g, table_rows).to(torch.float32)


def _rle_backward(idx, g, table_rows, max_runs, accum):
    return rle_scatter_add_safe(idx, g, max_runs, table_rows, accum).to(torch.float32)


def level_backward(config: PackedGridConfig, level: int, n: int):
    """The table-gradient scatter of one level for n rows: a function
    (slot [n] int32, g [n, 8F] f32, table_rows) -> [table_rows, 8F] f32."""
    exp_run = rle_expected_run(config, level)
    if exp_run >= RLE_MIN_RUN:
        return functools.partial(
            _rle_backward, max_runs=min(n, int(_RLE_SAFETY * n / exp_run)),
            accum="bf16" if config.grad_accum == "bf16" else "f32")
    if config.grad_accum in ("f32", "sorted", "pallas"):
        return scatter_add
    if config.grad_accum in ("bf16", "sorted_bf16"):
        return _scatter_bf16_as_f32
    raise ValueError(f"unknown grad_accum {config.grad_accum!r}")


class _GatherRows(torch.autograd.Function):
    """packed[slot] through K2p; the backward scatters the row gradients
    into a fresh [table_rows, 8F] f32 table with `scatter`."""

    @staticmethod
    def forward(ctx, packed, slot, scatter):
        ctx.save_for_backward(slot)
        ctx.table_rows = packed.shape[0]
        ctx.scatter = scatter
        return gather_rows(packed, slot)

    @staticmethod
    def backward(ctx, g):
        (slot,) = ctx.saved_tensors
        grad = ctx.scatter(slot, g.to(torch.float32).contiguous(), ctx.table_rows)
        return grad, None, None


def pack_table(table: torch.Tensor, config: PackedGridConfig) -> tuple:
    """V [total_rows, F] -> tuple of per-level P_l [T_l, 8*F] via 8 rolls."""
    sizes = config.level_table_sizes()
    res = config.level_resolutions()
    offsets = config.level_offsets()
    packed_levels = []
    for l in range(config.n_levels):
        v = table[int(offsets[l]):int(offsets[l]) + int(sizes[l])]
        A, B = int(res[l]) * int(res[l]), int(res[l])
        rows = [torch.roll(v, -(int(dx * A + dy * B + dz) % int(sizes[l])), 0)
                for dx, dy, dz in _CORNERS]
        packed_levels.append(torch.cat(rows, dim=1))
    return tuple(packed_levels)


def packed_encode(packed: tuple, x: torch.Tensor,
                  config: PackedGridConfig) -> torch.Tensor:
    """Encode positions x [..., 3] in [0, 1]^3 (clipped) with the packed
    per-level tables; returns [..., n_levels * F] f32."""
    batch_shape = x.shape[:-1]
    x = x.reshape(-1, 3).to(torch.float32).clamp(0.0, 1.0)
    n = x.shape[0]
    L, F = config.n_levels, config.n_features
    dev = x.device

    scales = torch.as_tensor(config.level_scales(), device=dev)  # [L] f32
    res = config.level_resolutions()
    pos = x[:, None, :] * scales[None, :, None] + 0.5  # [N, L, 3]
    pos_floor = torch.floor(pos)
    frac = pos - pos_floor

    # int32 cast, then clip to the valid cell range [0, res-2], as in JAX.
    # The slot arithmetic runs in int64: on wrapped levels
    # (lin mod 2^32) & (2^k - 1) == lin & (2^k - 1), and dense levels have
    # lin < res^3 <= 2^k, so it equals the reference's uint32 result.
    max_cell = torch.as_tensor((res - 2).astype(np.int64), device=dev)
    cell = torch.minimum(pos_floor.to(torch.int32).clamp(min=0).long(),
                         max_cell[None, :, None])
    A = torch.as_tensor(res * res, device=dev)
    B = torch.as_tensor(res, device=dev)
    lin = cell[..., 0] * A[None, :] + cell[..., 1] * B[None, :] + cell[..., 2]

    corners = torch.as_tensor(_CORNERS, device=dev).bool()  # [8, 3]
    f = frac[:, :, None, :]
    w = torch.where(corners[None, None], f, 1.0 - f).prod(dim=-1)  # [N, L, 8]

    wrapped = config.level_wrapped()
    mask = (1 << config.log2_table_size) - 1
    outs = []
    for l in range(L):
        slot = ((lin[:, l] & mask) if wrapped[l] else lin[:, l]).to(torch.int32).contiguous()
        rows = _GatherRows.apply(packed[l], slot, level_backward(config, l, n)).reshape(n, 8, F)
        outs.append(torch.einsum("nc,ncf->nf", w[:, l], rows))
    out = torch.stack(outs, dim=1)  # [N, L, F]
    return out.reshape(*batch_shape, L * F)
