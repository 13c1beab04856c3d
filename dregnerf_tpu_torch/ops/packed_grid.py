"""Packed-row multiresolution grid encoding (port of dregnerf_tpu/ops/packed_grid.py).

Every level is a (possibly modulo-wrapped) dense vertex grid with linear
slot index slot = (x*res^2 + y*res + z) mod T_l. The 8 corners of a cell
sit at 8 static slot offsets, so a packed table P[t] = concat_o V[(t+o) mod T]
(8 rolls of the vertex table V) gives every corner of a point in ONE
[8*F] row per level; trilinear weights then blend them.

The table-gradient backward is selected by `PackedGridConfig.grad_accum`:
"f32" keeps autograd's own gather backward; "pallas" sends each level's
gradient through kernel K1 (`ops/scatter_add.py`, the port of the Pallas
`bucketed_scatter_add`). The other accumulators of the JAX package
("bf16", "sorted", "sorted_bf16", and the RLE backward `rle_step_u > 0`)
are still to be ported (ROADMAP.md, queue 1); their forward is the same
gather, so inference works for every value and only a backward raises.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dregnerf_tpu_torch.ops.scatter_add import scatter_add

SUPPORTED_GRAD_ACCUM = ("f32", "pallas")


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


def check_backward_supported(config: PackedGridConfig) -> None:
    """Raise for a table-gradient backward the port does not have yet."""
    if config.rle_step_u > 0.0:
        raise NotImplementedError(
            "the RLE table-gradient backward (rle_step_u > 0) is not ported "
            "yet; see ROADMAP.md queue 1 (use --no-rle_backward)")
    if config.grad_accum not in SUPPORTED_GRAD_ACCUM:
        raise NotImplementedError(
            f"grad_accum={config.grad_accum!r} is not ported yet; see "
            f"ROADMAP.md queue 1 (supported: {SUPPORTED_GRAD_ACCUM})")


def init_packed_grid(config: PackedGridConfig, generator: torch.Generator | None = None,
                     device: torch.device | str = "cpu") -> torch.Tensor:
    """Vertex table V: [total_rows, F], uniform(-1e-4, 1e-4)."""
    u = torch.rand(config.total_rows, config.n_features, generator=generator,
                   device=device, dtype=torch.float32)
    return u * 2e-4 - 1e-4


# corner order (dx, dy, dz) with dz fastest: offsets 0,1,B,B+1,A,A+1,A+B,A+B+1
_CORNERS = np.stack(
    np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"), axis=-1
).reshape(8, 3).astype(np.int64)


class _GatherScatterK1(torch.autograd.Function):
    """packed[slot]; the backward sums the row gradients into a fresh
    [table_rows, 8F] f32 table with kernel K1 (the JAX `_gather_rows_pallas`)."""

    @staticmethod
    def forward(ctx, packed, slot):
        ctx.save_for_backward(slot)
        ctx.table_rows = packed.shape[0]
        return packed.index_select(0, slot)

    @staticmethod
    def backward(ctx, g):
        (slot,) = ctx.saved_tensors
        grad = scatter_add(slot, g.to(torch.float32).contiguous(), ctx.table_rows)
        return grad, None


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
    needs_grad = torch.is_grad_enabled() and any(p.requires_grad for p in packed)
    if needs_grad:
        check_backward_supported(config)
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
        slot = (lin[:, l] & mask) if wrapped[l] else lin[:, l]
        if config.grad_accum == "pallas" and needs_grad:
            rows = _GatherScatterK1.apply(packed[l], slot.to(torch.int32))
        else:
            rows = packed[l][slot]
        rows = rows.reshape(n, 8, F)
        outs.append(torch.einsum("nc,ncf->nf", w[:, l], rows))
    out = torch.stack(outs, dim=1)  # [N, L, F]
    return out.reshape(*batch_shape, L * F)
