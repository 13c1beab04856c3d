"""Packed-row multiresolution grid encoding (port of dregnerf_tpu/ops/packed_grid.py).

Every level is a (possibly modulo-wrapped) dense vertex grid with linear
slot index slot = (x*res^2 + y*res + z) mod T_l. The 8 corners of a cell
sit at 8 static slot offsets o_c, so a packed table P[t] = concat_o
V[(t+o) mod T] (8 rolls of the vertex table V) gives every corner of a
point in ONE [8*F] row per level; trilinear weights then blend them.

Two encoders compute this. `vertex_encode(V, x, config)` is the one the
model calls: on the card it is kernel K2 (csrc/packed_grid.cu), which reads
the 8 corner rows of V in place, so no packed table exists there; its
backward forms each level's corner-row gradients w_c * dL/denc ([N, 8F],
as the packed rows' gradient), sums them into a packed-row gradient G_l
with the level's accumulator below, and unpacks G_l into dV (the transpose
of pack_table's placement). On the CPU each of its three launches has a
plain PyTorch version. `packed_encode(pack_table(V), x, config)` is the
JAX package's own form, kept as the CPU inference path (`ngp.prepare_params`
packs a CPU table once) and as the reference the tests hold K2 to: its row
gather is kernel K2p (`ops/gather_rows.py`).

The table-gradient accumulator follows `PackedGridConfig.grad_accum`, as in
the JAX package, in both encoders (`level_backward`):
  * "f32", "sorted", "pallas": an exact f32 sum-scatter, kernel K1
    (`ops/scatter_add.py`); the three differ only in summation order;
  * "bf16", "sorted_bf16": a bf16-accumulating scatter, kernel K1p (the
    stable sort of "sorted_bf16" keeps each slot's order, so the JAX
    results of the two are equal);
  * a level whose expected run of equal slots (`rle_expected_run`) is at
    least RLE_MIN_RUN, when `rle_step_u > 0`: the run-length backward of
    `ops/rle.py`, accumulating in bf16 only under grad_accum "bf16" and in
    f32 for every other value, "sorted_bf16" included (JAX's own rule).

`vertex_encode.launches`, `.rows_launches` and `.unpack_launches` count
K2's three launches. While a profiler records (runtime/profiling.py), the
counters are `packed.encode_calls` (every call of either encoder),
`packed.kernel_calls` (K2's forward launches) and `packed.rows` (the
points handed to them).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from dregnerf_tpu_torch.device import resolve_device
from dregnerf_tpu_torch.ops.gather_rows import gather_rows
from dregnerf_tpu_torch.ops.native import launch
from dregnerf_tpu_torch.ops.rle import rle_scatter_add_safe
from dregnerf_tpu_torch.ops.scatter_add import scatter_add, scatter_add_bf16
from dregnerf_tpu_torch.runtime import profiling

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


def corner_offsets(config: PackedGridConfig) -> np.ndarray:
    """o_c mod T_l [L, 8] int64: where corner c of a cell lies from its slot."""
    res = config.level_resolutions()[:, None]
    o = _CORNERS[:, 0] * res * res + _CORNERS[:, 1] * res + _CORNERS[:, 2]
    return o % config.level_table_sizes()[:, None]


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
    sizes, offsets, o = config.level_table_sizes(), config.level_offsets(), corner_offsets(config)
    packed_levels = []
    for l in range(config.n_levels):
        v = table[int(offsets[l]):int(offsets[l]) + int(sizes[l])]
        packed_levels.append(torch.cat([torch.roll(v, -int(o[l, c]), 0) for c in range(8)], dim=1))
    return tuple(packed_levels)


_LEVEL_CONSTANTS: dict = {}


def _level_constants(config: PackedGridConfig, device: torch.device) -> tuple:
    """The encoder's per-level constants on `device`, made once a
    (configuration, device): level scales [L] f32; the largest cell
    res - 2, res^2 and res [L] int64; the corner offsets [8, 3] bool. (A
    copy from the host on every call would wait for the device, and a
    CUDA graph's capture cannot make one.)"""
    key = (config, device)
    consts = _LEVEL_CONSTANTS.get(key)
    if consts is None:
        res = config.level_resolutions()
        consts = _LEVEL_CONSTANTS[key] = (
            torch.as_tensor(config.level_scales(), device=device),
            torch.as_tensor((res - 2).astype(np.int64), device=device),
            torch.as_tensor(res * res, device=device), torch.as_tensor(res, device=device),
            torch.as_tensor(_CORNERS, device=device).bool())
    return consts


def _slots_and_weights(x: torch.Tensor, config: PackedGridConfig) -> tuple:
    """Points x [N, 3] f32 -> (slot [N, L] int64, trilinear weights
    [N, L, 8] f32): the cell of each point at each level and its corners'
    weights, products over the axes x first."""
    scales, max_cell, A, B, corners = _level_constants(config, x.device)
    pos = x.clamp(0.0, 1.0)[:, None, :] * scales[None, :, None] + 0.5  # [N, L, 3]
    pos_floor = torch.floor(pos)
    frac = pos - pos_floor

    # int32 cast, then clip to the valid cell range [0, res-2], as in JAX.
    # The slot arithmetic runs in int64: on wrapped levels
    # (lin mod 2^32) & (2^k - 1) == lin & (2^k - 1), and dense levels have
    # lin < res^3 <= 2^k, which the mask leaves as it is, so it equals the
    # reference's uint32 result.
    cell = torch.minimum(pos_floor.to(torch.int32).clamp(min=0).long(),
                         max_cell[None, :, None])
    lin = cell[..., 0] * A[None, :] + cell[..., 1] * B[None, :] + cell[..., 2]
    slot = lin & ((1 << config.log2_table_size) - 1)

    f = frac[:, :, None, :]
    w = torch.where(corners[None, None], f, 1.0 - f)  # [N, L, 8, 3]
    return slot, w[..., 0] * w[..., 1] * w[..., 2]


def packed_encode(packed: tuple, x: torch.Tensor,
                  config: PackedGridConfig) -> torch.Tensor:
    """Encode positions x [..., 3] in [0, 1]^3 (clipped) with the packed
    per-level tables; returns [..., n_levels * F] f32."""
    batch_shape = x.shape[:-1]
    x = x.reshape(-1, 3).to(torch.float32)
    n = x.shape[0]
    L, F = config.n_levels, config.n_features
    profiling.count("packed.encode_calls", 1)
    slot, w = _slots_and_weights(x, config)
    outs = []
    for l in range(L):
        rows = _GatherRows.apply(packed[l], slot[:, l].to(torch.int32).contiguous(),
                                 level_backward(config, l, n)).reshape(n, 8, F)
        outs.append(torch.einsum("nc,ncf->nf", w[:, l], rows))
    out = torch.stack(outs, dim=1)  # [N, L, F]
    return out.reshape(*batch_shape, L * F)


# --------------------------------------------------------------------- K2

_K2_ARGS: dict = {}


def _k2_args(config: PackedGridConfig) -> tuple:
    """K2's per-level host arrays: scales (f32), resolutions (int32), table
    rows T_l (int64)."""
    args = _K2_ARGS.get(config)
    if args is None:
        args = _K2_ARGS[config] = (
            torch.as_tensor(config.level_scales(), dtype=torch.float32),
            torch.as_tensor(config.level_resolutions(), dtype=torch.int32),
            torch.as_tensor(config.level_table_sizes(), dtype=torch.int64))
    return args


def _launch(entry: str, config: PackedGridConfig, device, *args, aligned=()) -> None:
    launch("packed_grid", entry, device, *args, config.n_levels, config.n_features,
           config.log2_table_size, *_k2_args(config), aligned=aligned)


def vertex_rows(slot: torch.Tensor, config: PackedGridConfig) -> torch.Tensor:
    """Slots [N, L] -> the rows of V [N, L, 8] (int64) of each point's 8
    corners at each level: the rows pack_table places in its packed row."""
    o = torch.as_tensor(corner_offsets(config), device=slot.device)
    sizes = torch.as_tensor(config.level_table_sizes(), device=slot.device)
    first = torch.as_tensor(config.level_offsets()[:-1], device=slot.device)
    return (slot[..., None] + o) % sizes[:, None] + first[:, None]


def k2_forward_plain(table: torch.Tensor, x: torch.Tensor,
                     config: PackedGridConfig) -> torch.Tensor:
    """Plain version of K2's forward: [N, 3] f32 -> [N, L*F] f32, the 8
    corners blended in order."""
    slot, w = _slots_and_weights(x, config)
    v = table[vertex_rows(slot, config)]  # [N, L, 8, F]
    out = w[..., 0, None] * v[..., 0, :]
    for c in range(1, 8):
        out = out + w[..., c, None] * v[..., c, :]
    return out.reshape(x.shape[0], config.out_dim)


def k2_rows_plain(x: torch.Tensor, dout: torch.Tensor, config: PackedGridConfig) -> tuple:
    """Plain version of K2's rows launch: (slots [L, N] int32, corner-row
    gradients [L, N, 8F] f32, w_c * dout of each level)."""
    n, L, F = x.shape[0], config.n_levels, config.n_features
    slot, w = _slots_and_weights(x, config)
    rows = w.transpose(0, 1)[..., None] * dout.reshape(n, L, F).transpose(0, 1)[:, :, None, :]
    return (slot.t().to(torch.int32).contiguous(),
            rows.reshape(L, n, 8 * F).contiguous())


def k2_unpack_plain(grads: list, config: PackedGridConfig) -> torch.Tensor:
    """Plain version of K2's unpack: the packed-row gradients G_l [T_l, 8F]
    of each level -> dV [total_rows, F], dV_l[s] = sum_c G_l[(s - o_c) mod
    T_l, c] in corner order (the transpose of pack_table)."""
    F, o = config.n_features, corner_offsets(config)
    parts = []
    for l, g in enumerate(grads):
        g = g.reshape(g.shape[0], 8, F)
        acc = torch.roll(g[:, 0], int(o[l, 0]), 0)
        for c in range(1, 8):
            acc = acc + torch.roll(g[:, c], int(o[l, c]), 0)
        parts.append(acc)
    return torch.cat(parts)


def _k2_forward(table, x, config):
    if x.device.type == "cpu":
        return k2_forward_plain(table, x, config)
    out = torch.empty(x.shape[0], config.out_dim, dtype=torch.float32, device=x.device)
    _launch("packed_grid_fwd_f32", config, x.device, x, table, out, x.shape[0],
            aligned=((table, 16), (out, 16)))
    vertex_encode.launches += 1
    profiling.count("packed.kernel_calls", 1)
    profiling.count("packed.rows", x.shape[0])
    return out


def _k2_rows(x, dout, config):
    if x.device.type == "cpu":
        return k2_rows_plain(x, dout, config)
    n, L, F = x.shape[0], config.n_levels, config.n_features
    slots = torch.empty(L, n, dtype=torch.int32, device=x.device)
    rows = torch.empty(L, n, 8 * F, dtype=torch.float32, device=x.device)
    _launch("packed_grid_rows_f32", config, x.device, x, dout, slots, rows, n,
            aligned=((dout, 16), (rows, 16)))
    vertex_encode.rows_launches += 1
    return slots, rows


def _k2_unpack(grads, config, device):
    if device.type == "cpu":
        return k2_unpack_plain(grads, config)
    ptrs = torch.tensor([g.data_ptr() for g in grads], dtype=torch.int64)
    out = torch.empty(config.total_rows, config.n_features, dtype=torch.float32,
                      device=device)
    _launch("packed_grid_unpack_f32", config, device, ptrs, out,
            aligned=((out, 16), *((g, 16) for g in grads)))
    vertex_encode.unpack_launches += 1
    return out


class _VertexEncode(torch.autograd.Function):
    """K2 forward; its backward is K2's rows, each level's accumulator
    (`level_backward`), then K2's unpack."""

    @staticmethod
    def forward(ctx, table, x, config):
        ctx.save_for_backward(x)
        ctx.config = config
        return _k2_forward(table, x, config)

    @staticmethod
    def backward(ctx, dout):
        (x,) = ctx.saved_tensors
        config, n = ctx.config, x.shape[0]
        slots, rows = _k2_rows(x, dout.to(torch.float32).contiguous(), config)
        sizes = config.level_table_sizes()
        grads = [level_backward(config, l, n)(slots[l], rows[l], int(sizes[l]))
                 for l in range(config.n_levels)]
        return _k2_unpack(grads, config, x.device), None, None


def _check(table: torch.Tensor, x: torch.Tensor, config: PackedGridConfig) -> None:
    if config.n_features not in (1, 2, 4, 8, 16) or not 1 <= config.n_levels <= 32 \
            or config.log2_table_size > 31:
        raise ValueError(f"K2 takes 1, 2, 4, 8 or 16 features, 1-32 levels and at most "
                         f"2^31 rows a level, not {config}")
    if table.dtype != torch.float32 or tuple(table.shape) != (config.total_rows,
                                                              config.n_features):
        raise TypeError(f"table must be [total_rows, F] float32 for {config}, got "
                        f"{table.dtype} {tuple(table.shape)}")
    if not table.is_contiguous() or table.device != x.device:
        raise ValueError(f"table must be contiguous and on {x.device}")
    if x.requires_grad and torch.is_grad_enabled():
        raise ValueError("K2 gives no gradient to the positions")


def vertex_encode(table: torch.Tensor, x: torch.Tensor,
                  config: PackedGridConfig) -> torch.Tensor:
    """Encode positions x [..., 3] in [0, 1]^3 (clipped) with the vertex
    table V [total_rows, F] read in place: [..., n_levels * F] f32. K2 on
    CUDA, its plain versions on the CPU."""
    batch_shape = x.shape[:-1]
    pts = x.reshape(-1, 3).to(torch.float32)
    profiling.count("packed.encode_calls", 1)
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"vertex_encode runs on cuda or cpu, not {table.device}")
    _check(table, pts, config)
    out = _VertexEncode.apply(table, pts.contiguous(), config)
    return out.reshape(*batch_shape, config.out_dim)


vertex_encode.launches = 0
vertex_encode.rows_launches = 0
vertex_encode.unpack_launches = 0
