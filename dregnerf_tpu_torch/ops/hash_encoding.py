"""Multiresolution xor-hash grid encoding, Instant-NGP's (port of
dregnerf_tpu/ops/hash_encoding.py).

All L levels in one pass: positions are scaled per level, the 8 corner
rows of every (point, level) pair form one [N, L, 8] index tensor, and one
gather pulls [N, L, 8, F] features from the [L*T, F] table. A level whose
dense vertex grid fits in T rows indexes it densely (x + y*res + z*res^2);
a larger one takes the spatial hash x*1 xor y*2654435761 xor z*805459861
(uint32 products) mod T. The choice is static per level. The table is f32
and so is the interpolation.

`hash_encode` launches kernel K6 (csrc/hash_grid.cu) for CUDA tensors, as
an autograd.Function: one launch computes every corner's row and weight in
registers and writes the blended encoding in f32 (the MLP rounds it to its
own operand type, which `--no_bf16` keeps f32), and its backward recomputes
them and adds w * dL/denc into a zeroed f32 table gradient with float2
atomics (the positions get no gradient). It takes the plain version
(`hash_encode_plain`, whose backward is autograd's scatter-add into the
table) only for CPU tensors. The JAX package computes this encoder in XLA,
outside any Pallas kernel, so K6 replaces no TPU kernel.

`hash_encode.launches` and `.grad_launches` count K6's forward and
backward launches. While a profiler records (runtime/profiling.py), the
span `hash.encode` wraps each forward launch and `hash.encode_grad` each
backward launch (on autograd's device thread), and the counters are
`hash.encode_calls` (every call), `hash.kernel_calls` (the forward
launches) and `hash.rows` (the points handed to them).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dregnerf_tpu_torch.device import resolve_device
from dregnerf_tpu_torch.ops.native import launch
from dregnerf_tpu_torch.runtime import profiling

_PRIMES = (1, 2654435761, 805459861)
_MASK32 = (1 << 32) - 1

# The 8 corners of a unit cube, [8, 3].
_CORNERS = np.stack(
    np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"), axis=-1
).reshape(8, 3).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class HashGridConfig:
    """tiny-cuda-nn's HashGrid defaults: 16 levels x 2 features, 2^19 rows a level."""

    n_levels: int = 16
    n_features: int = 2
    log2_table_size: int = 19
    base_resolution: int = 16
    per_level_scale: float = 1.4472692012786865

    @property
    def table_size(self) -> int:
        return 1 << self.log2_table_size

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features

    def level_scales(self) -> np.ndarray:
        """Per-level grid scale (number of cells along an axis)."""
        return np.array(
            [
                self.base_resolution * self.per_level_scale**lvl - 1.0
                for lvl in range(self.n_levels)
            ],
            dtype=np.float32,
        )

    def level_resolutions(self) -> np.ndarray:
        """Per-level vertex count along an axis."""
        return (np.ceil(self.level_scales()) + 1.0).astype(np.int64)

    def level_is_dense(self) -> np.ndarray:
        """True for levels where the dense grid fits in the hash table."""
        res = self.level_resolutions()
        return (res**3) <= self.table_size


def init_hash_table(config: HashGridConfig, generator: torch.Generator | None = None,
                    device: torch.device | str | None = None) -> torch.Tensor:
    """[L*T, F] f32 table, uniform in (-1e-4, 1e-4), on `device` (cuda
    unless given; raises without CUDA)."""
    device = resolve_device(device)
    u = torch.rand(config.n_levels * config.table_size, config.n_features,
                   generator=generator, device=device, dtype=torch.float32)
    return u * 2e-4 - 1e-4


def _corner_indices(config: HashGridConfig, pos_grid: torch.Tensor) -> torch.Tensor:
    """Integer corner coordinates [N, L, 8, 3] (int64, clamped to the
    level's vertices) -> table rows [N, L, 8] (int64, offset by level)."""
    dev = pos_grid.device
    T = config.table_size
    res = torch.as_tensor(config.level_resolutions(), device=dev)[None, :, None]
    dense = torch.as_tensor(config.level_is_dense(), device=dev)[None, :, None]
    x, y, z = pos_grid.unbind(-1)
    dense_idx = x + y * res + z * (res * res)
    hashed = (((x * _PRIMES[0]) & _MASK32) ^ ((y * _PRIMES[1]) & _MASK32)
              ^ ((z * _PRIMES[2]) & _MASK32)) & (T - 1)
    idx = torch.where(dense, dense_idx, hashed)
    return idx + torch.arange(config.n_levels, device=dev)[None, :, None] * T


def hash_corners(x: torch.Tensor, config: HashGridConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """[N, 3] positions -> (table rows [N, L, 8] int64, trilinear weights
    [N, L, 8] f32) of every point's 8 corners at every level; corners
    outside the grid are clamped to it."""
    dev = x.device
    scales = torch.as_tensor(config.level_scales(), device=dev)
    pos = x[:, None, :] * scales[None, :, None] + 0.5  # [N, L, 3]
    pos_floor = torch.floor(pos)
    frac = pos - pos_floor

    corners = torch.as_tensor(_CORNERS, device=dev)  # [8, 3]
    pos_grid = pos_floor[:, :, None, :].to(torch.int64) + corners  # [N, L, 8, 3]
    res = torch.as_tensor(config.level_resolutions(), device=dev)
    pos_grid = torch.minimum(pos_grid.clamp(min=0), (res - 1)[None, :, None, None])

    # the product over the axes of frac (corner coordinate 1) or 1 - frac
    w = torch.where(corners.bool(), frac[:, :, None, :], 1.0 - frac[:, :, None, :])
    return _corner_indices(config, pos_grid), w[..., 0] * w[..., 1] * w[..., 2]


def hash_encode_plain(table: torch.Tensor, x: torch.Tensor,
                      config: HashGridConfig) -> torch.Tensor:
    """Plain PyTorch version: [N, 3] f32 positions -> [N, L*F] f32."""
    rows, w = hash_corners(x, config)
    return (w[..., None] * table[rows]).sum(dim=2).reshape(x.shape[0], config.out_dim)


_LEVEL_ARGS: dict = {}


def _level_args(config: HashGridConfig) -> tuple[torch.Tensor, ...]:
    """K6's per-level host arrays: scales (f32), resolutions and dense
    flags (int32)."""
    args = _LEVEL_ARGS.get(config)
    if args is None:
        args = _LEVEL_ARGS[config] = (
            torch.as_tensor(config.level_scales(), dtype=torch.float32),
            torch.as_tensor(config.level_resolutions(), dtype=torch.int32),
            torch.as_tensor(config.level_is_dense(), dtype=torch.int32))
    return args


def _launch(entry: str, x, src, dst, config: HashGridConfig) -> None:
    launch("hash_grid", entry, x.device, x, src, dst, x.shape[0], config.n_levels,
           config.log2_table_size, *_level_args(config), aligned=((src, 8), (dst, 8)))


class _HashEncode(torch.autograd.Function):
    """K6 forward; its backward is K6's table gradient."""

    @staticmethod
    def forward(ctx, table, x, config):
        out = torch.empty(x.shape[0], config.out_dim, dtype=torch.float32, device=x.device)
        with profiling.annotate("hash.encode"):
            _launch("hash_grid_fwd_f32", x, table, out, config)
        hash_encode.launches += 1
        profiling.count("hash.kernel_calls", 1)
        profiling.count("hash.rows", x.shape[0])
        ctx.save_for_backward(x)
        ctx.config, ctx.table_shape = config, table.shape
        return out

    @staticmethod
    def backward(ctx, dout):
        (x,) = ctx.saved_tensors
        grad = torch.zeros(ctx.table_shape, dtype=torch.float32, device=x.device)
        with profiling.annotate("hash.encode_grad"):
            _launch("hash_grid_bwd_f32", x, dout.float().contiguous(), grad, ctx.config)
        hash_encode.grad_launches += 1
        return grad, None, None


def _check(table: torch.Tensor, x: torch.Tensor, config: HashGridConfig) -> None:
    if config.n_features != 2 or not 1 <= config.n_levels <= 32 or config.log2_table_size > 31:
        raise ValueError(f"K6 takes 2 features, 1-32 levels and at most 2^31 rows a level, "
                         f"not {config}")
    if table.dtype != torch.float32 or tuple(table.shape) != (
            config.n_levels * config.table_size, config.n_features):
        raise TypeError(f"table must be [L*T, F] float32 for {config}, got {table.dtype} "
                        f"{tuple(table.shape)}")
    if not table.is_contiguous() or table.device != x.device:
        raise ValueError(f"table must be contiguous and on {x.device}")
    if x.requires_grad and torch.is_grad_enabled():
        raise ValueError("K6 gives no gradient to the positions")


def hash_encode(table: torch.Tensor, x: torch.Tensor, config: HashGridConfig) -> torch.Tensor:
    """[..., 3] positions in [0, 1]^3 (corners outside are clamped to the
    grid) -> [..., L*F] f32 features: K6 on CUDA, the plain version on the
    CPU."""
    batch_shape = x.shape[:-1]
    pts = x.reshape(-1, 3).to(torch.float32)
    profiling.count("hash.encode_calls", 1)
    if table.device.type == "cpu":
        out = hash_encode_plain(table, pts, config)
    elif table.device.type == "cuda":
        _check(table, x, config)
        out = _HashEncode.apply(table, pts.contiguous(), config)
    else:
        raise ValueError(f"hash_encode runs on cuda or cpu, not {table.device}")
    return out.reshape(*batch_shape, config.out_dim)


hash_encode.launches = 0
hash_encode.grad_launches = 0
