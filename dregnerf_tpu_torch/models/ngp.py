"""Instant-NGP radiance field (port of dregnerf_tpu/models/ngp.py).

A grid encoding, chosen by the type of `NGPConfig.grid` as in the JAX
package (the packed grid of ops/packed_grid.py, the default, or the
xor-hash grid of ops/hash_encoding.py), + a 1-hidden 64-wide density MLP
-> (log-density, 15-dim geo feature); SH degree-4 view encoding + a
2-hidden 64-wide color MLP with sigmoid output; density activation trunc_exp(x - 1); out-of-box
selector zeroing density.

Parameters are a plain dict of tensors in the JAX package's layout
(`{"table", "density_mlp": [w0, w1], "color_mlp": [w0, w1, w2]}`, weights
[in, out]), so checkpoints and weights cross between the two packages.

MLP numerics: the reference takes bf16 operands and accumulates in f32
(`jnp.dot(..., preferred_element_type=f32)`), returning f32. Here each
layer rounds its operands to `compute_dtype` and multiplies them as f32
with `torch.matmul` (PyTorch's default f32 matmul precision: TF32 off), so
the products of the bf16 values are exact, the sums are f32, and the last
layer's output is f32, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from dregnerf_tpu_torch.device import resolve_device
from dregnerf_tpu_torch.ops.activation import density_activation
from dregnerf_tpu_torch.ops.contraction import contract_aabb, contract_unisphere
from dregnerf_tpu_torch.ops.hash_encoding import HashGridConfig, hash_encode, init_hash_table
from dregnerf_tpu_torch.ops.packed_grid import (
    PackedGridConfig,
    init_packed_grid,
    pack_table,
    packed_encode,
    vertex_encode,
)
from dregnerf_tpu_torch.ops.sh import sh_encode

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class NGPConfig:
    grid: PackedGridConfig | HashGridConfig = PackedGridConfig()
    geo_feat_dim: int = 15
    hidden_dim: int = 64
    sh_degree: int = 4
    use_viewdirs: bool = True
    unbounded: bool = False
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def sh_dim(self) -> int:
        return self.sh_degree**2

    @property
    def color_in_dim(self) -> int:
        return (self.sh_dim if self.use_viewdirs else 0) + self.geo_feat_dim


def _packed(config: NGPConfig) -> bool:
    return isinstance(config.grid, PackedGridConfig)


def _dense_init(shape, generator, device) -> torch.Tensor:
    """He-uniform, matching tcnn's default layer init scale."""
    bound = (6.0 / shape[0]) ** 0.5
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return u * (2.0 * bound) - bound


def init_ngp(config: NGPConfig = NGPConfig(), generator: torch.Generator | None = None,
             device: torch.device | str | None = None) -> Params:
    """Random weights on `device` (cuda unless given; raises without CUDA)."""
    device = resolve_device(device)
    h = config.hidden_dim
    init_table = init_packed_grid if _packed(config) else init_hash_table
    return {
        "table": init_table(config.grid, generator, device),
        "density_mlp": [
            _dense_init((config.grid.out_dim, h), generator, device),
            _dense_init((h, 1 + config.geo_feat_dim), generator, device),
        ],
        "color_mlp": [
            _dense_init((config.color_in_dim, h), generator, device),
            _dense_init((h, h), generator, device),
            _dense_init((h, 3), generator, device),
        ],
    }


def parameters(params: Params) -> list[torch.Tensor]:
    """The trainable leaves, in a fixed order."""
    return [params["table"], *params["density_mlp"], *params["color_mlp"]]


def params_from_jax(params_np: Params, device: torch.device | str | None = None) -> Params:
    """JAX parameter pytree (numpy leaves) -> the port's parameter dict on
    `device` (cuda unless given; raises without CUDA)."""
    device = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.array(a, dtype=np.float32), device=device)

    return {
        "table": t(params_np["table"]),
        "density_mlp": [t(w) for w in params_np["density_mlp"]],
        "color_mlp": [t(w) for w in params_np["color_mlp"]],
    }


def params_to_numpy(params: Params) -> Params:
    """Inverse of `params_from_jax`."""
    def n(x):
        return x.detach().cpu().numpy()

    return {
        "table": n(params["table"]),
        "density_mlp": [n(w) for w in params["density_mlp"]],
        "color_mlp": [n(w) for w in params["color_mlp"]],
    }


def _encode(params: Params, u: torch.Tensor, config: NGPConfig) -> torch.Tensor:
    if not _packed(config):
        return hash_encode(params["table"], u, config.grid)
    packed = params.get("packed_table")
    if packed is not None:
        return packed_encode(packed, u, config.grid)
    return vertex_encode(params["table"], u, config.grid)


def prepare_params(params: Params, config: NGPConfig) -> Params:
    """Pack a CPU table once for an inference loop (the JAX package's form,
    the CPU's reference path). The card's encoder (K2) reads the vertex
    table in place, and a hash grid is not packed: nothing to prepare."""
    if (_packed(config) and "packed_table" not in params
            and params["table"].device.type == "cpu"):
        return dict(params, packed_table=pack_table(params["table"], config.grid))
    return params


def _mlp(layers, x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """Bias-free ReLU MLP: operands rounded to compute_dtype, f32 products
    and sums (see the module docstring); returns f32."""
    h = x
    for i, w in enumerate(layers):
        h = torch.matmul(h.to(compute_dtype).to(torch.float32),
                         w.to(compute_dtype).to(torch.float32))
        if i + 1 < len(layers):
            h = torch.relu(h)
    return h


def query_density(params: Params, x: torch.Tensor, aabb: torch.Tensor,
                  config: NGPConfig = NGPConfig(), return_feat: bool = False):
    """Density (post-activation) at world positions x [..., 3]."""
    u = contract_unisphere(x, aabb) if config.unbounded else contract_aabb(x, aabb)
    selector = ((u > 0.0) & (u < 1.0)).all(dim=-1)
    enc = _encode(params, u, config)
    out = _mlp(params["density_mlp"], enc, config.compute_dtype)
    raw_density, feat = out[..., :1], out[..., 1:]
    density = density_activation(raw_density) * selector[..., None]
    if return_feat:
        return density, feat
    return density


def query_rgb(params: Params, viewdirs: torch.Tensor, feat: torch.Tensor,
              config: NGPConfig = NGPConfig()) -> torch.Tensor:
    """Color from unit view directions + geo features."""
    if config.use_viewdirs:
        h = torch.cat([sh_encode(viewdirs, config.sh_degree), feat], dim=-1)
    else:
        h = feat
    return torch.sigmoid(_mlp(params["color_mlp"], h, config.compute_dtype))


def forward(params: Params, positions: torch.Tensor, viewdirs: torch.Tensor,
            aabb: torch.Tensor, config: NGPConfig = NGPConfig()):
    """(rgb, density) at sample points."""
    density, feat = query_density(params, positions, aabb, config, return_feat=True)
    return query_rgb(params, viewdirs, feat, config), density


def config_to_meta(config: NGPConfig) -> dict:
    """JSON-able description, the schema of the JAX package's checkpoints."""
    return {
        "encoder": "packed" if _packed(config) else "xor_hash",
        "grid": dataclasses.asdict(config.grid),
        "geo_feat_dim": config.geo_feat_dim,
        "hidden_dim": config.hidden_dim,
        "sh_degree": config.sh_degree,
        "use_viewdirs": config.use_viewdirs,
        "unbounded": config.unbounded,
        "bf16": config.compute_dtype == torch.bfloat16,
    }


def config_from_meta(meta: dict) -> NGPConfig:
    grid_cls = PackedGridConfig if meta.get("encoder", "packed") == "packed" else HashGridConfig
    return NGPConfig(
        grid=grid_cls(**meta.get("grid", {})),
        geo_feat_dim=meta.get("geo_feat_dim", 15),
        hidden_dim=meta.get("hidden_dim", 64),
        sh_degree=meta.get("sh_degree", 4),
        use_viewdirs=meta.get("use_viewdirs", True),
        unbounded=meta.get("unbounded", False),
        compute_dtype=torch.bfloat16 if meta.get("bf16", True) else torch.float32,
    )
