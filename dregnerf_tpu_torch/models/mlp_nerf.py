"""Vanilla NeRF and D-NeRF radiance fields, frequency-encoded MLPs (port of
dregnerf_tpu/models/mlp_nerf.py).

  * Vanilla: an 8x256 ReLU trunk over posenc(x, 10) with the encoding
    concatenated again after every 4th layer, a softplus sigma head, and a
    bottleneck (no activation) concatenated with posenc(dirs, 4) into a
    1x128 ReLU color head with a sigmoid output.
  * D-NeRF: adds a 4x64 warp MLP over [posenc(x, 10), posenc(t, 4)] whose
    output offsets x before the canonical field, when a time is given.

Parameters are a dict of tensors in the JAX package's layout (`trunk[i]`,
`sigma`, `bottleneck`, `color[i]`, `rgb`, and `warp[i]`, `warp_out` with
the warp; each `{"w": [in, out], "b": [out]}`), so checkpoints cross
between the packages. Each dense layer rounds its operands to
`compute_dtype` and multiplies them as f32 (the products of bf16 values are
exact, the sums f32), then adds the f32 bias: the JAX package's
`jnp.dot(..., preferred_element_type=f32) + b`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from dregnerf_tpu_torch.device import resolve_device

Params = Dict[str, Any]


def posenc(x: torch.Tensor, num_freqs: int, include_input: bool = True) -> torch.Tensor:
    """NeRF sinusoidal encoding at frequencies 2^0 .. 2^(L-1):
    [x, sin(x 2^l) for l, d.., cos(x 2^l) for l, d..] per level."""
    freqs = 2.0 ** torch.arange(num_freqs, dtype=torch.float32, device=x.device)
    xs = x[..., None, :] * freqs[:, None]  # [..., L, D]
    enc = torch.cat([torch.sin(xs), torch.cos(xs)], dim=-1).reshape(*x.shape[:-1], -1)
    if include_input:
        enc = torch.cat([x, enc], dim=-1)
    return enc


@dataclasses.dataclass(frozen=True)
class VanillaNeRFConfig:
    net_depth: int = 8
    net_width: int = 256
    skip_layer: int = 4
    net_depth_condition: int = 1
    net_width_condition: int = 128
    posenc_xyz: int = 10
    posenc_dir: int = 4
    warp: bool = False  # D-NeRF time-conditioned deformation
    warp_depth: int = 4
    warp_width: int = 64
    posenc_time: int = 4
    compute_dtype: torch.dtype = torch.float32

    @property
    def xyz_dim(self) -> int:
        return 3 + 6 * self.posenc_xyz

    @property
    def dir_dim(self) -> int:
        return 3 + 6 * self.posenc_dir

    @property
    def time_dim(self) -> int:
        return 1 + 2 * self.posenc_time

    def skip_after(self, i: int) -> bool:
        """True when the encoding is concatenated after trunk layer i."""
        return bool(self.skip_layer) and (i + 1) % self.skip_layer == 0 \
            and i + 1 < self.net_depth


def _dense_init(shape, generator, device) -> Dict[str, torch.Tensor]:
    """He-uniform weights (bound sqrt(6 / fan_in)), zero biases."""
    bound = (6.0 / shape[0]) ** 0.5
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return {"w": u * (2.0 * bound) - bound,
            "b": torch.zeros(shape[1], dtype=torch.float32, device=device)}


def init_vanilla_nerf(config: VanillaNeRFConfig = VanillaNeRFConfig(),
                      generator: torch.Generator | None = None,
                      device: torch.device | str | None = None) -> Params:
    """Random weights on `device` (cuda unless given; raises without CUDA)."""
    device = resolve_device(device)

    def dense(n_in, n_out):
        return _dense_init((n_in, n_out), generator, device)

    params: Params = {"trunk": []}
    in_dim = config.xyz_dim
    for i in range(config.net_depth):
        params["trunk"].append(dense(in_dim, config.net_width))
        in_dim = config.net_width + (config.xyz_dim if config.skip_after(i) else 0)
    params["sigma"] = dense(config.net_width, 1)
    params["bottleneck"] = dense(config.net_width, config.net_width)
    params["color"] = []
    c_in = config.net_width + config.dir_dim
    for _ in range(config.net_depth_condition):
        params["color"].append(dense(c_in, config.net_width_condition))
        c_in = config.net_width_condition
    params["rgb"] = dense(c_in, 3)
    if config.warp:
        params["warp"] = []
        w_in = config.xyz_dim + config.time_dim
        for _ in range(config.warp_depth):
            params["warp"].append(dense(w_in, config.warp_width))
            w_in = config.warp_width
        params["warp_out"] = dense(w_in, 3)
    return params


def _map_layers(fn, params: Params) -> Params:
    return {k: [{"w": fn(l["w"]), "b": fn(l["b"])} for l in v] if isinstance(v, list)
            else {"w": fn(v["w"]), "b": fn(v["b"])} for k, v in params.items()}


def params_from_jax(params_np: Params, device: torch.device | str | None = None) -> Params:
    """JAX parameter pytree (numpy leaves) -> the port's parameter dict on
    `device` (cuda unless given; raises without CUDA)."""
    device = resolve_device(device)
    return _map_layers(
        lambda a: torch.as_tensor(np.array(a, dtype=np.float32), device=device), params_np)


def params_to_numpy(params: Params) -> Params:
    """Inverse of `params_from_jax`."""
    return _map_layers(lambda t: t.detach().cpu().numpy(), params)


def _apply_dense(p: Dict[str, torch.Tensor], x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    y = torch.matmul(x.to(dtype).to(torch.float32), p["w"].to(dtype).to(torch.float32))
    return y + p["b"]


def _trunk(params: Params, enc: torch.Tensor, config: VanillaNeRFConfig) -> torch.Tensor:
    h = enc
    for i, layer in enumerate(params["trunk"]):
        h = torch.relu(_apply_dense(layer, h, config.compute_dtype))
        if config.skip_after(i):
            h = torch.cat([h, enc], dim=-1)
    return h


def warp_points(params: Params, x: torch.Tensor, t: torch.Tensor,
                config: VanillaNeRFConfig) -> torch.Tensor:
    """D-NeRF deformation: x_canonical = x + MLP(posenc(x), posenc(t))."""
    h = torch.cat([posenc(x, config.posenc_xyz), posenc(t, config.posenc_time)], dim=-1)
    for layer in params["warp"]:
        h = torch.relu(_apply_dense(layer, h, config.compute_dtype))
    return x + _apply_dense(params["warp_out"], h, config.compute_dtype)


def query_density(params: Params, x: torch.Tensor,
                  config: VanillaNeRFConfig = VanillaNeRFConfig(),
                  t: Optional[torch.Tensor] = None, return_feat: bool = False):
    """softplus density [..., 1] at x [..., 3] (warped first when the
    config has a warp and a time `t` [..., 1] is given), and the trunk's
    features with `return_feat`."""
    if config.warp and t is not None:
        x = warp_points(params, x, t, config)
    h = _trunk(params, posenc(x, config.posenc_xyz), config)
    sigma = torch.nn.functional.softplus(_apply_dense(params["sigma"], h, config.compute_dtype))
    if return_feat:
        return sigma, h
    return sigma


def query_rgb(params: Params, viewdirs: torch.Tensor, feat: torch.Tensor,
              config: VanillaNeRFConfig = VanillaNeRFConfig()) -> torch.Tensor:
    b = _apply_dense(params["bottleneck"], feat, config.compute_dtype)
    h = torch.cat([b, posenc(viewdirs, config.posenc_dir)], dim=-1)
    for layer in params["color"]:
        h = torch.relu(_apply_dense(layer, h, config.compute_dtype))
    return torch.sigmoid(_apply_dense(params["rgb"], h, config.compute_dtype))


def forward(params: Params, positions: torch.Tensor, viewdirs: torch.Tensor,
            config: VanillaNeRFConfig = VanillaNeRFConfig(),
            t: Optional[torch.Tensor] = None):
    """(rgb, sigma) at sample points."""
    sigma, feat = query_density(params, positions, config, t=t, return_feat=True)
    return query_rgb(params, viewdirs, feat, config), sigma
