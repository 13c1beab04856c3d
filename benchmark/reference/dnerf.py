"""Plain PyTorch reference of the D-NeRF block: the time-conditioned warp,
the canonical 8x256 field, and its training step with Adam over the
marcher, the compositor and the occupancy update of
`benchmark/reference/ngp.py`.

A frozen copy of the arithmetic of the port's D-NeRF field
(dregnerf_tpu_torch: models/mlp_nerf.py, models/fields.py, the times of
render/renderer.py and runtime/ngp_trainer.py), in plain torch and f32:

  * posenc(v, L) = [v, sin(v 2^l) for each l's dims, cos(v 2^l) for each
    l's dims], l = 0 .. L-1 (the port's layout, a level's sines then its
    cosines);
  * every dense layer is round(h) @ round(W) + b, the operands rounded as
    `precision` says ("bf16": the configuration's bf16 operands with f32
    sums; "fp8": the control; "f32"), the bias f32;
  * warp: x_c = x + W_out relu^4([posenc(x, 10), posenc(t, 4)]) (4 x 64);
  * trunk: 8 ReLU layers of 256 over posenc(x_c, 10), the encoding
    concatenated again after layer 4; sigma = softplus(W_s h), times the
    strict aabb selector of the un-warped x; rgb = sigmoid(W_rgb
    relu(W_c [W_b h, posenc(d, 4)])), a bottleneck of 256 with no
    activation and one colour layer of 128;
  * a ray's time is its image's; a padding slot of the sample buffer takes
    the last ray's time (the renderer's rule); the occupancy update queries
    the density at no time, so the canonical field unwarped.

Departures from D-NeRF (Pumarola et al., CVPR 2021, arXiv:2011.13961), each
the program's too, listed as `assumed` in benchmark/configs/dnerf-8x256.json:
bf16 operands where D-NeRF computes in f32; the occupancy-grid marcher in
place of stratified and hierarchical sampling; occupancy updates at no
time; 4,096 rays a step pinned (64 samples a ray at the 2^18 buffer); lr
5e-4 under the x0.33 multistep schedule, with Adam's eps 1e-15; the warp as
the port implements it, 4 x 64 over [posenc(x, 10), posenc(t, 4)], added
to x; and the scene (benchmark/traffic/dynamic.py).

It imports nothing of the program and nothing of JAX.
"""
from __future__ import annotations

import math

import torch

from benchmark.reference.ngp import composite_packed, march_capped, pixel_rays, warmup_grid
from benchmark.reference.precision import round_operand

__all__ = ["Field", "leaves", "layer_shapes", "step_loss", "train_steps", "warmup_grid"]


def posenc(v: torch.Tensor, freqs: int) -> torch.Tensor:
    scales = 2.0 ** torch.arange(freqs, dtype=torch.float32, device=v.device)
    vs = v[..., None, :] * scales[:, None]  # [..., L, D]
    enc = torch.cat([torch.sin(vs), torch.cos(vs)], dim=-1).reshape(*v.shape[:-1], -1)
    return torch.cat([v, enc], dim=-1)


def layer_shapes(cfg: dict) -> dict:
    """{group: [(in, out)]} of the field's layers: `trunk`, `color` and
    `warp` hold lists; `sigma`, `bottleneck`, `rgb` and `warp_out` one each."""
    enc_x = 3 * (1 + 2 * cfg["posenc_xyz"])
    enc_d = 3 * (1 + 2 * cfg["posenc_dir"])
    enc_t = 1 + 2 * cfg["posenc_time"]
    w, skip = cfg["net_width"], cfg["skip_layer"]
    trunk, n_in = [], enc_x
    for i in range(cfg["net_depth"]):
        trunk.append((n_in, w))
        n_in = w + (enc_x if skip and (i + 1) % skip == 0 and i + 1 < cfg["net_depth"] else 0)
    color, n_in = [], cfg["bottleneck_width"] + enc_d
    for _ in range(cfg["net_depth_condition"]):
        color.append((n_in, cfg["net_width_condition"]))
        n_in = cfg["net_width_condition"]
    warp, w_in = [], enc_x + enc_t
    for _ in range(cfg["warp_depth"]):
        warp.append((w_in, cfg["warp_width"]))
        w_in = cfg["warp_width"]
    return {"trunk": trunk, "sigma": (w, 1), "bottleneck": (w, cfg["bottleneck_width"]),
            "color": color, "rgb": (n_in, 3), "warp": warp, "warp_out": (w_in, 3)}


class Field:
    """The configuration's D-NeRF field over parameters in the program's
    tree ({group: {"w", "b"}} or [{"w", "b"}])."""

    def __init__(self, cfg: dict, precision: str = "bf16"):
        self.cfg = cfg
        self.precision = precision

    def dense(self, layer: dict, h: torch.Tensor) -> torch.Tensor:
        p = self.precision
        return torch.matmul(round_operand(h, p), round_operand(layer["w"], p)) + layer["b"]

    def warp(self, params, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        h = torch.cat([posenc(x, self.cfg["posenc_xyz"]), posenc(t, self.cfg["posenc_time"])],
                      dim=-1)
        for layer in params["warp"]:
            h = torch.relu(self.dense(layer, h))
        return x + self.dense(params["warp_out"], h)

    def density(self, params, x: torch.Tensor, aabb: torch.Tensor, return_feat=False, t=None):
        """sigma [..., 1] at x [..., 3], warped first when a time `t`
        [..., 1] is given; with `return_feat`, also the trunk's output."""
        inside = ((x > aabb[:3]) & (x < aabb[3:])).all(dim=-1)[..., None]
        xc = x if t is None else self.warp(params, x, t)
        enc = posenc(xc, self.cfg["posenc_xyz"])
        h, skip, depth = enc, self.cfg["skip_layer"], len(params["trunk"])
        for i, layer in enumerate(params["trunk"]):
            h = torch.relu(self.dense(layer, h))
            if skip and (i + 1) % skip == 0 and i + 1 < depth:
                h = torch.cat([h, enc], dim=-1)
        sigma = torch.nn.functional.softplus(self.dense(params["sigma"], h)) * inside
        return (sigma, h) if return_feat else sigma

    def rgb(self, params, dirs: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
        h = torch.cat([self.dense(params["bottleneck"], feat),
                       posenc(dirs, self.cfg["posenc_dir"])], dim=-1)
        for layer in params["color"]:
            h = torch.relu(self.dense(layer, h))
        return torch.sigmoid(self.dense(params["rgb"], h))


# ---------------------------------------------------------------- training

def leaves(params) -> dict:
    """{"<group>.<i>.w": ..} for the listed groups, {"<group>.w": ..} for the
    others, weights and biases, in the tree's order."""
    out = {}
    for group, v in params.items():
        for i, layer in (enumerate(v) if isinstance(v, list) else [(None, v)]):
            name = group if i is None else f"{group}.{i}"
            out[f"{name}.w"], out[f"{name}.b"] = layer["w"], layer["b"]
    return out


def _tree(flat: dict, like) -> dict:
    """`flat` (as `leaves` names them) in the tree of `like`."""
    return {group: [{"w": flat[f"{group}.{i}.w"], "b": flat[f"{group}.{i}.b"]}
                    for i in range(len(v))] if isinstance(v, list)
            else {"w": flat[f"{group}.w"], "b": flat[f"{group}.b"]}
            for group, v in like.items()}


def step_loss(field: Field, params, binary, aabb, images, c2ws, K, times, draws, rcfg: dict):
    """Huber over the alive rays / (n_alive * 3), each ray at its image's
    time."""
    img_id, x, y, bg, jitter = draws
    rgba = images[img_id, y, x].float() / 255.0
    pixels = rgba[:, :3] * rgba[:, 3:4] + bg * (1.0 - rgba[:, 3:4])
    origins, dirs = pixel_rays(x, y, K, c2ws[img_id])
    ray, t0, valid = march_capped(origins, dirs, binary, aabb, rcfg["step"], rcfg["buffer"],
                                  rcfg["max_steps"], rcfg["k_cap"], jitter)
    pos = origins[ray] + dirs[ray] * ((t0 + (t0 + rcfg["step"])) * 0.5)[:, None]
    ray_time = times[img_id]
    t = torch.where(valid, ray_time[ray], ray_time[-1])[:, None]
    sigma, feat = field.density(params, pos, aabb, return_feat=True, t=t)
    rgbs = field.rgb(params, dirs[ray], feat)
    sigma = torch.where(valid, sigma.reshape(-1), 0.0)
    rgb = composite_packed(ray, t0, valid, rcfg["step"], rgbs, sigma, x.shape[0], bg)
    counts = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device).index_add(
        0, ray, valid.long())
    alive = (counts > 0).float()
    diff = rgb - pixels
    a = diff.abs()
    hub = torch.where(a < 1.0, 0.5 * diff * diff, a - 0.5)
    return (hub * alive[:, None]).sum() / (torch.clamp(alive.sum(), min=1.0) * 3.0)


def train_steps(field: Field, params0: dict, binary, aabb, images, c2ws, K, times, draws_list,
                rcfg: dict, lr: float, eps: float):
    """The first steps from params0 under Adam (betas 0.9, 0.999): returns
    (losses, first gradients by leaf, final parameters by leaf)."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in leaves(params0).items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first = [], None
    for t, draws in enumerate(draws_list, start=1):
        loss = step_loss(field, _tree(p, params0), binary, aabb, images, c2ws, K, times, draws,
                         rcfg)
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        with torch.no_grad():
            for k in p:
                m[k].mul_(0.9).add_(grads[k], alpha=0.1)
                v2[k].mul_(0.999).addcmul_(grads[k], grads[k], value=0.001)
                denom = (v2[k].sqrt() / math.sqrt(1 - 0.999**t)).add_(eps)
                p[k].addcdiv_(m[k], denom, value=-lr / (1 - 0.9**t))
    return losses, first, {k: v.detach() for k, v in p.items()}
