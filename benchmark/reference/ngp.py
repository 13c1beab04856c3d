"""Plain PyTorch reference of the NGP block: the packed-layout field, the
occupancy update, the marcher, the compositor and the training step with
Adam.

A frozen copy of the arithmetic of the port's plain code
(dregnerf_tpu_torch: models/ngp.py, ops/{packed_grid,ray_march,occupancy,
composite,contraction,activation,sh}.py, geometry/cameras.py,
runtime/ngp_trainer.py) with none of its kernels:
the encoder reads each corner of the vertex table by plain indexing, so
its table gradient is autograd's exact f32 scatter, and the step's
gradients are autograd's. It imports nothing of the program. The MLP
operands are rounded as `precision` says ("bf16": the configuration's
bf16 operands with f32 sums; "fp8": the control).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.precision import round_operand

_BIG = 1 << 30
CORNERS = np.stack(np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"),
                   axis=-1).reshape(8, 3).astype(np.int64)


# --------------------------------------------------------------------- field

class Field:
    """The configuration's field over the vertex table and MLP weights
    `params` ({"table", "density_mlp": [..], "color_mlp": [..]})."""

    def __init__(self, cfg: dict, precision: str = "bf16"):
        self.cfg = cfg
        self.precision = precision
        g = cfg["grid"]
        self.levels, self.features = g["n_levels"], g["n_features"]
        self.scales = [g["base_resolution"] * g["per_level_scale"] ** l - 1.0
                       for l in range(self.levels)]
        self.scales = np.array(self.scales, np.float32)
        self.res = (np.ceil(self.scales) + 1.0).astype(np.int64)
        t_max = 1 << g["log2_table_size"]
        self.sizes = np.where(self.res**3 <= t_max, self.res**3, t_max).astype(np.int64)
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)]).astype(np.int64)

    def encode(self, table: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """[..., 3] in [0, 1]^3 (clipped) -> [..., levels * features]."""
        shape = u.shape[:-1]
        x = u.reshape(-1, 3).float().clamp(0.0, 1.0)
        dev = x.device
        outs = []
        for l in range(self.levels):
            pos = x * float(self.scales[l]) + 0.5
            fl = torch.floor(pos)
            frac = pos - fl
            r = int(self.res[l])
            cell = fl.to(torch.int32).clamp(min=0).long().clamp(max=r - 2)
            lin = cell[:, 0] * (r * r) + cell[:, 1] * r + cell[:, 2]
            size, off = int(self.sizes[l]), int(self.offsets[l])
            acc = 0.0
            for dx, dy, dz in CORNERS:
                w = ((frac[:, 0] if dx else 1 - frac[:, 0])
                     * (frac[:, 1] if dy else 1 - frac[:, 1])
                     * (frac[:, 2] if dz else 1 - frac[:, 2]))
                row = (lin + int(dx * r * r + dy * r + dz)) % size + off
                acc = acc + w[:, None] * table[row]
            outs.append(acc)
        return torch.cat(outs, dim=-1).reshape(*shape, -1).to(dev)

    def mlp(self, layers, h: torch.Tensor) -> torch.Tensor:
        for i, w in enumerate(layers):
            h = torch.matmul(round_operand(h, self.precision), round_operand(w, self.precision))
            if i + 1 < len(layers):
                h = torch.relu(h)
        return h

    def density(self, params, x: torch.Tensor, aabb: torch.Tensor, return_feat=False):
        u = (x - aabb[:3]) / (aabb[3:] - aabb[:3])
        inside = ((u > 0.0) & (u < 1.0)).all(dim=-1)
        out = self.mlp(params["density_mlp"], self.encode(params["table"], u))
        sigma = TruncExp.apply(out[..., :1] - 1.0) * inside[..., None]
        return (sigma, out[..., 1:]) if return_feat else sigma

    def rgb(self, params, dirs: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
        h = torch.cat([sh_encode(dirs), feat], dim=-1)
        return torch.sigmoid(self.mlp(params["color_mlp"], h))


class TruncExp(torch.autograd.Function):
    """exp(x); its gradient takes exp(min(x, 15)) (the model's rule)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, max=15.0))


def sh_encode(d: torch.Tensor) -> torch.Tensor:
    """Degree-4 real spherical harmonics (instant-ngp's constants)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814),
        -0.48860251190291987 * y, 0.48860251190291992 * z, -0.48860251190291987 * x,
        1.0925484305920792 * xy, -1.0925484305920792 * yz,
        0.94617469575755997 * zz - 0.31539156525251999, -1.0925484305920792 * xz,
        0.54627421529603959 * (xx - yy),
        0.59004358992664352 * y * (-3.0 * xx + yy), 2.8906114426405538 * xy * z,
        0.45704579946446572 * y * (1.0 - 5.0 * zz), 0.3731763325901154 * z * (5.0 * zz - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * zz), 1.4453057213202769 * z * (xx - yy),
        0.59004358992664352 * x * (-xx + 3.0 * yy)], dim=-1)


# ----------------------------------------------------------------- occupancy

def cell_points(indices: torch.Tensor, res: int, noise: torch.Tensor) -> torch.Tensor:
    """Contracted positions of cells jittered by noise in [-0.5, 0.5)."""
    iz, iy, ix = indices % res, (indices // res) % res, indices // (res * res)
    return (torch.stack([ix, iy, iz], -1).float() + 0.5) / res + noise / res


def warmup_grid(field: Field, params, aabb, res: int, step_size: float,
                noise: torch.Tensor, chunk: int = 1 << 16) -> torch.Tensor:
    """The binary grid [res^3] after the first (warm-up) update of an empty
    grid: every cell's density at its jittered point times the step,
    thresholded at min(mean, 0.01)."""
    n = res**3
    u = cell_points(torch.arange(n, device=noise.device), res, noise)
    with torch.no_grad():
        vals = torch.cat([field.density(params, c * (aabb[3:] - aabb[:3]) + aabb[:3],
                                        aabb).reshape(-1) * step_size
                          for c in u.split(chunk)])
    occs = torch.zeros(n, device=noise.device).scatter_reduce(
        0, torch.arange(n, device=noise.device), vals.float(), reduce="amax",
        include_self=True)
    return occs > torch.clamp(occs.mean(), max=0.01)


# -------------------------------------------------------------------- march

def ray_aabb(origins, dirs, aabb, near=0.0, far=1e10):
    inv = 1.0 / torch.where(dirs.abs() < 1e-10, torch.full_like(dirs, 1e-10), dirs)
    t0, t1 = (aabb[:3] - origins) * inv, (aabb[3:] - origins) * inv
    return (torch.clamp(torch.minimum(t0, t1).amax(dim=-1), min=near),
            torch.clamp(torch.maximum(t0, t1).amin(dim=-1), max=far))


def _group(max_steps: int, res: int) -> int:
    steps_per_cell = max_steps / (res * 1.7320508)
    g = min(max(math.floor(3.5 * steps_per_cell) + 1, 1), 32)
    while max_steps % g:
        g -= 1
    return g


def candidates(origins, dirs, binary, aabb, step, max_steps, jitter):
    """(mask [R, S], t_lo [R]): lattice steps inside the box whose midpoint
    reads occupied (the marcher's region rule)."""
    t_lo, t_hi = ray_aabb(origins, dirs, aabb)
    r_n = origins.shape[0]
    res = binary.shape[0]
    steps = torch.arange(max_steps, dtype=torch.float32, device=origins.device)[None]
    t_mid = t_lo[:, None] + (steps + jitter) * step + 0.5 * step
    group = _group(max_steps, res)
    lo, ext = aabb[:3], aabb[3:] - aabb[:3]
    in_range = in_region = flat = None
    for k in range(3):
        v = torch.floor((origins[:, k, None] + dirs[:, k, None] * t_mid - lo[k]) / ext[k] * res)
        ok = (v >= 0) & (v < res)
        c = v.clamp(0, res - 1).to(torch.int32)
        cg = c.view(r_n, max_steps // group, group)
        sc = (cg[:, :, group // 2] >> 2).clamp(0, res // 4 - 1)
        local = cg - (4 * sc - 2)[..., None]
        inside = ((local >= 0) & (local < 8)).view(r_n, max_steps)
        in_range = ok if in_range is None else in_range & ok
        in_region = inside if in_region is None else in_region & inside
        flat = c.long() if flat is None else flat * res + c
    occupied = (binary.reshape(-1)[flat] | ~in_region) & in_range
    return occupied & (t_mid < t_hi[:, None]) & (t_lo < t_hi)[:, None], t_lo


def first_survivors(mask, k):
    steps = torch.arange(mask.shape[1], dtype=torch.int32, device=mask.device)
    keys = torch.where(mask, -steps[None], torch.full_like(steps, -_BIG)[None])
    vals = torch.topk(keys, k, dim=1, largest=True, sorted=True).values
    valid = vals > -_BIG
    return torch.where(valid, -vals, 0).to(torch.int64), valid


def march_capped(origins, dirs, binary, aabb, step, buffer, max_steps, k_cap, jitter):
    """The training marcher: each ray's first k_cap survivors back to back,
    cut at the buffer. Returns (ray [B], t_start [B], valid [B])."""
    mask, t_lo = candidates(origins, dirs, binary, aabb, step, max_steps, jitter)
    k_cap = min(k_cap, max_steps, buffer)
    steps, valid_rk = first_survivors(mask, k_cap)
    rays = torch.arange(origins.shape[0], device=origins.device)[:, None].expand_as(steps)
    ray, st = rays[valid_rk][:buffer], steps[valid_rk][:buffer]
    n = ray.shape[0]
    pad = buffer - n
    ray = torch.cat([ray, torch.zeros(pad, dtype=ray.dtype, device=ray.device)])
    st = torch.cat([st, torch.zeros(pad, dtype=st.dtype, device=st.device)])
    valid = torch.arange(buffer, device=ray.device) < n
    t0 = torch.where(valid, t_lo[ray] + (st.float() + jitter[ray, 0]) * step, 0.0)
    return ray, t0, valid


def composite_packed(ray, t0, valid, step, rgbs, sigmas, num_rays, bg):
    dt = (t0 + step) - t0
    alphas = torch.where(valid, 1.0 - torch.exp(-sigmas.reshape(-1) * dt), 0.0)
    log1 = torch.log(torch.clamp(1.0 - alphas, 1e-10, 1.0))
    csum = torch.cumsum(log1, 0)
    excl = torch.cat([torch.zeros_like(csum[:1]), csum[:-1]])
    base = torch.full((num_rays + 1,), -torch.inf, device=excl.device).scatter_reduce(
        0, torch.where(valid, ray, num_rays), torch.where(valid, excl, -torch.inf),
        reduce="amax", include_self=True)
    # padding is based at itself, so that its exp cannot overflow
    base = torch.where(valid, base[ray.clamp(max=num_rays - 1)], excl)
    trans = torch.where(valid, torch.exp(excl - base), 0.0)
    w = alphas * trans
    seg = torch.where(valid, ray, num_rays)
    rgb = torch.zeros(num_rays + 1, 3, device=w.device).index_add(0, seg, w[:, None] * rgbs)
    opacity = torch.zeros(num_rays + 1, device=w.device).index_add(0, seg, w)
    return rgb[:num_rays] + (1.0 - opacity[:num_rays])[:, None] * bg


# ---------------------------------------------------------------- training

def pixel_rays(x, y, K, c2w):
    """World rays through pixels (OpenGL cameras)."""
    d = torch.stack([(x.float() - K[0, 2] + 0.5) / K[0, 0],
                     -(y.float() - K[1, 2] + 0.5) / K[1, 1],
                     -torch.ones_like(x, dtype=torch.float32)], -1)
    dirs = torch.einsum("...ij,...j->...i", c2w[..., :3, :3], d)
    return torch.broadcast_to(c2w[..., :3, 3], dirs.shape), dirs / dirs.norm(dim=-1, keepdim=True)


def step_loss(field: Field, params, binary, aabb, images, c2ws, K, draws, rcfg: dict):
    """(loss, n_alive): Huber over the alive rays / (n_alive * 3)."""
    img_id, x, y, bg, jitter = draws
    rgba = images[img_id, y, x].float() / 255.0
    pixels = rgba[:, :3] * rgba[:, 3:4] + bg * (1.0 - rgba[:, 3:4])
    origins, dirs = pixel_rays(x, y, K, c2ws[img_id])
    ray, t0, valid = march_capped(origins, dirs, binary, aabb, rcfg["step"], rcfg["buffer"],
                                  rcfg["max_steps"], rcfg["k_cap"], jitter)
    pos = origins[ray] + dirs[ray] * ((t0 + (t0 + rcfg["step"])) * 0.5)[:, None]
    sigma, feat = field.density(params, pos, aabb, return_feat=True)
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


def leaves(params) -> dict:
    return {"table": params["table"],
            **{f"density_mlp.{i}": w for i, w in enumerate(params["density_mlp"])},
            **{f"color_mlp.{i}": w for i, w in enumerate(params["color_mlp"])}}


def train_steps(field: Field, params0: dict, binary, aabb, images, c2ws, K, draws_list,
                rcfg: dict, lr: float, eps: float):
    """The first steps from params0 under Adam (betas 0.9, 0.999): returns
    (losses, first gradients by leaf, final parameters by leaf)."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in leaves(params0).items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first = [], None

    def tree():
        return {"table": p["table"],
                "density_mlp": [p[f"density_mlp.{i}"] for i in range(len(params0["density_mlp"]))],
                "color_mlp": [p[f"color_mlp.{i}"] for i in range(len(params0["color_mlp"]))]}

    for t, draws in enumerate(draws_list, start=1):
        loss = step_loss(field, tree(), binary, aabb, images, c2ws, K, draws, rcfg)
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
