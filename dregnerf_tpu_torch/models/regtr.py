"""NeRFRegTr, the registration network (port of dregnerf_tpu/models/regtr.py).

3D ResNet-FPN over the rgba voxel grid -> trilinear upsample to the grid's
resolution, read at the selected occupied voxels -> hierarchical voxel
subsample -> sine position embedding -> cross-encoder -> correspondence
decoder -> a weighted Kabsch pose per layer. Every shape is fixed, as in
JAX: occupied voxels are selected by a strided stable sort with a validity
mask, and tokens are padded to `num_tokens` per side.

Layouts: the input grid is [R, R, R, 7] (xyz 0:3, rgb 3:6, alpha 6) and
the masks flat [R^3] in ix*R^2 + iy*R + iz order, as in the JAX package;
the network runs in NCDHW, and the FPN output is permuted to channels-last
before its rows are read by flat index.

Weights cross between the packages: `params_from_jax` takes the flax
parameter tree (numpy leaves under flax's names) to this module's
state_dict, `params_to_jax` goes back (for the parameters, or any tensors
in their layout: gradients, Adam moments), and `random_jax_params` draws a
flax-layout tree with flax's initializers.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dregnerf_tpu_torch.geometry.kabsch import rigid_from_moments, weighted_moments
from dregnerf_tpu_torch.models.layers import Conv3d, GroupNorm, LayerNorm, Linear
from dregnerf_tpu_torch.models.pos_embed import (
    PositionEmbeddingCoordsSine,
    PositionEmbeddingLearned,
)
from dregnerf_tpu_torch.models.resnet3d import FeaturePyramid3D
from dregnerf_tpu_torch.models.transformer import (
    CorrespondenceDecoder,
    MultiHeadAttention,
    TransformerCrossEncoder,
)
from dregnerf_tpu_torch.ops.voxel_subsample import (
    PointSet,
    hierarchical_subsample,
    masked_select_strided,
)
from dregnerf_tpu_torch.runtime import profiling


def trilinear_resize(x: torch.Tensor, size) -> torch.Tensor:
    """[B, C, D, H, W] trilinear upsample with half-pixel centres (the
    convention of jax.image.resize's upsampling)."""
    return F.interpolate(x, size=tuple(size), mode="trilinear", align_corners=False)


def gather_trilinear_resized(vol: torch.Tensor, full_size, idx: torch.Tensor) -> torch.Tensor:
    """`trilinear_resize(vol, full_size)` read at the flat full-resolution
    indices `idx` ([K], ix*H*W + iy*W + iz), without the resized volume:
    8 corner gathers from the coarse one, summed in f32, returned in
    vol's dtype. vol: [1, C, d, h, w] -> [K, C]."""
    _, c, d, h, w = vol.shape
    D, H, W = full_size
    flat = vol[0].permute(1, 2, 3, 0).reshape(d * h * w, c)  # channels-last rows

    iz = idx % W
    iy = torch.div(idx, W, rounding_mode="floor") % H
    ix = torch.div(idx, W * H, rounding_mode="floor")

    def axis_coords(i, n_in, n_out):
        cx = (i.float() + 0.5) * (n_in / n_out) - 0.5
        f = torch.floor(cx)
        t = cx - f
        c0 = f.long().clamp(0, n_in - 1)
        c1 = (f.long() + 1).clamp(0, n_in - 1)
        return c0, c1, t

    x0, x1, tx = axis_coords(ix, d, D)
    y0, y1, ty = axis_coords(iy, h, H)
    z0, z1, tz = axis_coords(iz, w, W)

    out = torch.zeros(idx.shape[0], c, device=vol.device)
    for xc, wx in ((x0, 1.0 - tx), (x1, tx)):
        for yc, wy in ((y0, 1.0 - ty), (y1, ty)):
            for zc, wz in ((z0, 1.0 - tz), (z1, tz)):
                rows = flat[(xc * h + yc) * w + zc]
                out = out + rows.float() * (wx * wy * wz)[:, None]
    return out.to(vol.dtype)


class NeRFRegTr(nn.Module):
    def __init__(self, pos_emb_type: str = "sine", d_model: int = 256,
                 pos_emb_scaling: float = 1.0, num_downsample: int = 6,
                 backbone: str = "resnet50", num_layers: int = 6, num_heads: int = 8,
                 dim_feedforward: int = 1024, max_input_points: int = 16384,
                 num_tokens: int = 2048, init_subsample_cell: float = 0.05,
                 max_points: int = 1500, dtype: torch.dtype = torch.float32,
                 sp_mesh=None, dense_resize: bool = False):
        super().__init__()
        self.d_model, self.num_layers, self.num_heads = d_model, num_layers, num_heads
        self.num_downsample = num_downsample
        self.max_input_points, self.num_tokens = max_input_points, num_tokens
        self.init_subsample_cell, self.max_points = init_subsample_cell, max_points
        self.dtype, self.dense_resize = dtype, dense_resize
        self.fpn3d = FeaturePyramid3D(backbone, d_model, dtype)
        if pos_emb_type == "sine":
            self.pos_embed = PositionEmbeddingCoordsSine(3, d_model, scale=pos_emb_scaling)
        else:
            self.pos_embed = PositionEmbeddingLearned(3, d_model)
        self.transformer_encoder = TransformerCrossEncoder(
            num_layers, d_model, num_heads, dim_feedforward, dtype, sp_mesh=sp_mesh)
        self.decoder = CorrespondenceDecoder(d_model, dtype)

    def _side(self, grid: torch.Tensor, mask: torch.Tensor) -> PointSet:
        r = grid.shape[0]
        rgba = grid[..., 3:7].permute(3, 0, 1, 2)[None].to(self.dtype)  # [1, 4, R, R, R]
        feats = self.fpn3d(rgba)  # [1, D, R/2, R/2, R/2]
        xyz_flat = grid[..., :3].reshape(-1, 3)
        # strided selection: first-k would take a low-x slab of a large
        # occupied set, and the two sides' slabs would cover other regions
        idx, valid = masked_select_strided(mask, self.max_input_points)
        if self.dense_resize:
            up = trilinear_resize(feats, (r, r, r))[0]  # [D, R, R, R]
            sel = up.permute(1, 2, 3, 0).reshape(-1, self.d_model)[idx]
        else:
            sel = gather_trilinear_resized(feats, (r, r, r), idx)
        return PointSet(xyz=xyz_flat[idx] * valid[:, None], feats=sel * valid[:, None],
                        valid=valid, count=mask.sum().to(torch.int32))

    def forward(self, data: Dict[str, torch.Tensor],
                solve_pose: bool = True) -> Dict[str, torch.Tensor]:
        """data: src_grid/tgt_grid [R, R, R, 7] f32, src_mask/tgt_mask [R^3]
        bool. Returns JAX's keys: per-layer conditioned features [L, 1, N, D],
        keypoints [N, 3], warped keypoints [L, N, 3], overlaps [L, N],
        validity [N], 'pose' [L, 3, 4] and 'ds_level'. Spans `regtr.fpn`,
        `.subsample`, `.transformer`, `.heads`; counters `regtr.src_points`
        and `regtr.tgt_points` (the subsampled counts) and `regtr.level`.

        solve_pose=False leaves the per-layer Kabsch at its moments:
        'pose_moments' (`weighted_moments`' three tensors, [L, 1, ...]) in
        the place of 'pose', for a caller that solves them later
        (`rigid_from_moments`), as a CUDA graph of the training step does."""
        with profiling.annotate("regtr.fpn"):
            src = self._side(data["src_grid"], data["src_mask"])
            tgt = self._side(data["tgt_grid"], data["tgt_mask"])
        with profiling.annotate("regtr.subsample"):
            src_ds, tgt_ds, level = hierarchical_subsample(
                src, tgt, self.num_downsample, self.init_subsample_cell, self.max_points)
        profiling.count("regtr.src_points", src_ds.count)
        profiling.count("regtr.tgt_points", tgt_ds.count)
        profiling.count("regtr.level", level)

        with profiling.annotate("regtr.transformer"):
            k = self.num_tokens
            src_xyz, tgt_xyz = src_ds.xyz[:k][None], tgt_ds.xyz[:k][None]  # [1, N, 3]
            src_feats = src_ds.feats[:k][None].to(self.dtype)
            tgt_feats = tgt_ds.feats[:k][None].to(self.dtype)
            src_valid, tgt_valid = src_ds.valid[:k][None], tgt_ds.valid[:k][None]

            src_pe = self.pos_embed(src_xyz).to(self.dtype)
            tgt_pe = self.pos_embed(tgt_xyz).to(self.dtype)
            src_cond, tgt_cond = self.transformer_encoder(
                src_feats, tgt_feats, src_valid, tgt_valid, src_pe, tgt_pe)  # [L, 1, N, D]
        with profiling.annotate("regtr.heads"):
            src_corr, tgt_corr, src_overlap, tgt_overlap = self.decoder(
                src_cond, tgt_cond, src_xyz, tgt_xyz, src_valid, tgt_valid, src_pe, tgt_pe)

            # per-layer weighted Kabsch over the correspondences of both directions, in f32
            L = src_corr.shape[0]
            src_xyz_l = src_xyz[None].expand(L, *src_xyz.shape)
            tgt_xyz_l = tgt_xyz[None].expand(L, *tgt_xyz.shape)
            corr_src = torch.cat([src_xyz_l, src_corr.float()], dim=-1)
            corr_tgt = torch.cat([tgt_corr.float(), tgt_xyz_l], dim=-1)
            corr_all = torch.cat([corr_src, corr_tgt], dim=2)  # [L, 1, 2N, 6]
            w = torch.cat([src_overlap.float() * src_valid[None],
                           tgt_overlap.float() * tgt_valid[None]], dim=2)  # [L, 1, 2N]
            moments = weighted_moments(corr_all[..., :3], corr_all[..., 3:], w)
            pose = {"pose": rigid_from_moments(*moments)[:, 0]} if solve_pose else {
                "pose_moments": moments}

        return {
            "src_feats": src_cond, "tgt_feats": tgt_cond,
            "src_kp": src_xyz[0], "tgt_kp": tgt_xyz[0],
            "src_kp_warped": src_corr[:, 0], "tgt_kp_warped": tgt_corr[:, 0],
            "src_overlap": src_overlap[:, 0], "tgt_overlap": tgt_overlap[:, 0],
            "src_valid": src_valid[0], "tgt_valid": tgt_valid[0],
            **pose, "ds_level": level,
        }


# ----------------------------------------------------- weights from and to flax

def _flax_module_names(model: nn.Module) -> Iterator[tuple[str, str, nn.Module]]:
    """(torch module path, flax module path, module) of every module that
    holds parameters. Flax names modules by class and creation order
    (ResNet3D_0, Bottleneck3D_k, Conv_i, GroupNorm_i, Dense_i) or by the
    name given (lateral1, layer{i}, ...)."""
    for path, module in model.named_modules():
        if not any(True for _ in module.parameters(recurse=False)):
            continue
        parts, flax = path.split("."), []
        i = 0
        while i < len(parts):
            p = parts[i]
            nxt = parts[i + 1] if i + 1 < len(parts) else None
            if p == "backbone":
                flax.append("ResNet3D_0")
            elif p == "stem":
                flax.append("Conv_0")
            elif p == "stem_norm":
                flax.append("GroupNorm_0")
            elif p in ("blocks", "convs", "norms", "layers", "dense"):
                owner = model.get_submodule(".".join(parts[:i + 2]))
                name = {"blocks": type(owner).__name__, "convs": "Conv", "norms": "GroupNorm",
                        "layers": "layer", "dense": "Dense"}[p]
                flax.append(f"{name}{nxt}" if p == "layers" else f"{name}_{nxt}")
                i += 1
            else:
                flax.append(p)
            i += 1
        yield path, "/".join(flax), module


def _leaf_map(model: nn.Module):
    """(flax leaf path, torch parameter key, kind, heads) for every
    parameter of `model` (NeRFRegTr or any of its parts); `heads` is the
    attention module's head count (0 elsewhere)."""
    out = []
    for path, flax, module in _flax_module_names(model):
        parent = path.rsplit(".", 1)[-1]
        for name, _ in module.named_parameters(recurse=False):
            is_weight, heads = name == "weight", 0
            if isinstance(module, (GroupNorm, LayerNorm)):
                leaf, kind = ("scale" if is_weight else "bias"), "same"
            elif isinstance(module, (Conv3d, Linear)):
                leaf = "kernel" if is_weight else "bias"
                owner = model.get_submodule(path.rsplit(".", 1)[0]) if "." in path else model
                if isinstance(module, Conv3d):
                    kind = "conv" if is_weight else "same"
                elif not isinstance(owner, MultiHeadAttention):
                    kind = "dense" if is_weight else "same"
                elif parent == "out":
                    kind, heads = ("attn_out" if is_weight else "same"), owner.num_heads
                else:
                    kind, heads = ("attn_in" if is_weight else "attn_in_bias"), owner.num_heads
            else:
                raise TypeError(f"no flax mapping for {type(module).__name__} at {path}")
            out.append((f"{flax}/{leaf}", f"{path}.{name}", kind, heads))
    return out


def _flat_tree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tree(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def params_from_jax(tree, model: nn.Module) -> Dict[str, torch.Tensor]:
    """flax parameter tree of `model` (nested dicts of numpy arrays) ->
    its state_dict (f32 CPU tensors). Every flax leaf must be used exactly
    once and every parameter filled: raises otherwise.

    Convolution kernels [kd, kh, kw, in, out] -> [out, in, kd, kh, kw];
    dense kernels [in, out] -> their transpose; attention query/key/value
    kernels [in, H, hd] -> reshape(in, H*hd).T with their [H, hd] biases
    flattened; the attention `out` kernel [H, hd, out] -> reshape(H*hd,
    out).T; norm `scale` -> weight."""
    flat = _flat_tree(tree)
    state = {}
    for flax_path, key, kind, _ in _leaf_map(model):
        if flax_path not in flat:
            raise KeyError(f"flax tree has no leaf {flax_path!r} (for {key})")
        a = np.array(flat.pop(flax_path), np.float32)  # a writable copy
        if kind == "conv":
            a = a.transpose(4, 3, 0, 1, 2)
        elif kind == "dense":
            a = a.T
        elif kind == "attn_in":
            a = a.reshape(a.shape[0], -1).T
        elif kind == "attn_in_bias":
            a = a.reshape(-1)
        elif kind == "attn_out":
            a = a.reshape(-1, a.shape[-1]).T
        state[key] = torch.from_numpy(np.ascontiguousarray(a))
    if flat:
        raise KeyError(f"flax leaves with no parameter in the port: {sorted(flat)}")
    missing = set(model.state_dict()) - set(state)
    if missing:
        raise KeyError(f"parameters not filled from the flax tree: {sorted(missing)}")
    return state


def params_to_jax(model: nn.Module, state: Dict[str, torch.Tensor] | None = None) -> dict:
    """Inverse of `params_from_jax`: the model's parameters as a flax tree
    of numpy arrays; or, given `state` (tensors in the parameters' layout
    under their state_dict keys: gradients, Adam moments), those."""
    sd = model.state_dict() if state is None else state
    tree: dict = {}
    for flax_path, key, kind, heads in _leaf_map(model):
        a = sd[key].detach().cpu().float().numpy()
        if kind == "conv":
            a = a.transpose(2, 3, 4, 1, 0)
        elif kind == "dense":
            a = a.T
        elif kind == "attn_in":
            a = a.T.reshape(a.shape[1], heads, -1)
        elif kind == "attn_in_bias":
            a = a.reshape(heads, -1)
        elif kind == "attn_out":
            a = a.T.reshape(heads, -1, a.shape[0])
        node = tree
        *dirs, leaf = flax_path.split("/")
        for d in dirs:
            node = node.setdefault(d, {})
        node[leaf] = np.array(a, order="C")  # a copy: never a view of a parameter
    return tree


def random_jax_params(model: nn.Module, rng: np.random.Generator) -> dict:
    """A flax-layout parameter tree for `model` drawn with flax's default
    initializers: LeCun-normal kernels (truncated at 2 sigma, fan-in of the
    flattened input axes), zero biases, unit norm scales."""
    tree = params_to_jax(model)
    flat = _flat_tree(tree)
    for path, a in flat.items():
        leaf = path.rsplit("/", 1)[-1]
        if leaf == "kernel":
            # attention query/key/value kernels [in, H, hd] flatten their
            # output axes; every other kernel's output axis is its last
            attn_in = any(f"/{n}/kernel" in path for n in ("query", "key", "value"))
            fan_in = a.shape[0] if attn_in else int(np.prod(a.shape[:-1]))
            std = np.float32(np.sqrt(1.0 / fan_in) / 0.87962566103423978)
            x = rng.standard_normal(a.shape, dtype=np.float32)
            bad = np.abs(x) > 2.0
            while bad.any():
                x[bad] = rng.standard_normal(int(bad.sum()), dtype=np.float32)
                bad = np.abs(x) > 2.0
            np.multiply(x, std, out=a)
        elif leaf == "scale":
            a[...] = 1.0
        else:
            a[...] = 0.0
    return tree
