"""Transformer cross-encoder and correspondence decoder (port of
dregnerf_tpu/models/transformer.py).

Per layer, both sides go through one shared self-attention, one shared
cross-attention and one shared feed-forward, pre-norm, with the position
embedding added to queries, keys and values; every layer's output goes
through the one `final_norm`.

Masking follows flax exactly. A (query, key) pair is masked unless both
are valid, and a masked logit becomes finfo(dtype).min (not -inf). So a
padded query row, or a row whose keys are all padded, softmaxes to a
uniform distribution and stays finite; a boolean `attn_mask` in
`scaled_dot_product_attention` would give NaN rows there, and 0 * NaN
survives the overlap weights into Kabsch. The attention is therefore a
plain matmul-softmax, in the compute dtype as in flax.

`sp_mesh` (a parallel/mesh.py Mesh) is the sequence-parallel switch: the
six attention calls of each layer split their queries over the mesh's
ranks (parallel/sp_attention.py), with the JAX seam's -1e9 mask, and every
rank gets the whole output.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.precision import round_operand
from benchmark.reference.regtr.layers import LayerNorm, Linear


def _check_sp_mesh(sp_mesh) -> None:
    if sp_mesh is not None:
        raise ValueError("the reference runs on one device: no sequence-parallel mesh")


def _root(depth: int, like: torch.Tensor) -> torch.Tensor:
    """sqrt(depth) rounded to like's dtype, as flax's `jnp.sqrt(depth).astype(dtype)`;
    a [depth] tensor, so that the division is a true one on the card too
    (CUDA multiplies by the reciprocal of a Python scalar divisor)."""
    return torch.full((depth,), math.sqrt(depth), dtype=torch.float32,
                      device=like.device).to(like.dtype)


def attention_mask(q_valid: torch.Tensor, k_valid: torch.Tensor) -> torch.Tensor:
    """[B, 1, Q, K] boolean mask: both the query and the key are valid."""
    return q_valid[:, None, :, None] & k_valid[:, None, None, :]


class MultiHeadAttention(nn.Module):
    """flax's nn.MultiHeadDotProductAttention: query/key/value/out dense
    layers (head h is features h*hd:(h+1)*hd), q / sqrt(hd) rounded to the
    dtype, masked logits set to finfo(dtype).min, softmax in the dtype."""

    def __init__(self, d_model: int, num_heads: int, compute_dtype: torch.dtype,
                 sp_mesh=None):
        super().__init__()
        self.num_heads = num_heads
        self.compute_dtype = compute_dtype
        self.query, self.key, self.value, self.out = (
            Linear(d_model, d_model, compute_dtype=compute_dtype) for _ in range(4))
        self.sp_attention = None

    operands = "f32"  # the reference's precision (layers.set_operands)

    def rounded(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.operands == "f32" else round_operand(t, self.operands)

    def forward(self, q_in, k_in, v_in, mask: torch.Tensor) -> torch.Tensor:
        b, nq, d = q_in.shape
        h, dt = self.num_heads, self.compute_dtype
        hd = d // h

        def heads(x):  # [B, N, D] -> [B, H, N, hd]
            return x.view(b, -1, h, hd).transpose(1, 2)

        q = heads(self.query(q_in))
        k, v = heads(self.key(k_in)), heads(self.value(v_in))
        if self.sp_attention is not None:
            out = self.sp_attention(q, k, v, mask).transpose(1, 2).reshape(b, nq, d)
            return self.out(out)
        q = q / _root(hd, q)
        r = self.rounded
        logits = r(q @ k.transpose(-1, -2))
        logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
        attn = r(torch.softmax(logits, dim=-1))
        out = r(attn @ v).transpose(1, 2).reshape(b, nq, d)
        return self.out(out)


class CrossEncoderLayer(nn.Module):
    def __init__(self, d_model: int = 256, num_heads: int = 8, dim_feedforward: int = 1024,
                 compute_dtype: torch.dtype = torch.float32, sp_mesh=None):
        super().__init__()
        _check_sp_mesh(sp_mesh)
        dt = compute_dtype
        self.self_attn = MultiHeadAttention(d_model, num_heads, dt, sp_mesh)
        self.cross_attn = MultiHeadAttention(d_model, num_heads, dt, sp_mesh)
        self.norm1, self.norm2, self.norm3 = (LayerNorm(d_model, dt) for _ in range(3))
        self.ffn1 = Linear(d_model, dim_feedforward, compute_dtype=dt)
        self.ffn2 = Linear(dim_feedforward, d_model, compute_dtype=dt)

    def forward(self, src, tgt, src_valid, tgt_valid, src_pos, tgt_pos):
        s2p = self.norm1(src) + src_pos
        src = src + self.self_attn(s2p, s2p, s2p, attention_mask(src_valid, src_valid))
        t2p = self.norm1(tgt) + tgt_pos
        tgt = tgt + self.self_attn(t2p, t2p, t2p, attention_mask(tgt_valid, tgt_valid))

        s2p, t2p = self.norm2(src) + src_pos, self.norm2(tgt) + tgt_pos
        src = src + self.cross_attn(s2p, t2p, t2p, attention_mask(src_valid, tgt_valid))
        tgt = tgt + self.cross_attn(t2p, s2p, s2p, attention_mask(tgt_valid, src_valid))

        src = src + self.ffn2(F.relu(self.ffn1(self.norm3(src))))
        tgt = tgt + self.ffn2(F.relu(self.ffn1(self.norm3(tgt))))
        return src, tgt


class TransformerCrossEncoder(nn.Module):
    def __init__(self, num_layers: int = 6, d_model: int = 256, num_heads: int = 8,
                 dim_feedforward: int = 1024, compute_dtype: torch.dtype = torch.float32,
                 sp_mesh=None):
        super().__init__()
        _check_sp_mesh(sp_mesh)
        self.layers = nn.ModuleList(
            CrossEncoderLayer(d_model, num_heads, dim_feedforward, compute_dtype, sp_mesh)
            for _ in range(num_layers))
        self.final_norm = LayerNorm(d_model, compute_dtype)

    def forward(self, src, tgt, src_valid, tgt_valid, src_pos, tgt_pos):
        """src/tgt: [B, N, D]; valid: [B, N] bool; pos: [B, N, D].
        Returns (src_all, tgt_all): [num_layers, B, N, D], each normalized."""
        src_out, tgt_out = [], []
        for layer in self.layers:
            src, tgt = layer(src, tgt, src_valid, tgt_valid, src_pos, tgt_pos)
            src_out.append(self.final_norm(src))
            tgt_out.append(self.final_norm(tgt))
        return torch.stack(src_out), torch.stack(tgt_out)


class CorrespondenceDecoder(nn.Module):
    """Single-head attention onto the other cloud's coordinates (keys
    masked with -1e9) and a sigmoid overlap head on the features."""

    def __init__(self, d_model: int = 256, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.q_proj = Linear(d_model, d_model, compute_dtype=compute_dtype)
        self.k_proj = Linear(d_model, d_model, compute_dtype=compute_dtype)
        self.conf_logits_decoder = Linear(d_model, 1, compute_dtype=compute_dtype)

    def _attend(self, query, key, value, k_valid):
        # query/key: [L, B, N, D]; value: [B, S, 3] f32
        q = self.q_proj(query) / _root(query.shape[-1], query)
        k = self.k_proj(key)
        attn = self.q_proj.rounded(q @ k.transpose(-1, -2))
        attn = torch.where(k_valid[None, :, None, :], attn, -1e9)
        attn = self.q_proj.rounded(torch.softmax(attn, dim=-1))
        # JAX promotes the (bf16) attention with the f32 coordinates to f32
        dt = torch.promote_types(attn.dtype, value.dtype)
        return attn.to(dt) @ value.to(dt)

    def forward(self, src_feats, tgt_feats, src_xyz, tgt_xyz, src_valid, tgt_valid,
                src_pos, tgt_pos):
        """src_feats/tgt_feats: [L, B, N, D]. Returns (src_corr [L, B, N, 3],
        tgt_corr, src_overlap [L, B, N], tgt_overlap)."""
        src_q = src_feats + src_pos[None]
        tgt_q = tgt_feats + tgt_pos[None]
        src_corr = self._attend(src_q, tgt_q, tgt_xyz, tgt_valid)
        tgt_corr = self._attend(tgt_q, src_q, src_xyz, src_valid)
        src_overlap = torch.sigmoid(self.conf_logits_decoder(src_feats)[..., 0])
        tgt_overlap = torch.sigmoid(self.conf_logits_decoder(tgt_feats)[..., 0])
        return src_corr, tgt_corr, src_overlap, tgt_overlap
