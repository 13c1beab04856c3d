"""Sequence-parallel attention for the registration cross-encoder (port of
dregnerf_tpu/parallel/sp_attention.py).

Queries (tokens) are split over the ranks of a mesh and keys/values are
gathered whole onto every rank, one all_gather a call (head sharding is
not needed at d_model 256); the softmax and the weighted sum are then
local. The result is exactly that of unsharded attention: masked logits
are -1e9, the logits are divided by sqrt(head dim) rounded to the dtype,
as the JAX seam computes them.

Two forms, as in JAX:
  * `sharded_attention` takes and returns a rank's rows (JAX's sharded
    arrays): each rank passes its slice of q, k, v and the masks, and gets
    its slice of the output;
  * `sp_attention_fn(mesh)` is the model's switch (the cross-encoder's
    `sp_mesh`). A JAX array is one global view, but each torch rank holds
    the whole, equal inputs, so here every rank computes its query rows
    against the keys and values it already holds, and the gather comes
    after: an all_gather of the output rows gives every rank the full
    output, equal to local attention. Its backward keeps that contract:
    each rank's key/value gradients are summed over the ranks and the
    query gradients gathered, so every rank holds the full gradient.
"""
from __future__ import annotations

import math

import torch

from dregnerf_tpu_torch.parallel.mesh import Mesh

MASKED_LOGIT = -1e9


def _scale(depth: int, like: torch.Tensor) -> torch.Tensor:
    """sqrt(depth) rounded to like's dtype, as a one-element tensor (a true
    division on the card, as models/transformer.py::_root)."""
    return torch.full((1,), math.sqrt(depth), dtype=torch.float32,
                      device=like.device).to(like.dtype)


class _GatherRows(torch.autograd.Function):
    """all_gather of every rank's rows; the adjoint of a sharded gather:
    the summed gradient's rows of this rank."""

    @staticmethod
    def forward(ctx, mesh, x, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return mesh.all_gather_rows(x, dim)

    @staticmethod
    def backward(ctx, g):
        g = ctx.mesh.all_reduce_sum_(g.contiguous().clone())
        return None, ctx.mesh.shard(g, ctx.dim), None


def _attend(q, k, v, mask):
    """q [B, H, Q, hd], k/v [B, H, K, hd], mask [B, 1|H, Q, K] bool."""
    logits = (q @ k.transpose(-1, -2)) / _scale(q.shape[-1], q)
    logits = torch.where(mask, logits, torch.tensor(MASKED_LOGIT, dtype=logits.dtype,
                                                    device=logits.device))
    return torch.softmax(logits, dim=-1) @ v


def sharded_attention(mesh: Mesh, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_valid: torch.Tensor, k_valid: torch.Tensor,
                      num_heads: int = 8) -> torch.Tensor:
    """Multi-head attention with the token axis split over the ranks.

    q/k/v: this rank's rows [N_q / n, D], [N_kv / n, D]; q_valid, k_valid
    its rows of the [N] bool masks. Returns this rank's rows [N_q / n, D].
    No projection (the caller projects)."""
    d = q.shape[-1]
    k_full = _GatherRows.apply(mesh, k, 0)
    v_full = _GatherRows.apply(mesh, v, 0)
    kv_full = mesh.all_gather_rows(k_valid)
    qh, kh, vh = (x.reshape(x.shape[0], num_heads, d // num_heads).transpose(0, 1)[None]
                  for x in (q, k_full, v_full))
    out = _attend(qh, kh, vh, kv_full[None, None, None, :])[0]
    return out.transpose(0, 1).reshape(q.shape[0], d) * q_valid[:, None]


class _SPAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, q, k, v, mask):
        ctx.mesh = mesh
        ctx.save_for_backward(q, k, v, mask)
        return mesh.all_gather_rows(_attend(mesh.shard(q, 2), k, v, mesh.shard(mask, 2)), 2)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        q, k, v, mask = ctx.saved_tensors
        with torch.enable_grad():
            ql, kk, vv = (x.detach().requires_grad_(True) for x in (mesh.shard(q, 2), k, v))
            out = _attend(ql, kk, vv, mesh.shard(mask, 2))
            dq, dk, dv = torch.autograd.grad(out, (ql, kk, vv), mesh.shard(g, 2))
        dkv = mesh.all_reduce_sum_(torch.stack([dk, dv]))
        return None, mesh.all_gather_rows(dq, 2), dkv[0], dkv[1], None


def sp_attention_fn(mesh: Mesh):
    """The attention core of models/transformer.py::MultiHeadAttention over
    `mesh`: (q [B, H, Q, hd] projected and not yet scaled, k, v [B, H, K,
    hd], mask [B, 1, Q, K]) -> [B, H, Q, hd] whole on every rank. Q must
    divide by the mesh size (the model pads tokens to a power of two)."""

    def attention(q, k, v, mask):
        return _SPAttention.apply(mesh, q, k, v, mask.expand(-1, -1, q.shape[2], -1))

    return attention
