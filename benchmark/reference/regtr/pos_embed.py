"""Position embeddings of continuous 3D coordinates (port of
dregnerf_tpu/models/pos_embed.py): the sine embedding (temperature 1000,
scale * 2 pi) and a learned two-layer alternative. Both compute in f32."""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.regtr.layers import Linear


class PositionEmbeddingCoordsSine(nn.Module):
    """Per axis, num_pos_feats = d_model // n_dim // 2 * 2 features (84 at
    d = 256): sin of the even and cos of the odd frequency columns,
    interleaved (sin f0, cos f1, sin f2, ...); the axes follow one another
    and zero columns pad to d_model (4 at d = 256)."""

    def __init__(self, n_dim: int = 3, d_model: int = 256, temperature: float = 1000.0,
                 scale: float = 1.0):
        super().__init__()
        self.n_dim, self.d_model = n_dim, d_model
        self.temperature, self.scale = temperature, scale

    def forward(self, xyz: torch.Tensor) -> torch.Tensor:
        num_pos_feats = self.d_model // self.n_dim // 2 * 2
        padding = self.d_model - num_pos_feats * self.n_dim
        dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=xyz.device)
        dim_t = self.temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                                     / num_pos_feats)
        x = xyz.float() * (self.scale * 2 * math.pi)
        pos = x[..., None] / dim_t  # [..., n_dim, num_pos_feats]
        emb = torch.stack([torch.sin(pos[..., 0::2]), torch.cos(pos[..., 1::2])], dim=-1)
        emb = emb.reshape(*x.shape[:-1], -1)
        return F.pad(emb, (0, padding)) if padding else emb


class PositionEmbeddingLearned(nn.Module):
    """Dense(d_model) -> tanh-approximated GELU (flax's default) -> Dense(d_model)."""

    def __init__(self, n_dim: int = 3, d_model: int = 256):
        super().__init__()
        self.dense = nn.ModuleList([Linear(n_dim, d_model), Linear(d_model, d_model)])

    def forward(self, xyz: torch.Tensor) -> torch.Tensor:
        h = F.gelu(self.dense[0](xyz.float()), approximate="tanh")
        return self.dense[1](h)
