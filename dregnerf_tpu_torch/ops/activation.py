"""Activations with custom gradients (port of dregnerf_tpu/ops/activation.py).

`trunc_exp`: forward exp(x); backward g * exp(min(x, 15)), so density
gradients cannot explode. The NGP density activation is trunc_exp(x - 1).
"""
from __future__ import annotations

import torch


class TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, max=15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return TruncExp.apply(x)


def density_activation(x: torch.Tensor) -> torch.Tensor:
    """NGP default density activation: trunc_exp(x - 1)."""
    return trunc_exp(x - 1.0)
