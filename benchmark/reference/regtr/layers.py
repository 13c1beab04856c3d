"""Layers with flax.linen's numerics, for the registration model (a
frozen copy of dregnerf_tpu_torch/models/layers.py; the reference runs
them in f32, and `set_operands` computes them one precision down for the
control).

The JAX package's modules take a compute `dtype` (bf16 by default in
stage 3) over f32 parameters. Flax then:
  - casts a convolution's or dense layer's input, kernel and bias to the
    dtype, and adds the bias after the product, in the dtype;
  - computes a norm's statistics in f32 as E[x^2] - E[x]^2 (clamped at 0),
    normalizes and applies scale and bias in f32, and returns the dtype;
    the default epsilon is 1e-6 (torch's is 1e-5).
These layers do the same with explicit casts (no autocast, whose softmax
and norms differ). Parameters stay f32; `compute_dtype` is the dtype.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.precision import round_operand

EPS = 1e-6  # flax's LayerNorm and GroupNorm default


class Conv3d(nn.Conv3d):
    """nn.Conv3d (NCDHW) computing in `compute_dtype` as flax's nn.Conv does."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, bias=bias)
        self.compute_dtype = compute_dtype

    operands = "f32"  # the reference's operand rounding (precision.py)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.operands != "f32":
            y = F.conv3d(round_operand(x, self.operands), round_operand(self.weight, self.operands),
                         None, self.stride, self.padding)
            y = y + self.bias.view(1, -1, 1, 1, 1) if self.bias is not None else y
            return round_operand(y, self.operands)
        if dt == torch.bfloat16 and x.device.type == "cpu":
            # oneDNN's bf16 conv3d weight gradient on the CPU returns garbage
            # (up to 1e27, varying from call to call) when the input is
            # smaller than the kernel, as in the deepest blocks at R = 16:
            # on the CPU, the bf16 operands' products are summed in f32 and
            # rounded once to bf16, as cuDNN's bf16 kernels do on the card
            y = F.conv3d(x.to(dt).float(), self.weight.to(dt).float(), None, self.stride,
                         self.padding).to(dt)
        else:
            y = F.conv3d(x.to(dt), self.weight.to(dt), None, self.stride, self.padding)
        if self.bias is not None:
            y = y + self.bias.to(dt).view(1, -1, 1, 1, 1)
        return y


class Linear(nn.Linear):
    """nn.Linear computing in `compute_dtype` as flax's nn.Dense does."""

    def rounded(self, t: torch.Tensor) -> torch.Tensor:
        """t in this layer's reference precision (the attention products
        that follow it)."""
        return t if self.operands == "f32" else round_operand(t, self.operands)

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    operands = "f32"  # the reference's operand rounding (precision.py)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.operands != "f32":
            y = F.linear(round_operand(x, self.operands), round_operand(self.weight, self.operands))
            return round_operand(y + self.bias if self.bias is not None else y, self.operands)
        y = F.linear(x.to(dt), self.weight.to(dt))
        return y + self.bias.to(dt) if self.bias is not None else y


def _normalize(xf: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
               weight: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """flax's `_normalize` on the f32 input: (x - mean) * (rsqrt(var + eps) * scale) + bias."""
    return (xf - mean) * (torch.rsqrt(var + eps) * weight) + bias


class GroupNorm(nn.Module):
    """flax's nn.GroupNorm(num_groups=min(32, C)) on NCDHW (or NC...) input."""

    operands = "f32"

    def __init__(self, channels: int, compute_dtype: torch.dtype = torch.float32,
                 eps: float = EPS):
        super().__init__()
        self.num_groups = min(32, channels)
        self.eps = eps
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        g = self.num_groups
        xf = x.float().reshape(b, g, -1)
        mean = xf.mean(dim=-1)
        var = ((xf * xf).mean(dim=-1) - mean * mean).clamp(min=0.0)
        per_channel = (b, c) + (1,) * (x.ndim - 2)
        mean = mean.repeat_interleave(c // g, dim=1).view(per_channel)
        var = var.repeat_interleave(c // g, dim=1).view(per_channel)
        channel = (c,) + (1,) * (x.ndim - 2)
        y = _normalize(xf.reshape(x.shape), mean, var, self.weight.view(channel),
                       self.bias.view(channel), self.eps)
        return round_operand(y, self.operands) if self.operands != "f32" else y.to(
            self.compute_dtype)


class LayerNorm(nn.Module):
    """flax's nn.LayerNorm over the last dim."""

    operands = "f32"

    def __init__(self, features: int, compute_dtype: torch.dtype = torch.float32,
                 eps: float = EPS):
        super().__init__()
        self.eps = eps
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp(min=0.0)
        y = _normalize(xf, mean, var, self.weight, self.bias, self.eps)
        return round_operand(y, self.operands) if self.operands != "f32" else y.to(
            self.compute_dtype)


def set_operands(model: nn.Module, precision: str) -> None:
    """Compute `model` in `precision` as flax computes in its dtype: every
    Conv3d's and Linear's inputs, kernel and output, every norm's output,
    and the attention's logits, weights and output, rounded to `precision`
    (precision.round_operand); products and sums in f32."""
    for m in model.modules():
        if isinstance(m, (Conv3d, Linear, GroupNorm, LayerNorm)) or hasattr(m, "rounded"):
            m.operands = precision
