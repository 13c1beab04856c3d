"""Operand rounding of the references' products.

"f32" leaves operands as they are; "bf16" rounds them to bfloat16 (the
products of two bf16 values are exact in f32, so the sums stay f32, as
in a bf16 kernel that accumulates in f32); "fp8" rounds them to float8
e4m3 after scaling each tensor by its largest magnitude (per-tensor
scaling, as fp8 training and inference do): the control, one precision
below a configuration that states bf16.
"""
from __future__ import annotations

import torch

FP8_MAX = 448.0  # largest finite float8 e4m3fn


def round_operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """x rounded to `precision` and returned in f32."""
    if precision == "f32":
        return x.float()
    if precision == "bf16":
        return x.to(torch.bfloat16).float()
    if precision == "fp8":
        return _Fp8.apply(x.float())
    raise ValueError(f"unknown precision {precision!r}")


class _Fp8(torch.autograd.Function):
    """Per-tensor scaled e4m3 rounding, the gradient passed straight
    through (as a cast's)."""

    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale

    @staticmethod
    def backward(ctx, g):
        return g


def no_tf32():
    """The references' products in true f32 (TF32 off for matmuls and
    cuDNN convolutions); returns a restore function."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def restore():
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old

    return restore
