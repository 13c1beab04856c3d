"""Bytes that K6, the xor-hash grid encoder of the port
(dregnerf_tpu_torch/csrc/hash_grid.cu), surely needs for `n` points of a
configuration, as benchmark/harness/counts.py counts the other kernels:
the least the inputs need, so that a share read against these cannot pass
100 %. Each point's 8 corner rows a level, read or added, are not counted:
how many of them are distinct the benchmark cannot see."""
from __future__ import annotations


def encoding_floats(cfg: dict) -> int:
    """Floats of one point's encoding: every level's features."""
    g = cfg["grid"]
    return g["n_levels"] * g["n_features"]


def k6_forward_bytes(n: int, cfg: dict) -> int:
    """The forward: the f32 positions read and the encoding written as the
    MLP's bf16 operands."""
    return n * (12 + 2 * encoding_floats(cfg))


def k6_backward_bytes(n: int, cfg: dict) -> int:
    """The backward: the f32 positions and the f32 gradient of the encoding
    read."""
    return n * (12 + 4 * encoding_floats(cfg))
