"""FLOPs of the frequency-encoded D-NeRF field (the warp, the canonical
trunk and its heads; the layers of benchmark/reference/dnerf.py), from a
configuration's widths, as benchmark/harness/counts.py counts the NGP
field: the least each live sample surely needs, so that a share read
against these cannot pass 100 %. Only the products count: the encodings,
activations and bias adds are left out."""
from __future__ import annotations

from benchmark.reference.dnerf import layer_shapes


def _macs(shapes) -> int:
    return sum(a * b for a, b in shapes)


def _groups(cfg: dict) -> dict:
    """{group: [(in, out)]}, every group as a list."""
    return {k: v if isinstance(v, list) else [v] for k, v in layer_shapes(cfg).items()}


def forward_macs(cfg: dict) -> int:
    """Multiply-adds of one sample through the warp, the trunk and the heads."""
    return sum(_macs(v) for v in _groups(cfg).values())


def train_sample_flops(cfg: dict) -> int:
    """One marched sample of a training step: every product forward (2 FLOPs
    a multiply-add) and backward (the input's and the weight's gradient, 4),
    less the input gradient of the warp's first layer, whose inputs (the
    encoded positions and times) want none."""
    a, b = layer_shapes(cfg)["warp"][0]
    return 6 * forward_macs(cfg) - 2 * a * b


def density_point_flops(cfg: dict) -> int:
    """One point of an occupancy update, forward only: the trunk and the
    sigma head at no time (no warp)."""
    g = _groups(cfg)
    return 2 * (_macs(g["trunk"]) + _macs(g["sigma"]))
