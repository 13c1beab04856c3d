"""The FLOP and byte counts against hand sums and against the reference
model's own convolutions."""
from __future__ import annotations

import json
import os

import torch

from benchmark.harness import counts
from benchmark.tests.tiny import ROOT


def _cfg(name):
    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as f:
        return json.load(f)


def test_ngp_counts_by_hand():
    c = _cfg("ngp-l4f8")
    assert counts.ngp_density_macs(c) == 32 * 64 + 64 * 16
    assert counts.ngp_color_macs(c) == 31 * 64 + 64 * 64 + 64 * 3
    assert counts.ngp_encode_flops(c) == 2 * 8 * 4 * 8
    assert counts.ngp_train_sample_flops(c) == 6 * (3072 + 6272) + 2 * 512
    assert counts.ngp_density_point_flops(c) == 2 * 3072 + 512
    assert counts.level_table_rows(c) == [16**3, 1 << 19, 1 << 19, 1 << 19]
    assert counts.packed_row_width(c) == 64


def test_kernel_bytes_by_hand():
    n, w = 1 << 18, 64
    assert counts.k2p_bytes(n, w) == 4 * n + 4 * n * w
    assert counts.k1p_bytes(n, w, 1 << 19) == 4 * n + 4 * n * w + 2 * (1 << 19) * w
    assert counts.k1p_bytes(0, w, 4096) == 2 * 4096 * w


def test_ngp_step_bytes_count_the_live_samples():
    """A step's kernel bytes follow its live samples (clamped to the
    buffer), not the buffer; an occupancy step adds its K2p gathers."""
    from benchmark.drivers.ngp_train import _record

    c = _cfg("ngp-l4f8")
    w, buf, n_occ = 64, 1 << 18, 2 * (1 << 17)
    rec = _record(c, [1000, 1 << 20, 7], [15, 16, 17], 2)
    k1p = sum(3 * counts.k1p_bytes(n, w, 1 << 19) + counts.k1p_bytes(0, w, 16**3)
              for n in (1000, buf))
    k2p = sum(4 * counts.k2p_bytes(n, w) for n in (1000, buf)) + 4 * counts.k2p_bytes(n_occ, w)
    assert rec["bytes"] == {"k1p": k1p, "k2p": k2p}
    assert rec["flops"] == ((1000 + buf) * counts.ngp_train_sample_flops(c)
                            + n_occ * counts.ngp_density_point_flops(c))
    assert rec["units"] == 2


def test_fpn_count_matches_the_reference_convolutions():
    """At 16^3, the analytic multiply-adds of every FPN convolution equal
    those of the reference model's Conv3d calls, read by hooks."""
    from benchmark.reference.regtr.resnet3d import FeaturePyramid3D

    c = _cfg("regtr-r50")
    fpn = FeaturePyramid3D("resnet50", c["d_model"])
    macs = []

    def hook(m, inp, out):
        macs.append(out.numel() // out.shape[0] * m.in_channels * m.kernel_size[0] ** 3)

    for m in fpn.modules():
        if isinstance(m, torch.nn.Conv3d):
            m.register_forward_hook(hook)
    with torch.no_grad():
        fpn(torch.zeros(1, 4, 16, 16, 16))
    assert sum(macs) == sum(m for _, m in counts.regtr_fpn_convs(c, 16))
    assert len(macs) == len(counts.regtr_fpn_convs(c, 16))


def test_regtr_flops_by_hand():
    c = _cfg("regtr-r50")
    convs = counts.regtr_fpn_convs(c, 128)
    assert convs[0] == ("stem", 64**3 * 4 * 64 * 125)
    total = sum(m for _, m in convs)
    assert counts.regtr_forward_flops(c, 128) == 4 * total
    assert counts.regtr_train_flops(c, 128) == 4 * (3 * total - convs[0][1])
