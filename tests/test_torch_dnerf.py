"""D-NeRF at its published widths on the port's normal stage-1 path
(`--field dnerf`, `--field_lr`) against the benchmark's plain reference
(benchmark/reference/dnerf.py); the MLP field's spans and counters; the
learning-rate flag; and the time-varying scene of the cell
dnerf-8x256.train (benchmark/traffic/dynamic.py).

The reference imports nothing of the program. The field runs at the
configuration's widths (8x256 trunk, 4x64 warp) and at chip_smoke's
FIELDS_SMALL; the scene, the sample buffer and the occupancy grid shrink.
Torch runs on one thread. About 15 s alone."""
import json
import os
import types

import numpy as np
import pytest
import torch

from benchmark.drivers import dnerf_train, ngp_block, ngp_train
from benchmark.reference import dnerf as ref
from benchmark.traffic import dynamic
from chip_smoke import FIELDS_SMALL
from dregnerf_tpu_torch.models import fields as tfields
from dregnerf_tpu_torch.models import mlp_nerf as tmlp
from dregnerf_tpu_torch.models import ngp as tngp
from dregnerf_tpu_torch.runtime import ngp_trainer as TT
from dregnerf_tpu_torch.runtime import profiling
from dregnerf_tpu_torch.runtime.config import config_parser
from torch_graph_common import tiny_ngp_trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 3000000001
TINY = {"sample_budget": 2048, "max_march_steps": 64, "grid_resolution": 16,
        "init_num_rays": 32, "max_num_rays": 32}
SCENE = {"family": "moving_spheres", "scene_seed": 7, "views": 4, "image_size": 16,
         "camera_distance": 3.0, "fov_x": 0.9, "max_offset": 0.15}
AABB = torch.tensor([-1.0, -1.0, -1.0, 1.0, 1.0, 1.0])


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one intra-op thread while the module runs: the steps are
    many small operations on a few thousand samples, and the tier-1 run
    shares the cores between several test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def empty_store():
    profiling.reset()
    yield
    profiling.reset()


def cell_config(**over) -> dict:
    with open(os.path.join(ROOT, "benchmark", "configs", "dnerf-8x256.json")) as f:
        return {**json.load(f), **TINY, **over}


def dnerf_trainer(out, cfg: dict):
    """(trainer, scene, weights, jitter) built as the cell builds them."""
    return dnerf_train.build(cfg, SCENE, SEED, "cpu", str(out))


def test_the_field_matches_the_reference():
    """The port's dnerf field at FIELDS_SMALL with a time a point, in f32,
    against the reference: sigma and rgb within 1e-5 of their max (the same
    f32 operations; some points lie outside the aabb, where sigma is 0)."""
    mc = tmlp.VanillaNeRFConfig(**FIELDS_SMALL, warp=True)
    cfg = {**FIELDS_SMALL, "skip_layer": mc.skip_layer, "bottleneck_width": mc.net_width}
    params = tmlp.init_vanilla_nerf(mc, torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)
    x = torch.rand(2000, 3, generator=g) * 2.2 - 1.1
    t = torch.rand(2000, 1, generator=g)
    d = torch.nn.functional.normalize(torch.randn(2000, 3, generator=g), dim=-1)
    rgb, sigma = tfields.get_field("dnerf").forward(params, x, d, AABB, mc, t=t)
    field = ref.Field(cfg, "f32")
    want_sigma, feat = field.density(params, x, AABB, return_feat=True, t=t)
    want_rgb = field.rgb(params, d, feat)
    assert (sigma == 0).any() and (sigma > 0).any()
    for got, want in ((sigma, want_sigma), (rgb, want_rgb)):
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


# (loss_gap, grad_gap, update_gap) bounds of one step: the program and the
# reference run the same f32 products in the same order on the CPU, and
# differ only in the order of the compositor's and the marcher's sums, so
# the loss agrees to f32 rounding (1e-6) and the first gradient's norms to
# 1e-5; Adam's first update moves every element by lr times the sign of
# its gradient, whatever the gradient's size, so an element whose gradient
# is a rounding error can flip: the change's norms within 1e-4. In bf16 a
# rounding difference can also move an operand by a bf16 ulp (2^-8): the
# same bounds hold (measured: the three gaps at most 2e-8 either way).
STEP_TOL = {"loss_gap": 1e-6, "grad_gap": 1e-5, "update_gap": 1e-4}


@pytest.mark.parametrize("operands", ["float32", "bfloat16"])
def test_one_trainer_step_matches_the_reference(tmp_path, operands):
    """One NGPTrainer step under --field dnerf at the configuration's
    widths and lr (32 rays of the dynamic scene, a 2048-sample buffer)
    against the reference's train_steps on the same weights, jitter and
    draws, compared as the cell compares them."""
    cfg = cell_config(mlp_operands=operands)
    tr, scene, weights, noise = dnerf_trainer(tmp_path, cfg)
    assert tr.timestamps is not None
    draws = ngp_block.draw(torch.Generator().manual_seed(3), tr.num_rays, scene, "cpu")
    loss = float(tr.train_iteration(1, draws)["loss"])
    first = {k: tr.optimizer.state[p]["exp_avg"] / 0.1 for k, p in ref.leaves(tr.params).items()}
    init = ref.leaves(weights)
    update = {k: p.detach() - init[k] for k, p in ref.leaves(tr.params).items()}
    state = types.SimpleNamespace(weights=weights, noise=noise, draws=[draws], scene=scene)
    ctx = types.SimpleNamespace(config=cfg, device=torch.device("cpu"))
    precision = {"float32": "f32", "bfloat16": "bf16"}[operands]
    reference = dnerf_train.reference_readings(state, ctx, precision)
    norms = {k: float(v.double().norm()) for k, v in first.items()}
    gaps = ngp_train.compare(([loss], norms, {k: float(v.double().norm())
                                              for k, v in update.items()}), reference)
    assert all(gaps[k] <= STEP_TOL[k] for k in STEP_TOL), gaps
    assert all(v > 0 for v in norms.values())  # every layer, the warp's too, has a gradient


def test_the_field_counts_its_rows_and_spans_its_parts():
    mc = tmlp.VanillaNeRFConfig(**FIELDS_SMALL, warp=True)
    params = tmlp.init_vanilla_nerf(mc, torch.Generator().manual_seed(0), "cpu")
    x, t, d = torch.rand(4, 5, 3), torch.rand(4, 5, 1), torch.rand(4, 5, 3)
    tmlp.forward(params, x, d, mc, t=t)
    assert profiling.snapshot() == {"spans": {}, "counters": {}}  # off without a profiler
    with torch.profiler.profile():
        tmlp.forward(params, x, d, mc, t=t)
        tmlp.query_density(params, x[0], mc)  # at no time: not warped
    snap = profiling.snapshot()
    assert snap["counters"] == {"mlp.rows": 25, "mlp.warp_rows": 20}
    assert {k: v["calls"] for k, v in snap["spans"].items()} == {
        "mlp.warp": 1, "mlp.trunk": 2, "mlp.color": 1}


def test_a_traced_step_counts_the_buffer_and_the_update(tmp_path):
    """A step with an occupancy update under a profiler: every buffer row
    through the trunk and the warp; the update's points (all 16^3 cells,
    below step 256) through the trunk at no time. The counters are what
    warp_share.dnerf_train reads."""
    tr, _, _, _ = dnerf_trainer(tmp_path, cell_config())
    with torch.profiler.profile():
        tr.train_iteration(16)
    counters = profiling.snapshot()["counters"]
    assert counters["mlp.warp_rows"] == TINY["sample_budget"]
    assert counters["mlp.rows"] == TINY["sample_budget"] + TINY["grid_resolution"] ** 3


def test_the_lr_flag_reaches_adam_and_the_schedule(tmp_path):
    assert config_parser([]).field_lr == TT.BASE_LR == 1e-2
    tr, _, _, _ = dnerf_trainer(tmp_path, cell_config())
    assert tr.optimizer.param_groups[0]["lr"] == tr.lr_at(0) == 5e-4
    assert tr.lr_at(tr.config.max_iterations // 2) == pytest.approx(5e-4 * 0.33, rel=1e-12)
    with pytest.raises(ValueError, match="is not the configuration's"):
        dnerf_train.check_layout(tr, cell_config(lr=1e-2))


def test_the_default_lr_leaves_an_ngp_step_bit_for_bit(tmp_path):
    """Two NGP steps at the flag's default against the same steps under
    the optimizer the trainer built before the flag: Adam at BASE_LR and
    the multistep schedule of BASE_LR."""
    a, b = tiny_ngp_trainer(tmp_path / "a"), tiny_ngp_trainer(tmp_path / "b")
    b.lr_at = TT.multistep_lr(TT.BASE_LR, b.config.max_iterations)
    b.optimizer = torch.optim.Adam(tngp.parameters(b.params), lr=TT.BASE_LR,
                                   betas=(0.9, 0.999), eps=1e-15)
    for tr in (a, b):
        for step in (1, 2):
            tr.train_iteration(step)
    for p, q in zip(tngp.parameters(a.params), tngp.parameters(b.params)):
        assert torch.equal(p, q)


def test_the_dynamic_scene():
    """Deterministic from its seed; view i at time i / 99; the central
    sphere still, the others moved by at most max_offset and inside the
    aabb at every time (the motion is linear: its ends suffice)."""
    scene = {**SCENE, "views": 100, "image_size": 8}
    first, second = dynamic.block_views(scene), dynamic.block_views(scene)
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a, b)
    images, c2w, K, times = first
    assert images.shape == (100, 8, 8, 4) and c2w.shape == (100, 4, 4)
    np.testing.assert_array_equal(times, (np.arange(100) / 99).astype(np.float32))
    shapes, offsets = dynamic.moving_spheres(7, 0.15)
    assert not offsets[0].any() and (np.linalg.norm(offsets, axis=1) <= 0.15).all()
    assert np.linalg.norm(offsets[1:], axis=1).min() > 0
    for t in (0.0, 1.0):
        for center, radius, _ in dynamic.shapes_at(shapes, offsets, t):
            assert np.abs(center).max() + radius < 1.0
    data = dnerf_train.scene_data({**SCENE, "views": 3})
    np.testing.assert_array_equal(data.timestamps, [0.0, 0.5, 1.0])
    assert data.near == 0.0 and data.far == 1e10
