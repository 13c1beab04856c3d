"""The xor-hash NGP on the port's normal stage-1 path (`--encoder xor_hash`)
against the benchmark's plain reference (benchmark/reference/ngp_hash.py),
K6's autograd wrapper with its launches stood in for on the CPU, and the
byte counts of K6 (benchmark/harness/hash_counts.py).

The reference imports nothing of the program; the port's CPU path takes
the plain encoder. The small grid is 4 levels of 2^13 rows: level 0
(16^3 vertices) dense, levels 1-3 hashed."""
import dataclasses
import json
import os
import types

import pytest
import torch

from benchmark.drivers import ngp_block, ngp_hash_train, ngp_train
from benchmark.harness import counts, hash_counts
from benchmark.reference import ngp_hash
from benchmark.tests.tiny import NGP_CFG, NGP_SCENE, ROOT
from dregnerf_tpu_torch.models import ngp as tngp
from dregnerf_tpu_torch.ops import hash_encoding as H
from dregnerf_tpu_torch.runtime import ngp_trainer as TT
from dregnerf_tpu_torch.runtime import profiling
from dregnerf_tpu_torch.runtime.config import config_parser
from torch_reg_common import few_torch_threads  # noqa: F401 (fixture)

SMALL = H.HashGridConfig(n_levels=4, log2_table_size=13)
SEED = 3000000001


def bench_config(grid: H.HashGridConfig = SMALL) -> dict:
    """The cell's configuration at the tiny sizes, with `grid` (and the
    density MLP's input as wide as its encoding)."""
    with open(os.path.join(ROOT, "benchmark", "configs", "ngp-hash-l16f2.json")) as f:
        cfg = {**json.load(f), **NGP_CFG}
    return {**cfg, "grid": {"encoder": "xor_hash", **dataclasses.asdict(grid)},
            "density_mlp": [grid.out_dim, *cfg["density_mlp"][1:]]}


def flags(out, extra=()):
    return ngp_hash_train.program_flags(bench_config(), SEED, str(out)) + [
        "--device", "cpu", *extra]


def small_trainer(out, grid: H.HashGridConfig = SMALL) -> TT.NGPTrainer:
    """A trainer built through `--encoder xor_hash`, its grid then cut to
    `grid` (the published one is 2^23 rows)."""
    tr = TT.NGPTrainer(config_parser(flags(out)), ngp_block.scene_data(NGP_SCENE),
                       output_dir=str(out), device="cpu")
    tr.model_config = dataclasses.replace(tr.model_config, grid=grid)
    tr.init_params(torch.Generator().manual_seed(0))
    tr.setup_optimizer()
    return tr


def test_the_encoder_flag_parses():
    assert config_parser([]).encoder == "packed"
    assert config_parser(["--encoder", "xor_hash"]).encoder == "xor_hash"
    with pytest.raises(SystemExit):
        config_parser(["--encoder", "hash"])


@pytest.mark.parametrize("encoder", ["packed", "xor_hash"])
def test_build_networks_builds_the_encoders_grid(tmp_path, encoder):
    cfg = config_parser(flags(tmp_path, ["--encoder", encoder]))
    tr = TT.NGPTrainer(cfg, ngp_block.scene_data(NGP_SCENE), output_dir=str(tmp_path),
                       device="cpu")
    mc = tr.model_config
    assert mc.compute_dtype == torch.bfloat16 and not mc.unbounded
    if encoder == "xor_hash":
        assert mc.grid == H.HashGridConfig()
        assert tuple(tr.params["table"].shape) == (16 << 19, 2)
    else:
        assert mc.grid.n_levels == 4 and mc.grid.grad_accum == "bf16"
        assert mc.grid.rle_step_u > 0
    assert tngp.config_from_meta(tngp.config_to_meta(mc)) == mc


def test_a_hash_checkpoint_round_trips(tmp_path):
    tr = small_trainer(tmp_path)
    tr.train_iteration(1)
    tr.save_checkpoint(2)
    path = os.path.join(tr.output_dir, "model", "model.ckpt")
    params, _, meta, mc, _ = TT.load_field_from_checkpoint(path, "cpu")
    assert meta["model_config"]["encoder"] == "xor_hash" and mc == tr.model_config
    assert torch.equal(params["table"], tr.params["table"].detach())
    resumed = small_trainer(tmp_path)
    resumed.config.ckpt_path = path
    assert resumed.load_checkpoint() == 2
    assert torch.equal(resumed.params["table"], tr.params["table"].detach())


def test_reference_encoder_matches_the_port():
    """ngp_hash.Field.encode and its table gradient against the port's plain
    hash_encode within 1e-6 of their max (the same f32 products, the
    8-corner sums and the scatter's adds in another order); corners past
    the faces are clamped by both."""
    field = ngp_hash.Field(bench_config())
    g = torch.Generator().manual_seed(1)
    x = torch.rand(3000, 3, generator=g) * 1.1 - 0.05
    table = torch.rand(4 << 13, 2, generator=g) * 2 - 1
    cot = torch.randn(3000, 8, generator=g)
    outs = []
    for encode in (lambda t: field.encode(t, x), lambda t: H.hash_encode(t, x, SMALL)):
        t = table.clone().requires_grad_(True)
        out = encode(t)
        out.backward(cot)
        outs.append((out.detach(), t.grad))
    (want, want_g), (got, got_g) = outs
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()
    assert (got_g - want_g).abs().max() <= 1e-6 * want_g.abs().max()


def test_hash_trainer_steps_match_the_reference(tmp_path):
    """Three NGPTrainer steps under --encoder xor_hash on the CPU (64 rays)
    against the reference's train_steps from the same weights, occupancy
    jitter and draws, compared as the cell compares them. Both run the
    same f32 arithmetic with bf16 MLP operands, in other orders of their
    sums: the losses within 1e-6 (the cell's CPU run reads 0), the first
    gradients' norms within 1e-5 and the changes' within 1e-4 (Adam's first
    steps divide by sqrt(v), which amplifies f32 rounding where a gradient
    is small)."""
    cfg = bench_config()
    tr = small_trainer(tmp_path)
    weights = ngp_hash_train.draw_weights(cfg, SEED, "cpu")
    ngp_block.load_weights(tr, weights)
    noise = torch.rand(16**3, 3, generator=torch.Generator().manual_seed(2)) - 0.5
    tr.update_occupancy(0, noise=noise)
    gen = torch.Generator().manual_seed(3)
    draws, losses = [], []
    for step in range(1, 4):
        draws.append(ngp_block.draw(gen, tr.num_rays, tr.scene, "cpu"))
        losses.append(float(tr.train_iteration(step, draws[-1])["loss"]))
        if step == 1:
            first = {k: tr.optimizer.state[p]["exp_avg"] / 0.1
                     for k, p in ngp_hash.leaves(tr.params).items()}
    assert tr.num_rays == 64
    init = ngp_hash.leaves(weights)
    update = {k: p.detach() - init[k] for k, p in ngp_hash.leaves(tr.params).items()}

    state = types.SimpleNamespace(weights=weights, noise=noise, draws=draws, scene=tr.scene)
    ctx = types.SimpleNamespace(config=cfg, device=torch.device("cpu"))
    reference = ngp_hash_train.reference_readings(state, ctx, "bf16")
    gaps = ngp_train.compare((losses, {k: float(v.norm()) for k, v in first.items()},
                              {k: float(v.double().norm()) for k, v in update.items()}),
                             reference)
    assert gaps["loss_gap"] <= 1e-6 and gaps["grad_gap"] <= 1e-5, gaps
    assert gaps["update_gap"] <= 1e-4, gaps


def _plain_launch(entry, x, src, dst, config):
    """K6's two launches, done by the plain encoder on the CPU."""
    if entry.endswith("fwd_f32"):
        dst.copy_(H.hash_encode_plain(src, x, config).detach())
        return
    t = torch.zeros_like(dst).requires_grad_(True)
    with torch.enable_grad():  # inside autograd's backward
        (grad,) = torch.autograd.grad(H.hash_encode_plain(t, x, config), t, src)
    dst.add_(grad)


def test_the_kernel_wrapper_spans_and_counters(monkeypatch):
    """_HashEncode with K6's launches stood in for on the CPU: the output
    and the table gradient are the plain encoder's, each launch is counted
    once, and under a profiler the store holds `hash.encode` and
    `hash.encode_grad` and the launch and row counters."""
    monkeypatch.setattr(H, "_launch", _plain_launch)
    g = torch.Generator().manual_seed(4)
    x = torch.rand(500, 3, generator=g)
    table = (torch.rand(4 << 13, 2, generator=g) - 0.5).requires_grad_(True)
    want = H.hash_encode_plain(table, x, SMALL)
    (want_g,) = torch.autograd.grad(want.square().sum(), table)
    before = (H.hash_encode.launches, H.hash_encode.grad_launches)
    profiling.reset()
    with torch.profiler.profile():
        got = H._HashEncode.apply(table, x, SMALL)
        (got_g,) = torch.autograd.grad(got.square().sum(), table)
    snap = profiling.snapshot()
    profiling.reset()
    assert torch.equal(got, want) and torch.equal(got_g, want_g)
    assert (H.hash_encode.launches, H.hash_encode.grad_launches) == (before[0] + 1,
                                                                     before[1] + 1)
    assert {k: v["calls"] for k, v in snap["spans"].items()} == {"hash.encode": 1,
                                                                 "hash.encode_grad": 1}
    assert snap["counters"] == {"hash.kernel_calls": 1, "hash.rows": 500}


def test_the_plain_path_counts_calls_and_no_launch():
    x = torch.rand(10, 3)
    profiling.reset()
    with torch.profiler.profile():
        H.hash_encode(torch.zeros(4 << 13, 2), x, SMALL)
    snap = profiling.snapshot()
    profiling.reset()
    assert snap["counters"] == {"hash.encode_calls": 1} and not snap["spans"]


def test_the_kernel_path_refuses_what_k6_cannot_do():
    x = torch.rand(4, 3)
    with pytest.raises(ValueError, match="2 features"):
        H._check(torch.zeros(4 << 13, 4), x, H.HashGridConfig(n_levels=4, n_features=4,
                                                               log2_table_size=13))
    with pytest.raises(TypeError, match="L\\*T, F"):
        H._check(torch.zeros(100, 2), x, SMALL)
    with pytest.raises(ValueError, match="no gradient to the positions"):
        H._check(torch.zeros(4 << 13, 2), x.requires_grad_(True), SMALL)


@pytest.mark.parametrize("grid", [SMALL, H.HashGridConfig()])
@pytest.mark.parametrize("n", [0, 1, 4096, 1 << 18])
def test_k6_byte_counts_never_exceed_the_inputs(grid, n):
    """The forward's count is at most the positions read and the f32
    encoding written; the backward's at most the positions and the f32
    gradient read, with the table's rows left out of both."""
    cfg = bench_config(grid)
    positions, encoding = 12 * n, 4 * n * grid.out_dim
    assert 0 <= hash_counts.k6_forward_bytes(n, cfg) <= positions + encoding
    assert 0 <= hash_counts.k6_backward_bytes(n, cfg) <= positions + encoding
    assert hash_counts.k6_forward_bytes(n, cfg) == n * (12 + 2 * grid.out_dim)


def test_the_cells_record_counts_k6_over_live_samples_and_updates():
    cfg = bench_config(H.HashGridConfig())
    record = ngp_hash_train._record(cfg, [1000, cfg["sample_budget"] + 5], [15, 16], 2)
    n_occ = min(cfg["grid_resolution"] ** 3 // 4, 1 << 17) * 2
    live = 1000 + cfg["sample_budget"]
    assert record["units"] == 2
    assert record["bytes"]["k6f"] == hash_counts.k6_forward_bytes(live + n_occ, cfg)
    assert record["bytes"]["k6b"] == hash_counts.k6_backward_bytes(live, cfg)
    assert record["flops"] == (live * counts.ngp_train_sample_flops(cfg)
                               + n_occ * counts.ngp_density_point_flops(cfg))
