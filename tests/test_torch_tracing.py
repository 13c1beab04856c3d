"""The port's spans and counters (runtime/profiling.py) in both training
steps: off without a profiler, every stage span once a step inside its
step span when a torch.profiler session records, the same losses and
parameters bit for bit either way, the counters, and --profile_steps."""
import contextlib
import json
import os

import pytest
import torch
from torch.autograd import DeviceType

from dregnerf_tpu_torch.datasets import fixtures as tfix
from dregnerf_tpu_torch.models import ngp as tngp
from dregnerf_tpu_torch.ops.packed_grid import PackedGridConfig
from dregnerf_tpu_torch.ops.rle import rle_scatter_add_safe
from dregnerf_tpu_torch.runtime import ngp_trainer as TT
from dregnerf_tpu_torch.runtime import profiling
from dregnerf_tpu_torch.runtime.config import config_parser
from torch_reg_common import few_torch_threads, pair_root, port_trainer  # noqa: F401 (fixtures)

NGP_STAGES = ("ngp.occupancy", "ngp.rays", "render.march", "render.field",
              "render.composite", "ngp.loss", "ngp.backward", "ngp.optimizer")
REGTR_STAGES = ("regtr.inputs", "regtr.fpn", "regtr.subsample", "regtr.transformer",
                "regtr.heads", "regtr.losses", "regtr.backward", "regtr.optimizer")


@pytest.fixture(autouse=True)
def empty_store():
    profiling.reset()
    yield
    profiling.reset()


def ngp_trainer(out, extra=()):
    """A trainer at the CLI defaults (bf16 table gradient with the
    run-length backward at the coarse levels) on a 2-level grid."""
    cfg = config_parser(["--expname", "tiny", "--out_dir", str(out),
                         "--aabb=-1.0,-1.0,-1.0,1.0,1.0,1.0", "--sample_budget", "4096",
                         "--max_march_steps", "128", "--grid_resolution", "32",
                         "--init_num_rays", "256", "--max_num_rays", "1024",
                         "--n_tensorboard", "1000", "--n_validation", "1000000",
                         "--n_checkpoint", "1000000", *extra])
    tr = TT.NGPTrainer(cfg, tfix.make_scene_data("train", num_views=8, image_size=24),
                       device="cpu")
    grid = PackedGridConfig(n_levels=2, log2_table_size=10, base_resolution=4,
                            per_level_scale=2.0, grad_accum="bf16",
                            rle_step_u=tr.model_config.grid.rle_step_u)
    tr.model_config = tngp.NGPConfig(grid=grid, compute_dtype=torch.float32)
    tr.init_params(torch.Generator().manual_seed(0))
    tr.setup_optimizer()
    return tr


def reg_trainer(root, out):
    return port_trainer(root, str(out))


def ngp_steps(tr, steps):
    return [tr.train_iteration(step)["loss"] for step in steps]


def reg_steps(tr, n):
    return [tr.train_iteration(tr.train_dataset.get_raw(0))["total"] for _ in range(n)]


def annotations(prof):
    """{name: [(start ns, end ns)]} of the profiler's user annotations."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU and e.is_user_annotation():
            out.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def assert_stages_divide_the_step(prof, step, stages):
    ann = annotations(prof)
    spans = profiling.snapshot()["spans"]
    assert set(spans) == {step, *stages}
    for name in (step, *stages):
        assert spans[name]["calls"] == 1, name
        assert spans[name]["device_ms"] is None  # no card
        assert spans[name]["host_ms"] > 0
        assert len(ann[name]) == 1, name  # an event of the profiler's own trace
    (s0, s1), = ann[step]
    inner = sorted(ann[name][0] for name in stages)
    assert all(s0 <= a and b <= s1 for a, b in inner)
    assert all(b <= a2 for (_, b), (a2, _) in zip(inner, inner[1:]))  # no overlap
    host = sum(spans[name]["host_ms"] for name in stages)
    assert host <= spans[step]["host_ms"]


def test_spans_are_off_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    a, b = profiling.annotate("ngp.step"), profiling.annotate("regtr.fpn")
    assert a is b  # one shared no-op: nothing allocated
    with a:
        profiling.count("rle.calls", 1)
    assert profiling.snapshot() == {"spans": {}, "counters": {}}


def test_the_ngp_step_has_every_stage_span_once(tmp_path):
    tr = ngp_trainer(tmp_path)
    with torch.profiler.profile() as prof:
        metrics = tr.train_iteration(16)  # an occupancy update
    assert_stages_divide_the_step(prof, "ngp.step", NGP_STAGES)
    counters = profiling.snapshot()["counters"]
    assert counters["ngp.live_samples"] == int(metrics["n_samples"])
    assert counters["ngp.sample_buffer"] == tr.config.sample_budget
    assert counters["rle.calls"] == 2 and counters["rle.direct"] == 0  # both levels


def test_a_step_off_the_occupancy_interval_has_no_occupancy_span(tmp_path):
    tr = ngp_trainer(tmp_path)
    with torch.profiler.profile():
        ngp_steps(tr, (17, 18))
    spans = profiling.snapshot()["spans"]
    assert "ngp.occupancy" not in spans
    assert {spans[n]["calls"] for n in ("ngp.step", *NGP_STAGES[1:])} == {2}


def test_the_regtr_step_has_every_stage_span_once(pair_root, tmp_path):  # noqa: F811
    tr = reg_trainer(pair_root, tmp_path)
    with torch.profiler.profile() as prof:
        reg_steps(tr, 1)
    assert_stages_divide_the_step(prof, "regtr.step", REGTR_STAGES)
    counters = profiling.snapshot()["counters"]
    assert set(counters) == {"regtr.src_points", "regtr.tgt_points", "regtr.level"}
    assert 0 < counters["regtr.src_points"] and 0 < counters["regtr.tgt_points"]
    assert 0 <= counters["regtr.level"] < tr.model.num_downsample


@pytest.mark.parametrize("which", ["ngp", "regtr"])
def test_spans_change_no_bit_of_the_training(which, pair_root, tmp_path):  # noqa: F811
    runs = []
    for on in (False, True):
        out = tmp_path / str(on)
        tr = ngp_trainer(out) if which == "ngp" else reg_trainer(pair_root, out)
        with torch.profiler.profile() if on else contextlib.nullcontext():
            if which == "ngp":  # steps 15-17: an occupancy update and a bucket read
                losses, params = ngp_steps(tr, (15, 16, 17)), tngp.parameters(tr.params)
            else:
                losses, params = reg_steps(tr, 3), [tr.optimizer.flat]
        runs.append((losses, [p.detach().clone() for p in params]))
    assert profiling.snapshot()["spans"][f"{which}.step"]["calls"] == 3
    (l0, p0), (l1, p1) = runs
    for a, b in zip(l0 + p0, l1 + p1):
        assert torch.equal(a, b)


@pytest.mark.parametrize("max_runs, direct", [(2, 1), (8, 0)])
def test_rle_direct_counts_an_overflow_of_the_runs(max_runs, direct):
    idx = torch.arange(16) // 2  # 8 runs of 2
    vals = torch.ones(16, 4)
    with torch.profiler.profile():
        table = rle_scatter_add_safe(idx, vals, max_runs, table_rows=8)
    torch.testing.assert_close(table, torch.full((8, 4), 2.0))
    assert profiling.snapshot()["counters"] == {"rle.calls": 1, "rle.direct": direct}


def test_profile_steps_writes_the_trace_and_the_spans(tmp_path):
    tr = ngp_trainer(tmp_path, ["--max_iterations", "5", "--profile_steps", "2:2"])
    tr.train()
    prof_dir = os.path.join(tr.output_dir, "profile")
    traces = [f for f in os.listdir(prof_dir) if f.endswith(".pt.trace.json")]
    assert len(traces) == 1
    with open(os.path.join(prof_dir, "spans.json")) as f:
        spans = json.load(f)
    assert spans["spans"]["ngp.step"]["calls"] == 2
    assert spans["counters"]["rle.calls"] == 4
    assert not torch.autograd._profiler_enabled()


@pytest.mark.parametrize("spec", ["3", "a:2", "1:0", "-1:2"])
def test_profile_steps_refuses_a_malformed_window(spec):
    with pytest.raises(ValueError, match="--profile_steps"):
        profiling.StepWindow(spec, "unused")


class _FakeEvent:
    """A timing event the stream has passed (`done`) or not."""

    def __init__(self, t_ms, done=True):
        self.t_ms, self.done = t_ms, done

    def query(self):
        return self.done

    def elapsed_time(self, end):
        return end.t_ms - self.t_ms


def test_passed_event_pairs_go_back_to_the_pool():
    """Off a full pool, the store folds each span's pairs up to the first
    the stream has not passed into device ms, and reuses their events."""
    store = profiling._Store()
    ev = [_FakeEvent(t) for t in (0.0, 2.0, 5.0, 6.5)]
    late = [_FakeEvent(7.0), _FakeEvent(9.0, done=False)]
    store.add("a.step", 10, ev[0], ev[3])
    store.add("a.x", 1, ev[0], ev[1])
    store.add("a.x", 1, *late)
    store.add("a.x", 1, ev[2], ev[3])  # after the pending pair: kept in order
    store.fold(wait=False)
    assert store.spans["a.step"].device_ms == 6.5 and store.spans["a.x"].device_ms == 2.0
    assert store.spans["a.x"].pairs == [tuple(late), (ev[2], ev[3])]
    assert len(store.pool) == 4
    late[1].done = True
    store.fold(wait=False)
    assert store.spans["a.x"].device_ms == 2.0 + 2.0 + 1.5 and not store.spans["a.x"].pairs
    assert len(store.pool) == 8
