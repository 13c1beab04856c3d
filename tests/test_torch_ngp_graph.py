"""The NGP trainer's single-device step as a CUDA graph per ray bucket
(dregnerf_tpu_torch/runtime/ngp_graph.py).

On the CPU the capture is replaced by `eager_capture` (the warm-up, then a
"graph" whose replay runs the body into the static output and, as a real
replay runs no kernel wrapper, puts the wrappers' launch counters back), so that the
static-buffer path (the draws copied or drawn into their buffers, the grid
read in place, the packed metrics and counters and their clone) runs here and
is held bit for bit to the eager step. Off the card the optimizer is the
eager step's own Adam. The `cuda` test holds replayed steps to eager steps
on the card. This file imports no JAX, so that the card's test runs where
JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_ngp_graph.py
"""
import contextlib
from types import SimpleNamespace

import pytest
import torch

from dregnerf_tpu_torch.datasets import fixtures
from dregnerf_tpu_torch.models import ngp as tngp
from dregnerf_tpu_torch.ops import gather_rows, hash_encoding, scatter_add
from dregnerf_tpu_torch.ops.hash_encoding import HashGridConfig
from dregnerf_tpu_torch.ops.packed_grid import PackedGridConfig
from dregnerf_tpu_torch.runtime import ngp_graph, profiling
from dregnerf_tpu_torch.runtime import ngp_trainer as TT
from dregnerf_tpu_torch.runtime.config import config_parser

STEPS = 10  # occupancy updates at 0, bucket feedback at 0 and 8 (a new bucket at 8)
ENCODERS = ["packed", "xor_hash"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the tier-1 run puts several test processes on the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def trainer(out, encoder="packed", device="cpu", extra=()):
    """A trainer at the CLI defaults on a 2-level grid: the packed one with
    the bf16 table gradient and the run-length backward at level 0, or a
    2-level xor-hash grid (`--encoder xor_hash`)."""
    cfg = config_parser(["--expname", "tiny", "--out_dir", str(out), "--watchdog_s", "0",
                         "--aabb=-1.0,-1.0,-1.0,1.0,1.0,1.0", "--sample_budget", "2048",
                         "--max_march_steps", "64", "--grid_resolution", "16",
                         "--init_num_rays", "32", "--max_num_rays", "256",
                         "--encoder", encoder, *extra])
    tr = TT.NGPTrainer(cfg, fixtures.make_scene_data("train", num_views=4, image_size=16),
                       device=device)
    if encoder == "packed":
        grid = PackedGridConfig(n_levels=2, log2_table_size=10, base_resolution=4,
                                per_level_scale=2.0, grad_accum="bf16",
                                rle_step_u=tr.model_config.grid.rle_step_u)
    else:
        grid = HashGridConfig(n_levels=2, log2_table_size=10, base_resolution=4,
                              per_level_scale=2.0)
    tr.model_config = tngp.NGPConfig(grid=grid, compute_dtype=torch.bfloat16)
    tr.init_params(torch.Generator(device=device).manual_seed(0))
    tr.setup_optimizer()
    return tr


def eager_capture(body, state, pool):
    """The capture's stand-in off the card: the warm-up, then a graph whose
    replay runs the body into the static output and puts the launch
    counters back (a replay runs no Python)."""
    out = ngp_graph.warm_up(body, state, 1)

    def replay():
        before = ngp_graph.launches()
        out.copy_(body())
        for name, (fn, attr) in ngp_graph.launch_counters().items():
            setattr(fn, attr, before[name])

    return SimpleNamespace(replay=replay), out


@contextlib.contextmanager
def graph_on_cpu(mp, captures=None):
    """Graphs engage on the CPU, each capture recorded in `captures`."""

    def record(body, state, pool):
        if captures is not None:
            captures.append(len(state))
        return eager_capture(body, state, pool)

    mp.setattr(ngp_graph, "DEVICE_TYPES", ("cpu",))
    mp.setattr(ngp_graph, "capture", record)
    yield captures


@contextlib.contextmanager
def plain_versions_count(mp):
    """The kernels' plain versions count as launches: off the card the
    wrappers launch nothing, so the launch counters would read 0."""
    for module, fn, counter in ((gather_rows, "gather_rows_plain", gather_rows.gather_rows),
                                (scatter_add, "scatter_add_bf16_plain",
                                 scatter_add.scatter_add_bf16),
                                (hash_encoding, "hash_encode_plain",
                                 hash_encoding.hash_encode)):
        def counted(*args, _real=getattr(module, fn), _counter=counter, **kwargs):
            _counter.launches += 1
            return _real(*args, **kwargs)

        mp.setattr(module, fn, counted)
    yield


def state(tr):
    """The parameters, then Adam's moments and counts."""
    params = tngp.parameters(tr.params)
    st = [tr.optimizer.state[p] for p in params]
    return ([p.detach() for p in params] + [s["exp_avg"] for s in st]
            + [s["exp_avg_sq"] for s in st] + [s["step"] for s in st])


def counted_run(tr):
    """STEPS steps, their counts collected (as a profiler's store would sum
    them): their metrics, the counters and the kernels' host launches."""
    before = ngp_graph.launches()
    with profiling.collect({}) as counts:
        metrics = [tr.train_iteration(step) for step in range(STEPS)]
    counters = {name: sum(int(v) for v in values) for name, values in counts.items()}
    return metrics, counters, {k: v - before[k] for k, v in ngp_graph.launches().items()}


@pytest.fixture(scope="module", params=ENCODERS)
def runs(request, tmp_path_factory):
    """(eager trainer, its run, graphed trainer, its run, the captures' state
    sizes) of STEPS steps from the same seed, the graph's capture stood in
    for."""
    out = tmp_path_factory.mktemp(request.param)
    with pytest.MonkeyPatch.context() as mp, plain_versions_count(mp):
        eager = trainer(out / "eager", request.param)
        want = counted_run(eager)
        captures = []
        with graph_on_cpu(mp, captures):
            graphed = trainer(out / "graph", request.param)
            got = counted_run(graphed)
    return eager, want, graphed, got, captures


def test_static_buffer_step_equals_the_eager_step_bit_for_bit(runs):
    """The parameters, Adam's moments and counts, every metric in the eager
    order and dtype, the buckets, the grid and the generator's state."""
    eager, (want, _, _), graphed, (got, _, _), _ = runs
    assert eager.graph_replays == 0 and graphed.graph_replays == STEPS
    for g, w in zip(state(graphed), state(eager)):
        assert torch.equal(g, w)
    assert [m["num_rays"] for m in got] == [m["num_rays"] for m in want]
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k, v in w.items():
            if isinstance(v, torch.Tensor):
                assert g[k].dtype == v.dtype and torch.equal(g[k], v), k
            else:
                assert g[k] == v, k
    assert torch.equal(graphed.grid.occs, eager.grid.occs)
    assert torch.equal(graphed.grid.binary, eager.grid.binary)
    assert torch.equal(graphed.generator.get_state(), eager.generator.get_state())
    assert graphed.num_rays == eager.num_rays


def test_counters_and_launches_counted_per_replay_equal_the_eager_steps(runs):
    """The counters, counted after each replay, are the eager run's. The
    wrappers count only the host's launches (the eager occupancy updates'
    and each capture's warm-up: a replay runs no wrapper); with the
    replays' derived launches in the place of the warm-ups' they sum to
    the eager run's."""
    eager, (_, want_counts, want_launches), graphed, (_, got_counts, got_launches), _ = runs
    assert got_counts.pop("ngp.graph_captures") == graphed.graph_captures
    assert got_counts.pop("ngp.graph_replays") == STEPS
    assert got_counts == want_counts
    warm_ups = {k: sum(g.launched[k] for g in graphed._graph.graphs.values())
                for k in want_launches}
    replayed = graphed.replayed_launches
    assert {k: got_launches[k] - warm_ups[k] + replayed.get(k, 0)
            for k in want_launches} == want_launches
    assert any(replayed.values()) and all(v <= want_launches[k] for k, v in replayed.items())
    assert eager.replayed_launches == {}
    assert "ngp.live_samples" in want_counts
    assert ("rle.direct" in want_counts) == ("hash.encode_calls" not in want_counts)


def test_each_bucket_is_captured_once(runs):
    """A capture for each bucket the run met, each of the whole state."""
    _, _, graphed, (got, _, _), captures = runs
    buckets = sorted({m["num_rays"] for m in got})
    assert len(buckets) > 1
    assert graphed.graph_captures == len(captures) == len(buckets)
    assert len(set(captures)) == 1 and captures[0] == len(state(graphed))
    assert sorted(k[0][0][0] for k in graphed._graph.graphs) == buckets


def test_a_new_bucket_captures_and_an_old_one_replays(tmp_path, monkeypatch):
    with graph_on_cpu(monkeypatch):
        tr = trainer(tmp_path)
        scene = tr.scene
        gen = torch.Generator().manual_seed(1)
        for step, rays in enumerate((32, 64, 32, 64, 32), start=1):
            draws = TT.draw_step_inputs(gen, rays, scene.num_images, scene.height,
                                        scene.width, "cpu")
            tr.train_iteration(step, draws)
    assert (tr.graph_captures, tr.graph_replays) == (2, 5)
    assert len(tr._graph.graphs) == 2


def test_two_steps_metrics_do_not_alias(tmp_path, monkeypatch):
    with graph_on_cpu(monkeypatch):
        tr = trainer(tmp_path)
        first = tr.train_iteration(0)
        kept = {k: v.clone() for k, v in first.items() if isinstance(v, torch.Tensor)}
        second = tr.train_iteration(1)
    assert not torch.equal(first["loss"], second["loss"])
    for k, v in kept.items():
        assert torch.equal(first[k], v), k
        assert first[k].data_ptr() != second[k].data_ptr(), k


def test_an_occupancy_update_between_replays_is_what_the_next_replay_reads(tmp_path,
                                                                          monkeypatch):
    """The update writes the grid's own tensors; an emptied grid leaves the
    next replay no sample, as it leaves the eager step none."""
    with graph_on_cpu(monkeypatch):
        tr = trainer(tmp_path)
        occs, binary = tr.grid.occs, tr.grid.binary
        assert int(tr.train_iteration(0)["n_samples"]) > 0  # after the first update
        tr.update_occupancy(TT.OCC_WARMUP_STEPS)  # a non-warm-up update
        assert tr.grid.occs is occs and tr.grid.binary is binary
        assert int(tr.train_iteration(1)["n_samples"]) > 0
        tr.grid.binary.zero_()
        assert int(tr.train_iteration(2)["n_samples"]) == 0
    assert tr.graph_captures == 1 and tr.graph_replays == 3


@pytest.mark.parametrize("case,engages", [("one device", True), ("mesh", False),
                                          ("off the card", False)])
def test_the_graph_engages_on_one_device_only(tmp_path, monkeypatch, case, engages):
    """--mesh_shape takes the data-parallel step (stood in for here) and
    CPU tensors the eager one; neither builds a graph."""
    dp_calls = []
    with graph_on_cpu(monkeypatch):
        tr = trainer(tmp_path)
        if case == "mesh":
            from dregnerf_tpu_torch.parallel import ngp_dp

            def dp_step(mesh, params, *args, **kwargs):
                dp_calls.append(mesh)
                return {"n_samples": torch.zeros((), dtype=torch.int64)}

            monkeypatch.setattr(ngp_dp, "dp_train_step", dp_step)
            tr.mesh = SimpleNamespace(size=1)
        elif case == "off the card":
            monkeypatch.setattr(ngp_graph, "DEVICE_TYPES", ("cuda",))
        tr.train_iteration(1)
    assert ngp_graph.engages(tr) == engages
    assert (tr.graph_captures, tr.graph_replays) == ((1, 1) if engages else (0, 0))
    assert (tr._graph is not None) == engages
    assert len(dp_calls) == (case == "mesh")


def test_the_warm_up_puts_the_state_back_even_when_the_body_raises(tmp_path, monkeypatch):
    with graph_on_cpu(monkeypatch):
        tr = trainer(tmp_path)
        tr.train_iteration(0)
        before = [t.clone() for t in state(tr)]
        real = tr.apply_gradients

        def update_then_fail(step):
            real(step)
            raise RuntimeError("out of memory")

        tr.apply_gradients = update_then_fail
        with pytest.raises(RuntimeError):
            tr.train_iteration(2, TT.draw_step_inputs(torch.Generator().manual_seed(2), 64,
                                                      tr.scene.num_images, tr.scene.height,
                                                      tr.scene.width, "cpu"))
    assert int(tr.optimizer.state[tngp.parameters(tr.params)[0]]["step"]) == 1
    for a, b in zip(state(tr), before):
        assert torch.equal(a, b)


def test_ngp_graph_share_reads_replays_per_traced_unit(tmp_path, monkeypatch):
    from benchmark.metrics import ngp_graph_share

    trace = SimpleNamespace()
    profiling.reset()
    assert ngp_graph_share.read({"units": 2}, None) is None
    assert ngp_graph_share.read({"units": 0}, trace) is None
    assert ngp_graph_share.read({"units": 2}, trace) is None  # the store is empty
    with graph_on_cpu(monkeypatch):
        tr = trainer(tmp_path)
        tr.train_iteration(1)  # the capture, before the trace
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            tr.train_iteration(2)
            tr.train_iteration(3)
    try:
        assert ngp_graph_share.read({"units": 2}, trace) == 100.0
        assert ngp_graph_share.read({"units": 4}, trace) == 50.0
        assert "ngp.graph_captures" not in profiling.snapshot()["counters"]
    finally:
        profiling.reset()


# ------------------------------------------------------------------- the card

# chip_smoke.py's bound on two computations of one gradient on the card (the
# atomics add in a varying order): each leaf's norm within 1 % of the other's
GRAD_NORM_TOL = 1e-2
# The first step's loss: both sides compute it from the same weights, grid
# and draws. The later ones follow updates from gradients whose atomics added
# in another order, and Adam's first steps move every element by about lr
# sign(g), so an element whose gradient is near 0 can move either way. The
# limit was set at five times the eager runs' first gap (1.02e-5 at steps
# 2-3, 3 draws of each grid); over later calls the eager step's own losses
# on the packed grid lay up to 4.1e-5 apart at step 3, and the graph's up
# to 4.2e-5 from them, so the margin is thin.
LOSS_RTOL = 1e-6
LATER_LOSS_RTOL = 5e-5


# The card's cases: the draws' seed, the rays of each step's draws, and the
# flags. "lr steps and an older bucket": `--max_iterations 4` puts the
# schedule's steps at updates 2 and 3, so the device learning rate is
# written in place between replays, and bucket 128's graph replays after
# bucket 256's was captured into the shared pool.
CARD_CASES = {"one bucket": (7, (32, 32, 32), ()),
              "lr steps and an older bucket": (11, (128, 256, 128, 256, 128),
                                               ("--max_iterations", "4"))}


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
@pytest.mark.parametrize("encoder", ENCODERS)
def test_replayed_steps_match_eager_steps_on_the_card(tmp_path, monkeypatch, encoder, case):
    """Replays against eager steps from the same weights, grid and draws:
    each update's learning rate, the losses, and the first gradient as
    Adam's first moment holds it (m / 0.1) leaf by leaf; each graph's body
    under the sync debug mode raises nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    seed, rays, extra = CARD_CASES[case]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    graphed = trainer(tmp_path / "graph", encoder, dev, extra)
    scene = graphed.scene
    draws = [TT.draw_step_inputs(gen, r, scene.num_images, scene.height, scene.width, dev)
             for r in rays]

    def run(tr):
        tr.update_occupancy(0)
        losses, lrs, first = [], [], None
        for step, d in enumerate(draws, start=1):
            losses.append(float(tr.train_iteration(step, d)["loss"]))
            lrs.append(float(tr.optimizer.param_groups[0]["lr"]))
            if step == 1:
                first = [tr.optimizer.state[p]["exp_avg"].norm().item() / 0.1
                         for p in tngp.parameters(tr.params)]
        return losses, lrs, first

    got, got_lrs, got_first = run(graphed)
    graphs = list(graphed._graph.graphs.values())
    assert (graphed.graph_captures, graphed.graph_replays) == (len(set(rays)), len(rays))
    assert graphed.optimizer.param_groups[0]["capturable"]
    assert len({g.graph.pool() for g in graphs}) == 1
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for g in graphs:
            ngp_graph.warm_up(lambda: g.body(graphed), graphed._graph.state)
    finally:
        torch.cuda.set_sync_debug_mode(0)

    monkeypatch.setattr(ngp_graph, "DEVICE_TYPES", ())
    eager = trainer(tmp_path / "eager", encoder, dev, extra)
    want, want_lrs, want_first = run(eager)
    assert eager.graph_captures == 0
    schedule = [graphed.lr_at(step) for step in range(1, len(rays) + 1)]
    assert want_lrs == schedule and len(set(schedule)) == (3 if extra else 1)
    assert got_lrs == [torch.tensor(x, dtype=torch.float32).item() for x in schedule]
    gaps = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    grad_gaps = [abs(a - b) / b for a, b in zip(got_first, want_first)]
    print(f"{case}: losses: graph {got} eager {want}, relative gaps {gaps}; first gradient "
          f"norms: worst relative gap {max(grad_gaps):.3e}")
    assert gaps[0] <= LOSS_RTOL and max(gaps[1:]) <= LATER_LOSS_RTOL
    assert max(grad_gaps) <= GRAD_NORM_TOL
