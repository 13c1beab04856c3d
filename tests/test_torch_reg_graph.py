"""The registration trainer's device-cached step as a CUDA graph
(dregnerf_tpu_torch/runtime/reg_graph.py).

On the CPU the capture is replaced by `eager_capture` (the warm-up, then a
"graph" whose replay runs the body into the static output), so that the
static-buffer path (the copy-in, the noise drawn into buffers, the packed
metrics and their clone) runs here and is held bit for bit to the eager
step. The `cuda` test holds replayed steps to eager steps on the card.
This file imports no JAX, so that the card's test runs where JAX is not
installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_reg_graph.py
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dregnerf_tpu_torch.models.regtr import NeRFRegTr
from dregnerf_tpu_torch.runtime import profiling, reg_graph, reg_optim
from dregnerf_tpu_torch.runtime.config import config_parser
from dregnerf_tpu_torch.runtime.reg_trainer import RegTrainer

R = 16
TINY = dict(backbone="resnet18", d_model=32, num_layers=1, num_heads=2, dim_feedforward=64,
            max_input_points=256, num_tokens=64, max_points=50, num_downsample=2)
LR = 1e-4  # the config's default


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """At most 2 torch threads: the tier-1 run puts several test processes
    on the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _block(rng):
    """An R^3 grid of 300 random occupied voxels and its flat mask."""
    grid = np.zeros((R, R, R, 7), np.float32)
    ii = rng.integers(2, R - 2, size=(300, 3))
    flat = ii[:, 0] * R * R + ii[:, 1] * R + ii[:, 2]
    grid.reshape(-1, 7)[flat, :3] = (ii + 0.5) / R * 2.0 - 1.0
    grid.reshape(-1, 7)[flat, 3:] = rng.uniform(size=(300, 4))
    mask = np.zeros(R ** 3, bool)
    mask[flat] = True
    return grid, mask


def _rigid(rng, std):
    """A small random rigid transform [4, 4] f32."""
    q = np.concatenate([[1.0], rng.normal(scale=std, size=3)])
    w, x, y, z = q / np.linalg.norm(q)
    out = np.eye(4)
    out[:3, :3] = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                   [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                   [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]]
    out[:3, 3] = rng.normal(scale=std, size=3)
    return out.astype(np.float32)


class Pairs:
    """Two blocks, as the trainer's dataset (it reads the grid resolution
    and the jitter) and as a source of device-cached items (get_raw's
    layout: cache keys and an `aug` dict)."""

    jitter_scale, jitter_clip = 0.005, 0.05

    def __init__(self, seed=0):
        rng = np.random.default_rng(seed)
        self.blocks = [_block(rng), _block(rng)]

    def __len__(self):
        return 1

    def __getitem__(self, i):
        return self.host_item(np.eye(4, dtype=np.float32))

    def host_item(self, pose):
        (g0, m0), (g1, m1) = self.blocks
        return {"src_grid": g0, "src_mask": m0, "tgt_grid": g1, "tgt_mask": m1, "pose": pose}

    def items(self, n, seed=1, jitter=True):
        """n device-cached items with random poses and perturbations."""
        rng = np.random.default_rng(seed)
        out = []
        for k in range(n):
            p = _rigid(rng, 0.1)
            item = {**self.host_item(_rigid(rng, 0.3)), "src_cache_key": "b0",
                    "tgt_cache_key": "b1",
                    "aug": {"p_src": p if k % 2 else np.eye(4, dtype=np.float32),
                            "p_tgt": np.eye(4, dtype=np.float32) if k % 2 else p,
                            "jitter": jitter}}
            out.append(item)
        return out


def trainer(tmp_path, device="cpu", shape=TINY, bf16=False):
    cfg = config_parser(["--position_embedding_dim", str(shape["d_model"]),
                         "--num_downsample", str(shape["num_downsample"]),
                         "--out_dir", str(tmp_path), "--expname", "reg", "--watchdog_s", "0",
                         *([] if bf16 else ["--no_bf16"])])
    ds = Pairs()
    dtype = torch.bfloat16 if bf16 else torch.float32
    return RegTrainer(cfg, ds, ds, model=NeRFRegTr(**shape, dtype=dtype), device=device), ds


def eager_capture(body, state):
    """The capture's stand-in off the card: the warm-up, then a graph whose
    replay runs the body into the static output."""
    out = reg_graph.warm_up(body, state, 1)
    return SimpleNamespace(replay=lambda: out.copy_(body())), out


@pytest.fixture
def graph_on_cpu(monkeypatch):
    """Graphs engage on the CPU, each capture recorded."""
    captures = []

    def record(body, state):
        captures.append(len(state))
        return eager_capture(body, state)

    monkeypatch.setattr(reg_graph, "DEVICE_TYPES", ("cpu",))
    monkeypatch.setattr(reg_graph, "capture", record)
    return captures


def _state(tr):
    opt = tr.optimizer
    return [opt.flat, opt.mu, opt.nu, opt.count, opt.schedule_count]


def _profiled_steps(tr, items):
    """The steps' metrics and the store's counters over them."""
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        metrics = [tr.train_iteration(it) for it in items]
    counters = profiling.snapshot()["counters"]
    profiling.reset()
    return metrics, counters


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_static_buffer_step_equals_the_eager_step_bit_for_bit(tmp_path, monkeypatch, bf16):
    """Three steps through the graph's body (capture stood in for) against
    three eager steps from the same state, pairs and generator: parameters,
    moments, counts, every metric in the eager order and dtype, the
    counters, and the jitter generator's state afterwards."""
    eager, ds = trainer(tmp_path / "eager", bf16=bf16)
    items = ds.items(3)
    want, want_counts = _profiled_steps(eager, items)
    assert eager.graph_captures == eager.graph_replays == 0

    monkeypatch.setattr(reg_graph, "DEVICE_TYPES", ("cpu",))
    monkeypatch.setattr(reg_graph, "capture", eager_capture)
    graphed, _ = trainer(tmp_path / "graph", bf16=bf16)
    got, got_counts = _profiled_steps(graphed, items)
    assert graphed.graph_captures == 1 and graphed.graph_replays == 3

    for g, w in zip(_state(graphed), _state(eager)):
        assert torch.equal(g, w)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), k
    assert torch.equal(graphed._aug_gen.get_state(), eager._aug_gen.get_state())
    assert got_counts.pop("regtr.graph_captures") == 1
    assert got_counts.pop("regtr.graph_replays") == 3
    assert got_counts == want_counts and set(want_counts) == set(reg_graph.COUNTERS)


def test_two_steps_metrics_do_not_alias(tmp_path, graph_on_cpu):
    tr, ds = trainer(tmp_path)
    first_item, second_item = ds.items(2)
    first = tr.train_iteration(first_item)
    kept = {k: v.clone() for k, v in first.items()}
    second = tr.train_iteration(second_item)
    assert not torch.equal(first["total"], second["total"])
    for k, v in first.items():
        assert torch.equal(v, kept[k]), k
        assert v.data_ptr() != second[k].data_ptr(), k
    assert graph_on_cpu == [5]  # one capture, of the optimizer's five tensors


@pytest.mark.parametrize("case,engages", [
    ("device-cached", True),
    ("host batch", False),
    ("exact visibility", False),
    ("mesh", False),
    ("batch 2", False),
    ("off the card", False),
])
def test_the_graph_engages_only_on_the_cached_batch_1_grid_path(tmp_path, monkeypatch,
                                                                graph_on_cpu, case, engages):
    tr, ds = trainer(tmp_path)
    item = ds.items(1)[0]
    if case == "host batch":
        item = {k: v for k, v in item.items() if k != "aug"}
    elif case == "exact visibility":
        tr.visibility = "exact"
        # a cached item under exact labels takes the eager grid step
    elif case == "mesh":
        tr.mesh = SimpleNamespace()
    elif case == "batch 2":
        tr.batch_size = 2
    elif case == "off the card":
        monkeypatch.setattr(reg_graph, "DEVICE_TYPES", ("cuda",))
    metrics = tr.train_iteration(item)
    assert torch.isfinite(metrics["total"])
    assert (tr.graph_captures, tr.graph_replays) == ((1, 1) if engages else (0, 0))
    assert len(graph_on_cpu) == tr.graph_captures
    assert (tr._graph is not None) == engages


def test_the_graph_is_captured_anew_when_the_jitter_or_the_optimizer_changes(tmp_path,
                                                                             graph_on_cpu):
    tr, ds = trainer(tmp_path)
    on, off = ds.items(3), ds.items(1, seed=2, jitter=False)
    tr.train_iteration(on[0])
    tr.train_iteration(on[1])
    assert (tr.graph_captures, tr.graph_replays) == (1, 2)
    tr.train_iteration(off[0])  # no noise: other work
    assert tr._graph.noise is None and tr.graph_captures == 2
    tr.set_lr_schedule(reg_optim.run_sized_schedule(10))
    assert tr._graph is None
    tr.train_iteration(on[2])
    assert (tr.graph_captures, tr.graph_replays) == (3, 4)
    assert tr._graph.optimizer is tr.optimizer and int(tr.optimizer.count) == 1


def test_a_trainer_made_without_init_reads_the_graph_defaults():
    leaves = [torch.randn(3, requires_grad=True)]
    tr = RegTrainer.__new__(RegTrainer)
    tr.config = SimpleNamespace(lr=1e-4)
    tr.optimizer = reg_optim.GuardedAdamW(leaves, 1e-4)
    assert tr._graph is None and tr.graph_captures == tr.graph_replays == 0
    tr.set_lr_schedule({5: 0.5})
    assert tr._graph is None


def test_warm_up_puts_the_state_back_even_when_the_body_raises():
    state = [torch.zeros(3), torch.zeros((), dtype=torch.int32)]

    def body():
        state[0].add_(1.0)
        state[1].add_(1)
        if int(state[1]) == 2:
            raise RuntimeError("out of memory")
        return state[0].clone()

    assert torch.equal(reg_graph.warm_up(body, state, 1), torch.ones(3))
    assert not state[0].any() and int(state[1]) == 0
    with pytest.raises(RuntimeError):
        reg_graph.warm_up(body, state, 3)
    assert not state[0].any() and int(state[1]) == 0


def test_graph_share_reads_replays_per_traced_step(graph_on_cpu, tmp_path):
    from benchmark.metrics import graph_share

    tr, ds = trainer(tmp_path)
    _, counters = _profiled_steps(tr, ds.items(2))
    profiling.reset()
    trace = SimpleNamespace()
    assert graph_share.read({"units": 2}, None) is None
    assert graph_share.read({"units": 0}, trace) is None
    assert graph_share.read({"units": 2}, trace) is None  # the store is empty
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        tr.train_iteration(ds.items(1, seed=3)[0])
    assert graph_share.read({"units": 1}, trace) == 100.0
    assert graph_share.read({"units": 4}, trace) == 25.0
    profiling.reset()
    assert counters["regtr.graph_replays"] == 2


# ------------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# Two runs from the same state on the same inputs part only where the
# convolutions' backward sums in another order (cuDNN's atomics): every step
# moves an element by about lr at most, so the parameters of two runs stay
# within 2 lr a step of each other; the first moment (0.1 g + 0.9 m) within
# bf16 rounding of its largest element; the losses within 1 %, but for the
# nerf-consistency term: its labels are the voxel masks read at the warped
# keypoints, and a keypoint the two runs warp a last bit apart across a
# voxel face flips its label, a step of 0.25 / (layers x valid tokens),
# 2e-3 here (read once on the card); a few such flips are allowed.
PARAM_ATOL = 2 * LR * 3
MU_RTOL = 2e-2
LOSS_RTOL = 1e-2
LABEL_ATOL = 1e-2


@pytest.mark.cuda
def test_replayed_steps_match_eager_steps_on_the_card(tmp_path, monkeypatch, cuda_device):
    """Three replays against three eager steps from the same state, pairs
    and noise, at bf16 with two layers (cuSOLVER's batched SVD, as at full
    width); the graph's body under the sync debug mode raises nothing."""
    shape = {**TINY, "num_layers": 2}
    graphed, ds = trainer(tmp_path / "graph", cuda_device, shape, bf16=True)
    items = ds.items(3)

    # the body, as captured, reads nothing on the host (the warm-up's run
    # puts the state back)
    item = items[0]
    sides, matrices = graphed._cached_sides(item), reg_graph.matrices(item)
    probe = reg_graph.StepGraph(graphed, sides, matrices, graphed._jitter(item["aug"]))
    probe.fill(sides, matrices, torch.Generator(device=cuda_device).manual_seed(0))
    before = [t.clone() for t in _state(graphed)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        reg_graph.warm_up(lambda: probe.body(graphed), probe.state, 1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for a, b in zip(_state(graphed), before):
        assert torch.equal(a, b)
    del probe

    got = [graphed.train_iteration(it) for it in items]
    assert graphed.graph_captures == 1 and graphed.graph_replays == 3

    monkeypatch.setattr(reg_graph, "DEVICE_TYPES", ())
    eager, _ = trainer(tmp_path / "eager", cuda_device, shape, bf16=True)
    want = [eager.train_iteration(it) for it in items]
    assert eager.graph_captures == 0
    assert torch.equal(graphed._aug_gen.get_state(), eager._aug_gen.get_state())

    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in ("total", "overlap", "nerf_cont", "feature", "corr"):
            gap = abs(float(g[k]) - float(w[k]))
            print(f"{k}: graph {float(g[k]):.6f} eager {float(w[k]):.6f} gap {gap:.3e}")
            tol = LABEL_ATOL if k == "nerf_cont" else LOSS_RTOL * abs(float(w[k])) + 1e-6
            assert gap <= tol, k
        assert float(g["skipped_nonfinite"]) == float(w["skipped_nonfinite"]) == 0.0
    go, wo = graphed.optimizer, eager.optimizer
    param_gap = float((go.flat - wo.flat).abs().max())
    mu_gap = float((go.mu - wo.mu).abs().max())
    print(f"parameters: max gap {param_gap:.3e}; first moment: max gap {mu_gap:.3e} of "
          f"{float(wo.mu.abs().max()):.3e}")
    assert param_gap <= PARAM_ATOL
    assert mu_gap <= MU_RTOL * float(wo.mu.abs().max())
    assert int(go.count) == int(wo.count) == 3
