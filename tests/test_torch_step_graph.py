"""The CUDA-graph step mechanism both trainers share
(dregnerf_tpu_torch/runtime/step_graph.py): the packing of a step's
output, the counters counted after each replay, the warm-up that puts a
trainer's state back, replays whose metrics do not alias, and the import
rule that keeps the module apart from the trainers. The capture is stood
in for on the CPU (tests/torch_graph_common.py); the trainers' own graph
tests are test_torch_ngp_graph.py and test_torch_reg_graph.py. This file
imports no JAX.
"""
import ast
import pathlib

import pytest
import torch
from torch_graph_common import graph_on_cpu, tiny_ngp_trainer, tiny_reg_trainer

from dregnerf_tpu_torch.models import ngp as tngp
from dregnerf_tpu_torch.runtime import ngp_trainer as TT
from dregnerf_tpu_torch.runtime import profiling, step_graph

PACKAGE = pathlib.Path(step_graph.__file__).resolve().parents[1]
KINDS = ["ngp", "regtr"]


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """At most 2 torch threads: the tier-1 run puts several test processes
    on the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def ngp_state(tr):
    """The parameters, then Adam's moments and counts."""
    params = tngp.parameters(tr.params)
    st = [tr.optimizer.state[p] for p in params]
    return ([p.detach() for p in params] + [s["exp_avg"] for s in st]
            + [s["exp_avg_sq"] for s in st] + [s["step"] for s in st])


def reg_state(tr):
    opt = tr.optimizer
    return [opt.flat, opt.mu, opt.nu, opt.count, opt.schedule_count]


def test_pack_unpack_round_trip_bit_for_bit():
    """Tensors of four dtypes, odd sizes and 0-dim, back as views of the
    packed vector, each aligned for its dtype and equal bit for bit."""
    gen = torch.Generator().manual_seed(0)
    f32 = torch.randn(7, generator=gen)
    f32[3] = float("nan")
    values = [torch.tensor(True), f32, torch.randint(-2 ** 40, 2 ** 40, (3,), generator=gen),
              torch.tensor(-5, dtype=torch.int32), torch.rand(9, generator=gen) > 0.5,
              torch.tensor(2.5), torch.randint(-9, 9, (5, 3), generator=gen, dtype=torch.int32),
              torch.tensor(2 ** 40 + 1), torch.randn(1, 3, generator=gen)]
    out, layout = step_graph.pack(values)
    assert out.dtype == torch.uint8 and out.dim() == 1
    assert out.numel() == sum(v.numel() * v.element_size() for v in values)
    got = step_graph.unpack(out, layout)
    for g, v in zip(got, values):
        assert g.dtype == v.dtype and g.shape == v.shape
        assert g.untyped_storage().data_ptr() == out.untyped_storage().data_ptr()
        assert (g.data_ptr() - out.data_ptr()) % g.element_size() == 0
        assert torch.equal(g.reshape(-1).view(torch.uint8), v.reshape(-1).view(torch.uint8))


def test_counters_are_counted_after_every_replay_with_its_values(monkeypatch):
    """A body that counts a device scalar and a host int, replayed 3 times:
    both are counted 3 times, the device one with each replay's value, in
    the body's order, beside one capture and 3 replays."""
    x = torch.zeros((), dtype=torch.int64)

    def body():
        x.add_(1)
        profiling.count("t.device", x * 10)
        profiling.count("t.host", 3)
        return {"x": x.clone()}

    with graph_on_cpu(monkeypatch):
        graph = step_graph.StepGraph("t", body, [x])
        with profiling.collect({}) as counts:
            metrics = [graph.replay() for _ in range(3)]
    assert [int(m["x"]) for m in metrics] == [1, 2, 3]
    assert list(counts) == ["t.graph_captures", "t.graph_replays", "t.device", "t.host"]
    assert {k: [int(v) for v in vs] for k, vs in counts.items()} == {
        "t.graph_captures": [1], "t.graph_replays": [1, 1, 1], "t.device": [10, 20, 30],
        "t.host": [3, 3, 3]}


def _own_imports(tree) -> set:
    """The modules of this package that `tree`'s import statements name."""
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            names |= {f"{node.module}.{a.name}" for a in node.names}
        elif isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
    return {n for n in names if n.startswith("dregnerf_tpu_torch")}


def test_step_graph_imports_no_trainer_and_runtime_imports_no_trainer_in_a_function():
    tree = ast.parse((PACKAGE / "runtime" / "step_graph.py").read_text())
    assert _own_imports(tree) == {"dregnerf_tpu_torch.runtime.profiling"}
    for path in sorted((PACKAGE / "runtime").glob("*.py")):
        for fn in ast.walk(ast.parse(path.read_text())):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                inside = _own_imports(fn)
                assert not any(t in n for n in inside for t in ("ngp_trainer", "reg_trainer")), \
                    (path.name, fn.name, inside)


def _ngp_steps(tmp_path):
    tr = tiny_ngp_trainer(tmp_path)
    return tr, ngp_state, "loss", tr.train_iteration


@pytest.fixture(scope="module")
def reg(tmp_path_factory):
    """One tiny RegTrainer and its pairs for this file's cases."""
    return tiny_reg_trainer(tmp_path_factory.mktemp("reg"))


def _reg_steps(reg):
    tr, ds = reg
    tr._graph = None  # a capture of its own
    items = ds.items(2)
    return tr, reg_state, "total", lambda i: tr.train_iteration(items[i])


@pytest.mark.parametrize("kind", KINDS)
def test_two_steps_metrics_do_not_alias(tmp_path, monkeypatch, request, kind):
    """Each replay's metrics are its own: the first step's keep their values
    after the second, and no two share memory; one capture, of the whole
    state."""
    with graph_on_cpu(monkeypatch, []) as captures:
        tr, state, loss, step = (_ngp_steps(tmp_path) if kind == "ngp"
                                 else _reg_steps(request.getfixturevalue("reg")))
        first = step(0)
        kept = {k: v.clone() for k, v in first.items() if isinstance(v, torch.Tensor)}
        second = step(1)
    assert not torch.equal(first[loss], second[loss])
    for k, v in kept.items():
        assert torch.equal(first[k], v), k
        assert first[k].data_ptr() != second[k].data_ptr(), k
    assert captures == [len(state(tr))]


def _ngp_failing_capture(tmp_path, monkeypatch):
    """A trainer after one step, whose update fails at a new bucket's capture."""
    tr = tiny_ngp_trainer(tmp_path)
    tr.train_iteration(0)
    real = tr.apply_gradients

    def update_then_fail(step):
        real(step)
        raise RuntimeError("out of memory")

    monkeypatch.setattr(tr, "apply_gradients", update_then_fail)
    draws = TT.draw_step_inputs(torch.Generator().manual_seed(2), 64, tr.scene.num_images,
                                tr.scene.height, tr.scene.width, "cpu")
    return tr, ngp_state(tr), lambda: tr.train_iteration(2, draws)


def _reg_failing_capture(reg, monkeypatch):
    """A trainer whose step makes a guarded update and then fails, at a
    capture."""
    tr, ds = reg
    tr._graph = None
    opt = tr.optimizer

    def update_then_fail(batches, solve_pose=True):
        opt.step(torch.ones_like(opt.flat), torch.ones(()))
        raise RuntimeError("out of memory")

    monkeypatch.setattr(tr, "_step", update_then_fail)
    return tr, reg_state(tr), lambda: tr.train_iteration(ds.items(1)[0])


@pytest.mark.parametrize("kind", KINDS)
def test_warm_up_puts_the_state_back_even_when_the_body_raises(tmp_path, monkeypatch, request,
                                                               kind):
    """The capture's warm-up updates the parameters and the optimizer, then
    its body raises: the trainer's state is as it was, and no capture is
    counted."""
    with graph_on_cpu(monkeypatch):
        tr, state, failing = (_ngp_failing_capture(tmp_path, monkeypatch) if kind == "ngp"
                              else _reg_failing_capture(request.getfixturevalue("reg"),
                                                        monkeypatch))
        before = [t.clone() for t in state]
        captures = tr.graph_captures
        with pytest.raises(RuntimeError, match="out of memory"):
            failing()
    assert tr.graph_captures == captures
    for a, b in zip(state, before):
        assert torch.equal(a, b)
