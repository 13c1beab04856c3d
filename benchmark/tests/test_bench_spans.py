"""The per-stage readers (benchmark/metrics/*_ms.py over stage_spans.py):
nothing without a trace, without units or without device times (the CPU),
and on a store with device times, each stage's milliseconds a unit."""
from __future__ import annotations

import json

import pytest
import torch

from benchmark.harness import registry
from benchmark.harness.tracing import TraceSummary
from benchmark.tests.tiny import ROOT
from dregnerf_tpu_torch.runtime import profiling

# every per-stage metric, with the span it reads in its cell
SPANS = {
    "occupancy_ms.block_train": "ngp.occupancy", "march_ms.block_train": "render.march",
    "field_ms.block_train": "render.field", "composite_ms.block_train": "render.composite",
    "backward_ms.block_train": "ngp.backward", "optimizer_ms.block_train": "ngp.optimizer",
    "fpn_ms.regtr_train": "regtr.fpn", "transformer_ms.regtr_train": "regtr.transformer",
    "heads_ms.regtr_train": "regtr.heads", "losses_ms.regtr_train": "regtr.losses",
    "backward_ms.regtr_train": "regtr.backward", "optimizer_ms.regtr_train": "regtr.optimizer",
}
TRACE = TraceSummary(busy_s=1.0, window_s=2.0, units=4, n_device_ops=100)


def _store(device: bool) -> dict:
    """A snapshot of a traced window with every span of both steps,
    4 calls each (the occupancy update once), with device ms or without."""
    spans = {}
    for i, name in enumerate(sorted({*SPANS.values(), "ngp.step", "regtr.step", "ngp.rays"})):
        calls = 1 if name == "ngp.occupancy" else 4
        spans[name] = {"calls": calls, "host_ms": 1.0 + i,
                       "device_ms": 10.0 * (i + 1) if device else None}
    return {"spans": spans, "counters": {"rle.calls": 4}}


def test_every_per_stage_metric_is_declared():
    bench = registry.load_benchmark(ROOT)
    declared = {m["name"]: m for m in bench["per_layer"] if m["source"] == "program_span"}
    assert set(declared) == set(SPANS)
    for name, m in declared.items():
        cell = "ngp-l4f8.train" if name.endswith(".block_train") else "regtr-r50.train"
        assert m["workloads"] == [cell] and m["unit"] == "ms" and m["better"] == "lower"


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_a_reader_finds_nothing_without_a_trace_units_or_device_times(metric, monkeypatch):
    read = registry.reader(metric).read
    monkeypatch.setattr(profiling, "snapshot", lambda: _store(device=True))
    assert read({"units": 4}, None) is None
    assert read({"units": 0}, TRACE) is None
    assert read({}, TRACE) is None
    monkeypatch.setattr(profiling, "snapshot", lambda: _store(device=False))
    assert read({"units": 4}, TRACE) is None


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_a_reader_gives_its_stage_ms_a_unit(metric, monkeypatch):
    store = _store(device=True)
    if metric.endswith(".block_train"):  # one cell's program: the other's spans are absent
        store["spans"] = {k: v for k, v in store["spans"].items() if not k.startswith("regtr.")}
    else:
        store["spans"] = {k: v for k, v in store["spans"].items()
                          if k.startswith("regtr.")}
    monkeypatch.setattr(profiling, "snapshot", lambda: store)
    want = store["spans"][SPANS[metric]]["device_ms"] / 4
    assert registry.reader(metric).read({"units": 4}, TRACE) == pytest.approx(want, rel=1e-12)


def test_the_cpu_store_of_a_traced_step_reads_nothing():
    """A real store, filled by a profiled CPU step: no device times, so no
    reading (the CPU line keeps the metrics it had)."""
    from dregnerf_tpu_torch.ops.rle import rle_scatter_add_safe

    profiling.reset()
    with torch.profiler.profile():
        with profiling.annotate("ngp.step"), profiling.annotate("ngp.backward"):
            rle_scatter_add_safe(torch.arange(8), torch.ones(8, 4), 4, 8)
    try:
        snap = profiling.snapshot()
        assert snap["spans"]["ngp.backward"]["calls"] == 1
        json.dumps(snap)  # spans.json's form
        for metric in SPANS:
            assert registry.reader(metric).read({"units": 1}, TRACE) is None
    finally:
        profiling.reset()


def test_a_program_without_the_store_reads_nothing(monkeypatch):
    """The readers laid over a program whose profiling module has no
    snapshot (the parent of the store) leave their metrics out."""
    monkeypatch.delattr(profiling, "snapshot")
    for metric in SPANS:
        assert registry.reader(metric).read({"units": 4}, TRACE) is None
