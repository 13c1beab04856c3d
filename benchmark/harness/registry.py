"""Finds a cell's files by the names in BENCHMARK.json.

  configuration  the `file` of its `configs` entry (benchmark/configs/)
  cell           benchmark/workloads/<cell name>.json, whose `driver`
                 key names benchmark/drivers/<driver>.py
  metric         benchmark/metrics/<family>.py, the family being the
                 metric's name before its first dot

A new configuration, cell or per-layer metric is a new file and a new
entry; nothing here names one.
"""
from __future__ import annotations

import importlib
import json
import os

BENCH_DIR = "benchmark"


def load_benchmark(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_json(root: str, rel: str) -> dict:
    with open(os.path.join(root, rel)) as f:
        return json.load(f)


def cell_files(root: str, bench: dict, cell_name: str) -> tuple[dict, dict, dict]:
    """(the cell's entry, its configuration file, its workload file)."""
    cell = find(bench["workloads"], cell_name, "workload")
    config = load_json(root, find(bench["configs"], cell["config"], "config")["file"])
    workload = load_json(root, f"{BENCH_DIR}/workloads/{cell_name}.json")
    return cell, config, workload


def driver(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}")


def reader(metric_name: str):
    return importlib.import_module(f"benchmark.metrics.{metric_name.split('.', 1)[0]}")


def end_to_end_for(bench: dict, cell_name: str) -> list[dict]:
    """The end-to-end metrics that the cell reports."""
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell_name in m["workloads"]]


def per_layer_for(bench: dict, cell_name: str) -> list[dict]:
    """The per-layer metrics that the cell reports: those whose
    `workloads` list names it (every per-layer entry has the list)."""
    for m in bench["per_layer"]:
        if "workloads" not in m:
            raise KeyError(f"per-layer metric {m['name']!r} lists no workloads")
    return [m for m in bench["per_layer"] if cell_name in m["workloads"]]
