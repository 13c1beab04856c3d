"""Nothing of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program (whole top-level names: the
port's name begins with the JAX package's)."""
from __future__ import annotations

import ast
import os

from benchmark.tests.tiny import ROOT

BENCH = os.path.join(ROOT, "benchmark")
FORBIDDEN = {"jax", "jaxlib", "flax", "dregnerf_tpu"}


def _imports(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _files(top: str):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere_in_the_benchmark():
    bad = {p: _imports(p) & FORBIDDEN for p in _files(BENCH)}
    assert not {p: b for p, b in bad.items() if b}


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    bad = {p: _imports(p) & (FORBIDDEN | {"dregnerf_tpu_torch"}) for p in _files(ref)}
    assert not {p: b for p, b in bad.items() if b}


def test_the_scan_tells_the_port_from_the_jax_package(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import dregnerf_tpu_torch.ops\nfrom dregnerf_tpu.models import ngp\n")
    assert _imports(str(f)) & FORBIDDEN == {"dregnerf_tpu"}
