"""The port stands alone: neither `dregnerf_tpu_torch` nor `chip_smoke.py`
imports JAX, its libraries or the JAX package, and every port module
imports in a process where JAX cannot be imported."""
import ast
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import dregnerf_tpu_torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "dregnerf_tpu_torch"
BANNED = ("jax", "jaxlib", "flax", "optax", "dregnerf_tpu")
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_port_sources(path):
    assert not _imported_roots(path) & set(BANNED)


def test_every_port_module_imports_without_jax():
    modules = sorted(m.name for m in pkgutil.walk_packages(
        dregnerf_tpu_torch.__path__, "dregnerf_tpu_torch."))
    assert "dregnerf_tpu_torch.runtime.ngp_trainer" in modules
    code = (
        "import importlib, json, sys\n"
        f"banned = {BANNED!r}\n"
        "for name in [m for m in sys.modules if m.split('.')[0] in banned]:\n"
        "    del sys.modules[name]\n"
        "for name in banned:\n"
        "    sys.modules[name] = None  # any import of it raises ImportError\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', 'chip_smoke.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "                        if m.split('.')[0] in banned and sys.modules[m])))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_chip_smoke_fails_without_a_card_and_prints_no_result(tmp_path):
    """Without CUDA the smoke script exits non-zero and prints no result;
    the CPU test environment stands in for a machine without a card."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
