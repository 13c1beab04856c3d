"""The port stands alone: neither `dregnerf_tpu_torch`, `chip_smoke.py` nor
`probes/` imports JAX, its libraries or the JAX package, every port module imports
in a process where JAX cannot be imported, and the port reads its own
copies of the registration split JSONs. One `cuda` test holds the
registration forward on the card against the CPU (this file imports no
JAX, so it runs on the card with --noconftest)."""
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
PORT_FILES = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "probes").glob("*.py")))


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


@pytest.mark.parametrize("path", sorted(p for p in PORT.rglob("*") if p.suffix in
                                         (".py", ".cu", ".cpp")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_never_name_the_jax_packages_native_build(path):
    """The port builds its own copy of the FGR source (csrc/fgr.cpp) and
    loads its own library: no source names the pre-built library or the
    directory it lives in."""
    text = path.read_text()
    assert "libdregnative" not in text and "native/" not in text


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


LAZY = ("imageio", "h5py", "PIL")  # image and HDF5 decoding, absent on the card's machine


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_sklearn_and_lazy_decoders(path):
    """No port file imports sklearn (the port clusters cameras with its own
    k-means), and imageio, h5py and PIL are imported only inside the
    functions that read files, never when a module is imported."""
    tree = ast.parse(path.read_text(), str(path))
    assert "sklearn" not in _imported_roots(path)
    for node in tree.body:  # module-level statements only
        for sub in ast.walk(node):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                break
            if isinstance(sub, ast.Import):
                names = [a.name.split(".")[0] for a in sub.names]
            elif isinstance(sub, ast.ImportFrom) and sub.level == 0:
                names = [sub.module.split(".")[0]]
            else:
                continue
            assert not set(names) & set(LAZY), f"{path}:{sub.lineno} imports {names}"


def test_loaders_import_without_decoders():
    """Every loader of --dataset imports in a process where imageio, h5py,
    PIL and sklearn cannot be imported, and splits a scene into blocks."""
    code = (
        "import sys\n"
        "for name in ('imageio', 'h5py', 'PIL', 'sklearn'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np\n"
        "from dregnerf_tpu_torch.datasets import base\n"
        "for name in set(base.DATASET_MODULES.values()) - {'dnerf_synthetic'}:\n"
        "    base.dataset_module(name)\n"
        "print(base.cluster_cameras(np.stack([np.eye(4)[:3]] * 3 + [np.eye(4)[:3] + 5] * 3)"
        ".astype(np.float32), 2).tolist())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) in ([0, 0, 0, 1, 1, 1],
                                                              [1, 1, 1, 0, 0, 0])


def test_port_reads_its_own_split_jsons():
    from dregnerf_tpu_torch.datasets import register_pairs

    json_dir = Path(register_pairs.JSON_DIR).resolve()
    assert json_dir == PORT / "datasets" / "register"
    for name in ("objaverse.json", "obj_id_names.json"):
        assert (json_dir / name).is_file()
    assert register_pairs.load_split_subjects("", "objaverse", "test")


def test_stage3_training_modules_are_in_the_port():
    """The registration-training modules, the CLI twin and the classical
    registration modules exist in the package, so the import checks above
    cover them."""
    for rel in ("losses/registration.py", "losses/visibility.py", "runtime/reg_optim.py",
                "runtime/reg_trainer.py", "train_nerf_regtr.py", "registration/icp.py",
                "registration/global_icp.py", "registration/fgr.py", "registration/pipeline.py"):
        assert (PORT / rel) in PORT_FILES, rel


def _pair_scene(root: Path, r: int = 8) -> None:
    """Two blocks of one scene (identity world frames), voxel artifacts only."""
    import numpy as np
    import torch

    from dregnerf_tpu_torch.datasets.base import save_world_frame_transforms

    flat = np.arange(0, r ** 3, 7)
    grid = np.zeros((r ** 3, 7), np.float32)
    grid[flat, :3] = np.random.default_rng(0).uniform(-1, 1, (len(flat), 3))
    grid[flat, 3:] = 0.5
    for b in (0, 1):
        block = root / "nerf_models" / "s" / f"block_{b}"
        block.mkdir(parents=True)
        torch.save(torch.from_numpy(grid.reshape(r, r, r, 7)), block / "voxel_grid.pt")
        torch.save(torch.from_numpy(flat.astype(np.int64)), block / "voxel_mask.pt")
        (block / "model.ckpt").write_bytes(b"")
    (root / "images" / "s").mkdir(parents=True)
    save_world_frame_transforms(str(root / "images" / "s"), {0: np.eye(4), 1: np.eye(4)})


def test_training_entry_points_run_on_cuda_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    """RegTrainer, the train CLI twin and the exact-visibility loader take
    cuda unless given a device, and raise without CUDA."""
    import torch

    from dregnerf_tpu_torch import train_nerf_regtr
    from dregnerf_tpu_torch.datasets.register_pairs import NeRFRegDataset
    from dregnerf_tpu_torch.losses.visibility import load_visibility_context
    from dregnerf_tpu_torch.runtime.config import config_parser
    from dregnerf_tpu_torch.runtime.reg_trainer import RegTrainer

    _pair_scene(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--root_dir", str(tmp_path), "--scene", "s", "--out_dir", str(tmp_path / "out")]
    ds = NeRFRegDataset(str(tmp_path), subject_id="s", split="train")
    with pytest.raises(RuntimeError, match="CUDA"):
        RegTrainer(config_parser(argv), ds, ds)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_nerf_regtr.main(argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_visibility_context(str(tmp_path / "no_such.ckpt"))


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_regtr_forward_on_the_card_matches_the_cpu(cuda_device):
    """The full-width NeRFRegTr in f32 (TF32 off) on a pair of R = 16 grids:
    level and validity exact, conditioned features within 1e-3 of their max,
    poses within 1e-3, on the card and on the CPU with the same weights."""
    import numpy as np
    import torch

    from dregnerf_tpu_torch.models.regtr import NeRFRegTr, params_from_jax, random_jax_params

    rng = np.random.default_rng(0)
    r, data = 16, {}
    for side in ("src", "tgt"):
        grid = np.zeros((r, r, r, 7), np.float32)
        ii = rng.integers(2, r - 2, size=(300, 3))
        flat = ii[:, 0] * r * r + ii[:, 1] * r + ii[:, 2]
        grid.reshape(-1, 7)[flat, :3] = (ii + 0.5) / r * 2.0 - 1.0
        grid.reshape(-1, 7)[flat, 3:] = rng.uniform(size=(300, 4))
        mask = np.zeros(r ** 3, bool)
        mask[flat] = True
        data[f"{side}_grid"], data[f"{side}_mask"] = grid, mask
    model = NeRFRegTr()
    model.load_state_dict(params_from_jax(random_jax_params(model, rng), model))
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            want = model({k: torch.as_tensor(v) for k, v in data.items()})
            got = model.to(cuda_device)({k: torch.as_tensor(v, device=cuda_device)
                                         for k, v in data.items()})
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    got = {k: v.cpu() for k, v in got.items()}
    assert int(got["ds_level"]) == int(want["ds_level"])
    for key in ("src_valid", "tgt_valid"):
        assert torch.equal(got[key], want[key])
    for key in ("src_feats", "tgt_feats"):
        assert (got[key] - want[key]).abs().max() <= 1e-3 * want[key].abs().max()
    assert (got["pose"] - want["pose"]).abs().max() <= 1e-3
