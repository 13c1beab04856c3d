"""The port's runtime and utility modules against the JAX package's, on the
CPU: resilience (retries, the watchdog, the NaN guard), the scalar logger,
profiling (the port's own span store), the checkpoint exporter, the pose viewer, the sampler, the
feature colours, the mesh export; and the NGP trainer's train() logging in
JAX's format under the watchdog.

Tolerances: features_to_rgb within 1e-6 (float64 SVDs, f32 output);
everything else equal: printed and written lines, JSON states, sampler
ids, mesh vertices and faces, exported tensors and files byte for byte."""
import json
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from dregnerf_tpu.runtime import export_torch as jexport
from dregnerf_tpu.runtime import logging as jlogging
from dregnerf_tpu.runtime import resilience as jres
from dregnerf_tpu.utils import feature_visualizer as jfeat
from dregnerf_tpu.utils import pose_server as jpose
from dregnerf_tpu.utils import sampler as jsampler
from dregnerf_tpu.utils import visualization as jvis
from dregnerf_tpu_torch.datasets import fixtures as tfix
from dregnerf_tpu_torch.models import ngp as tngp
from dregnerf_tpu_torch.runtime import checkpoint as tckpt
from dregnerf_tpu_torch.runtime import export_torch as pexport
from dregnerf_tpu_torch.runtime import logging as plogging
from dregnerf_tpu_torch.runtime import ngp_trainer as TT
from dregnerf_tpu_torch.runtime import profiling as pprofiling
from dregnerf_tpu_torch.runtime import resilience as pres
from dregnerf_tpu_torch.runtime.config import config_parser
from dregnerf_tpu_torch.utils import feature_visualizer as pfeat
from dregnerf_tpu_torch.utils import pose_server as ppose
from dregnerf_tpu_torch.utils import sampler as psampler
from dregnerf_tpu_torch.utils import visualization as pvis
from torch_views_common import camera_ring, save_jax_block

ROOT = Path(__file__).resolve().parent.parent


# ----------------------------------------------------------------- resilience

@pytest.mark.parametrize("msg", ["Broken pipe", "x response body closed y", "UNAVAILABLE: z",
                                 "DEADLINE_EXCEEDED", "Connection reset by peer",
                                 "real bug", "CUDA error: out of memory", ""])
def test_is_transient_matches_jax(msg):
    exc = RuntimeError(msg)
    assert pres.is_transient(exc) == jres.is_transient(exc)


def _scenario(module, failures, max_retries=2, fail_save=False):
    """fn fails with the given messages in turn, then returns 7; returns
    (result or the exception's text, calls, on_failure's arguments)."""
    calls, saved = [0], []

    def fn():
        calls[0] += 1
        if calls[0] <= len(failures):
            raise RuntimeError(failures[calls[0] - 1])
        return 7

    def on_failure(exc):
        saved.append(str(exc))
        if fail_save:
            raise OSError("disk full")

    try:
        out = module.run_with_retries(fn, max_retries=max_retries, backoff_s=0.0,
                                      on_failure=on_failure)
    except RuntimeError as exc:
        out = f"raised {exc}"
    return out, calls[0], saved


@pytest.mark.parametrize("failures,fail_save", [
    (["Broken pipe", "UNAVAILABLE"], False),  # retried, then the value
    (["real bug"], False),  # fatal: on_failure, re-raised
    (["Broken pipe"] * 3, False),  # transient past the budget of 2
    (["real bug"], True)])  # the emergency save fails too
def test_run_with_retries_matches_jax(failures, fail_save, capsys):
    got = _scenario(pres, failures, fail_save=fail_save)
    got_out = capsys.readouterr().out
    want = _scenario(jres, failures, fail_save=fail_save)
    assert got == want and got_out == capsys.readouterr().out
    assert got[0] == (7 if len(failures) == 2 else f"raised {failures[-1]}")


def _tree(bad=None):
    """A mixed tree of tensors and arrays; `bad` names the leaf given a NaN."""
    tree = {"model": {"table": torch.ones(4), "mlp": [np.ones(3, np.float32),
                                                       torch.ones(2, dtype=torch.bfloat16)]},
            "count": torch.tensor(3), "ids": np.arange(4)}
    if bad == "model/table":
        tree["model"]["table"][1] = float("nan")
    elif bad == "model/mlp/0":
        tree["model"]["mlp"][0][2] = np.inf
    elif bad == "model/mlp/1":
        tree["model"]["mlp"][1][0] = float("-inf")
    return tree


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v) for v in tree]
    return tree.float().numpy() if isinstance(tree, torch.Tensor) else tree


@pytest.mark.parametrize("bad", [None, "model/table", "model/mlp/0", "model/mlp/1"])
def test_guard_nans_matches_jax_and_names_the_leaf(bad):
    tree = _tree(bad)
    if bad is None:
        pres.guard_nans(tree, "ok")
        jres.guard_nans(_numpy_tree(tree), "ok")
        return
    with pytest.raises(FloatingPointError, match=f"^non-finite values at step 3:{bad}$"):
        pres.guard_nans(tree, "step 3")
    with pytest.raises(FloatingPointError):
        jres.guard_nans(_numpy_tree(tree), "step 3")


def test_watchdog_beats_and_disabled():
    import threading

    before = threading.active_count()
    with pres.Watchdog(timeout_s=0, name="off") as wd:
        wd.beat()
        assert threading.active_count() == before and wd._stop is None
    assert pres.Watchdog.EXIT_CODE == jres.Watchdog.EXIT_CODE == 86
    with pres.Watchdog(timeout_s=60.0, name="on") as wd:
        assert threading.active_count() == before + 1
        last = wd._last
        time.sleep(0.01)
        wd.beat()
        assert wd._last > last
    assert wd._stop.is_set()


def test_watchdog_fires_in_a_subprocess():
    """Beats keep the process alive past the timeout; a stale heartbeat then
    exits with code 86 and JAX's message."""
    code = (
        "import time\n"
        "from dregnerf_tpu_torch.runtime.resilience import Watchdog\n"
        "with Watchdog(timeout_s=1.0, name='sub') as wd:\n"
        "    for _ in range(25):\n"
        "        time.sleep(0.1)\n"
        "        wd.beat()\n"
        "    print('alive after 2.5 s of beats', flush=True)\n"
        "    time.sleep(30)\n"
        "print('should not reach here')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=60)
    assert r.returncode == 86, r.stderr
    assert "alive after 2.5 s of beats" in r.stdout
    assert "[watchdog:sub] no heartbeat for" in r.stdout and "should not" not in r.stdout


# -------------------------------------------------------------------- logging

SCALARS = {"train/loss": 0.0123456789, "train/psnr": 31.5, "train/num_rays": 4096,
           "elapsed_s": 12.25, "val/x": 1e-7}


def test_scalar_logger_lines_match_jax(tmp_path, capsys):
    for name, module in (("port", plogging), ("jax", jlogging)):
        logger = module.ScalarLogger(str(tmp_path / name / "tb"),
                                     text_path=str(tmp_path / f"{name}.txt"))
        logger.log_scalars(5, SCALARS)
        logger.log_scalars(6, {"loss": 2})
        logger.log_image(6, "img", np.zeros((2, 2, 3)))  # no writer: nothing
        logger.close()
    out = capsys.readouterr().out.splitlines()
    assert out[:2] == out[2:] and out[0].startswith("step 5 | train/loss 0.012346 | ")
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax.txt").read_text()
    assert not (tmp_path / "port" / "tb").exists()


def test_scalar_logger_writes_tensorboard_events(tmp_path):
    logger = plogging.ScalarLogger(str(tmp_path / "tb"), enable_tensorboard=True)
    assert logger.writer is not None
    logger.log_scalars(1, {"loss": 0.5})
    logger.log_image(1, "img", np.random.default_rng(0).uniform(size=(4, 5, 3)))
    logger.close()
    events = list((tmp_path / "tb").glob("events.out.tfevents.*"))
    assert len(events) == 1 and events[0].stat().st_size > 0


def test_scalar_logger_without_tensorboardx_says_so(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    lines = []
    for module in (plogging, jlogging):
        logger = module.ScalarLogger(str(tmp_path / "tb"), enable_tensorboard=True)
        assert logger.writer is None
        lines.append(capsys.readouterr().out)
    assert lines[0] == lines[1] and lines[0].startswith("[logging] tensorboard unavailable:")


# ------------------------------------------------------------------ profiling

def test_span_store_counts_calls_and_host_ms(monkeypatch):
    """The port's own span store (the JAX package has none): calls and host
    ms of each span over a patched clock, counters of host ints and device
    scalars summed when read, and reset."""
    clock = iter([0, 250_000, 1_000_000, 1_500_000, 2_000_000, 2_000_000, 3_000_000,
                  3_125_000])
    monkeypatch.setattr(pprofiling.time, "perf_counter_ns", lambda: next(clock))
    pprofiling.reset()
    with torch.profiler.profile():
        for name in ("step", "step", "val", "io"):
            with pprofiling.annotate(name):
                pprofiling.count("rows", 3)
                pprofiling.count("live", torch.tensor(2))
    snap = pprofiling.snapshot()
    assert snap["spans"] == {"step": {"calls": 2, "host_ms": 0.75, "device_ms": None},
                             "val": {"calls": 1, "host_ms": 0.0, "device_ms": None},
                             "io": {"calls": 1, "host_ms": 0.125, "device_ms": None}}
    assert snap["counters"] == {"rows": 12, "live": 8}
    assert pprofiling.snapshot() == snap  # a second read sums nothing twice
    pprofiling.reset()
    assert pprofiling.snapshot() == {"spans": {}, "counters": {}}


def test_trace_writes_a_trace_with_the_annotation(tmp_path):
    with pprofiling.trace(str(tmp_path)):
        with pprofiling.annotate("port_annotated_region"):
            x = torch.ones(64, 64)
            (x @ x).sum()
    files = list(tmp_path.rglob("*.pt.trace.json"))
    assert len(files) == 1
    assert "port_annotated_region" in files[0].read_text()
    spans = json.loads((tmp_path / "spans.json").read_text())
    assert spans == {"spans": {"port_annotated_region": {
        "calls": 1, "host_ms": spans["spans"]["port_annotated_region"]["host_ms"],
        "device_ms": None}}, "counters": {}}


# --------------------------------------------------------------------- export

def _port_checkpoint(path):
    """A block written by the port's checkpoint writer (f32 and bool
    leaves, nested lists, the meta's lists, floats and strings)."""
    cfg = tngp.NGPConfig(grid=tngp.PackedGridConfig(n_levels=2, log2_table_size=8),
                         compute_dtype=torch.float32)
    params = tngp.init_ngp(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    meta = {"aabb": [-1.0, -1.0, -1.0, 1.0, 1.0, 1.0], "unbounded": False,
            "grid_resolution": 8, "contraction_type": "aabb", "near_plane": 0.0,
            "far_plane": 1e10, "render_step_size": 0.01, "alpha_thre": 0.0, "cone_angle": 0.0,
            "camera_poses": camera_ring(2).tolist(), "block_id": 1, "field": "ngp",
            "model_config": tngp.config_to_meta(cfg), "step": 12}
    tckpt.save_checkpoint(path, {"model": params, "occupancy": {
        "occs": torch.from_numpy(rng.uniform(size=512).astype(np.float32)),
        "binary": torch.from_numpy(rng.uniform(size=(8, 8, 8)) < 0.5)}}, meta)
    return path


def _assert_same_export(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], dict) and k in ("model", "occupancy_grid"):
            assert got[k].keys() == want[k].keys()
            for name, t in want[k].items():
                assert got[k][name].dtype == t.dtype and torch.equal(got[k][name], t), name
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_export_reference_pth_matches_jax(writer, tmp_path):
    ckpt = str(tmp_path / "model.ckpt")
    if writer == "jax":
        save_jax_block(ckpt)
    else:
        _port_checkpoint(ckpt)
    got_path = pexport.export_reference_pth(ckpt, str(tmp_path / "port.pth"))
    want_path = jexport.export_reference_pth(ckpt, str(tmp_path / "jax.pth"))
    got = torch.load(got_path)  # the default weights_only=True loads it
    want = torch.load(want_path)
    _assert_same_export(got, want)
    assert got["field"] == "ngp" and "table" in got["model"] and "binary" in got["occupancy_grid"]
    assert pexport.export_reference_pth(ckpt) == str(tmp_path / "model.pth")


def test_export_cli(tmp_path, capsys):
    ckpt = _port_checkpoint(str(tmp_path / "a.ckpt"))
    pexport.main([ckpt, "--out", str(tmp_path / "b.pth")])
    assert capsys.readouterr().out.strip() == f"wrote {tmp_path / 'b.pth'}"
    with pytest.raises(SystemExit, match="exactly one"):
        pexport.main([ckpt, ckpt, "--out", str(tmp_path / "c.pth")])


# ---------------------------------------------------------------- pose viewer

def _push_all(module, server):
    rng = np.random.default_rng(4)
    gt = np.concatenate([camera_ring(5), rng.normal(size=(5, 1, 4)).astype(np.float32)], 1)
    gt[:, 3] = [0, 0, 0, 1]
    pred = camera_ring(4, phase=0.1)
    cloud = rng.normal(size=(2000, 3))
    traces = [module.point_trace(cloud, "#999999", seed=1),
              module.point_trace(cloud[:300], "#4488ff", seed=2)]
    module.visualize_cameras(server, 17, poses=[gt, pred], cam_depth=0.15,
                             colors=("#4488ff", "#ff44cc"), extra_traces=traces)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.read().decode()


def test_pose_server_state_matches_jax():
    servers = [ppose.PoseVizServer(port=0), jpose.PoseVizServer(port=0)]
    try:
        assert json.loads(_get(servers[0].port, "/state.json")) == {"step": None, "traces": []}
        _push_all(ppose, servers[0])
        _push_all(jpose, servers[1])
        states = [_get(s.port, "/state.json") for s in servers]
        pages = [_get(s.port, "/") for s in servers]
    finally:
        for s in servers:
            s.close()
    assert states[0] == states[1] and pages[0] == pages[1]
    state = json.loads(states[0])
    assert state["step"] == 17 and [t["kind"] for t in state["traces"]] == ["points"] * 2 + \
        ["lines"] * 3
    assert len(state["traces"][0]["points"]) == 800
    np.testing.assert_array_equal(ppose.camera_wireframes(camera_ring(3)),
                                  jpose.camera_wireframes(camera_ring(3)))


# ------------------------------------------------------- sampler, features, mesh

def test_simple_sampler_matches_jax_over_three_epochs():
    got, want = psampler.SimpleSampler(10, 4, seed=3), jsampler.SimpleSampler(10, 4, seed=3)
    for _ in range(9):  # 3 batches an epoch (4, 4, 2)
        np.testing.assert_array_equal(got.nextids(), want.nextids())
    it = psampler.cycle([1, 2, 3])
    assert [next(it) for _ in range(7)] == [1, 2, 3, 1, 2, 3, 1]


def test_feature_colours_match_jax(tmp_path):
    rng = np.random.default_rng(6)
    feats = rng.normal(size=(300, 32)).astype(np.float32)
    xyz = rng.uniform(-1, 1, (300, 3))
    got, want = pfeat.features_to_rgb(feats), jfeat.features_to_rgb(feats)
    assert got.dtype == np.float32 and got.min() == 0.0 and got.max() == 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    pfeat.save_feature_cloud(str(tmp_path / "p.ply"), xyz, feats)
    jfeat.save_feature_cloud(str(tmp_path / "j.ply"), xyz, feats)
    assert (tmp_path / "p.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


def test_sdf_to_mesh_matches_jax(tmp_path):
    g = np.linspace(-1, 1, 7)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    sdf = np.sqrt(x ** 2 + (1.3 * y) ** 2 + z ** 2) - 0.7
    for level in (0.0, 0.15):
        got = pvis.sdf_to_mesh(sdf, level, origin=(-1, -1, -1), spacing=(1 / 3,) * 3)
        want = jvis.sdf_to_mesh(sdf, level, origin=(-1, -1, -1), spacing=(1 / 3,) * 3)
        assert len(got[1]) > 50
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    verts, faces = got
    pvis.save_mesh_ply(str(tmp_path / "p.ply"), verts, faces)
    jvis.save_mesh_ply(str(tmp_path / "j.ply"), verts, faces)
    assert (tmp_path / "p.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    empty = pvis.sdf_to_mesh(np.ones((3, 3, 3)))
    assert empty[0].shape == (0, 3) and empty[1].shape == (0, 3)


# --------------------------------------------------------------- NGP trainer

def test_ngp_train_logs_jax_lines_under_the_watchdog(tmp_path, monkeypatch):
    """train() for 2 steps on the CPU (a tiny field): each step inside the
    watchdog with a beat after it, log.txt in JAX's ScalarLogger format for
    the scalars log.jsonl holds, the checkpoint at the last step."""
    beats = []

    class Recorder(pres.Watchdog):
        def __enter__(self):
            beats.append(("enter", self.timeout_s, self.name))
            return super().__enter__()

        def beat(self):
            beats.append("beat")
            super().beat()

    monkeypatch.setattr(TT, "Watchdog", Recorder)
    cfg = config_parser(["--expname", "tiny", "--out_dir", str(tmp_path), "--max_iterations",
                         "2", "--sample_budget", str(1 << 12), "--max_march_steps", "64",
                         "--grid_resolution", "16", "--init_num_rays", "256",
                         "--n_tensorboard", "1", "--n_validation", "1000",
                         "--n_checkpoint", "1000", "--no_bf16", "--watchdog_s", "600"])
    trainer = TT.NGPTrainer(cfg, tfix.make_scene_data("train", num_views=4, image_size=16),
                            device="cpu")
    trainer.model_config = tngp.NGPConfig(
        grid=tngp.PackedGridConfig(n_levels=2, log2_table_size=8), compute_dtype=torch.float32)
    trainer.params = tngp.init_ngp(trainer.model_config, torch.Generator().manual_seed(0), "cpu")
    for p in tngp.parameters(trainer.params):
        p.requires_grad_(True)
    trainer.setup_optimizer()
    trainer.train()
    assert beats == [("enter", 600.0, "tiny"), "beat", "beat", "beat"]  # entry's, 2 steps
    out = tmp_path / "tiny"
    with open(out / "log.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records] == [0, 1]
    jax_txt = tmp_path / "jax_log.txt"
    logger = jlogging.ScalarLogger(str(tmp_path / "tb"), text_path=str(jax_txt))
    for r in records:
        logger.log_scalars(r.pop("step"), r)
    logger.close()
    assert (out / "log.txt").read_text() == jax_txt.read_text()
    assert (out / "model" / "model.ckpt").exists() and trainer.step == 2
