"""Exact visibility, the trainer's options and the train CLI twin of the
port on the CPU: labels marched through a tiny NGP block against the JAX
package's, guarded exact steps, the options that are not ported or
invalid, the live pose viewer against JAX's, and
`python -m dregnerf_tpu_torch.train_nerf_regtr --device cpu`."""
import json
import math
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dregnerf_tpu.runtime import reg_trainer as JRT
from dregnerf_tpu_torch.runtime import reg_trainer as PRT
from dregnerf_tpu_torch.runtime.checkpoint import load_checkpoint
from torch_reg_common import few_torch_threads  # noqa: F401 (an autouse fixture)
from torch_reg_common import LOSS_KEYS, TINY, _ngp_checkpoint, pair_root, port_trainer


@pytest.fixture(scope="module")
def ngp_ckpt(tmp_path_factory):
    return _ngp_checkpoint(str(tmp_path_factory.mktemp("ngp") / "model.ckpt"))


def test_exact_visibility_labels_match_jax(ngp_ckpt):
    """make_exact_visibility_fns of both packages on the same checkpoint
    (4 of its 5 cameras, 64-ray chunks): equal labels on [2, 100, 3]
    points, except where the port's score is within 1e-4 of the 0.5
    cutoff; both labels present."""
    from dregnerf_tpu_torch.losses import visibility as pvis

    pts = np.random.default_rng(1).uniform(-1.1, 1.1, (2, 100, 3)).astype(np.float32)
    jsrc, _ = JRT.make_exact_visibility_fns(ngp_ckpt, ngp_ckpt, max_cameras=4,
                                            buffer_size=1 << 12)
    want = np.asarray(jsrc(jnp.asarray(pts)))
    psrc, _ = PRT.make_exact_visibility_fns(ngp_ckpt, ngp_ckpt, max_cameras=4,
                                            buffer_size=1 << 12, device="cpu")
    got = psrc(torch.from_numpy(pts))
    assert got.shape == (2, 100) and got.dtype == torch.float32
    ctx, mcfg, rcfg = pvis.load_visibility_context(ngp_ckpt, 4, "cpu")
    assert ctx.cam_origins.shape == (4, 3)
    scores = pvis.exact_visibility_scores(ctx.params, mcfg, ctx.grid, ctx.aabb, rcfg,
                                          ctx.cam_origins, torch.from_numpy(pts.reshape(-1, 3)),
                                          1 << 12).reshape(2, 100).numpy()
    clear = np.abs(scores - 0.5) > 1e-4
    np.testing.assert_array_equal(got.numpy()[clear], want[clear])
    np.testing.assert_array_equal((scores >= 0.5).astype(np.float32), got.numpy())
    assert 10 <= want.sum() <= want.size - 10, want.sum()


@pytest.fixture(scope="module")
def exact_root(pair_root, ngp_ckpt, tmp_path_factory):
    """pair_root's scene with the tiny NGP checkpoint as each block's NeRF."""
    import shutil

    root = str(tmp_path_factory.mktemp("exact"))
    shutil.copytree(pair_root, root, dirs_exist_ok=True)
    for k in (0, 1):
        shutil.copyfile(ngp_ckpt, os.path.join(root, "nerf_models", "test_scene", f"block_{k}",
                                               "model.ckpt"))
    return root


@pytest.mark.parametrize("warped", ["grid", "exact"])
def test_exact_visibility_steps(exact_root, tmp_path, warped):
    """Two guarded steps with --visibility exact (4 cameras, 2^12 buffer):
    finite losses, both NeRF contexts cached once, optimizer counts at 2;
    --vis_exact_warped marches the warped keypoints too."""
    extra = ["--visibility", "exact", "--vis_max_cameras", "4", "--vis_buffer_size",
             str(1 << 12)]
    if warped == "exact":
        extra.append("--vis_exact_warped")
    tr = port_trainer(exact_root, str(tmp_path), extra)
    for _ in range(2):
        m = tr.train_iteration(tr.train_dataset[0])
        for k in (*LOSS_KEYS, "total"):
            assert math.isfinite(float(m[k])), k
        assert float(m["skipped_nonfinite"]) == 0.0
    assert len(tr._vis_cache) == 2 and int(tr.optimizer.count) == 2


def test_exact_steps_gather_from_every_level_of_both_fields(exact_root, tmp_path,
                                                            monkeypatch):
    """The rows of an exact step come through packed_grid.gather_rows (K2p
    on the card) from each level table of the two NeRF contexts and from
    no other table: the map that chip_smoke.py uses to hold the path's own
    K2p calls against index_select."""
    from dregnerf_tpu_torch.ops import packed_grid
    from dregnerf_tpu_torch.ops.gather_rows import gather_rows_plain

    real, seen = packed_grid.gather_rows, {}

    def recorded(table, idx):
        out = real(table, idx)
        seen.setdefault(table.data_ptr(), (table, idx, out))
        return out

    monkeypatch.setattr(packed_grid, "gather_rows", recorded)
    tr = port_trainer(exact_root, str(tmp_path), ["--visibility", "exact", "--vis_max_cameras",
                                                  "4", "--vis_buffer_size", str(1 << 12)])
    item = tr.train_dataset[0]
    tr.train_iteration(item)
    tables = {t.data_ptr() for side in ("src", "tgt")
              for t in tr._get_vis_ctx(item[f"{side}_nerf_path"]).params["packed_table"]}
    assert len(tables) == 2 * len(tr._get_vis_ctx(item["src_nerf_path"]).params["packed_table"])
    assert set(seen) == tables
    for table, idx, out in seen.values():
        assert torch.equal(out, gather_rows_plain(table, idx))


def test_exact_visibility_refuses_a_mixed_fleet(exact_root, tmp_path):
    other = _ngp_checkpoint(str(tmp_path / "other.ckpt"), log2_table_size=9)
    tr = port_trainer(exact_root, str(tmp_path), ["--visibility", "exact"])
    tr._get_vis_ctx(os.path.join(exact_root, "nerf_models", "test_scene", "block_0",
                                 "model.ckpt"))
    with pytest.raises(ValueError, match="config-homogeneous"):
        tr._get_vis_ctx(other)


# ---------------------------------------------------------- options and CLI

@pytest.mark.parametrize("flags,error", [
    (["--mesh_shape", "2,1"], NotImplementedError),
    (["--visibility", "exact", "--reg_batch_size", "2"], ValueError)])
def test_unported_or_invalid_options_raise(pair_root, tmp_path, flags, error):
    with pytest.raises(error, match="ROADMAP" if error is NotImplementedError else "batch"):
        port_trainer(pair_root, str(tmp_path), flags)


def test_visdom_pushes_jax_traces(pair_root, tmp_path, monkeypatch):
    """--enable_visdom (on a free port): validate() pushes the first pair it
    scores, and /state.json holds what JAX's _push_pose_viz pushes for the
    same batch, pose and iteration: 3 point clouds, two frustum sets and
    the centre segment."""
    import urllib.request
    from types import SimpleNamespace

    from dregnerf_tpu.utils.pose_server import PoseVizServer

    tr = port_trainer(pair_root, str(tmp_path), ["--enable_visdom", "--visdom_port", "0"])
    seen = []
    real = tr._push_pose_viz
    monkeypatch.setattr(tr, "_push_pose_viz", lambda b, p: (seen.append((b, p)), real(b, p)))
    tr.iteration = 3
    try:
        tr.validate(fraction=1.0)
        with urllib.request.urlopen(f"http://127.0.0.1:{tr.pose_viz.port}/state.json",
                                    timeout=10) as r:
            state = json.loads(r.read())
    finally:
        tr.pose_viz.close()
    assert len(seen) == 1
    batch, pose = seen[0]
    jserver = PoseVizServer(port=0)
    try:
        jself = SimpleNamespace(aabb=jnp.asarray(tr.config.aabb, jnp.float32),
                                grid_resolution=tr.grid_resolution, iteration=3,
                                pose_viz=jserver)
        JRT.RegTrainer._push_pose_viz(jself, {k: v.numpy() for k, v in batch.items()},
                                      pose.float().numpy())
        with urllib.request.urlopen(f"http://127.0.0.1:{jserver.port}/state.json",
                                    timeout=10) as r:
            want = json.loads(r.read())
    finally:
        jserver.close()
    assert state == want
    assert state["step"] == 3
    assert [t["kind"] for t in state["traces"]] == ["points"] * 3 + ["lines"] * 3


def test_train_cli_on_the_cpu(pair_root, tmp_path, capsys, monkeypatch):
    """`python -m dregnerf_tpu_torch.train_nerf_regtr --device cpu` for one
    epoch of the one train pair at the default bf16, with the model factory
    narrowed to the tiny width (the full one is held on the card by
    chip_smoke.py): a validation, a checkpoint with the JAX keys, both logs
    and, with --enable_tensorboard, an event file under logs/cli."""
    from dregnerf_tpu_torch import train_nerf_regtr
    from dregnerf_tpu_torch.models.regtr import NeRFRegTr

    made = []

    def tiny(config, dtype=torch.float32):
        made.append(dtype)
        return NeRFRegTr(dtype=dtype, **TINY)

    monkeypatch.setattr(PRT, "make_reg_model", tiny)
    tr = train_nerf_regtr.main([
        "--root_dir", pair_root, "--scene", "test_scene", "--out_dir", str(tmp_path),
        "--expname", "cli", "--position_embedding_dim", "32", "--num_downsample", "2",
        "--epochs", "1", "--n_tensorboard", "1", "--n_validation", "1", "--n_checkpoint",
        "1000", "--val_fraction", "1.0", "--enable_tensorboard", "--device", "cpu"])
    try:
        assert made == [torch.bfloat16] and tr.model.dtype == torch.bfloat16
        assert tr.iteration == 1 and tr.device.type == "cpu"
        out = capsys.readouterr().out
        assert "[val] iter 1" in out and "not ported" not in out
        tr.logger.close()  # flushes the writer's queue
        events = list((tmp_path / "logs" / "cli").glob("events.out.tfevents.*"))
        assert len(events) == 1 and events[0].stat().st_size > 0
        flat, meta = load_checkpoint(str(tmp_path / "cli" / "model" / "model.ckpt"))
        assert meta["step"] == 1 and "_score" in meta
        assert "optimizer::1/0/mu/model/decoder/q_proj/kernel" in flat
        assert int(flat["optimizer::1/0/count"]) == 1
        with open(tmp_path / "cli" / "log.jsonl") as f:
            line = json.loads(f.read().splitlines()[-1])
        assert line["iter"] == 1 and math.isfinite(line["total"])
    finally:
        shutil.rmtree(tmp_path / "cli" / "model")  # 0.4 GB a file at this width
