"""The stage-3 scene fleet of the port against the JAX package, on the CPU:
the scene generators `random_spheres` / `random_boxes` and the box branch
of `_trace` byte for byte, `render_views(spheres=)` against what JAX's
`make_scene(spheres=)` writes, the twin's in-memory blocks against JAX's
loader on JAX's files, and a smoke of the twin of
scripts/experiments/stage3_fleet.py at a tiny size whose regdata tree the
JAX package's NeRFRegDataset reads with the same poses as the port's,
and its reuse of a cached block only under the knobs it was trained under.

The smoke's blocks have 4 levels of 2^12-row tables on a 16^3 grid
(`tests/test_torch_pipeline_e2e.py`'s encoder), 8 views of 24 px, 80 steps
of 2^11 samples and 32 march steps, and NeRFRegTr at the tests' tiny width
for 2 steps. About 52 s alone on one torch thread, 38 s of it the smoke
and 6 s the block retrained under other knobs."""
import dataclasses
import json
import os
import shutil
import tempfile

import numpy as np
import pytest
import torch

from dregnerf_tpu.datasets import fixtures as jfix
from dregnerf_tpu.datasets import register_pairs as jrp
from dregnerf_tpu.datasets.base import load_scene_blocks
from dregnerf_tpu_torch.datasets import fixtures as tfix
from dregnerf_tpu_torch.datasets import register_pairs as prp
from dregnerf_tpu_torch.datasets.base import read_world_frame_transforms
from dregnerf_tpu_torch.models.regtr import NeRFRegTr
from dregnerf_tpu_torch.scripts.experiments import stage3_fleet as twin

VIEWS, SIZE = 8, 24
TINY_REGTR = dict(backbone="resnet18", d_model=32, num_layers=1, num_heads=2,
                  dim_feedforward=64, max_input_points=256, num_tokens=64, max_points=50,
                  num_downsample=2)
# the accepted difference of make_blocks' first split (a float64 frame)
# against later ones (its float32 copy from the file), in a camera entry
FIRST_SPLIT_CAMERA_TOL = 2.4e-7


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the smoke runs many small ops, which a thread
    pool shared by several test processes only slows."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_shapes(a, b):
    assert len(a) == len(b)
    for (ca, sa, aa), (cb, sb, ab) in zip(a, b):
        np.testing.assert_array_equal(ca, cb)
        assert np.ndim(sa) == np.ndim(sb)
        np.testing.assert_array_equal(sa, sb)
        np.testing.assert_array_equal(aa, ab)


@pytest.mark.parametrize("seed", list(range(100, 116)) + list(range(200, 216)))
def test_random_spheres_and_boxes_match_jax(seed):
    _same_shapes(tfix.random_spheres(seed), jfix.random_spheres(seed))
    _same_shapes(tfix.random_boxes(seed), jfix.random_boxes(seed))


def _rays(n=4000, seed=0):
    """Rays from points around the scene, aimed near the origin."""
    rng = np.random.default_rng(seed)
    origins = rng.normal(size=(n, 3))
    origins = 2.5 * origins / np.linalg.norm(origins, axis=1, keepdims=True)
    dirs = rng.normal(scale=0.3, size=(n, 3)) - origins
    return origins, dirs / np.linalg.norm(dirs, axis=1, keepdims=True)


@pytest.mark.parametrize("shapes", ["default", "spheres", "boxes", "mixed"])
def test_trace_rgba_matches_jax(shapes):
    lists = {"default": None, "spheres": jfix.random_spheres(104),
             "boxes": jfix.random_boxes(207),
             "mixed": jfix.random_boxes(201)[:2] + jfix.random_spheres(102)}
    origins, dirs = _rays()
    got = tfix._trace(origins, dirs, lists[shapes])
    want = jfix._trace(origins, dirs, lists[shapes])
    assert got.tobytes() == want.tobytes()
    assert 0.05 < float((got[:, 3] > 0).mean()) < 0.95


@pytest.fixture(scope="module")
def jax_scene(tmp_path_factory):
    """JAX's make_scene files of the twin's scene 1 (boxes) at the small
    size, as JAX's experiment writes its scenes."""
    root = str(tmp_path_factory.mktemp("jax_scene"))
    jfix.make_scene(root, num_views=VIEWS, image_size=SIZE, seed=1, name="scene_01",
                    spheres=twin.scene_shapes(1))
    return root


def test_render_views_matches_jax_make_scene(jax_scene):
    import imageio.v2 as imageio
    import json

    images, c2w = tfix.render_views(VIEWS, SIZE, seed=1, spheres=twin.scene_shapes(1))
    with open(os.path.join(jax_scene, "scene_01", "transforms.json")) as f:
        meta = json.load(f)
    assert meta["camera_angle_x"] == twin.FOV_X
    for i, frame in enumerate(meta["frames"]):
        png = imageio.imread(os.path.join(jax_scene, "scene_01", frame["file_path"] + ".png"))
        assert png.tobytes() == images[i].tobytes()
        np.testing.assert_array_equal(np.asarray(frame["transform_matrix"]), c2w[i])


def test_twin_blocks_match_jax_loader(jax_scene, tmp_path):
    knobs = twin.Knobs(views=VIEWS, img=SIZE)
    got = twin.scene_blocks(str(tmp_path), "scene_01", 1, knobs)
    for split in ("train", "test"):
        want = load_scene_blocks("objaverse", jax_scene, "scene_01", split, 1, True, 2)
        assert len(got[split]) == len(want) == 2
        for a, b in zip(got[split], want):
            assert (a.block_id, a.split, a.subject_id) == (b.block_id, b.split, b.subject_id)
            assert a.images.tobytes() == b.images.tobytes()
            np.testing.assert_array_equal(a.K, b.K)
            assert a.camtoworlds.dtype == b.camtoworlds.dtype
            np.testing.assert_allclose(a.camtoworlds, b.camtoworlds, rtol=0,
                                       atol=FIRST_SPLIT_CAMERA_TOL)
    frames = [read_world_frame_transforms(os.path.join(d, "scene_01"))
              for d in (str(tmp_path), jax_scene)]
    for k in (0, 1):
        np.testing.assert_array_equal(frames[0][k], frames[1][k])


def test_scene_families_alternate():
    for i in range(6):
        sizes = [np.ndim(size) for _, size, _ in twin.scene_shapes(i)]
        assert sizes == [0 if i % 2 == 0 else 1] * len(sizes) and 3 <= len(sizes) <= 5


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """The twin's main on the CPU at the tiny size."""
    work = str(tmp_path_factory.mktemp("fleet"))
    knobs = twin.Knobs(
        scenes=2, test_scenes=1, ngp_iters=80, budget=1 << 11, views=VIEWS, img=SIZE,
        reg_iters=2, work=work, out=os.path.join(work, "out"), layout="L4F8",
        grid=dict(log2_table_size=12, base_resolution=4, per_level_scale=2.0),
        ngp_flags=("--grid_resolution", "16", "--max_march_steps", "32", "--init_num_rays",
                   "256", "--max_num_rays", "1024", "--test_chunk_size", "256"),
        reg_flags=("--no_bf16",))
    torch.manual_seed(0)
    result = twin.main(["--device", "cpu"], knobs=knobs, reg_model=NeRFRegTr(**TINY_REGTR))
    return knobs, result


def test_fleet_smoke_writes_the_regdata_tree_and_metrics(fleet):
    knobs, result = fleet
    reg_root = os.path.join(knobs.work, "regdata")
    for scene in twin.scene_names(knobs):
        assert os.path.exists(os.path.join(reg_root, "images", scene,
                                           "world_frame_transforms.json"))
        for k in range(2):
            block = os.path.join(reg_root, "nerf_models", scene, f"block_{k}")
            for rel in ("model/model.ckpt", "voxel_grid.pt", "voxel_mask.pt",
                        "voxel_point_cloud.ply"):
                assert os.path.getsize(os.path.join(block, rel)) > 0, rel
            assert torch.load(os.path.join(block, "voxel_grid.pt")).shape == (16, 16, 16, 7)
    for name in ("metrics_test.json", "fgr_metrics_test.json", "stage1_psnr.json",
                 "stage_seconds.json"):
        assert os.path.exists(os.path.join(knobs.out, name)), name
    reg = result["regtr"]
    assert reg["test_scenes"] == ["scene_01"] and reg["iters"] == 2
    assert reg["eval_ckpt"] == "final"
    assert [(p["scene"], p["draw"]) for p in reg["pairs"]] == [("scene_01", 0), ("scene_01", 1)]
    assert all(np.isfinite(p["RRE"]) and np.isfinite(p["RTE"]) for p in reg["pairs"])
    assert len(result["fgr"]["pairs"]) == 2


def test_default_work_directory_is_under_the_temporary_directory():
    assert twin.Knobs().work == os.path.join(tempfile.gettempdir(), "stage3_fleet_torch")


def test_fleet_reuses_a_block_only_under_the_same_knobs(fleet, tmp_path, capsys):
    """A copy of the smoke's work tree: scene_00's blocks are reused as
    they are, unless block_knobs.json names other knobs; that block is
    trained and extracted again, and its knobs file rewritten."""
    knobs, _ = fleet
    work = str(tmp_path / "work")
    shutil.copytree(knobs.work, work)
    knobs = dataclasses.replace(knobs, scenes=1, work=work, out=str(tmp_path / "out"))
    blocks = [os.path.join(work, "out", "scene_00", f"block_{k}") for k in (0, 1)]
    stale = os.path.join(blocks[0], "block_knobs.json")
    with open(stale) as f:
        assert json.load(f) == knobs.block_knobs(0)
    before = [os.path.getmtime(os.path.join(b, "model", "model.ckpt")) for b in blocks]
    capsys.readouterr()
    twin.stage1_and_2(knobs, "cpu")
    log = capsys.readouterr().out
    for k in (0, 1):
        assert f"[stage1] scene_00 block_{k}: cached" in log
        assert f"[stage2] scene_00 block_{k}: cached" in log
    with open(stale, "w") as f:
        json.dump(dict(knobs.block_knobs(0), layout="L8F4"), f)
    torch.manual_seed(0)
    twin.stage1_and_2(knobs, "cpu")
    log = capsys.readouterr().out
    assert "[stage1] scene_00 block_0: trained under other knobs, trained again" in log
    assert "[stage1] scene_00 block_0: val PSNR" in log
    assert "[stage2] scene_00 block_0: cached" not in log
    assert "[stage1] scene_00 block_1: cached" in log
    with open(stale) as f:
        assert json.load(f) == knobs.block_knobs(0)
    after = [os.path.getmtime(os.path.join(b, "model", "model.ckpt")) for b in blocks]
    assert after[0] > before[0] and after[1] == before[1]


@pytest.mark.parametrize("scene", ["scene_00", "scene_01"])
def test_jax_dataset_reads_the_twins_regdata_with_the_same_poses(fleet, scene):
    """The cross-package rule on artifacts: JAX's NeRFRegDataset reads the
    twin's tree, and both packages give each block order the pose
    tgt_T inv(src_T) of the frames the twin wrote."""
    knobs, _ = fleet
    reg_root = os.path.join(knobs.work, "regdata")
    frames = read_world_frame_transforms(os.path.join(reg_root, "images", scene))
    want_ds = jrp.NeRFRegDataset(reg_root, subject_id=scene, split="test", seed=4)
    got_ds = prp.NeRFRegDataset(reg_root, subject_id=scene, split="test", seed=4)
    for order in ((0, 1), (1, 0)):
        want_ds.fixed_order = got_ds.fixed_order = order
        a, b = want_ds[0], got_ds[0]
        assert list(a["block_list"]) == list(b["block_list"]) == list(order)
        np.testing.assert_array_equal(b["pose"], a["pose"])
        for key in ("src_grid", "tgt_grid", "src_mask", "tgt_mask"):
            np.testing.assert_array_equal(b[key], a[key], err_msg=key)
        T = frames[order[1]].astype(np.float64) @ np.linalg.inv(frames[order[0]]
                                                               .astype(np.float64))
        np.testing.assert_allclose(a["pose"], T, rtol=0, atol=1e-6)
