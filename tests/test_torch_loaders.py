"""The port's dataset loaders and utils/colmap.py against the JAX package's,
on tiny on-disk fixtures in each format (the layouts of
tests/test_native_loaders.py and tests/test_datasets_and_models.py, with
cameras on two opposite arcs so that two camera blocks exist): the same
arrays, one block and with multi_blocks=True (each package splitting its
own copy of the fixture, so each draws and writes its own world frames,
and the frame files must be equal byte for byte). Where a split holds one
view, two blocks cannot be made, and both packages raise."""
import csv
import json
import os
import shutil

import numpy as np
import pytest

from dregnerf_tpu.datasets import hypersim as jhypersim
from dregnerf_tpu.datasets import mvs as jmvs
from dregnerf_tpu.datasets import nerf_synthetic as jnerf_synthetic
from dregnerf_tpu.datasets import nsvf as jnsvf
from dregnerf_tpu.datasets import real_world as jreal_world
from dregnerf_tpu.datasets import scannerf as jscannerf
from dregnerf_tpu.utils import colmap as JC
from dregnerf_tpu_torch.datasets import hypersim as thypersim
from dregnerf_tpu_torch.datasets import mvs as tmvs
from dregnerf_tpu_torch.datasets import nerf_synthetic as tnerf_synthetic
from dregnerf_tpu_torch.datasets import nsvf as tnsvf
from dregnerf_tpu_torch.datasets import real_world as treal_world
from dregnerf_tpu_torch.datasets import scannerf as tscannerf
from dregnerf_tpu_torch.utils import colmap as TC

SUBJECT = "scene1"
N_VIEWS = 12


def _png(path, rng, h=12, w=16, channels=4):
    import imageio.v2 as imageio

    imageio.imwrite(path, rng.integers(0, 255, (h, w, channels), dtype=np.uint8))


def _w2c(i, n=N_VIEWS, radius=4.0):
    """OpenCV world-to-camera of view i, looking at the origin: the first
    half of the views on an arc of 60 degrees, the second half on the
    opposite arc, so that the two camera blocks are far from a tie."""
    th = np.pi * (i >= n // 2) + (np.pi / 3) * (i % (n // 2)) / (n // 2)
    eye = radius * np.array([np.cos(th), np.sin(th), 0.3 + 0.1 * (i % 3)])
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    rot = np.stack([right, down, fwd])
    out = np.eye(4)
    out[:3, :3] = rot
    out[:3, 3] = -rot @ eye
    return out


def _c2w(i, n=N_VIEWS):
    return np.linalg.inv(_w2c(i, n))


def _assert_same_blocks(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.images, w.images)
        assert g.camtoworlds.dtype == w.camtoworlds.dtype
        np.testing.assert_array_equal(g.camtoworlds, w.camtoworlds)
        np.testing.assert_array_equal(g.K, w.K)
        assert (g.opengl, g.synthetic, g.subject_id, g.split, g.block_id, g.near, g.far) == (
            w.opengl, w.synthetic, w.subject_id, w.split, w.block_id, w.near, w.far)


def _compare(tmp_path, make, jmod, tmod, splits, multi_blocks, factor=1):
    """Write the fixture once, copy it for each package, load every split
    through both loaders and compare; with multi_blocks also the frame
    files each package wrote."""
    make(str(tmp_path / "jax"))
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    for split in splits:
        try:
            want = jmod.load_blocks(str(tmp_path / "jax"), SUBJECT, split, factor,
                                    multi_blocks, 2)
        except ValueError as e:  # one view, two blocks: both packages refuse
            assert multi_blocks and "n_samples=1" in str(e)
            with pytest.raises(ValueError, match="n_samples=1"):
                tmod.load_blocks(str(tmp_path / "port"), SUBJECT, split, factor, True, 2)
            continue
        got = tmod.load_blocks(str(tmp_path / "port"), SUBJECT, split, factor, multi_blocks, 2)
        _assert_same_blocks(got, want)
        if multi_blocks:
            assert [b.block_id for b in got] == [0, 1]
    frames = [tmp_path / pkg / SUBJECT / "world_frame_transforms.json"
              for pkg in ("jax", "port")]
    if multi_blocks:
        assert frames[0].read_bytes() == frames[1].read_bytes()
    else:
        assert not frames[0].exists() and not frames[1].exists()


MULTI = pytest.mark.parametrize("multi_blocks", [False, True], ids=["one_block", "multi"])


def _make_nerf_synthetic(root):
    rng = np.random.default_rng(0)
    d = os.path.join(root, SUBJECT)
    os.makedirs(d)
    for split in ("train", "test"):
        frames = []
        for i in range(N_VIEWS):
            _png(os.path.join(d, f"{split}_{i}.png"), rng)
            frames.append({"file_path": f"{split}_{i}",
                           "transform_matrix": _c2w(i).tolist()})
        with open(os.path.join(d, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.7, "frames": frames}, f)


@MULTI
def test_nerf_synthetic_matches_jax(tmp_path, multi_blocks):
    _compare(tmp_path, _make_nerf_synthetic, jnerf_synthetic, tnerf_synthetic,
             ("train", "test"), multi_blocks)


def test_nerf_synthetic_factor_matches_jax(tmp_path):
    _compare(tmp_path, _make_nerf_synthetic, jnerf_synthetic, tnerf_synthetic, ("train",),
             False, factor=2)


def _make_nsvf(root):
    rng = np.random.default_rng(1)
    d = os.path.join(root, SUBJECT)
    os.makedirs(os.path.join(d, "pose"))
    os.makedirs(os.path.join(d, "rgb"))
    with open(os.path.join(d, "intrinsics.txt"), "w") as f:
        f.write("100.0 8.0 8.0 0\n0 0 0 0\n")
    np.savetxt(os.path.join(d, "bbox.txt"), np.array([-1, -1, -1, 1, 1, 1, 0.01]))
    for i in range(N_VIEWS):
        prefix = "0" if i < 8 else ("1" if i < 10 else "2")
        np.savetxt(os.path.join(d, "pose", f"{prefix}_{i:04d}.txt"), _c2w(i))
        _png(os.path.join(d, "rgb", f"{prefix}_{i:04d}.png"), rng)


@MULTI
def test_nsvf_matches_jax(tmp_path, multi_blocks):
    _compare(tmp_path, _make_nsvf, jnsvf, tnsvf, ("train", "val", "test"), multi_blocks)
    np.testing.assert_array_equal(tnsvf.load_aabb(str(tmp_path / "port"), SUBJECT),
                                  jnsvf.load_aabb(str(tmp_path / "jax"), SUBJECT))


def _make_scannerf(root):
    rng = np.random.default_rng(2)
    d = os.path.join(root, SUBJECT)
    os.makedirs(d)
    frames = []
    for i in range(24):
        _png(os.path.join(d, f"r_{i}.png"), rng)
        frames.append({"file_path": f"r_{i}", "transform_matrix": _c2w(i, 24).tolist()})
    for split in ("train_all", "test_all"):
        with open(os.path.join(d, f"{split}.json"), "w") as f:
            json.dump({"fl_x": 100.0, "fl_y": 90.0, "cx": 8.0, "cy": 6.0, "frames": frames}, f)


@MULTI
def test_scannerf_matches_jax(tmp_path, multi_blocks):
    """`train` and `test` fall back to train_all / test_all (the test split
    every 10th frame); near/far 2-6 on one block, make_blocks' defaults on
    multi-block, as in the JAX loader."""
    _compare(tmp_path, _make_scannerf, jscannerf, tscannerf, ("train", "test", "train_all"),
             multi_blocks)
    block = tscannerf.load_blocks(str(tmp_path / "port"), SUBJECT, "train", 1, multi_blocks, 2)[0]
    assert (block.near, block.far) == ((0.0, 1e10) if multi_blocks else (2.0, 6.0))


def test_scannerf_register_json_is_the_jax_packages():
    here = os.path.dirname(os.path.abspath(__file__))
    paths = [os.path.join(here, "..", pkg, "datasets", "register", "scannerf.json")
             for pkg in ("dregnerf_tpu", "dregnerf_tpu_torch")]
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()


def _make_mvs_native(root):
    scene = os.path.join(root, SUBJECT)
    os.makedirs(os.path.join(scene, "images"))
    os.makedirs(os.path.join(scene, "cams"))
    K = np.array([[100.0, 0, 16], [0, 100.0, 12], [0, 0, 1]])
    rng = np.random.default_rng(3)
    for i in range(N_VIEWS):
        _png(os.path.join(scene, "images", f"{i:08d}.png"), rng, 24, 32, 3)
        lines = ["extrinsic", *(" ".join(str(v) for v in row) for row in _w2c(i)),
                 "", "intrinsic", *(" ".join(str(v) for v in row) for row in K),
                 "", "2.5 0.01 40.0"]
        with open(os.path.join(scene, "cams", f"{i:08d}_cam.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")


@MULTI
def test_mvs_native_matches_jax(tmp_path, multi_blocks):
    _compare(tmp_path, _make_mvs_native, jmvs, tmvs, ("train", "test"), multi_blocks)


def test_mvs_native_factor_and_parsers_match_jax(tmp_path):
    _compare(tmp_path, _make_mvs_native, jmvs, tmvs, ("train",), False, factor=2)
    cam = str(tmp_path / "port" / SUBJECT / "cams" / "00000003_cam.txt")
    for scale in (None, 1.5):
        for g, w in zip(tmvs.read_cam_file(cam, scale), jmvs.read_cam_file(cam, scale)):
            np.testing.assert_array_equal(g, w)
    rng = np.random.default_rng(4)
    for header, shape in ((b"Pf", (12, 16)), (b"PF", (12, 16, 3))):
        path = str(tmp_path / f"d_{header.decode()}.pfm")
        with open(path, "wb") as f:
            f.write(header + b"\n16 12\n-1.0\n")
            rng.normal(size=shape).astype("<f4").tofile(f)
        (got, gs), (want, ws) = tmvs.read_pfm(path), jmvs.read_pfm(path)
        assert gs == ws and got.shape == shape
        np.testing.assert_array_equal(got, want)


def _colmap_model(rng, n):
    cams = {1: JC.Camera("PINHOLE", 32, 24, np.array([100.0, 101.0, 16.0, 12.0]))}
    images = {}
    for i in range(n):
        w2c = _w2c(i, n)
        rot = w2c[:3, :3]
        w = np.sqrt(max(1.0 + np.trace(rot), 1e-12)) / 2
        q = np.array([w, (rot[2, 1] - rot[1, 2]) / (4 * w), (rot[0, 2] - rot[2, 0]) / (4 * w),
                      (rot[1, 0] - rot[0, 1]) / (4 * w)])
        images[i + 1] = JC.Image(q, w2c[:3, 3], 1, f"img_{i:03d}.png")
    points = rng.normal(size=(40, 3))
    return JC.SparseModel(cams, images, points, rng.integers(0, 255, (40, 3)).astype(np.uint8))


def _make_colmap_scene(root, binary=True, n=N_VIEWS, image_dir="images"):
    rng = np.random.default_rng(5)
    scene = os.path.join(root, SUBJECT)
    os.makedirs(os.path.join(scene, image_dir))
    model = _colmap_model(rng, n)
    JC.write_model(os.path.join(scene, "sparse", "0"), model, binary=binary)
    for im in model.images.values():
        _png(os.path.join(scene, image_dir, im.name), rng, 24, 32, 3)
    np.savetxt(os.path.join(scene, "sparse", "0", "bbox.txt"),
               np.array([-1, -1, -1, 1, 1, 1, 0.01]))


@MULTI
@pytest.mark.parametrize("binary", [True, False], ids=["bin", "txt"])
def test_real_world_matches_jax(tmp_path, binary, multi_blocks):
    _compare(tmp_path, lambda r: _make_colmap_scene(r, binary, n=20), jreal_world, treal_world,
             ("train", "test"), multi_blocks)


def test_real_world_downscaled_images_match_jax(tmp_path):
    """images_{factor}/ at half size: K scaled from the first image."""
    def make(root):
        _make_colmap_scene(root, n=8)
        rng = np.random.default_rng(6)
        os.makedirs(os.path.join(root, SUBJECT, "images_2"))
        for i in range(8):
            _png(os.path.join(root, SUBJECT, "images_2", f"img_{i:03d}.png"), rng, 12, 16, 3)
    _compare(tmp_path, make, jreal_world, treal_world, ("train", "test"), False, factor=2)


@MULTI
def test_mvs_colmap_fallback_matches_jax(tmp_path, multi_blocks):
    _compare(tmp_path, lambda r: _make_colmap_scene(r, n=N_VIEWS), jmvs, tmvs,
             ("train", "test"), multi_blocks)
    np.testing.assert_array_equal(tmvs.load_aabb(str(tmp_path / "port"), SUBJECT),
                                  jmvs.load_aabb(str(tmp_path / "jax"), SUBJECT))


def _make_hypersim_native(root):
    import h5py

    scene = os.path.join(root, SUBJECT)
    detail = os.path.join(scene, "_detail")
    rng = np.random.default_rng(7)
    with_meta = False
    for cam in ("cam_00", "cam_01"):
        os.makedirs(os.path.join(detail, cam))
        frame_dir = os.path.join(scene, "images", f"scene_{cam}_final_preview")
        os.makedirs(frame_dir)
        offset = 0 if cam == "cam_00" else 6
        c2ws = np.stack([_c2w(offset + i) for i in range(6)])
        with h5py.File(os.path.join(detail, cam, "camera_keyframe_positions.hdf5"), "w") as f:
            f.create_dataset("dataset", data=c2ws[:, :3, 3] / 0.025)
        with h5py.File(os.path.join(detail, cam, "camera_keyframe_orientations.hdf5"),
                       "w") as f:
            f.create_dataset("dataset", data=c2ws[:, :3, :3])
        for i in range(6):
            _png(os.path.join(frame_dir, f"frame.{i:04d}.tonemap.jpg"), rng, 24, 32, 3)
        if not with_meta:
            with open(os.path.join(detail, "metadata_scene.csv"), "w", newline="") as f:
                w = csv.DictWriter(f, ["parameter_name", "parameter_value"])
                w.writeheader()
                w.writerow({"parameter_name": "meters_per_asset_unit",
                            "parameter_value": "0.025"})
            with_meta = True


@MULTI
def test_hypersim_native_matches_jax(tmp_path, multi_blocks):
    _compare(tmp_path, _make_hypersim_native, jhypersim, thypersim, ("train", "test"),
             multi_blocks)
    detail = str(tmp_path / "port" / SUBJECT / "_detail")
    assert thypersim._camera_names(detail) == jhypersim._camera_names(detail)
    assert thypersim._meters_per_asset_unit(detail) == jhypersim._meters_per_asset_unit(detail)
    frames = str(tmp_path / "port" / SUBJECT / "images" / "scene_cam_01_final_preview")
    assert thypersim._tonemap_frames(frames) == jhypersim._tonemap_frames(frames)


@MULTI
def test_hypersim_colmap_fallback_matches_jax(tmp_path, multi_blocks):
    _compare(tmp_path, lambda r: _make_colmap_scene(r, n=N_VIEWS), jhypersim, thypersim,
             ("train", "test"), multi_blocks)
    np.testing.assert_array_equal(thypersim.load_aabb(str(tmp_path / "port"), SUBJECT),
                                  jhypersim.load_aabb(str(tmp_path / "jax"), SUBJECT))


# ------------------------------------------------------------------ utils/colmap.py


def _as_port(model):
    return TC.SparseModel(
        {k: TC.Camera(c.model, c.width, c.height, c.params) for k, c in model.cameras.items()},
        {k: TC.Image(i.qvec, i.tvec, i.camera_id, i.name) for k, i in model.images.items()},
        model.points, model.point_colors)


def _assert_same_model(got, want, points=True):
    assert sorted(got.cameras) == sorted(want.cameras)
    for k in want.cameras:
        g, w = got.cameras[k], want.cameras[k]
        assert (g.model, g.width, g.height) == (w.model, w.width, w.height)
        np.testing.assert_array_equal(g.params, w.params)
        np.testing.assert_array_equal(g.K, w.K)
    assert sorted(got.images) == sorted(want.images)
    for k in want.images:
        g, w = got.images[k], want.images[k]
        assert (g.camera_id, g.name) == (w.camera_id, w.name)
        np.testing.assert_array_equal(g.qvec, w.qvec)
        np.testing.assert_array_equal(g.tvec, w.tvec)
        np.testing.assert_array_equal(g.cam_to_world(), w.cam_to_world())
        np.testing.assert_array_equal(g.world_to_cam(), w.world_to_cam())
    if points:
        np.testing.assert_array_equal(got.points, want.points)
        np.testing.assert_array_equal(got.point_colors, want.point_colors)


@pytest.mark.parametrize("binary", [True, False], ids=["bin", "txt"])
def test_colmap_models_cross_both_ways(tmp_path, binary):
    """Each package writes the model, byte for byte the same files, and
    each reads the other's: the same cameras, images, poses and points."""
    rng = np.random.default_rng(8)
    model = _colmap_model(rng, 5)
    model.cameras[2] = JC.Camera("SIMPLE_RADIAL", 800, 600, np.array([450.0, 400.0, 300.0,
                                                                      0.01]))
    JC.write_model(str(tmp_path / "jax"), model, binary=binary)
    TC.write_model(str(tmp_path / "port"), _as_port(model), binary=binary)
    for name in sorted(os.listdir(tmp_path / "jax")):
        assert (tmp_path / "jax" / name).read_bytes() == (tmp_path / "port" / name).read_bytes()
    _assert_same_model(TC.read_model(str(tmp_path / "jax")),
                       JC.read_model(str(tmp_path / "port")), points=binary)
    _assert_same_model(TC.read_model(str(tmp_path / "port")),
                       JC.read_model(str(tmp_path / "jax")), points=binary)


def test_colmap_images_with_tracks_and_points_match_jax(tmp_path):
    rng = np.random.default_rng(9)
    model = _colmap_model(rng, 4)
    xys = {i: rng.uniform(0, 640, (10, 2)) for i in model.images}
    pids = {i: rng.integers(-1, 40, 10) for i in model.images}
    tracks = [[(1 + j % 4, j % 10)] * (j % 3) for j in range(40)]
    errors = rng.uniform(0, 2, 40)
    for pkg, mod in (("jax", JC), ("port", TC)):
        os.makedirs(tmp_path / pkg)
        images = model.images if mod is JC else _as_port(model).images
        mod.write_images_bin(str(tmp_path / pkg / "images.bin"), images, xys, pids)
        mod.write_points3d_bin(str(tmp_path / pkg / "points3D.bin"), model.points,
                               model.point_colors, errors, tracks)
    for name in ("images.bin", "points3D.bin"):
        assert (tmp_path / "jax" / name).read_bytes() == (tmp_path / "port" / name).read_bytes()
    got = TC.read_images_bin(str(tmp_path / "jax" / "images.bin"))
    want = JC.read_images_bin(str(tmp_path / "jax" / "images.bin"))
    assert [(g.name, g.camera_id) for g in got.values()] == [
        (w.name, w.camera_id) for w in want.values()]
    for g, w in zip(TC.read_points3d_bin(str(tmp_path / "jax" / "points3D.bin")),
                    JC.read_points3d_bin(str(tmp_path / "jax" / "points3D.bin"))):
        np.testing.assert_array_equal(g, w)


def test_colmap_aabb_and_pair_ids_match_jax():
    pts = np.random.default_rng(10).normal(size=(1000, 3))
    np.testing.assert_array_equal(TC.compute_aabb_from_points(pts),
                                  JC.compute_aabb_from_points(pts))
    for a, b in [(1, 2), (7, 7), (123456, 3), (3, 2147483646)]:
        pid = TC.image_ids_to_pair_id(a, b)
        assert pid == JC.image_ids_to_pair_id(a, b)
        assert TC.pair_id_to_image_ids(pid) == JC.pair_id_to_image_ids(pid)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_colmap_database_crosses_both_ways(tmp_path, writer):
    """One package fills a COLMAP database; both read it back the same."""
    rng = np.random.default_rng(11)
    mod = JC if writer == "jax" else TC
    path = str(tmp_path / "db.db")
    kp = rng.uniform(0, 640, (20, 2)).astype(np.float32)
    matches = np.stack([np.arange(10), np.arange(10) + 5], 1)
    with mod.COLMAPDatabase(path) as db:
        cid = db.add_camera("PINHOLE", 640, 480, np.array([500.0, 510.0, 320.0, 240.0]))
        i1 = db.add_image("a.png", cid, prior_q=np.array([1.0, 0, 0, 0]))
        i2 = db.add_image("b.png", cid, prior_t=np.array([0.1, 0.2, 0.3]))
        db.add_keypoints(i1, kp)
        db.add_descriptors(i1, rng.integers(0, 255, (20, 128)))
        db.add_matches(i1, i2, matches)
        db.add_matches(2 * 10**6, 3, matches)
        db.add_two_view_geometry(i1, i2, matches)
    readers = [JC.COLMAPDatabase(path), TC.COLMAPDatabase(path)]
    try:
        (jdb, tdb) = readers
        np.testing.assert_array_equal(tdb.read_keypoints(i1), jdb.read_keypoints(i1))
        np.testing.assert_array_equal(tdb.read_keypoints(i1), kp)
        for ids in ((i1, i2), (2 * 10**6, 3), (3, 2 * 10**6)):
            np.testing.assert_array_equal(tdb.read_matches(*ids), jdb.read_matches(*ids))
        got, want = tdb.read_cameras(), jdb.read_cameras()
        assert sorted(got) == sorted(want) == [cid]
        assert got[cid].model == want[cid].model == "PINHOLE"
        np.testing.assert_array_equal(got[cid].params, want[cid].params)
        for table in ("images", "two_view_geometries", "descriptors"):
            rows = [db.conn.execute(f"SELECT * FROM {table}").fetchall() for db in readers]
            assert rows[0] == rows[1] and rows[0]
    finally:
        for db in readers:
            db.close()
