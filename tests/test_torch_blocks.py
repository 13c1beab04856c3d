"""Multi-block splitting in the port (datasets/kmeans.py,
datasets/spectral.py, datasets/base.py) against scikit-learn and the JAX
package: k-means and spectral labels equal to sklearn's (not up to a permutation: a block's id keys its world frame),
the world frames and their file bit for bit, the same blocks from
make_blocks, each package reading the other's world_frame_transforms.json,
and the --dataset dispatch."""
import os

import numpy as np
import pytest
from sklearn.cluster import KMeans, SpectralClustering

from dregnerf_tpu.datasets import base as jbase
from dregnerf_tpu_torch.datasets import base as tbase
from dregnerf_tpu_torch.datasets import fixtures as tfix
from dregnerf_tpu_torch.datasets.kmeans import kmeans_labels
from dregnerf_tpu_torch.runtime.config import config_parser as tconfig_parser

# the 36-view fixture rig's labels at k = 2 (chip_smoke.py checks the same vector)
FIXTURE36_K2 = [0] * 8 + [1] * 18 + [0] * 10


def _rig(num_views):
    """The fixture rig's cameras [N, 3, 4] f32 (independent of image size)."""
    _, c2w = tfix.render_views(num_views, 2)
    return c2w.astype(np.float32)[:, :3, :4]


def _sklearn(points, k):
    return KMeans(n_clusters=k, n_init=10, random_state=0).fit_predict(points)


@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("num_views", [24, 30, 36])
def test_kmeans_gives_sklearns_labels_on_the_fixture_rig(num_views, k):
    centers = _rig(num_views)[:, :3, 3]
    np.testing.assert_array_equal(kmeans_labels(centers, k), _sklearn(centers, k))


def test_fixture_rig_labels_and_block_sizes():
    centers = _rig(36)[:, :3, 3]
    assert kmeans_labels(centers, 2).tolist() == FIXTURE36_K2
    assert np.bincount(kmeans_labels(centers, 3)).tolist() == [12, 11, 13]
    assert np.bincount(kmeans_labels(centers, 4)).tolist() == [8, 10, 9, 9]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("seed", range(4))
def test_kmeans_gives_sklearns_labels_on_separated_clusters(seed, dtype):
    """Seeded rigs of well-separated camera clusters (up to 300 cameras,
    so sklearn's chunks of 256 are crossed), asked for k - 1, k and k + 1
    clusters, and a rig with duplicated cameras that empties a cluster."""
    rng = np.random.default_rng(seed)
    k = int(rng.integers(2, 7))
    n = int(rng.integers(10 * k, 300))
    centres = rng.normal(size=(k, 3)) * 8.0
    points = (centres[rng.integers(0, k, n)] + rng.normal(size=(n, 3))).astype(dtype)
    for kk in (max(k - 1, 2), k, k + 1):
        np.testing.assert_array_equal(kmeans_labels(points, kk), _sklearn(points, kk))
    dup = np.repeat(points[:3], 5, axis=0)
    np.testing.assert_array_equal(kmeans_labels(dup, 3), _sklearn(dup, 3))


@pytest.mark.parametrize("num_views", [12, 24, 36])
def test_kmeans_gives_single_threaded_sklearns_labels_on_a_symmetric_ring(num_views):
    """Cameras evenly spaced on a ring: different clusterings tie in
    inertia to the last bits, and sklearn's parallel inertia sum breaks
    the tie differently at different thread counts. At one OpenMP thread
    sklearn sums in order, as the port does: the labels are equal."""
    from threadpoolctl import threadpool_limits

    th = 2 * np.pi * np.arange(num_views) / num_views
    ring = np.stack([4 * np.cos(th), 4 * np.sin(th), 0.3 + 0.1 * (np.arange(num_views) % 3)],
                    1).astype(np.float32)
    for k in (2, 3, 4):
        with threadpool_limits(1, "openmp"):
            want = _sklearn(ring, k)
        np.testing.assert_array_equal(kmeans_labels(ring, k), want)


def test_random_se3_and_world_frame_bit_for_bit():
    for seed in range(5):
        want = jbase.random_se3_np(np.random.default_rng(seed))
        got = tbase.random_se3_np(np.random.default_rng(seed))
        assert got.dtype == want.dtype and np.array_equal(got, want)
        c2w = _rig(12)
        assert np.array_equal(tbase.apply_world_frame(c2w, got),
                              jbase.apply_world_frame(c2w, want))


def _split(pkg, data_dir, split, k, num_views=36):
    c2w = _rig(num_views)
    images = np.arange(num_views, dtype=np.uint8).reshape(num_views, 1, 1, 1)
    K = np.eye(3, dtype=np.float32)
    return pkg.make_blocks(str(data_dir), images, c2w, K, split, k, 20, True, True, "rig")


@pytest.mark.parametrize("k", [2, 3, 4])
def test_make_blocks_matches_jax(tmp_path, k):
    """Both splits: the same block ids, the same views (the images are the
    view indices) and cameras, and world_frame_transforms.json byte for
    byte; the second split reads the file the first wrote."""
    for pkg in ("jax", "port"):
        os.makedirs(tmp_path / pkg)
    for split in ("train", "test"):
        want = _split(jbase, tmp_path / "jax", split, k)
        got = _split(tbase, tmp_path / "port", split, k)
        assert [b.block_id for b in got] == [b.block_id for b in want] == list(range(k))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.images, w.images)
            assert g.camtoworlds.dtype == np.float32
            assert np.array_equal(g.camtoworlds, w.camtoworlds)
            assert (g.split, g.near, g.far, g.opengl, g.synthetic) == (
                w.split, w.near, w.far, w.opengl, w.synthetic)
    names = [p / "world_frame_transforms.json" for p in (tmp_path / "jax", tmp_path / "port")]
    assert names[0].read_bytes() == names[1].read_bytes()
    if k == 2:  # 18 views a block: 17 to train on, view 0 of the block to test
        sizes = [[b.num_images for b in _split(tbase, tmp_path / "port", s, 2)]
                 for s in ("train", "test")]
        assert sizes == [[17, 17], [1, 1]]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_blocks(tmp_path, writer):
    """One package splits first and writes the frames; the other reads
    them and gives the blocks the writer gives from the file. (Both
    packages apply the fresh float64 frames on the first split and their
    float32 copies read from the file on every later one, so a later split
    is compared with a later split.)"""
    first, second = (jbase, tbase) if writer == "jax" else (tbase, jbase)
    fresh = _split(first, tmp_path, "train", 3)
    path = tmp_path / "world_frame_transforms.json"
    written = path.read_bytes()
    want = _split(first, tmp_path, "train", 3)
    got = _split(second, tmp_path, "train", 3)
    assert path.read_bytes() == written  # read, not drawn again
    for f, w in zip(fresh, want):
        np.testing.assert_allclose(f.camtoworlds, w.camtoworlds, rtol=0, atol=1e-6)
    for g, w in zip(got, want):
        assert g.block_id == w.block_id
        np.testing.assert_array_equal(g.images, w.images)
        assert np.array_equal(g.camtoworlds, w.camtoworlds)


def test_block_cameras_are_the_rig_in_the_blocks_frame(tmp_path):
    rig = _rig(36)
    blocks = _split(tbase, tmp_path, "train", 2)
    frames = tbase.read_world_frame_transforms(str(tmp_path))
    labels = np.array(FIXTURE36_K2)
    for b in blocks:
        ids = np.flatnonzero(labels == b.block_id)
        ids = ids[tbase.split_indices(len(ids), "train", 20)]
        np.testing.assert_array_equal(b.images[:, 0, 0, 0], ids)
        moved = frames[b.block_id].astype(np.float64) @ np.concatenate(
            [rig[ids].astype(np.float64), np.tile([[[0, 0, 0, 1.0]]], (len(ids), 1, 1))], 1)
        np.testing.assert_allclose(b.camtoworlds, moved[:, :3], rtol=0, atol=1e-6)


def _accepts(parse, name):
    try:
        return parse(["--dataset", name]).dataset == name
    except SystemExit:  # argparse refuses a value outside the choices
        return False


def test_dataset_dispatch(capsys):
    """--dataset takes the JAX package's choices; every choice and alias
    names the same loader as in the JAX package (dnerf included); unknown
    names raise ValueError."""
    from dregnerf_tpu.runtime.config import config_parser as jconfig_parser

    assert tbase.DATASET_MODULES == jbase.DATASET_MODULES
    accepted = [n for n in tbase.DATASET_MODULES if _accepts(jconfig_parser, n)]
    assert len(accepted) == 10
    assert [n for n in tbase.DATASET_MODULES if _accepts(tconfig_parser, n)] == accepted
    assert "dnerf" in accepted
    for name in tbase.DATASET_MODULES:
        module = tbase.dataset_module(name)
        assert module.__name__ == f"dregnerf_tpu_torch.datasets.{tbase.DATASET_MODULES[name]}"
        assert callable(module.load_blocks)
    with pytest.raises(ValueError, match="unknown dataset"):
        tbase.dataset_module("not_a_dataset")


def test_block_flags_match_jax():
    from dregnerf_tpu.runtime.config import config_parser as jconfig_parser

    j, t = jconfig_parser([]), tconfig_parser([])
    for name in ("num_blocks", "min_num_blocks", "max_num_blocks", "multi_blocks", "fleet"):
        assert getattr(t, name) == getattr(j, name), name


def _ring(num_views):
    """Cameras [N, 3, 4] evenly spaced on a ring of radius 4, at heights
    0.3-0.5 (only the centres matter)."""
    th = 2 * np.pi * np.arange(num_views) / num_views
    c2w = np.zeros((num_views, 3, 4), np.float32)
    c2w[:, :, 3] = np.stack([4 * np.cos(th), 4 * np.sin(th),
                             0.3 + 0.1 * (np.arange(num_views) % 3)], 1)
    return c2w


def _sklearn_spectral(points, k):
    return SpectralClustering(n_clusters=k, random_state=0,
                              assign_labels="discretize").fit_predict(points)


def _assert_spectral_labels(c2w):
    for k in (2, 3, 4):
        want = _sklearn_spectral(c2w[:, :3, 3], k)
        np.testing.assert_array_equal(tbase.cluster_cameras(c2w, k, method="Spectral"), want)
        np.testing.assert_array_equal(jbase.cluster_cameras(c2w, k, method="Spectral"), want)


def test_spectral_clustering_is_not_ported():
    """Now ported: cluster_cameras(method="Spectral") gives sklearn's
    SpectralClustering(random_state=0, assign_labels="discretize") labels
    exactly (not up to a permutation) on the 12-, 24- and 36-view fixture
    rigs at k = 2-4, as the JAX package's call does; an unknown method
    raises ValueError."""
    for num_views in (12, 24, 36):
        _assert_spectral_labels(_rig(num_views))
    with pytest.raises(ValueError):
        tbase.cluster_cameras(_rig(12), 2, method="Agglomerative")


@pytest.mark.parametrize("num_views", [8, 12, 16, 24, 36, 48])
def test_spectral_labels_equal_sklearns_on_a_ring(num_views):
    _assert_spectral_labels(_ring(num_views))
