"""The port's registration model against the JAX package, on the CPU.

The same numpy inputs (from a seed) go through each JAX function and its
port; weights are drawn once in flax's layout (`random_jax_params`) and
given to both, so every comparison also checks the flax-name mapping.
Tolerances: group counts, subsample levels and selections exact; f32
values as stated per test; bf16 loosely (bf16 rounds at 2^-8).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dregnerf_tpu.geometry import kabsch as jk
from dregnerf_tpu.models import pos_embed as jpe
from dregnerf_tpu.models import regtr as jregtr
from dregnerf_tpu.models import resnet3d as jres
from dregnerf_tpu.models import transformer as jtr
from dregnerf_tpu.ops import voxel_subsample as jvs
from dregnerf_tpu_torch.geometry import kabsch as pk
from dregnerf_tpu_torch.geometry import se3 as pse3
from dregnerf_tpu_torch.models import pos_embed as ppe
from dregnerf_tpu_torch.models import regtr as pregtr
from dregnerf_tpu_torch.models import resnet3d as pres
from dregnerf_tpu_torch.models import transformer as ptr
from dregnerf_tpu_torch.ops import voxel_subsample as pvs

SMALL = dict(backbone="resnet18", d_model=64, num_layers=2, num_heads=4, dim_feedforward=128,
             max_input_points=512, num_tokens=128, max_points=100)


def t(x):
    return torch.as_tensor(np.asarray(x))


def n(x):
    return x.detach().float().numpy() if x.is_floating_point() else x.detach().numpy()


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def point_set(rng, n_pts, n_valid, f=8, lo=-1.5, hi=1.5):
    xyz = rng.uniform(lo, hi, (n_pts, 3)).astype(np.float32)
    feats = rng.normal(size=(n_pts, f)).astype(np.float32)
    valid = np.arange(n_pts) < n_valid
    return xyz * valid[:, None], feats * valid[:, None], valid


def both_sets(xyz, feats, valid):
    count = int(valid.sum())
    return (jvs.PointSet(jnp.asarray(xyz), jnp.asarray(feats), jnp.asarray(valid),
                         jnp.int32(count)),
            pvs.PointSet(t(xyz), t(feats), t(valid), torch.tensor(count, dtype=torch.int32)))


def assert_sets_equal(js, ps, tol=1e-5):
    assert int(js.count) == int(ps.count)
    np.testing.assert_array_equal(np.asarray(js.valid), n(ps.valid))
    np.testing.assert_allclose(n(ps.xyz), np.asarray(js.xyz), rtol=0, atol=tol)
    np.testing.assert_allclose(n(ps.feats), np.asarray(js.feats), rtol=0, atol=tol)


# ------------------------------------------------------------ voxel_subsample

def _np_hash(coords):
    u = coords.astype(np.int32).astype(np.uint32)
    h = (u[:, 0] * np.uint32(73856093)) ^ (u[:, 1] * np.uint32(19349663)) \
        ^ (u[:, 2] * np.uint32(83492791))
    return h & np.uint32(0x7FFFFFFF)


def test_spatial_hash_is_jax_uint32_arithmetic():
    """Negative and large coordinates wrap as uint32; products mod 2^32."""
    rng = np.random.default_rng(0)
    coords = rng.integers(-2**31, 2**31 - 1, size=(4096, 3)).astype(np.int32)
    coords[:8] = [[-1, -1, -1], [0, 0, 0], [-2**31, 2**31 - 1, -7], [1, -1, 0],
                  [2**30, -2**30, 3], [-5, 6, -7], [65535, -65536, 1], [-1, 0, 1]]
    with np.errstate(over="ignore"):
        want = _np_hash(coords)
    np.testing.assert_array_equal(n(pvs.spatial_hash(t(coords))), want.astype(np.int64))


def _collision_points(n_pts, cell):
    """Two cells of different coordinates with the same hash, two points
    in each (interleaved), plus a third cell; then invalid padding."""
    c = np.stack(np.meshgrid(*[np.arange(-40, 40)] * 3, indexing="ij"), -1).reshape(-1, 3)
    with np.errstate(over="ignore"):
        h = _np_hash(c)
    order = np.argsort(h, kind="stable")
    dup = np.nonzero(h[order][1:] == h[order][:-1])[0][0]
    a, b = c[order[dup]], c[order[dup + 1]]
    xyz = np.zeros((n_pts, 3), np.float32)
    xyz[:5] = [(a + 0.25) * cell, (b + 0.25) * cell, (a + 0.75) * cell, (b + 0.75) * cell,
               (a + 5.5) * cell]
    feats = np.zeros((n_pts, 8), np.float32)
    feats[:5] = np.arange(40, dtype=np.float32).reshape(5, 8)
    return xyz, feats, np.arange(n_pts) < 5


_jax_downsample = jax.jit(jvs.voxel_downsample)  # the cell size traced: one compile


@pytest.mark.parametrize("case", ["negative", "invalid_mixed", "all_invalid", "collision",
                                  "merging"])
def test_voxel_downsample_matches_jax(case):
    rng = np.random.default_rng(1)
    n_pts, cell = 512, 0.05
    if case == "negative":  # every coordinate negative, cells of a few points
        xyz, feats, valid = point_set(rng, n_pts, 500, lo=-1.0, hi=-0.6)
    elif case == "invalid_mixed":  # invalid points scattered among valid ones
        xyz, feats, _ = point_set(rng, n_pts, n_pts)
        valid = rng.random(n_pts) < 0.6
        xyz, feats = xyz * valid[:, None], feats * valid[:, None]
    elif case == "all_invalid":
        xyz, feats, valid = point_set(rng, n_pts, 0)
    elif case == "collision":
        xyz, feats, valid = _collision_points(n_pts, cell)
    else:  # coarse cells: many points a group
        xyz, feats, valid = point_set(rng, n_pts, 480)
        cell = 0.4
    js, ps = both_sets(xyz, feats, valid)
    want = _jax_downsample(js, jnp.float32(cell))
    got = pvs.voxel_downsample(ps, cell)
    assert_sets_equal(want, got)
    if case == "collision":
        # the colliding cells interleave after the stable sort by key, and
        # a change of coordinates starts a group: 4 groups, never a merge
        assert int(got.count) == 5


_jax_hierarchical = jax.jit(jvs.hierarchical_subsample, static_argnums=2)


@pytest.mark.parametrize("n_valid,max_points,want_level", [
    (100, 1500, 0),  # small input: level 0
    (4000, 500, None),  # a middle level
    (4000, 1, 5),  # no level qualifies: the last
])
def test_hierarchical_subsample_matches_jax(n_valid, max_points, want_level):
    rng = np.random.default_rng(2)
    src, tgt = point_set(rng, 4096, n_valid), point_set(rng, 4096, n_valid - 50)
    (js, ps), (jt, pt) = both_sets(*src), both_sets(*tgt)
    s_j, t_j, level_j = _jax_hierarchical(js, jt, 6, jnp.float32(0.05), max_points)
    s_p, t_p, level_p = pvs.hierarchical_subsample(ps, pt, 6, 0.05, max_points)
    assert int(level_p) == int(level_j)
    if want_level is not None:
        assert int(level_p) == want_level
    else:
        assert 0 < int(level_p) < 5
    assert_sets_equal(s_j, s_p)
    assert_sets_equal(t_j, t_p)


@pytest.mark.parametrize("size,k,p", [(6, 4, 0.5), (10, 4, 1.0), (3, 8, 0.7),
                                      (4096, 16384, 0.3), (4096, 256, 0.4), (4096, 256, 0.0)])
def test_masked_selects_match_jax(size, k, p):
    """First-k and strided selections, exact; k > size pads (k = 16384 at
    R = 16, as in the model), count > k thins."""
    rng = np.random.default_rng(size + k)
    mask = rng.random(size) < p
    for jfn, pfn in ((jvs.masked_select_first_k, pvs.masked_select_first_k),
                     (jvs.masked_select_strided, pvs.masked_select_strided)):
        idx_j, valid_j = jfn(jnp.asarray(mask), k)
        idx_p, valid_p = pfn(t(mask), k)
        assert idx_p.shape == (k,) and valid_p.shape == (k,)
        np.testing.assert_array_equal(n(idx_p), np.asarray(idx_j))
        np.testing.assert_array_equal(n(valid_p), np.asarray(valid_j))


# ------------------------------------------------------------ embeddings

def test_sine_position_embedding_matches_jax():
    """d = 256: 84 features an axis, sin/cos interleaved, 4 zero columns."""
    rng = np.random.default_rng(3)
    xyz = rng.uniform(-1.5, 1.5, (2, 300, 3)).astype(np.float32)
    want = np.asarray(jpe.PositionEmbeddingCoordsSine(3, 256).apply({}, jnp.asarray(xyz)))
    got = n(ppe.PositionEmbeddingCoordsSine(3, 256)(t(xyz)))
    assert got.shape == (2, 300, 256)
    np.testing.assert_array_equal(got[..., 252:], 0.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_learned_position_embedding_matches_jax():
    rng = np.random.default_rng(4)
    xyz = rng.uniform(-1.5, 1.5, (1, 64, 3)).astype(np.float32)
    port = ppe.PositionEmbeddingLearned(3, 32)
    tree = pregtr.random_jax_params(port, rng)
    port.load_state_dict(pregtr.params_from_jax(tree, port))
    want = jpe.PositionEmbeddingLearned(3, 32).apply({"params": tree}, jnp.asarray(xyz))
    np.testing.assert_allclose(n(port(t(xyz))), np.asarray(want), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ FPN

@pytest.mark.parametrize("arch,lateral_kernel", [("resnet18", 3), ("resnet50", 1)])
def test_feature_pyramid_matches_jax(arch, lateral_kernel):
    """v3 pyramid for basic nets, v1 for bottleneck nets; R = 16, f32,
    full 256 output channels; within 1e-4 of the output's max. The
    weights are torch's default draws, biases included."""
    rng = np.random.default_rng(5)
    torch.manual_seed(5)
    port = pres.FeaturePyramid3D(arch, 256)
    tree = pregtr.params_to_jax(port)
    assert tree["lateral2"]["kernel"].shape[0] == lateral_kernel
    port.load_state_dict(pregtr.params_from_jax(tree, port))
    x = rng.uniform(size=(1, 16, 16, 16, 4)).astype(np.float32)
    want = np.asarray(jax.jit(jres.FeaturePyramid3D(arch, 256).apply)(
        {"params": tree}, jnp.asarray(x)))
    with torch.no_grad():
        got = n(port(t(x).permute(0, 4, 1, 2, 3))).transpose(0, 2, 3, 4, 1)
    assert got.shape == want.shape == (1, 8, 8, 8, 256)
    assert rel_err(got, want) < 1e-4


# ------------------------------------------------------------ transformer

@pytest.fixture(scope="module")
def encoder_pair():
    rng = np.random.default_rng(6)
    port = ptr.TransformerCrossEncoder(2, 64, 4, 128)
    tree = pregtr.random_jax_params(port, rng)
    port.load_state_dict(pregtr.params_from_jax(tree, port))
    return port, tree, jax.jit(jtr.TransformerCrossEncoder(2, 64, 4, 128).apply)


@pytest.mark.parametrize("n_src,n_tgt", [(10, 12), (16, 0)])
def test_cross_encoder_matches_jax_on_every_row(encoder_pair, n_src, n_tgt):
    """Padded tokens included: a padded query row, or a row whose keys are
    all padded (tgt wholly invalid), softmaxes to a uniform distribution,
    as flax's finfo.min mask gives; every row within 1e-5 of the max."""
    port, tree, apply = encoder_pair
    rng = np.random.default_rng(7)
    n_tok = 16
    src, tgt, spos, tpos = (rng.normal(size=(1, n_tok, 64)).astype(np.float32)
                            for _ in range(4))
    sv, tv = np.arange(n_tok)[None] < n_src, np.arange(n_tok)[None] < n_tgt
    want = apply({"params": tree}, *map(jnp.asarray, (src, tgt, sv, tv, spos, tpos)))
    with torch.no_grad():
        got = port(*map(t, (src, tgt, sv, tv, spos, tpos)))
    for w, g in zip(want, got):
        assert g.shape == (2, 1, n_tok, 64)
        assert np.isfinite(n(g)).all()
        assert rel_err(n(g), w) < 1e-5


def test_cross_encoder_refuses_sequence_parallel():
    """sp_mesh must be a parallel.mesh.Mesh (the sequence-parallel switch
    itself is held against JAX's in tests/test_torch_parallel.py)."""
    with pytest.raises(TypeError, match="Mesh"):
        ptr.TransformerCrossEncoder(sp_mesh=object())
    with pytest.raises(TypeError, match="Mesh"):
        pregtr.NeRFRegTr(sp_mesh=object(), **SMALL)


@pytest.mark.parametrize("n_src,n_tgt", [(10, 12), (9, 0)])
def test_correspondence_decoder_matches_jax(n_src, n_tgt):
    """Keys masked with -1e9; all keys invalid gives the mean of the
    other cloud's coordinates. Within 1e-5."""
    rng = np.random.default_rng(8)
    port = ptr.CorrespondenceDecoder(64)
    tree = pregtr.random_jax_params(port, rng)
    port.load_state_dict(pregtr.params_from_jax(tree, port))
    L, n_tok = 2, 16
    sf, tf = (rng.normal(size=(L, 1, n_tok, 64)).astype(np.float32) for _ in range(2))
    sx, tx = (rng.uniform(-1, 1, (1, n_tok, 3)).astype(np.float32) for _ in range(2))
    sp, tp = (rng.normal(size=(1, n_tok, 64)).astype(np.float32) for _ in range(2))
    sv, tv = np.arange(n_tok)[None] < n_src, np.arange(n_tok)[None] < n_tgt
    args = (sf, tf, sx, tx, sv, tv, sp, tp)
    want = jtr.CorrespondenceDecoder(64).apply({"params": tree}, *map(jnp.asarray, args))
    with torch.no_grad():
        got = port(*map(t, args))
    for w, g in zip(want, got):
        np.testing.assert_allclose(n(g), np.asarray(w), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ Kabsch

def _rotation(axis, angle):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k


def test_kabsch_recovers_a_known_transform():
    rng = np.random.default_rng(9)
    a = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    rot = _rotation([1.0, 2.0, -0.5], np.deg2rad(30)).astype(np.float32)
    b = a @ rot.T + np.array([0.1, -0.05, 0.2], np.float32)
    w = rng.uniform(0.2, 1.0, 500).astype(np.float32)
    got = n(pk.weighted_rigid_transform(t(a), t(b), t(w)))
    rel = got[:, :3].astype(np.float64).T @ rot.astype(np.float64)
    angle = np.linalg.norm(np.array([rel[2, 1] - rel[1, 2], rel[0, 2] - rel[2, 0],
                                     rel[1, 0] - rel[0, 1]])) / 2  # sin of the angle
    assert angle < 1e-4
    np.testing.assert_allclose(got[:, 3], [0.1, -0.05, 0.2], atol=1e-5)
    want = np.asarray(jk.weighted_rigid_transform(jnp.asarray(a), jnp.asarray(b),
                                                  jnp.asarray(w)))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_kabsch_fixes_a_reflection():
    """b mirrors a: the unfixed V U^T has det -1; the fixed one is a
    rotation, the same as JAX's."""
    rng = np.random.default_rng(10)
    a = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    b = a * np.array([1.0, 1.0, -1.0], np.float32)
    w = np.ones(64, np.float32)
    u, _, vt = np.linalg.svd((a - a.mean(0)).T @ (b - b.mean(0)))
    assert np.linalg.det(vt.T @ u.T) < 0
    got = n(pk.weighted_rigid_transform(t(a), t(b), t(w)))
    np.testing.assert_allclose(np.linalg.det(got[:, :3]), 1.0, atol=1e-5)
    np.testing.assert_allclose(got[:, :3] @ got[:, :3].T, np.eye(3), atol=1e-5)
    want = np.asarray(jk.weighted_rigid_transform(jnp.asarray(a), jnp.asarray(b),
                                                  jnp.asarray(w)))
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_kabsch_all_zero_weights_stays_finite():
    """The eps clamp of the weight sum keeps the pose finite (a rotation,
    zero translation), as in JAX; batched over layers."""
    rng = np.random.default_rng(11)
    a, b = (rng.uniform(-1, 1, (3, 1, 32, 3)).astype(np.float32) for _ in range(2))
    w = np.zeros((3, 1, 32), np.float32)
    got = n(pk.weighted_rigid_transform(t(a), t(b), t(w)))
    want = np.asarray(jk.weighted_rigid_transform(*map(jnp.asarray, (a, b, w))))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[..., 3], 0.0)
    for r in got.reshape(-1, 3, 4)[:, :, :3]:
        np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-6)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_umeyama_and_pose_error_match_jax():
    from dregnerf_tpu.geometry import se3 as jse3

    rng = np.random.default_rng(12)
    src = rng.uniform(-1, 1, (100, 3)).astype(np.float32)
    rot = _rotation([0.3, -1.0, 0.2], 1.1).astype(np.float32)
    dst = 1.7 * src @ rot.T + np.array([0.3, 0.1, -0.2], np.float32)
    for want, got in zip(jk.umeyama(jnp.asarray(src), jnp.asarray(dst)),
                         pk.umeyama(t(src), t(dst))):
        np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5)
    p1 = np.concatenate([rot, rng.normal(size=(3, 1))], 1).astype(np.float32)
    p2 = np.concatenate([_rotation([1, 0, 0], 0.2), rng.normal(size=(3, 1))], 1)
    p2 = p2.astype(np.float32)
    for want, got in zip(jse3.pose_error(jnp.asarray(p1), jnp.asarray(p2)),
                         pse3.pose_error(t(p1), t(p2))):
        np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-5)


# ------------------------------------------------------------ trilinear gather

@pytest.mark.parametrize("shape,full", [((4, 4, 4), (8, 8, 8)), ((3, 5, 4), (7, 9, 11)),
                                        ((8, 8, 8), (8, 8, 8))])
def test_gather_trilinear_resized_matches_dense_and_jax(shape, full):
    rng = np.random.default_rng(13)
    c = 6
    vol = rng.normal(size=(1, *shape, c)).astype(np.float32)  # NDHWC as in JAX
    idx = rng.integers(0, int(np.prod(full)), size=64)
    vol_t = t(vol).permute(0, 4, 1, 2, 3)
    sparse = n(pregtr.gather_trilinear_resized(vol_t, full, t(idx)))
    dense = n(pregtr.trilinear_resize(vol_t, full)[0].permute(1, 2, 3, 0).reshape(-1, c))[idx]
    np.testing.assert_allclose(sparse, dense, rtol=1e-5, atol=1e-5)
    want = np.asarray(jregtr.gather_trilinear_resized(jnp.asarray(vol), full,
                                                      jnp.asarray(idx, jnp.int32)))
    np.testing.assert_allclose(sparse, want, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ the whole model

def _scene(rng, r=16, n_occ=200, offset=0.0):
    grid = np.zeros((r, r, r, 7), np.float32)
    mask = np.zeros(r ** 3, bool)
    ii = rng.integers(2, r - 2, size=(n_occ, 3))
    flat = ii[:, 0] * r * r + ii[:, 1] * r + ii[:, 2]
    grid.reshape(-1, 7)[flat, :3] = (ii + 0.5) / r * 3.0 - 1.5 + offset
    grid.reshape(-1, 7)[flat, 3:6] = rng.uniform(size=(n_occ, 3))
    grid.reshape(-1, 7)[flat, 6] = 1.0
    mask[flat] = True
    return grid, mask


@pytest.fixture(scope="module")
def small_pair():
    rng = np.random.default_rng(14)
    (sg, sm), (tg, tm) = _scene(rng), _scene(rng, offset=0.1)
    data = {"src_grid": sg, "src_mask": sm, "tgt_grid": tg, "tgt_mask": tm}
    port = pregtr.NeRFRegTr(**SMALL)
    return data, pregtr.random_jax_params(port, rng)


# bf16 bounds: a few bf16 roundings (2^-8) of values of order 1 to 4
BF16_ATOL = {"src_feats": 0.1, "tgt_feats": 0.1, "src_kp_warped": 0.02,
             "tgt_kp_warped": 0.02, "src_overlap": 0.02, "tgt_overlap": 0.02, "pose": 0.02}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nerf_regtr_matches_jax(small_pair, dtype):
    """The small-width model (resnet18, d 64, 2 layers) on a pair of
    R = 16 grids. f32: every key within 2e-5 of its max (padded token rows
    included), keypoints, validity and the level exact. bf16 (flax's
    meaning: bf16 operands and softmax, f32 norms statistics, f32 Kabsch):
    within BF16_ATOL."""
    data, tree = small_pair
    jdt, pdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax.jit(jregtr.NeRFRegTr(dtype=jdt, **SMALL).apply)(
        {"params": tree}, {k: jnp.asarray(v) for k, v in data.items()})
    port = pregtr.NeRFRegTr(dtype=pdt, **SMALL)
    port.load_state_dict(pregtr.params_from_jax(tree, port))
    with torch.no_grad():
        got = port({k: t(v) for k, v in data.items()})
    assert set(got) == set(want)
    for key, w in want.items():
        assert (got[key].dtype == torch.bfloat16) == (w.dtype == jnp.bfloat16), key
        w = np.asarray(w.astype(jnp.float32) if w.dtype == jnp.bfloat16 else w)
        g = n(got[key])
        assert g.shape == w.shape, key
        if key in ("src_kp", "tgt_kp", "src_valid", "tgt_valid", "ds_level"):
            np.testing.assert_array_equal(g, w, err_msg=key)
        elif dtype == "float32":
            assert rel_err(g, w) < 2e-5, key
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=BF16_ATOL[key], err_msg=key)
    for rot in n(got["pose"])[:, :, :3]:
        np.testing.assert_allclose(rot @ rot.T, np.eye(3), atol=1e-5)


def test_dense_resize_path_matches_the_gather(small_pair):
    """dense_resize reads the materialized upsampled volume; the default
    samples the same reconstruction at the selected voxels (JAX's test of
    the two paths, on the port)."""
    data, tree = small_pair
    out = {}
    for dense in (False, True):
        port = pregtr.NeRFRegTr(dense_resize=dense, **SMALL)
        port.load_state_dict(pregtr.params_from_jax(tree, port))
        with torch.no_grad():
            out[dense] = port({k: t(v) for k, v in data.items()})
    for key in ("pose", "src_overlap", "src_feats"):
        assert rel_err(n(out[True][key]), n(out[False][key])) < 1e-4, key


def test_converter_covers_the_full_width_model():
    """The default model (resnet50, d 256, 6 layers, 8 heads): the flax
    tree's 341 leaves, their shapes from jax.eval_shape of the JAX init (no
    compile), each used once; every torch parameter filled; and the round
    trip flax -> torch -> flax exact."""
    r = 16
    spec = {"src_grid": jax.ShapeDtypeStruct((r, r, r, 7), jnp.float32),
            "tgt_grid": jax.ShapeDtypeStruct((r, r, r, 7), jnp.float32),
            "src_mask": jax.ShapeDtypeStruct((r ** 3,), jnp.bool_),
            "tgt_mask": jax.ShapeDtypeStruct((r ** 3,), jnp.bool_)}
    shapes = jax.eval_shape(jregtr.NeRFRegTr().init, jax.random.PRNGKey(0), spec)["params"]
    want = {jax.tree_util.keystr(p): leaf.shape
            for p, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert len(want) == 341

    port = pregtr.NeRFRegTr()
    tree = pregtr.random_jax_params(port, np.random.default_rng(15))
    got = {jax.tree_util.keystr(p): leaf.shape
           for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert got == want
    state = pregtr.params_from_jax(tree, port)
    assert set(state) == set(port.state_dict())
    assert sum(v.numel() for v in state.values()) == 61123713
    port.load_state_dict(state)
    back = pregtr.params_to_jax(port)
    for (p, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                              jax.tree_util.tree_flatten_with_path(back)[0]):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(p))

    with pytest.raises(KeyError, match="no leaf"):
        del tree["decoder"]["q_proj"]["bias"]
        pregtr.params_from_jax(tree, port)
