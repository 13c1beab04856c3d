"""The port's classical registration (dregnerf_tpu_torch/registration/)
against the JAX package's, on the CPU, on the clouds of the JAX tests
(tests/test_geometry.py::TestICP, tests/test_reg_training.py::
TestFGRBaseline and ::TestClassicalPipeline).

Poses are compared as the rotation angle and translation between the two
packages' results, never as neighbour indices: a near-tie in the argmin
can go the other way when sums run in another order. The port's ICP drops
`_prep`'s padding before the device work; the JAX side keeps it.

Tolerances (measured gaps in brackets, this file's clouds; run with -s to
see the gaps the tests print):
- POSE_TOL: 0.05 deg and 1e-4 between converged ICP poses (6.1e-4 deg,
  2.9e-6); the angle comes from both the sine and the cosine of the
  relative rotation, since arccos alone floors near 0.05 deg for f32
  rotations.
- rms and count of ICP's last matches: a match at the strict gate flips in
  or out when the poses differ in their last bits, so counts within
  MATCH_FLIPS and count * rms^2 within MATCH_FLIPS * gate^2 (a 4 % rms gap
  at an equal count on the partial-overlap shell: one match in, one out).
- SCORE_TOL: scores within 1e-4 + 1e-4 |score|; a converged score is the
  f32 rounding of |x|^2 - 2 x.y + |y|^2 under a square root (2.3e-5
  against 2.5e-5 on the race cloud).
- The FGR library: JAX's is the pre-built native/libdregnative.so, made
  with -march=native; the port builds csrc/fgr.cpp without it (and the
  same source built here with -march=native equals the pre-built one bit
  for bit). FMA contraction moves FPFH features by up to 6.7e-3 (FPFH_TOL
  2e-2) and FGR poses by up to 4.9e-4 in an entry, 0.03 deg (FGR_TOL 0.1
  deg, 2e-3).
"""
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from dregnerf_tpu.registration import fgr as jfgr
from dregnerf_tpu.registration import global_icp as jglobal
from dregnerf_tpu.registration import icp as jicp
from dregnerf_tpu.registration import pipeline as jpipe
from dregnerf_tpu_torch.ops import native
from dregnerf_tpu_torch.registration import fgr as pfgr
from dregnerf_tpu_torch.registration import global_icp as pglobal
from dregnerf_tpu_torch.registration import icp as picp
from dregnerf_tpu_torch.registration import pipeline as ppipe
from torch_reg_common import few_torch_threads  # noqa: F401 (an autouse fixture)

ROOT = Path(__file__).resolve().parent.parent
POSE_TOL = (0.05, 1e-4)  # degrees, translation
MATCH_FLIPS = 2
FPFH_TOL = 2e-2
FGR_TOL = (0.1, 2e-3)


def score_close(a: float, b: float) -> bool:
    return abs(a - b) <= 1e-4 + 1e-4 * abs(a)


def pose_gap(a, b) -> tuple[float, float]:
    """(degrees, translation) between two [3|4, 4] poses."""
    a, b = np.asarray(a, np.float64)[:3], np.asarray(b, np.float64)[:3]
    rel = a[:, :3].T @ b[:, :3]
    skew = rel - rel.T
    sin = np.linalg.norm([skew[2, 1], skew[0, 2], skew[1, 0]]) / 2
    cos = (np.trace(rel) - 1) / 2
    return float(np.degrees(np.arctan2(sin, cos))), float(np.linalg.norm(a[:, 3] - b[:, 3]))


def assert_pose_close(a, b, tol=POSE_TOL):
    deg, trans = pose_gap(a, b)
    assert deg <= tol[0] and trans <= tol[1], (deg, trans)


def assert_matches_close(rms_a, cnt_a, rms_b, cnt_b, gate):
    assert abs(cnt_a - cnt_b) <= MATCH_FLIPS, (cnt_a, cnt_b)
    assert abs(cnt_a * rms_a**2 - cnt_b * rms_b**2) <= MATCH_FLIPS * gate**2, (rms_a, rms_b)


def _pose(deg, t):
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = Rotation.from_euler("xyz", deg, degrees=True).as_matrix()
    T[:3, 3] = t
    return T


def _shell(rng, n=3000):
    """tests/test_geometry.py::TestICP._shell."""
    sph = rng.normal(size=(n, 3))
    sph /= np.linalg.norm(sph, axis=1, keepdims=True)
    pts = sph * np.array([0.5, 0.35, 0.25])
    pts[: n // 4] = rng.normal(size=(n // 4, 3)) * 0.04 + np.array([0.45, 0.3, 0.1])
    return pts.astype(np.float32)


def _icp_case(name):
    """(src, tgt, init, kwargs of icp_refine) of the TestICP cases."""
    if name == "coarse_init":
        rng = np.random.default_rng(3)
        src = _shell(rng)
        gt = _pose([40, -25, 70], [0.2, -0.1, 0.15])
        tgt = src @ gt[:3, :3].T + gt[:3, 3]
        init = (_pose([8, -5, 7], [0.03, 0.02, -0.03]) @ gt)[:3, :4]
        return src, tgt, init, dict(voxel_size=0.05, seed=1)
    if name == "partial_overlap_padding":
        rng = np.random.default_rng(4)
        src = _shell(rng, n=2500)
        gt = _pose([15, 30, -10], [0.1, 0.0, -0.05])
        tgt_full = src @ gt[:3, :3].T + gt[:3, 3]
        tgt = tgt_full[tgt_full[:, 0] < np.quantile(tgt_full[:, 0], 0.7)]
        init = (_pose([6, -4, 5], [0.02, -0.02, 0.01]) @ gt)[:3, :4]
        return src, tgt, init, dict(voxel_size=0.05, n_points=4096, seed=2)
    if name == "degenerate":
        return np.zeros((2, 3)), np.ones((2, 3)), np.eye(4)[:3], dict(seed=0)
    if name == "colored_sphere":
        rng = np.random.default_rng(7)
        pts = rng.normal(size=(4000, 3))
        pts /= np.linalg.norm(pts, axis=1, keepdims=True)
        pts = (pts * 0.5).astype(np.float32)
        cols = (0.5 + pts).astype(np.float32)  # 0.5 + 0.5 * p / 0.5
        gt = _pose([25, -15, 30], [0.05, -0.02, 0.03])
        tgt = pts @ gt[:3, :3].T + gt[:3, 3]
        init = (_pose([10, 6, -8], [0.01, 0.0, -0.01]) @ gt)[:3, :4]
        # 2048 of the 4000 points: the port's CPU ICP on 2 threads is slow at 4096
        return pts, tgt, init, dict(voxel_size=0.05, seed=3, src_colors=cols, tgt_colors=cols,
                                    n_points=2048)
    assert name == "diverging"  # tiny overlap: the init must not get worse
    rng = np.random.default_rng(9)
    src = rng.normal(size=(500, 3)).astype(np.float32)
    tgt = rng.normal(size=(500, 3)).astype(np.float32) + 5.0
    return src, tgt, np.eye(4, dtype=np.float32)[:3], dict(voxel_size=0.05, seed=1)


@pytest.fixture(scope="module")
def race_cloud():
    """tests/test_reg_training.py::TestClassicalPipeline's multi-cluster
    shell (drawn from the conftest's default_rng(0)) and its pose."""
    rng = np.random.default_rng(0)
    sph = rng.normal(size=(1200, 3))
    sph /= np.linalg.norm(sph, axis=1, keepdims=True)
    pts = np.vstack([
        sph * np.array([0.5, 0.3, 0.2]),
        rng.normal(size=(400, 3)) * 0.05 + np.array([0.45, 0.25, 0.1]),
        rng.normal(size=(300, 3)) * 0.04 - np.array([0.3, 0.4, 0.05]),
    ])
    T = _pose([60, -20, 110], [0.15, -0.2, 0.1]).astype(np.float64)
    return pts, pts @ T[:3, :3].T + T[:3, 3], T


# ---------------------------------------------------------------- sources


def test_fgr_source_is_a_byte_for_byte_copy():
    assert (ROOT / "dregnerf_tpu_torch" / "csrc" / "fgr.cpp").read_bytes() == \
        (ROOT / "native" / "fgr.cpp").read_bytes()


def test_failed_fgr_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    (tmp_path / "fgr.cpp").write_text("int broken( {\n")
    monkeypatch.setattr(native, "CSRC", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_loaded", {})
    monkeypatch.setattr(native, "_entries", {})
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed for libfgr_.*error"):
        pfgr.run_registration(np.zeros((20, 3)), np.ones((20, 3)))
    assert not list((tmp_path / "_build").glob("*.so"))


def test_fgr_library_is_the_ports_own_build():
    """g++ -O3 -fPIC -std=c++17 -shared (no -march=native) into _build/,
    named by a hash of the source and the flags, and that is what the
    binding loads."""
    pfgr.fpfh(np.random.default_rng(0).normal(size=(200, 3)), 0.1)
    so = native.library_path("fgr")
    assert so.parent == ROOT / "dregnerf_tpu_torch" / "_build" and so.exists()
    assert native.CXX_FLAGS == ("-O3", "-fPIC", "-std=c++17", "-shared")
    with open(f"/proc/{os.getpid()}/maps") as f:
        assert str(so) in f.read()


# ------------------------------------------------------------ small pieces


@pytest.mark.parametrize("n,colors", [(4096, None), (4096, "unit"), (1024, "byte"), (64, "byte")],
                         ids=["pad", "pad_colors", "pad_byte_colors", "subsample"])
def test_prep_matches_jax(n, colors):
    """Same seed, same calls in the same order (src, then tgt): the same
    points, colours (bytes rescaled by 1/255) and masks."""
    rng = np.random.default_rng(5)
    src, tgt = rng.normal(size=(300, 3)), rng.normal(size=(200, 3))
    cols = {None: None, "unit": rng.uniform(size=(300, 3)),
            "byte": rng.integers(0, 256, size=(300, 3)).astype(np.float64)}[colors]
    tcols = None if cols is None else cols[:200]
    want_rng, got_rng = np.random.default_rng(11), np.random.default_rng(11)
    for a, c in ((src, cols), (tgt, tcols)):
        want = jicp._prep(a, c, n, want_rng)
        got = picp._prep(a, c, n, got_rng)
        for w, g in zip(want, got):
            assert w.dtype == g.dtype
            np.testing.assert_array_equal(w, g)


def test_octahedral_rotations_equal():
    np.testing.assert_array_equal(pglobal.octahedral_rotations(), jglobal.octahedral_rotations())


def _padded_shell(n_pad=1024, n=700, seed=12):
    """A shell padded to n_pad rows, its moved copy, colours and masks."""
    rng = np.random.default_rng(seed)
    src = _shell(rng, n=n)
    gt = _pose([20, -10, 35], [0.05, 0.02, -0.04])
    tgt = src @ gt[:3, :3].T + gt[:3, 3]
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    r = np.random.default_rng(0)
    s, sc, sv = jicp._prep(src, cols, n_pad, r)
    t, tc, tv = jicp._prep(tgt, cols, n_pad, r)
    return s, t, 0.5 * sc, 0.5 * tc, sv, tv, gt


def test_icp_core_single_pose_matches_jax():
    """K = 1 on padded clouds with colour features: pose, rms and count."""
    s, t, sc, tc, sv, tv, gt = _padded_shell()
    init = (_pose([6, 4, -5], [0.02, 0.0, 0.01]) @ gt)[:3, :4]
    gate0, gate1 = 0.15, 0.02
    want = jicp.icp_core(*map(jnp.asarray, (s, t, sc, tc, sv, tv, init)), jnp.float32(gate0),
                         jnp.float32(gate1), iters=20)
    got = picp.icp_core(*map(torch.as_tensor, (s, t, sc, tc, sv, tv)),
                        torch.as_tensor(init)[None], gate0, gate1, iters=20)
    assert got[0].shape == (1, 3, 4) and got[1].shape == got[2].shape == (1,)
    print(f"icp_core K=1: pose gap to JAX {pose_gap(want[0], got[0][0].numpy())}, rms "
          f"{float(want[1]):.3e} / {float(got[1][0]):.3e}, count {float(want[2])} / "
          f"{float(got[2][0])}")
    assert_pose_close(np.asarray(want[0]), got[0][0].numpy())
    assert_pose_close(got[0][0].numpy(), gt)
    assert_matches_close(float(want[1]), float(want[2]), float(got[1][0]), float(got[2][0]),
                         gate1)


def test_icp_core_batched_over_the_24_seeds_matches_jax_vmap():
    """K = 24 from the octahedral seeds (the global race's call) against
    jax.vmap of JAX's icp_core: every seed's pose, rms and count."""
    s, t, sc, tc, sv, tv, _ = _padded_shell(n_pad=512, n=400, seed=13)
    rots = jglobal.octahedral_rotations()
    mu_s, mu_t = s[sv].mean(0), t[tv].mean(0)
    seeds = np.concatenate([rots, (mu_t - np.einsum("kij,j->ki", rots, mu_s))[..., None]], -1)
    gate0, gate1 = 8 * 0.03125, 0.8 * 0.03125
    args = tuple(map(jnp.asarray, (s, t, sc, tc, sv, tv)))
    want = jax.vmap(lambda p: jicp.icp_core(*args, p, jnp.float32(gate0), jnp.float32(gate1),
                                            iters=20))(jnp.asarray(seeds))
    got = picp.icp_core(*map(torch.as_tensor, (s, t, sc, tc, sv, tv)), torch.as_tensor(seeds),
                        gate0, gate1, iters=20)
    gaps = [pose_gap(want[0][k], got[0][k].numpy()) for k in range(24)]
    print(f"icp_core K=24: largest pose gap to JAX {max(g[0] for g in gaps):.3e} deg, "
          f"{max(g[1] for g in gaps):.3e}")
    for k in range(24):
        assert_pose_close(np.asarray(want[0][k]), got[0][k].numpy())
        assert_matches_close(float(want[1][k]), float(want[2][k]), float(got[1][k]),
                             float(got[2][k]), gate1)


@pytest.mark.parametrize("feat", [False, True], ids=["score_pose", "score_pose_feat"])
def test_scores_match_jax(feat):
    """The trimmed-NN scores on padded clouds (the trim counts the valid
    rows, in f32) at 25 poses, one at a time and batched."""
    s, t, sc, tc, sv, tv, gt = _padded_shell()
    rng = np.random.default_rng(1)
    poses = np.stack([(_pose(rng.normal(size=3) * 10, rng.normal(size=3) * 0.05) @ gt)[:3, :4]
                      for _ in range(24)] + [gt[:3, :4]]).astype(np.float32)
    if feat:
        want = [float(jicp.score_pose_feat(*map(jnp.asarray, (s, t, sc, tc, sv, tv, p))))
                for p in poses]
        args = tuple(map(torch.as_tensor, (s, t, sc, tc, sv, tv)))
        one = [float(picp.score_pose_feat(*args, torch.as_tensor(p))) for p in poses]
        batched = picp.score_pose_feat(*args, torch.as_tensor(poses)).tolist()
    else:
        want = [float(jicp.score_pose(*map(jnp.asarray, (s, t, sv, tv, p)))) for p in poses]
        args = tuple(map(torch.as_tensor, (s, t, sv, tv)))
        one = [float(picp.score_pose(*args, torch.as_tensor(p))) for p in poses]
        batched = picp.score_pose(*args, torch.as_tensor(poses)).tolist()
    for w, a, b in zip(want, one, batched):
        assert score_close(w, a) and score_close(w, b), (w, a, b)
    assert np.argmin(one) == np.argmin(want) == 24


def test_trim_counts_the_valid_rows():
    """1900 valid src rows padded to 4096 and one valid target: the score
    keeps int(f32(1900) * 0.9) = 1710 distances (1709 at 1, then 1000; the
    190 at 2000 are trimmed), not 0.9 of the padded capacity."""
    src = np.zeros((4096, 3), np.float32)
    src[:1709, 0], src[1709, 0], src[1710:1900, 0] = 1.0, 1000.0, 2000.0
    tgt = np.zeros((8, 3), np.float32)
    sv, tv = np.arange(4096) < 1900, np.arange(8) < 1
    args = (src, tgt, sv, tv, np.eye(4, dtype=np.float32)[:3])
    want = float(jicp.score_pose(*map(jnp.asarray, args)))
    got = float(picp.score_pose(*map(torch.as_tensor, args)))
    assert want == pytest.approx((1709 + 1000) / 1710, rel=1e-6)
    assert got == pytest.approx(want, rel=1e-6)


# ------------------------------------------------------------- entry points


@pytest.mark.parametrize("case", ["coarse_init", "partial_overlap_padding", "degenerate",
                                  "colored_sphere", "diverging"])
def test_icp_refine_matches_jax(case):
    src, tgt, init, kw = _icp_case(case)
    want = jicp.icp_refine(src, tgt, init, **kw)
    got = picp.icp_refine(src, tgt, init, device="cpu", **kw)
    assert (got[0] is None) == (want[0] is None)
    if want[0] is None:
        assert got[2] == want[2] and (got[1] == want[1] or abs(got[1] - want[1]) <= 1e-6)
        return
    assert got[0].shape == (3, 4) and got[0].dtype == np.float32
    print(f"icp_refine [{case}]: pose gap to JAX {pose_gap(want[0], got[0])}, rms "
          f"{want[1]:.4e} / {got[1]:.4e}, count {want[2]} / {got[2]}")
    assert_pose_close(want[0], got[0])
    assert_matches_close(want[1], want[2], got[1], got[2], 0.4 * kw["voxel_size"])


def test_global_colored_icp_matches_jax(race_cloud):
    pts, tgt, T = race_cloud
    want, winfo = jglobal.global_colored_icp(pts, tgt)
    got, ginfo = pglobal.global_colored_icp(pts, tgt, device="cpu")
    assert ginfo["coarse_seed"] == winfo["coarse_seed"]
    assert score_close(winfo["coarse_best_score"], ginfo["coarse_best_score"])
    assert set(ginfo) == set(winfo)
    print(f"global_colored_icp: pose gap to JAX {pose_gap(want, got)}, coarse score "
          f"{winfo['coarse_best_score']:.6e} / {ginfo['coarse_best_score']:.6e}")
    assert_pose_close(want, got)
    assert_pose_close(got, T, (2.0, 0.02))
    assert_matches_close(winfo["icp_rms"], winfo["icp_inliers"], ginfo["icp_rms"],
                         ginfo["icp_inliers"], 0.4 * 2.0 / 128 * 2)


def test_best_global_registration_matches_jax(race_cloud):
    """The race of tests/test_reg_training.py: the same candidates in the
    same order, each proposal's polished pose and score, the winner and the
    refined pose, within 3 deg and 0.05 of the truth (the JAX test's bound)."""
    pts, tgt, T = race_cloud
    want, winfo = jpipe.best_global_registration(pts, tgt, voxel_sizes=(0.03, 0.05))
    got, ginfo = ppipe.best_global_registration(pts, tgt, voxel_sizes=(0.03, 0.05),
                                                device="cpu")
    assert ginfo["winner"] == {**winfo["winner"], "score": ginfo["winner"]["score"]}
    assert score_close(winfo["winner"]["score"], ginfo["winner"]["score"])
    assert [(c["method"], c["voxel"], c.get("dir")) for c in ginfo["candidates"]] == \
        [(c["method"], c["voxel"], c.get("dir")) for c in winfo["candidates"]]
    for w, g in zip(winfo["candidates"], ginfo["candidates"]):
        assert "error" not in g and (w["score"] is None) == (g["score"] is None)
        if w["score"] is not None:
            assert score_close(w["score"], g["score"]), (w, g)
            assert_pose_close(w["T"], g["T"], FGR_TOL)
    print(f"best_global_registration: pose gap to JAX {pose_gap(want, got)}, to the truth "
          f"{pose_gap(got, T)}, winner {ginfo['winner']}")
    assert_pose_close(want, got)
    assert_pose_close(got, T, (3.0, 0.05))
    assert abs(ginfo["icp"]["inliers"] - winfo["icp"]["inliers"]) <= MATCH_FLIPS


def test_best_global_registration_degenerate_mirrors_jax():
    """5 points at 0 against 5 at 1: JAX's function returns the global-ICP
    candidate's pose (where its own test expects None), and so does the
    port: the function is mirrored, not that test."""
    args = (np.zeros((5, 3)), np.ones((5, 3)))
    want, winfo = jpipe.best_global_registration(*args, voxel_sizes=(0.05,))
    got, ginfo = ppipe.best_global_registration(*args, voxel_sizes=(0.05,), device="cpu")
    assert want is not None and got is not None
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert ginfo["winner"] == winfo["winner"]
    assert [c["score"] for c in ginfo["candidates"]] == [c["score"] for c in winfo["candidates"]]


# --------------------------------------------------------------------- FGR


def _fgr_cloud(rng):
    sph = rng.normal(size=(1000, 3))
    sph /= np.linalg.norm(sph, axis=1, keepdims=True)
    return np.vstack([sph * np.array([0.5, 0.3, 0.2]),
                      rng.normal(size=(300, 3)) * 0.05 + np.array([0.45, 0.25, 0.1])])


def _multicluster(rng):
    r = np.random.default_rng(7)
    pts = []
    for _ in range(4):
        c, rad = r.uniform(-0.6, 0.6, 3), r.uniform(0.15, 0.3)
        d = r.normal(size=(3000, 3))
        pts.append(c + rad * d / np.linalg.norm(d, axis=1, keepdims=True))
    p = np.unique(np.round(np.concatenate(pts) / (2 / 128)) * (2 / 128), axis=0)
    T = _pose([15, 25, -30], [0.3, -0.2, 0.1]).astype(np.float64)
    tgt = p @ T[:3, :3].T + T[:3, 3]
    return p[rng.random(len(p)) > 0.3], tgt[rng.random(len(tgt)) > 0.3], T


@pytest.mark.parametrize("case", ["recovers_pose", "multicluster_voxel_cloud",
                                  "sparse_retry_ladder", "ransac_large_rotation"])
def test_fgr_and_ransac_match_jax(case):
    """The TestFGRBaseline clouds through both packages' bindings, each on
    its own build of fgr.cpp."""
    rng = np.random.default_rng(0)
    if case == "multicluster_voxel_cloud":
        src, tgt, T = _multicluster(rng)
        call, kw = "run_registration", dict(voxel_size=0.05)
    elif case == "sparse_retry_ladder":
        sph = rng.normal(size=(90, 3))
        src = sph / np.linalg.norm(sph, axis=1, keepdims=True) * np.array([0.2, 0.15, 0.1])
        T = np.eye(4)
        T[:3, 3] = [0.05, -0.02, 0.01]
        tgt = src + T[:3, 3]
        call, kw = "run_registration", dict(voxel_size=0.2, retry=True)
    else:
        src = _fgr_cloud(rng)
        ransac = case == "ransac_large_rotation"
        T = _pose([80, 10, -120] if ransac else [20, -35, 50], [0.2, -0.1, 0.3])
        T = T.astype(np.float64)
        tgt = src @ T[:3, :3].T + T[:3, 3]
        call = "run_ransac_registration" if ransac else "run_registration"
        kw = dict(voxel_size=0.03)
    want, _ = getattr(jfgr, call)(src, tgt, **kw)
    got, seconds = getattr(pfgr, call)(src, tgt, **kw)
    assert want is not None and got is not None and seconds > 0
    print(f"{call} [{case}, {len(src)} points]: largest pose entry gap to JAX's build "
          f"{np.abs(got - want).max():.3e}, {pose_gap(want, got)}")
    assert got.shape == (4, 4) and got.dtype == np.float64
    assert_pose_close(want, got, FGR_TOL)
    if case != "sparse_retry_ladder":
        assert_pose_close(got, T, (10.0, 0.08))


def test_fgr_failure_and_fpfh_match_jax():
    rng = np.random.default_rng(0)
    pts = _fgr_cloud(rng)
    want, got = jfgr.fpfh(pts, 0.03), pfgr.fpfh(pts, 0.03)
    assert got.shape == want.shape and got.dtype == np.float32
    print(f"fpfh [{len(pts)} points, voxel 0.03]: largest gap to JAX's build "
          f"{np.abs(got - want).max():.3e}, largest feature {np.abs(want).max():.3f}")
    assert np.abs(got - want).max() <= FPFH_TOL
    np.testing.assert_array_equal(pfgr.fpfh(np.zeros((3, 3)), 0.05),
                                  jfgr.fpfh(np.zeros((3, 3)), 0.05))
    for fn in ("run_registration", "run_ransac_registration"):
        assert getattr(pfgr, fn)(np.zeros((5, 3)), np.ones((5, 3)))[0] is None
        assert getattr(jfgr, fn)(np.zeros((5, 3)), np.ones((5, 3)))[0] is None


def test_registration_entry_points_run_on_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.random.default_rng(0).normal(size=(50, 3))
    for call in (lambda: picp.icp_refine(pts, pts, np.eye(4)[:3]),
                 lambda: pglobal.global_colored_icp(pts, pts),
                 lambda: ppipe.best_global_registration(pts, pts)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
