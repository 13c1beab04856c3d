"""The port's geometry/rotation.py and geometry/align.py against the JAX
package on seeded batches, on the CPU, in float32.

Tolerances: quaternions and matrices within 2e-6 (a few f32 roundings of
unit-sized terms); matrix_to_quat also on near-180-degree rotations (where
w ~ 0 and the candidate choice moves off t0) and on ties between the
trace terms, where both packages take the first candidate; axis-angle
from a matrix within 1e-5, and 2e-5 within 1e-2 rad of 180 degrees (the
log divides by sin(theta), which amplifies f32 rounding at large angles); distances in degrees within 2e-4; umeyama's
scale, rotation and translation within 1e-5."""
import jax.numpy as jnp
import numpy as np
import torch

from dregnerf_tpu.geometry import align as jalign
from dregnerf_tpu.geometry import rotation as jrot
from dregnerf_tpu_torch.geometry import align as palign
from dregnerf_tpu_torch.geometry import rotation as prot


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _both(fn_name, *arrays, module=(prot, jrot)):
    got = getattr(module[0], fn_name)(*(torch.from_numpy(a) for a in arrays))
    want = getattr(module[1], fn_name)(*(jnp.asarray(a) for a in arrays))
    return got, want


def _close(got, want, atol):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)


def _near_180(rng, n):
    """Rotations by pi - 1e-4 .. pi about random axes, and exactly pi."""
    axes = rng.normal(size=(n, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    angles = np.pi - rng.uniform(0, 1e-4, n)
    angles[0] = np.pi
    return (axes * angles[:, None]).astype(np.float32)


def _rotations(rng):
    q = _quats(rng, 64)
    m = np.asarray(jrot.quat_to_matrix(jnp.asarray(q)))
    near = np.asarray(jrot.axis_angle_to_matrix(jnp.asarray(_near_180(rng, 16))))
    # ties between trace terms: identity (t0 only), and 180 degrees about
    # the axes (1, 1, 0) and (1, 1, 1) (t1 == t2, and t1 == t2 == t3)
    ties = []
    for axis in ([1.0, 1.0, 0.0], [1.0, 1.0, 1.0], [0.0, 1.0, 1.0]):
        a = np.asarray(axis) / np.linalg.norm(axis)
        ties.append(2 * np.outer(a, a) - np.eye(3))
    ties += [np.eye(3), np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, -1.0, 1.0])]
    return np.concatenate([m, near, np.asarray(ties)]).astype(np.float32)


def test_quat_to_matrix_matches_jax():
    q = _quats(np.random.default_rng(0), 128) * 3.0  # the input is normalized
    got, want = _both("quat_to_matrix", q)
    assert got.shape == (128, 3, 3)
    _close(got, want, 2e-6)


def test_matrix_to_quat_matches_jax_with_near_180_and_ties():
    rots = _rotations(np.random.default_rng(1))
    got, want = _both("matrix_to_quat", rots)
    _close(got, want, 2e-6)
    assert bool((got[:, 0] >= 0).all())
    t = np.stack([1 + rots[:, 0, 0] + rots[:, 1, 1] + rots[:, 2, 2],
                  1 + rots[:, 0, 0] - rots[:, 1, 1] - rots[:, 2, 2],
                  1 - rots[:, 0, 0] + rots[:, 1, 1] - rots[:, 2, 2],
                  1 - rots[:, 0, 0] - rots[:, 1, 1] + rots[:, 2, 2]], -1)
    assert (t == t.max(-1, keepdims=True)).sum(-1).max() >= 3  # a three-way tie is there
    # the round trip: q and -q are the same rotation
    back = prot.quat_to_matrix(got).numpy()
    np.testing.assert_allclose(back, rots, rtol=0, atol=5e-6)


def test_axis_angle_round_trip_matches_jax():
    rng = np.random.default_rng(2)
    aa = (rng.normal(size=(64, 3)) * 1.2).astype(np.float32)
    got, want = _both("axis_angle_to_matrix", aa)
    _close(got, want, 2e-6)
    rots = _rotations(rng)
    got, want = _both("matrix_to_axis_angle", rots)
    angle = np.linalg.norm(np.asarray(want), axis=-1)
    far = angle < np.pi - 1e-2
    _close(got.numpy()[far], np.asarray(want)[far], 1e-5)
    _close(got.numpy()[~far], np.asarray(want)[~far], 2e-5)


def test_euler_and_distances_match_jax():
    rng = np.random.default_rng(3)
    angles = rng.uniform(-np.pi, np.pi, (7, 5, 3)).astype(np.float32)
    got, want = _both("euler_to_matrix", angles)
    assert got.shape == (7, 5, 3, 3)
    _close(got, want, 2e-6)
    r1, r2 = _rotations(rng), _rotations(rng)[::-1].copy()
    got, want = _both("chordal_distance", r1, r2)
    _close(got, want, 2e-6)
    got, want = _both("angular_distance_deg", r1, r2)
    _close(got, want, 2e-4)


def test_camera_alignment_and_trajectories_match_jax():
    rng = np.random.default_rng(4)
    gt = np.concatenate([_rotations(rng)[:20], rng.normal(size=(20, 3, 1))], -1)
    pred = np.concatenate([_rotations(rng)[20:40], rng.normal(size=(20, 3, 1))], -1)
    got, want = _both("evaluate_camera_alignment", pred.astype(np.float32),
                      gt.astype(np.float32), module=(palign, jalign))
    assert set(got) == set(want) == {"R_error_deg", "t_error"}
    _close(got["R_error_deg"], want["R_error_deg"], 2e-4)
    _close(got["t_error"], want["t_error"], 2e-6)

    src = rng.normal(size=(50, 3)).astype(np.float32)
    R = np.asarray(jrot.euler_to_matrix(jnp.asarray([0.3, -0.7, 1.1])))
    dst = (1.7 * src @ R.T + np.array([0.2, -0.4, 0.9])).astype(np.float32)
    dst += rng.normal(scale=1e-3, size=dst.shape).astype(np.float32)
    got, want = _both("align_trajectories", src, dst, module=(palign, jalign))
    for g, w in zip(got, want):
        _close(g, w, 1e-5)
    assert abs(float(got[0]) - 1.7) < 1e-2
