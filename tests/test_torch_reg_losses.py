"""The port's registration losses, visibility lookup, device augmentation
and per-ray surface field against the JAX package, on the CPU.

The same numpy inputs (from a seed) go through each JAX function and its
port. Values and gradients in f32 within 1e-5 of the JAX value's max
(1e-6 where stated: device_augment, surface_field_per_ray); labels exact.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dregnerf_tpu.datasets import register_pairs as jrp
from dregnerf_tpu.losses import registration as jL
from dregnerf_tpu.losses import visibility as jvis
from dregnerf_tpu.ops import composite as jcomp
from dregnerf_tpu.ops import occupancy as jocc
from dregnerf_tpu.ops import ray_march as jmarch
from dregnerf_tpu_torch.datasets import register_pairs as prp
from dregnerf_tpu_torch.losses import registration as pL
from dregnerf_tpu_torch.losses import visibility as pvis
from dregnerf_tpu_torch.ops import composite as pcomp
from dregnerf_tpu_torch.ops import ray_march as pmarch

TOL = 1e-5  # relative to the JAX value's max |.|


def t(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


def close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= tol * max(np.abs(want).max(), 1.0), (what, err)


def infonce_inputs(rng, n=48, m=40, d=16, n_pos_valid=None):
    anchor_xyz = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    positive_xyz = np.concatenate([
        anchor_xyz[:m // 2] + rng.normal(scale=0.02, size=(m // 2, 3)),  # near matches
        rng.uniform(-1, 1, (m - m // 2, 3))]).astype(np.float32)
    anchor_valid = rng.random(n) < 0.85
    positive_valid = np.arange(m) < (m - 5 if n_pos_valid is None else n_pos_valid)
    return dict(
        W=rng.normal(size=(d, d)).astype(np.float32) * 0.1,
        anchor_feat=rng.normal(size=(n, d)).astype(np.float32),
        positive_feat=rng.normal(size=(m, d)).astype(np.float32),
        anchor_xyz=anchor_xyz, positive_xyz=positive_xyz,
        anchor_valid=anchor_valid, positive_valid=positive_valid)


@pytest.mark.parametrize("case", ["matches", "no_matches", "all_invalid_positives",
                                  "traced_radii"])
def test_infonce_matches_jax(case):
    """Value, positive count and the gradients of W and both features."""
    rng = np.random.default_rng(0)
    x = infonce_inputs(rng, n_pos_valid=0 if case == "all_invalid_positives" else None)
    if case == "no_matches":
        x["positive_xyz"] = x["positive_xyz"] + 100.0  # nothing within r_p
    r_p = 0.15 if case == "traced_radii" else 0.2
    diff = ("W", "anchor_feat", "positive_feat")
    rest = {k: v for k, v in x.items() if k not in diff}

    def jloss(W, fa, fb):
        if case == "traced_radii":  # r_p, r_n as traced arrays, as the trainer passes them
            rp = jnp.float32(r_p)
            return jL.infonce_loss(W, fa, fb, **{k: jnp.asarray(v) for k, v in rest.items()},
                                   r_p=rp, r_n=2.0 * rp, return_stats=True)
        return jL.infonce_loss(W, fa, fb, **{k: jnp.asarray(v) for k, v in rest.items()},
                               return_stats=True)

    jargs = [jnp.asarray(x[k]) for k in diff]
    want, want_n = jloss(*jargs)
    want_g = jax.grad(lambda *a: jloss(*a)[0], argnums=(0, 1, 2))(*jargs)
    args = [t(x[k], grad=True) for k in diff]
    kw = {k: t(v) for k, v in rest.items()}
    if case == "traced_radii":
        rp = torch.tensor(r_p, dtype=torch.float32)
        kw.update(r_p=rp, r_n=2.0 * rp)
    got, got_n = pL.infonce_loss(*args, **kw, return_stats=True)
    got.backward()
    assert int(got_n) == int(want_n)
    if case == "matches" or case == "traced_radii":
        assert int(got_n) > 5
    if case in ("no_matches", "all_invalid_positives"):
        assert int(got_n) == 0
    close(got.item(), float(want), what="loss")
    for a, g, name in zip(args, want_g, diff):
        assert torch.isfinite(a.grad).all(), name
        close(a.grad.numpy(), g, what=name)
        if case == "all_invalid_positives":
            assert not a.grad.any(), name


def test_infonce_argmin_ties_take_the_first_index():
    """Two positives at the same distance: the first is the positive, as
    in jnp.argmin (a row of ties, and a row of all-inf distances)."""
    xyz = np.array([[0.0, 0.0, 0.0], [5.0, 5.0, 5.0]], np.float32)
    pos = np.array([[0.1, 0.0, 0.0], [-0.1, 0.0, 0.0], [0.0, 0.1, 0.0]], np.float32)
    rng = np.random.default_rng(1)
    fa = rng.normal(size=(2, 4)).astype(np.float32)
    fb = rng.normal(size=(3, 4)).astype(np.float32)
    W = rng.normal(size=(4, 4)).astype(np.float32)
    for pv in (np.array([True, True, True]), np.array([False, False, False])):
        want = jL.infonce_loss(*map(jnp.asarray, (W, fa, fb, xyz, pos)),
                               jnp.ones(2, bool), jnp.asarray(pv), r_p=0.5, r_n=0.05)
        got = pL.infonce_loss(*map(t, (W, fa, fb, xyz, pos)), torch.ones(2, dtype=torch.bool),
                              t(pv), r_p=0.5, r_n=0.05)
        close(got.item(), float(want))


LOSS_CASES = ["overlap_bce", "nerf_consistency", "corr_robust_mae", "corr_plain_mse",
              "smooth_l1", "charbonnier"]


@pytest.mark.parametrize("case", LOSS_CASES)
def test_elementwise_losses_match_jax(case):
    """Value and the gradient of the predicted input, with masks, ties at
    the clip bounds of overlap_bce and |x| = delta of smooth_l1."""
    rng = np.random.default_rng(2)
    n, layers = 64, 3
    mask = rng.random(n) < 0.7
    if case == "overlap_bce":
        pred = rng.uniform(0, 1, n).astype(np.float32)
        pred[:4] = [0.0, 1.0, 1e-6, np.float32(1.0 - 1e-6)]
        gt = (rng.random(n) < 0.5).astype(np.float32)
        jf = lambda p: jL.overlap_bce(p, jnp.asarray(gt), jnp.asarray(mask))
        pf = lambda p: pL.overlap_bce(p, t(gt), t(mask))
    elif case == "nerf_consistency":
        pred = rng.uniform(-1.5, 1.5, (layers, n)).astype(np.float32)
        gt = (rng.random(n) < 0.5).astype(np.float32)
        jf = lambda p: jL.nerf_consistency(p, jnp.broadcast_to(jnp.asarray(gt), (layers, n)),
                                           jnp.asarray(mask))
        pf = lambda p: pL.nerf_consistency(p, t(gt).expand(layers, n), t(mask))
    elif case.startswith("corr"):
        robust, metric = case == "corr_robust_mae", case.rsplit("_", 1)[1]
        pred = rng.normal(size=(n, 3)).astype(np.float32)
        gt_kp = rng.normal(size=(n, 3)).astype(np.float32)
        pred[:2] = gt_kp[:2]  # zero error: the abs at 0
        w = rng.uniform(0, 1, n).astype(np.float32)
        jf = lambda p: jL.correspondence_loss(p, jnp.asarray(gt_kp), jnp.asarray(w),
                                              jnp.asarray(mask), robust, metric)
        pf = lambda p: pL.correspondence_loss(p, t(gt_kp), t(w), t(mask), robust, metric)
    elif case == "smooth_l1":
        pred = rng.normal(scale=2.0, size=n).astype(np.float32)
        pred[:3] = [1.0, -1.0, 0.0]
        jf = lambda p: jnp.sum(jL.smooth_l1(p))
        pf = lambda p: pL.smooth_l1(p).sum()
    else:
        pred = rng.normal(scale=2.0, size=n).astype(np.float32)
        pred[0] = 0.0
        jf = lambda p: jnp.sum(jL.charbonnier(p))
        pf = lambda p: pL.charbonnier(p).sum()
    want, want_g = jax.value_and_grad(jf)(jnp.asarray(pred))
    p = t(pred, grad=True)
    got = pf(p)
    got.backward()
    close(got.item(), float(want), what=case)
    close(p.grad.numpy(), want_g, what=case + " grad")


def test_overlap_bce_of_a_saturated_bf16_prediction_is_finite():
    """In bf16 the upper clip bound 1 - 1e-6 rounds to 1: the loss is taken
    in f32, so a prediction of exactly 1 (or 0) reads the f32 bounds' loss
    and no 0 * log(0), and its gradient is the f32 one."""
    pred = torch.tensor([1.0, 1.0, 0.0, 0.0, 0.25], dtype=torch.bfloat16, requires_grad=True)
    gt = torch.tensor([1.0, 0.0, 0.0, 1.0, 1.0])
    mask = torch.ones(5, dtype=torch.bool)
    got = pL.overlap_bce(pred, gt, mask)
    got.backward()
    want_pred = pred.detach().float().requires_grad_(True)
    want = pL.overlap_bce(want_pred, gt, mask)
    want.backward()
    assert got.dtype == torch.float32 and torch.isfinite(got) and torch.equal(got, want)
    assert torch.equal(pred.grad, want_pred.grad.to(torch.bfloat16))


def test_masked_mean_and_init_infonce_W():
    rng = np.random.default_rng(3)
    x = rng.normal(size=50).astype(np.float32)
    m = rng.random(50) < 0.5
    close(pL.masked_mean(t(x), t(m)).item(), float(jL.masked_mean(jnp.asarray(x), jnp.asarray(m))))
    assert pL.masked_mean(t(x), torch.zeros(50, dtype=torch.bool)).item() == 0.0
    w = pL.init_infonce_W(np.random.default_rng(4), 256)
    assert w.shape == (256, 256) and w.dtype == torch.float32
    assert abs(float(w.std()) - 0.1) < 0.002
    g = pL.init_infonce_W(torch.Generator().manual_seed(0), 64)
    assert g.shape == (64, 64) and abs(float(g.std()) - 0.1) < 0.01


@pytest.mark.parametrize("contraction", ["aabb", "un_bounded_sphere"])
def test_grid_visibility_labels_equal_jax(contraction):
    """Exact labels on points inside, on cell faces and outside the box,
    in any leading shape."""
    rng = np.random.default_rng(5)
    r = 16
    mask = rng.random(r ** 3) < 0.4
    aabb = np.array([-1.5, -1.5, -1.5, 1.5, 1.5, 1.5], np.float32)
    pts = rng.uniform(-2.5, 2.5, (3, 200, 3)).astype(np.float32)
    pts[0, :30] = (rng.integers(0, r + 1, (30, 3)) / r * 3.0 - 1.5).astype(np.float32)  # faces
    want = np.asarray(jvis.grid_visibility(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(aabb),
                                           r, contraction))
    got = pvis.grid_visibility(t(pts), t(mask), t(aabb), r, contraction)
    assert got.dtype == torch.float32 and got.shape == (3, 200)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size


def test_device_augment_matches_jax_with_its_noise():
    """JAX's draw jax.random.normal(key, (R^3, 3)) handed to the port:
    within 1e-6; rgb, alpha and unmasked rows bit for bit; no jitter
    without noise or at scale 0."""
    rng = np.random.default_rng(6)
    r = 16
    grid = rng.normal(size=(r, r, r, 7)).astype(np.float32)
    mask = rng.random(r ** 3) < 0.3
    p = jrp._se3_small(rng, 0.1).astype(np.float32)
    p[:3, 3] += rng.normal(size=3).astype(np.float32)
    key = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.normal(key, (r ** 3, 3), dtype=jnp.float32))
    for scale in (0.005, 0.5):  # 0.5: the clip at 0.05 binds
        want = np.asarray(jrp.device_augment(jnp.asarray(grid), jnp.asarray(mask),
                                             jnp.asarray(p), key, scale, 0.05))
        got = prp.device_augment(t(grid), t(mask), t(p), t(noise), scale, 0.05).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got.reshape(-1, 7)[:, 3:], grid.reshape(-1, 7)[:, 3:])
        np.testing.assert_array_equal(got.reshape(-1, 7)[~mask], grid.reshape(-1, 7)[~mask])
    want = np.asarray(jrp.device_augment(jnp.asarray(grid), jnp.asarray(mask), jnp.asarray(p),
                                         None))
    for got in (prp.device_augment(t(grid), t(mask), t(p)),
                prp.device_augment(t(grid), t(mask), t(p), t(noise), 0.0)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_surface_field_per_ray_matches_jax():
    """Segment max of T alpha over a packed buffer from the JAX marcher
    (capped, 64 a ray), with rays that march no sample: within 1e-6. The
    transmittance is one f32 cumsum over the whole buffer, whose summation
    order differs between the packages (ROADMAP.md queue 3), so the
    buffer's total optical depth is kept moderate (about 800 samples of
    sigma dt under 0.2)."""
    res, steps, rays = 32, 128, 48
    rng = np.random.default_rng(7)
    binary = rng.uniform(size=(res,) * 3) < 0.3
    o = rng.normal(size=(rays, 3))
    o = (3.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)).astype(np.float32)
    target = rng.uniform(-0.9, 0.9, (rays, 3))
    target[:16] = 5.0 * rng.normal(size=(16, 3))  # some rays miss the box
    d = (target - o) / np.linalg.norm(target - o, axis=-1, keepdims=True)
    jgrid = jocc.OccupancyGrid(occs=jnp.zeros(res ** 3), binary=jnp.asarray(binary))
    packed = jmarch.march_rays(jnp.asarray(o), jnp.asarray(d, jnp.float32), jgrid,
                               jnp.asarray([-1.0, -1, -1, 1, 1, 1]), "aabb",
                               2.0 * math.sqrt(3.0) / steps, 1 << 13, steps,
                               compaction="capped", k_cap=64)
    sigmas = rng.uniform(0.0, 6.0, packed.t_start.shape[0]).astype(np.float32)
    want = np.asarray(jcomp.surface_field_per_ray(packed, jnp.asarray(sigmas)))
    tpacked = pmarch.PackedSamples(
        ray_id=t(packed.ray_id).long(), t_start=t(packed.t_start), t_end=t(packed.t_end),
        valid=t(packed.valid), num_samples=t(packed.num_samples), num_rays=packed.num_rays)
    got = pcomp.surface_field_per_ray(tpacked, t(sigmas)).numpy()
    print(f"surface field max abs err {np.abs(got - want).max():.3e} over "
          f"{int(packed.num_samples)} samples")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (want == 0).any() and want.max() > 0.1 and int(packed.num_samples) > 500
