"""Port parity: cameras, contractions, trunc_exp and SH encoding against
the JAX package on the same numpy inputs (f32, atol 1e-6)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dregnerf_tpu.geometry import cameras as jcam
from dregnerf_tpu.ops import activation as jact
from dregnerf_tpu.ops import contraction as jcon
from dregnerf_tpu.ops import sh as jsh
from dregnerf_tpu_torch.geometry import cameras as tcam
from dregnerf_tpu_torch.ops import activation as tact
from dregnerf_tpu_torch.ops import contraction as tcon
from dregnerf_tpu_torch.ops import sh as tsh

ATOL = 1e-6


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=atol)


@pytest.fixture
def camera(rng):
    K = np.array([[40.0, 0, 16.0], [0, 40.0, 12.0], [0, 0, 1]], np.float32)
    c2w = np.concatenate([np.linalg.qr(rng.normal(size=(3, 3)))[0],
                          rng.normal(size=(3, 1))], 1).astype(np.float32)
    return K, c2w


@pytest.mark.parametrize("opengl", [True, False])
def test_rays_from_pixels(rng, camera, opengl):
    K, c2w = camera
    x = rng.integers(0, 32, 300)
    y = rng.integers(0, 24, 300)
    poses = np.broadcast_to(c2w, (300, 3, 4))
    want = jcam.rays_from_pixels(jnp.asarray(x), jnp.asarray(y), jnp.asarray(K),
                                 jnp.asarray(poses), opengl)
    got = tcam.rays_from_pixels(_t(x), _t(y), _t(K), _t(poses), opengl)
    _close(got.origins, want.origins)
    _close(got.viewdirs, want.viewdirs)
    _close(tcam.pixel_dirs(_t(x), _t(y), _t(K), opengl),
           jcam.pixel_dirs(jnp.asarray(x), jnp.asarray(y), jnp.asarray(K), opengl))


def test_image_rays(camera):
    K, c2w = camera
    want = jcam.image_rays(jnp.asarray(K), jnp.asarray(c2w), 24, 32)
    got = tcam.image_rays(_t(K), _t(c2w), 24, 32)
    assert got.viewdirs.shape == (24, 32, 3)
    _close(got.origins, want.origins)
    _close(got.viewdirs, want.viewdirs)


def test_ray_aabb_intersect(rng):
    o = rng.uniform(-3, 3, (500, 3)).astype(np.float32)
    d = rng.normal(size=(500, 3)).astype(np.float32)
    d[:50, 0] = 0.0  # exercise the |d| < 1e-10 clamp
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    aabb = np.array([-1, -1.2, -0.8, 1, 0.9, 1.1], np.float32)
    w0, w1 = jcam.ray_aabb_intersect(jnp.asarray(o), jnp.asarray(d), jnp.asarray(aabb), 0.1, 50.0)
    g0, g1 = tcam.ray_aabb_intersect(_t(o), _t(d), _t(aabb), 0.1, 50.0)
    np.testing.assert_allclose(g0.numpy(), np.asarray(w0), rtol=1e-6, atol=ATOL)
    np.testing.assert_allclose(g1.numpy(), np.asarray(w1), rtol=1e-6, atol=ATOL)


@pytest.mark.parametrize("kind", ["aabb", "un_bounded_sphere"])
def test_contraction_and_inverse(rng, kind):
    aabb = np.array([-1.5, -1.0, -1.2, 1.5, 1.0, 1.3], np.float32)
    x = rng.uniform(-4, 4, (400, 3)).astype(np.float32)
    u = rng.uniform(0.02, 0.98, (400, 3)).astype(np.float32)
    _close(tcon.contract(_t(x), _t(aabb), kind),
           jcon.contract(jnp.asarray(x), jnp.asarray(aabb), kind))
    got_inv = tcon.contract_inv(_t(u), _t(aabb), kind)
    want_inv = jcon.contract_inv(jnp.asarray(u), jnp.asarray(aabb), kind)
    np.testing.assert_allclose(got_inv.numpy(), np.asarray(want_inv), rtol=1e-5, atol=ATOL)


def test_trunc_exp_forward_and_clamped_backward():
    x = np.array([-3.0, 0.0, 1.5, 14.9, 15.0, 16.0, 20.0], np.float32)
    g = np.array([0.5, 1.0, -2.0, 1.0, 1.0, 0.25, 1.0], np.float32)
    xt = _t(x).requires_grad_(True)
    yt = tact.trunc_exp(xt)
    yt.backward(_t(g))
    y, vjp = jax.vjp(jact.trunc_exp, jnp.asarray(x))
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(y), rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), rtol=1e-6)
    # above 15 the gradient is g * exp(15), not g * exp(x)
    np.testing.assert_allclose(xt.grad.numpy()[-1], np.exp(np.float32(15.0)), rtol=1e-6)
    _close(tact.density_activation(_t(x[:4])),
           jact.density_activation(jnp.asarray(x[:4])), atol=1e-5)


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_sh_encode(rng, degree):
    d = rng.normal(size=(300, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    got = tsh.sh_encode(_t(d), degree)
    assert got.shape == (300, degree**2)
    _close(got, jsh.sh_encode(jnp.asarray(d), degree))
