"""Port parity: the image metrics of evaluation (utils/metrics.py and
utils/lpips.py) against the JAX package on the same images: PSNR, SSIM,
the random-feature LPIPS and LPIPS(alex) from a weight file, within 1e-5
relative (f32 convolutions summed in another order); `lpips` is None in
both packages when the weight file is absent."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dregnerf_tpu.utils import lpips as jlpips
from dregnerf_tpu.utils import metrics as jmetrics
from dregnerf_tpu_torch.utils import lpips as tlpips
from dregnerf_tpu_torch.utils import metrics as tmetrics


def _images(seed=0, size=(64, 48)):
    """A smooth image and a noisy copy, in [0, 1]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, size[0]), np.linspace(0, 1, size[1]), indexing="ij")
    a = np.stack([xx, yy, 0.5 + 0.5 * np.sin(6 * xx * yy)], -1).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.05, size=a.shape), 0, 1).astype(np.float32)
    return a, b


def test_psnr_and_ssim_match_jax():
    a, b = _images()
    want_psnr = float(jmetrics.psnr(jnp.asarray(a), jnp.asarray(b)))
    got_psnr = float(tmetrics.psnr(torch.as_tensor(a), torch.as_tensor(b)))
    np.testing.assert_allclose(got_psnr, want_psnr, rtol=1e-5)
    want_ssim = float(jmetrics.ssim(jnp.asarray(a), jnp.asarray(b)))
    got_ssim = float(tmetrics.ssim(torch.as_tensor(a), torch.as_tensor(b)))
    np.testing.assert_allclose(got_ssim, want_ssim, rtol=1e-5)
    assert 0.0 < got_ssim < 1.0
    assert float(tmetrics.ssim(torch.as_tensor(a), torch.as_tensor(a))) == pytest.approx(1.0)


def test_random_feature_weights_are_the_jax_draws():
    want = jlpips.random_feature_weights(0)
    got = tlpips.random_feature_weights(0)
    for i in range(5):  # torch keeps OIHW kernels, JAX HWIO
        kern = np.asarray(want[f"conv{i}"]["kernel"]).transpose(3, 2, 0, 1)
        np.testing.assert_array_equal(got[f"conv{i}"]["weight"].numpy(), kern)
        np.testing.assert_array_equal(got[f"lin{i}"].numpy(), np.asarray(want[f"lin{i}"]))


@pytest.mark.parametrize("seed", [0, 1])
def test_lpips_rand_matches_jax(seed):
    a, b = _images(seed)
    want = jmetrics.lpips_rand(a, b)
    got = tmetrics.lpips_rand(a, b)
    assert got > 0.0 and tmetrics.lpips_rand(a, a) == pytest.approx(0.0, abs=1e-7)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_lpips_is_none_without_weights(monkeypatch, tmp_path):
    monkeypatch.setenv("DREG_LPIPS_WEIGHTS", str(tmp_path / "absent.npz"))
    a, b = _images()
    assert jmetrics.lpips(a, b) is None
    assert tmetrics.lpips(a, b) is None


def test_lpips_from_a_weight_file_matches_jax(monkeypatch, tmp_path):
    """A weight file in the exported schema (HWIO kernels, biases, lin
    heads with some negative entries, which both packages clip to 0)."""
    rng = np.random.default_rng(4)
    arrays, cin = {}, 3
    for i, (cout, k, _, _) in enumerate(tlpips._ALEX_CONVS):
        arrays[f"conv{i}.kernel"] = rng.normal(scale=np.sqrt(2.0 / (k * k * cin)),
                                               size=(k, k, cin, cout)).astype(np.float32)
        arrays[f"conv{i}.bias"] = rng.normal(scale=0.01, size=cout).astype(np.float32)
        arrays[f"lin{i}"] = rng.normal(scale=0.1, size=cout).astype(np.float32)
        cin = cout
    path = tmp_path / "lpips_alex.npz"
    np.savez(path, **arrays)
    monkeypatch.setenv("DREG_LPIPS_WEIGHTS", str(path))
    a, b = _images(2)
    want = jmetrics.lpips(a, b)
    got = tmetrics.lpips(a, b)
    assert want is not None and got is not None and got > 0.0
    np.testing.assert_allclose(got, want, rtol=1e-5)
