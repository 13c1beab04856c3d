"""Image quality metrics (port of dregnerf_tpu/utils/metrics.py).

PSNR, and SSIM with the separable 11-tap Gaussian window (sigma 1.5,
VALID borders) over [H, W, C] images; LPIPS(alex) when its calibration
weights exist (else None) and the random-feature `lpips_rand` fallback,
both from `utils/lpips.py`. The evaluator computes them on CPU tensors:
the convolutions then run in full f32 (cuDNN would take TF32 on the card).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def mse_to_psnr(x: torch.Tensor) -> torch.Tensor:
    return -10.0 / np.log(10.0) * torch.log(x)


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return mse_to_psnr(mse(pred, target))


def _gaussian_kernel(size: int, sigma: float) -> np.ndarray:
    x = np.arange(size) - (size - 1) / 2.0
    g = np.exp(-(x**2) / (2 * sigma**2))
    return g / g.sum()


def ssim(img0: torch.Tensor, img1: torch.Tensor, max_val: float = 1.0,
         filter_size: int = 11, filter_sigma: float = 1.5, k1: float = 0.01,
         k2: float = 0.03) -> torch.Tensor:
    """SSIM over [H, W, C] images (separable Gaussian window, VALID)."""
    img0 = img0.to(torch.float32)
    img1 = img1.to(torch.float32)
    c = img0.shape[-1]
    kernel = torch.as_tensor(_gaussian_kernel(filter_size, filter_sigma),
                             dtype=torch.float32, device=img0.device)
    kh = kernel.view(1, 1, filter_size, 1).repeat(c, 1, 1, 1)
    kw = kernel.view(1, 1, 1, filter_size).repeat(c, 1, 1, 1)

    def blur(img):  # depthwise along H, then W
        x = img.permute(2, 0, 1)[None]  # [1, C, H, W]
        x = F.conv2d(F.conv2d(x, kh, groups=c), kw, groups=c)
        return x[0].permute(1, 2, 0)

    mu0, mu1 = blur(img0), blur(img1)
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    s00 = blur(img0 * img0) - mu00
    s11 = blur(img1 * img1) - mu11
    s01 = blur(img0 * img1) - mu01
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    num = (2 * mu01 + c1) * (2 * s01 + c2)
    den = (mu00 + mu11 + c1) * (s00 + s11 + c2)
    return torch.mean(num / den)


def lpips(img0: np.ndarray, img1: np.ndarray) -> float | None:
    """LPIPS(alex) of two [H, W, 3] images in [0, 1], or None when the
    calibration weights file is absent (no file is fetched)."""
    from dregnerf_tpu_torch.utils.lpips import lpips_fn

    fn = lpips_fn()
    if fn is None:
        return None
    return float(fn(torch.as_tensor(img0, dtype=torch.float32),
                    torch.as_tensor(img1, dtype=torch.float32)))


def lpips_rand(img0: np.ndarray, img1: np.ndarray) -> float:
    """Random-feature perceptual distance on the LPIPS(alex) architecture,
    reported as `lpips_rand_alex` (not comparable to published LPIPS)."""
    from dregnerf_tpu_torch.utils.lpips import lpips_rand_fn

    fn = lpips_rand_fn()
    return float(fn(torch.as_tensor(img0, dtype=torch.float32),
                    torch.as_tensor(img1, dtype=torch.float32)))
