"""LPIPS(alex) and its random-feature fallback (port of dregnerf_tpu/utils/lpips.py).

Inputs in [0, 1] go to [-1, 1] and through the LPIPS scaling layer; the
five ReLU taps of torchvision AlexNet's `features` (3x3 stride-2 max pools
after taps 0 and 1) are unit-normalised along channels, their squared
differences weighted per channel by the non-negative `lin` calibration,
averaged over space and summed over taps.

The calibration weights come from the same `.npz` as the JAX package's
($DREG_LPIPS_WEIGHTS, else ~/.cache/dregnerf/lpips_alex.npz; kernels in
HWIO, converted here to torch's OIHW). Without that file `lpips_fn()`
returns None; nothing is fetched. `random_feature_weights` draws the same
numbers as the JAX package from numpy's `default_rng(seed)`.
Images are [H, W, 3] or [N, H, W, 3], as in the JAX package.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

# torchvision alexnet.features geometry: (out_ch, kernel, stride, pad)
_ALEX_CONVS = [
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
]
_POOL_AFTER = {0, 1}  # a 3x3 stride-2 max pool follows these taps

# LPIPS ScalingLayer constants (Zhang et al. 2018 reference implementation)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

DEFAULT_WEIGHTS_ENV = "DREG_LPIPS_WEIGHTS"
DEFAULT_WEIGHTS_PATH = os.path.expanduser("~/.cache/dregnerf/lpips_alex.npz")


def _conv(kernel_hwio: np.ndarray, bias: np.ndarray) -> dict:
    return {"weight": torch.as_tensor(np.ascontiguousarray(
                kernel_hwio.astype(np.float32).transpose(3, 2, 0, 1))),
            "bias": torch.as_tensor(bias.astype(np.float32))}


def load_weights(path: str) -> dict:
    """The exported npz as torch parameters (shapes checked)."""
    raw = np.load(path)
    params = {}
    for i, (cout, k, _, _) in enumerate(_ALEX_CONVS):
        kern = raw[f"conv{i}.kernel"]
        if kern.shape[-1] != cout or kern.shape[0] != k:
            raise ValueError(f"conv{i} kernel shape {kern.shape} != HWIO with k={k}, "
                             f"cout={cout}")
        params[f"conv{i}"] = _conv(kern, raw[f"conv{i}.bias"])
        lin = raw[f"lin{i}"].astype(np.float32)
        if lin.shape != (cout,):
            raise ValueError(f"lin{i} shape {lin.shape} != ({cout},)")
        params[f"lin{i}"] = torch.as_tensor(np.maximum(lin, 0.0))
    return params


def _alex_taps(params: dict, x: torch.Tensor) -> list[torch.Tensor]:
    """x [N, 3, H, W] in LPIPS-normalised space -> the five ReLU taps."""
    taps = []
    h = x
    for i, (_, _, stride, pad) in enumerate(_ALEX_CONVS):
        h = torch.relu(F.conv2d(h, params[f"conv{i}"]["weight"], params[f"conv{i}"]["bias"],
                                stride=stride, padding=pad))
        taps.append(h)
        if i in _POOL_AFTER:
            h = F.max_pool2d(h, kernel_size=3, stride=2)
    return taps


@torch.no_grad()
def lpips_distance(params: dict, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
    """LPIPS between [H, W, 3] (or [N, H, W, 3]) images in [0, 1]."""
    if img0.dim() == 3:
        img0, img1 = img0[None], img1[None]
    shift = torch.as_tensor(_SHIFT)[None, :, None, None]
    scale = torch.as_tensor(_SCALE)[None, :, None, None]

    def norm_in(x):
        x = x.to(torch.float32).permute(0, 3, 1, 2) * 2.0 - 1.0
        return (x - shift) / scale

    total = 0.0
    for i, (a, b) in enumerate(zip(_alex_taps(params, norm_in(img0)),
                                   _alex_taps(params, norm_in(img1)))):
        a = a / (torch.linalg.norm(a, dim=1, keepdim=True) + 1e-10)
        b = b / (torch.linalg.norm(b, dim=1, keepdim=True) + 1e-10)
        d = (a - b) ** 2  # [N, C, H, W]
        total = total + (d * params[f"lin{i}"][None, :, None, None]).sum(dim=1).mean(dim=(1, 2))
    return total[0] if total.shape == (1,) else total


@functools.lru_cache(maxsize=1)
def _cached_fn(path: str):
    params = load_weights(path)
    return functools.partial(lpips_distance, params)


def lpips_fn():
    """`(img0, img1) -> scalar` LPIPS(alex), or None without the weights
    file ($DREG_LPIPS_WEIGHTS, else ~/.cache/dregnerf/lpips_alex.npz)."""
    path = os.environ.get(DEFAULT_WEIGHTS_ENV, DEFAULT_WEIGHTS_PATH)
    if not os.path.exists(path):
        return None
    return _cached_fn(path)


def random_feature_weights(seed: int = 0) -> dict:
    """Deterministic random-feature weights on the LPIPS(alex) taps:
    He-normal convs, zero biases, uniform calibration 1/C per tap (the JAX
    package's draws, in its order)."""
    rng = np.random.default_rng(seed)
    params = {}
    cin = 3
    for i, (cout, k, _, _) in enumerate(_ALEX_CONVS):
        fan_in = k * k * cin
        kern = rng.normal(scale=np.sqrt(2.0 / fan_in), size=(k, k, cin, cout))
        params[f"conv{i}"] = _conv(kern.astype(np.float32), np.zeros(cout, np.float32))
        params[f"lin{i}"] = torch.full((cout,), 1.0 / cout, dtype=torch.float32)
        cin = cout
    return params


@functools.lru_cache(maxsize=1)
def lpips_rand_fn(seed: int = 0):
    """Random-feature perceptual distance (see random_feature_weights)."""
    return functools.partial(lpips_distance, random_feature_weights(seed))
