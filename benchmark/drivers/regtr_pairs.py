"""NeRFRegTr cells: the pairs of block grids, the weights drawn on the
device from the seed, and the port's flags for the configuration."""
from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.drivers.common import generator
from benchmark.traffic import scenes

SEED_WEIGHTS, SEED_ORDER, SEED_AUG = 11, 12, 13
TRUNC = 2.0  # flax's LeCun normal, truncated at 2 sigma
TRUNC_STD = 0.87962566103423978  # the std of a unit normal truncated at 2


def program_flags(cfg: dict, seed: int, out_dir: str) -> list[str]:
    aabb = ",".join(str(float(v)) for v in cfg["aabb"])
    return [f"--aabb={aabb}", "--seed", str(seed % (1 << 31)), "--lr", str(cfg["lr"]),
            "--reg_batch_size", str(cfg["batch_size"]), "--visibility", cfg["visibility"],
            "--position_embedding_type", cfg["position_embedding"],
            "--position_embedding_dim", str(cfg["d_model"]),
            "--num_downsample", str(cfg["num_downsample"]),
            "--grid_resolution", str(cfg["grid_resolution"]),
            "--out_dir", out_dir, "--expname", "reg", "--watchdog_s", "0"]


def reference_model(cfg: dict, device):
    """The plain reference NeRFRegTr at the configuration, in f32."""
    from benchmark.reference.regtr.regtr import NeRFRegTr

    return NeRFRegTr(pos_emb_type=cfg["position_embedding"], d_model=cfg["d_model"],
                     num_downsample=cfg["num_downsample"], backbone=cfg["backbone"]["arch"],
                     num_layers=cfg["num_layers"], num_heads=cfg["num_heads"],
                     dim_feedforward=cfg["dim_feedforward"],
                     max_input_points=cfg["max_input_points"], num_tokens=cfg["num_tokens"],
                     dtype=torch.float32).to(device)


def draw_weights(shapes: dict, d_model: int, seed: int, device) -> tuple[dict, torch.Tensor]:
    """(state dict by parameter name, infonce W) from the seed, on the
    device in a few large calls: every convolution and dense kernel LeCun
    normal truncated at 2 sigma (std sqrt(1 / fan_in) / 0.8796, by the
    inverse normal CDF of one uniform draw), norm scales 1, biases 0, the
    InfoNCE matrix normal(0, 0.1)."""
    g = generator(seed, SEED_WEIGHTS, device)
    kernels = [(k, s) for k, s in shapes.items() if len(s) >= 2]
    numels = [math.prod(s) for _, s in kernels]
    stds = torch.tensor([math.sqrt(1.0 / math.prod(s[1:])) / TRUNC_STD for _, s in kernels],
                        device=device)
    lo = 0.5 * (1 + math.erf(-TRUNC / math.sqrt(2)))
    u = torch.rand(sum(numels), generator=g, device=device) * (1 - 2 * lo) + lo
    z = math.sqrt(2) * torch.erfinv(2 * u - 1)
    flat = z * torch.repeat_interleave(stds, torch.tensor(numels, device=device))
    state, i = {}, 0
    for (k, s), n in zip(kernels, numels):
        state[k] = flat[i:i + n].view(s)
        i += n
    for k, s in shapes.items():
        if k not in state:
            state[k] = (torch.ones if k.endswith("weight") else torch.zeros)(s, device=device)
    w = torch.randn(d_model, d_model, generator=g, device=device) * 0.1
    return state, w


def make_pairs(wl: dict, cfg: dict, device) -> list:
    """[((grid0, mask0), (grid1, mask1), pose)] of the workload's scenes."""
    return [scenes.voxel_pair({**p, **wl["blocks"]}, p["scene_seed"], cfg["grid_resolution"],
                              device) for p in wl["pairs"]]


def _se3_small(rng: np.random.Generator, std: float) -> np.ndarray:
    """exp of a normal twist (std): rotation by Rodrigues, translation as is."""
    xi = rng.normal(size=6) * std
    out = np.eye(4)
    angle = float(np.linalg.norm(xi[:3]))
    out[:3, :3] = scenes.rotation(xi[:3], angle) if angle > 0 else np.eye(3)
    out[:3, 3] = xi[3:]
    return out


def train_item(pair, index: int, rng: np.random.Generator, perturb_std: float) -> dict:
    """A training item of the port's device-cached path (the layout of
    NeRFRegDataset.get_raw): the cached grids, a random centroid-centred
    perturbation of one side with the pose updated, and a random swap."""
    (g0, m0), (g1, m1), pose = pair
    sides = [(g0, m0, f"pair{index}.0"), (g1, m1, f"pair{index}.1")]
    pose = pose.astype(np.float64)
    perturb = _se3_small(rng, perturb_std)
    perturb_src = rng.random() > 0.5
    grid, mask, _ = sides[0] if perturb_src else sides[1]
    centroid = grid.reshape(-1, 7)[mask, :3].mean(0).double().cpu().numpy()
    center = np.eye(4)
    center[:3, 3] = -centroid
    p = np.linalg.inv(center) @ perturb @ center
    p_src, p_tgt = (p, np.eye(4)) if perturb_src else (np.eye(4), p)
    pose = pose @ np.linalg.inv(p) if perturb_src else p @ pose
    if rng.random() > 0.5:
        sides = sides[::-1]
        p_src, p_tgt = p_tgt, p_src
        pose = np.linalg.inv(pose)
    (sg, sm, sk), (tg, tm, tk) = sides
    return {"src_grid": sg, "src_mask": sm, "tgt_grid": tg, "tgt_mask": tm,
            "src_cache_key": sk, "tgt_cache_key": tk, "pose": pose.astype(np.float32),
            "aug": {"p_src": p_src.astype(np.float32), "p_tgt": p_tgt.astype(np.float32),
                    "jitter": True}}


class Pairs:
    """The dataset that the port's RegTrainer is built over (it reads the
    grid resolution and, on the device-cached path, the jitter)."""

    jitter_scale, jitter_clip = 0.005, 0.05

    def __init__(self, pairs):
        self.pairs = pairs

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, i):
        (g0, m0), (g1, m1), pose = self.pairs[i]
        return {"src_grid": g0, "src_mask": m0, "tgt_grid": g1, "tgt_mask": m1, "pose": pose}
