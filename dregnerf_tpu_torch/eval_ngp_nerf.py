"""Evaluate trained NGP blocks and extract their voxel feature grids, stage
2 (twin of the root eval_ngp_nerf.py).

For each block (every <out_dir>/<expname>/block_k of a multi-block run,
else <out_dir>/<expname> itself) renders every test view (PSNR, SSIM,
LPIPS when its weights exist, and the random-feature `lpips_rand_alex`
-> <model_dir>/eval/metrics.json), then writes voxel_grid.pt,
voxel_mask.pt, voxel_point_cloud.ply and the density_voxel_* variants
next to the block's checkpoint.

Usage:
  python -m dregnerf_tpu_torch.eval_ngp_nerf --dataset objaverse \
      --root_dir <root> --scene <subject> --expname <name> [--device cpu]
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from dregnerf_tpu_torch.runtime.config import config_parser


class Evaluator:
    """One block: `model_dir` holds `model/model.ckpt` (or `model.ckpt`)
    written by either package, of an NGP field (packed or xor-hash grid:
    the JAX evaluator renders and extracts NGP fields only). Runs on
    `device` (default cuda)."""

    def __init__(self, config, model_dir: str, scene_data, device=None):
        from dregnerf_tpu_torch.device import resolve_device
        from dregnerf_tpu_torch.runtime.ngp_trainer import load_field_from_checkpoint

        self.config = config
        self.model_dir = model_dir
        self.scene = scene_data
        self.device = resolve_device(device if device is not None
                                     else getattr(config, "device", None))
        ckpt = os.path.join(model_dir, "model", "model.ckpt")
        if not os.path.exists(ckpt):
            ckpt = os.path.join(model_dir, "model.ckpt")
        (self.params, self.grid, self.meta, self.model_config,
         self.render_config) = load_field_from_checkpoint(ckpt, self.device)
        field = self.meta.get("field", "ngp")
        if field != "ngp":
            raise ValueError(f"{ckpt}: the evaluator renders and extracts NGP fields only, "
                             f"not field {field!r}")
        self.generator = torch.Generator().manual_seed(config.seed)  # voxel jitter

    def evaluate(self) -> dict:
        """Render every test view; PSNR/SSIM/LPIPS -> eval/metrics.json.
        The metrics are computed on the CPU, in f32."""
        from dregnerf_tpu_torch.geometry.cameras import image_rays
        from dregnerf_tpu_torch.render.renderer import render_image_chunked
        from dregnerf_tpu_torch.utils import metrics as M

        scene, dev = self.scene, self.device
        rcfg = dataclasses.replace(self.render_config,
                                   buffer_size=self.config.sample_budget,
                                   max_steps=self.config.max_march_steps,
                                   chunk_size=self.config.test_chunk_size)
        aabb = torch.as_tensor(self.meta["aabb"], dtype=torch.float32, device=dev)
        K = torch.as_tensor(scene.K, dtype=torch.float32, device=dev)
        psnrs, ssims, lpipss, lpips_rands = [], [], [], []
        out_dir = os.path.join(self.model_dir, "eval")
        os.makedirs(out_dir, exist_ok=True)
        for i in range(scene.num_images):
            c2w = torch.as_tensor(scene.camtoworlds[i], dtype=torch.float32, device=dev)
            rays = image_rays(K, c2w, scene.height, scene.width, scene.opengl)
            rgb, _, _ = render_image_chunked(
                self.params, self.model_config, self.grid, rays.origins.reshape(-1, 3),
                rays.viewdirs.reshape(-1, 3), aabb, rcfg, torch.ones(3, device=dev),
                device=dev)
            rgb = rgb.reshape(scene.height, scene.width, 3).cpu().numpy()
            gt = np.asarray(scene.images[i], np.float32) / 255.0
            if scene.synthetic:
                gt = gt[..., :3] * gt[..., 3:4] + (1.0 - gt[..., 3:4])
            psnrs.append(-10.0 * np.log10(float(np.mean((rgb - gt) ** 2))))
            ssims.append(float(M.ssim(torch.as_tensor(rgb), torch.as_tensor(gt))))
            lp = M.lpips(rgb, gt)
            if lp is not None:
                lpipss.append(lp)
            lpips_rands.append(M.lpips_rand(rgb, gt))
            _write_png(os.path.join(out_dir, f"rgb_{i:03d}.png"), rgb)
        result = {
            "psnr": float(np.mean(psnrs)),
            "ssim": float(np.mean(ssims)),
            "lpips": float(np.mean(lpipss)) if lpipss else None,
            # random-feature LPIPS architecture (utils/lpips.py), lower is
            # better; not comparable to published LPIPS(alex) values
            "lpips_rand_alex": float(np.mean(lpips_rands)),
            "num_views": len(psnrs),
        }
        if not lpipss:
            result["lpips_note"] = (
                "true LPIPS needs calibration weights exported by "
                "scripts/preprocess/export_lpips_weights.py; without them "
                "lpips_rand_alex is the fallback perceptual metric")
        with open(os.path.join(out_dir, "metrics.json"), "w") as f:
            json.dump(result, f, indent=2)
        print(f"[eval] {self.model_dir}: {result}", flush=True)
        return result

    def sample_points(self) -> dict:
        """Extract the voxel grid and write its artifacts; returns the
        extracted arrays and the paths written."""
        from dregnerf_tpu_torch.extract.sample_grid import (
            extract_voxel_features,
            save_voxel_artifacts,
        )

        extracted = extract_voxel_features(
            self.params, self.model_config, self.grid, self.meta, self.generator,
            surface_chunk=min(self.config.test_chunk_size, 8192), device=self.device)
        written = save_voxel_artifacts(self.model_dir, extracted)
        n_surf = int((extracted["surface_mask"] & extracted["density_mask"]).sum())
        print(f"[extract] {self.model_dir}: {n_surf} surface voxels", flush=True)
        return dict(extracted, written=written)


def _write_png(path: str, rgb: np.ndarray) -> None:
    try:
        import imageio.v2 as imageio
    except ImportError:  # images are a convenience; metrics.json is the result
        return
    imageio.imwrite(path, (np.clip(rgb, 0, 1) * 255).astype(np.uint8))


def eval_blocks(config, model_dirs, test_blocks) -> list:
    """Evaluate and extract the block in each of `model_dirs` on the
    matching block of `test_blocks`; returns [(metrics, extracted)]."""
    results = []
    for model_dir, scene in zip(model_dirs, test_blocks):
        ev = Evaluator(config, model_dir, scene)
        results.append((ev.evaluate(), ev.sample_points()))
    return results


def main(argv=None) -> None:
    from dregnerf_tpu_torch.datasets.base import load_scene_blocks

    config = config_parser(argv)
    exp_dir = os.path.join(config.out_dir, config.expname)
    block_dirs = sorted(d for d in os.listdir(exp_dir)
                        if d.startswith("block_")) if os.path.isdir(exp_dir) else []
    if block_dirs:
        test_blocks = load_scene_blocks(config.dataset, config.root_dir, config.scene, "test",
                                        config.factor, True, len(block_dirs))
        eval_blocks(config, [os.path.join(exp_dir, d) for d in block_dirs], test_blocks)
    else:
        scene = load_scene_blocks(config.dataset, config.root_dir, config.scene, "test",
                                  config.factor)[0]
        eval_blocks(config, [exp_dir], [scene])


if __name__ == "__main__":
    main()
