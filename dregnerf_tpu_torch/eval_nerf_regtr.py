"""Evaluate NeRFRegTr on held-out NeRF pairs, stage 3 (twin of the root
eval_nerf_regtr.py).

Per test pair: the registration forward (timed, synchronised with the
device), RRE/RTE against the ground truth, transformation_est.json,
pose_est.pt and pose_gt.pt; with `--icp_refine` the colour-aware ICP
polish of that pose (`*_icp` keys); the aligned and unaligned point
clouds (under the polished pose); the classical baseline
(`best_global_registration`: global colour ICP, FGR and RANSAC, refined
by ICP with `--icp_refine`); and the keypoint and overlap cloud dumps.
Then metrics_test.json and fgr_metrics_test.json with the mean and
median over pairs. The ICP runs on the evaluator's device, FGR and
RANSAC on the host. With `--render_videos` (or DREG_RENDER_VIDEOS set)
each pair's two NeRF checkpoints are rendered on the evaluator's device
along a 12-camera orbit at factor 8, src beside tgt with the tgt cameras
mapped by the ground-truth pose (`gt`), by the estimate (`aligned`) and
not at all (`unaligned`): PNG frames and depths, and an mp4 when ffmpeg
is on PATH (render/novel_views.py). The checkpoint is a JAX-layout
RegTrainer checkpoint (`params::model/...`, `params::infonce_W`) written
by either package; without one the random initialization is evaluated,
with a warning.

Usage:
  python -m dregnerf_tpu_torch.eval_nerf_regtr --dataset objaverse \
      --root_dir <root> [--scene <subject>] --expname <name> [--ckpt_path <ckpt>] \
      [--icp_refine] [--render_videos] [--no_bf16] [--device cpu]
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from dregnerf_tpu_torch.runtime.config import config_parser

MODEL_PREFIX = "params::model/"
INFONCE_KEY = "params::infonce_W"


def load_reg_checkpoint(path: str):
    """(flax parameter tree of the model, infonce_W, meta) of a RegTrainer
    checkpoint."""
    from dregnerf_tpu_torch.runtime.checkpoint import load_checkpoint, tree_under

    flat, meta = load_checkpoint(path)
    if INFONCE_KEY not in flat:
        raise KeyError(f"{path}: no {INFONCE_KEY}")
    return tree_under(flat, MODEL_PREFIX), flat[INFONCE_KEY], meta


def save_reg_checkpoint(path: str, tree: dict, infonce_W: np.ndarray, meta: dict) -> None:
    """Write a checkpoint with the parameter keys of a JAX RegTrainer
    checkpoint, without optimizer state (RegTrainer.save_checkpoint writes
    both)."""
    from dregnerf_tpu_torch.runtime.checkpoint import save_checkpoint

    save_checkpoint(path, {"params": {"model": tree, "infonce_W": infonce_W}}, meta)


class RegEvaluator:
    """Runs on `device` (default: the config's --device, else cuda)."""

    def __init__(self, config, dataset, device=None):
        from dregnerf_tpu_torch.device import resolve_device
        from dregnerf_tpu_torch.models.regtr import params_from_jax, random_jax_params
        from dregnerf_tpu_torch.runtime.reg_trainer import make_reg_model

        self.config = config
        self.dataset = dataset
        self.device = resolve_device(device if device is not None
                                     else getattr(config, "device", None))
        self.output_dir = os.path.join(config.out_dir, config.expname, "eval")
        os.makedirs(self.output_dir, exist_ok=True)

        self.model = make_reg_model(config, torch.bfloat16 if config.bf16 else torch.float32)
        ckpt = config.ckpt_path or os.path.join(config.out_dir, config.expname, "model",
                                                "model.ckpt")
        if os.path.exists(ckpt):
            tree, self.infonce_W, meta = load_reg_checkpoint(ckpt)
            print(f"loaded RegTr checkpoint {ckpt} (step {meta.get('step')})")
        else:
            rng = np.random.default_rng(0)
            tree = random_jax_params(self.model, rng)
            d = config.position_embedding_dim
            self.infonce_W = (rng.standard_normal((d, d)) * 0.1).astype(np.float32)
            print(f"[WARNING] no checkpoint at {ckpt}; evaluating random init")
        self.model.load_state_dict(params_from_jax(tree, self.model))
        self.model.to(self.device).eval()

    @torch.inference_mode()
    def forward(self, item: dict) -> dict:
        from dregnerf_tpu_torch.runtime.reg_trainer import to_device

        return self.model(to_device(item, self.device))

    def evaluate(self) -> dict:
        from dregnerf_tpu_torch.geometry import se3
        from dregnerf_tpu_torch.io.ply import read_ply, write_ply
        from dregnerf_tpu_torch.registration.icp import icp_refine
        from dregnerf_tpu_torch.registration.pipeline import best_global_registration

        def pose_error(est, gt):
            rre, rte = se3.pose_error(torch.from_numpy(np.asarray(est, np.float32)),
                                      torch.from_numpy(gt))
            return float(rre), float(rte)

        icp_voxel = 2.0 / self.config.grid_resolution * 2
        per_scene, fgr_per_scene = {}, {}
        for i in range(len(self.dataset)):
            item = self.dataset[i]
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
            pred = self.forward(item)
            pose = pred["pose"][-1].float().cpu().numpy()  # waits for the device
            dt = time.perf_counter() - t0
            pred_np = {k: (v.float() if v.is_floating_point() else v).cpu().numpy()
                       for k, v in pred.items()}
            gt = np.asarray(item["pose"], np.float32)[:3, :4]
            rre, rte = pose_error(pose, gt)
            scene = item["scene"]
            per_scene[scene] = {
                "R_error_deg": rre, "t_error": rte, "time": dt,
                "blocks": [int(b) for b in item["block_list"]],
            }

            scene_dir = os.path.join(self.output_dir, scene)
            os.makedirs(scene_dir, exist_ok=True)
            with open(os.path.join(scene_dir, "transformation_est.json"), "w") as f:
                json.dump({"pose_est": pose.tolist(), "pose_gt": gt.tolist()}, f, indent=2)
            torch.save(torch.from_numpy(pose.copy()), os.path.join(scene_dir, "pose_est.pt"))
            torch.save(torch.from_numpy(gt.copy()), os.path.join(scene_dir, "pose_gt.pt"))

            try:  # the ICP polish, aligned / unaligned point clouds, the classical baseline
                src_pts, src_cols = read_ply(item["src_ply_path"])
                tgt_pts, tgt_cols = read_ply(item["tgt_ply_path"])
                if self.config.icp_refine:
                    t1 = time.perf_counter()
                    refined, icp_rms, icp_cnt = icp_refine(
                        src_pts, tgt_pts, pose, voxel_size=icp_voxel, src_colors=src_cols,
                        tgt_colors=tgt_cols, device=self.device)
                    if refined is not None:
                        rre_i, rte_i = pose_error(refined, gt)
                        per_scene[scene].update(
                            R_error_icp_deg=rre_i, t_error_icp=rte_i, icp_rms=float(icp_rms),
                            icp_inliers=int(icp_cnt), icp_time=time.perf_counter() - t1)
                        pose = refined  # the aligned dumps use the best pose
                aligned = src_pts @ pose[:3, :3].T + pose[:3, 3]
                write_ply(os.path.join(scene_dir, "src_unaligned.ply"), src_pts, src_cols)
                write_ply(os.path.join(scene_dir, "src_aligned.ply"), aligned, src_cols)
                write_ply(os.path.join(scene_dir, "tgt.ply"), tgt_pts, tgt_cols)

                fgr_pose, ginfo = best_global_registration(
                    src_pts, tgt_pts, src_colors=src_cols, tgt_colors=tgt_cols,
                    icp_voxel=icp_voxel, refine=self.config.icp_refine, device=self.device)
                if fgr_pose is not None:
                    frre, frte = pose_error(fgr_pose[:3, :4], gt)
                    fgr_per_scene[scene] = {"R_error_deg": frre, "t_error": frte,
                                            "time": ginfo.get("time_s"),
                                            "winner": ginfo.get("winner")}
            except FileNotFoundError:
                pass
            dump_keypoint_clouds(scene_dir, pred_np, pose, gt)
            if self.config.render_videos or os.environ.get("DREG_RENDER_VIDEOS"):
                self._render_videos(scene_dir, item, pose, gt)
            print(f"[eval] {scene}: RRE {rre:.3f} deg RTE {rte:.4f} ({dt:.2f}s)")
        return self._agg_and_write(per_scene, fgr_per_scene)

    @staticmethod
    def _orbit_poses(n: int = 12) -> np.ndarray:
        """n camera-to-world poses on a circle of radius 3 at height 1.5,
        each looking at the origin."""
        poses = []
        for i in range(n):
            th = 2 * np.pi * i / n
            eye = 3.0 * np.array([np.cos(th), np.sin(th), 0.5])
            fwd = -eye / np.linalg.norm(eye)
            right = np.cross(fwd, [0, 0, 1.0])
            right /= np.linalg.norm(right)
            up = np.cross(right, fwd)
            c2w = np.eye(4)
            c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, -fwd, eye
            poses.append(c2w)
        return np.stack(poses)

    def _render_videos(self, scene_dir: str, item: dict, pose_est: np.ndarray,
                       pose_gt: np.ndarray) -> None:
        """The fused-scene orbits of a pair, [src rgb | depth | tgt rgb | depth]
        frames and an mp4, for `gt` and `aligned` (the tgt cameras mapped by
        that pose) and `unaligned` (the same cameras); nothing without both
        NeRF checkpoints. A tag that fails is reported and skipped, so that
        the other tags are still rendered."""
        from dregnerf_tpu_torch.render.novel_views import render_pair_views

        src_ckpt = item.get("src_nerf_path", "")
        tgt_ckpt = item.get("tgt_nerf_path", "")
        if not all(p and os.path.exists(p) for p in (src_ckpt, tgt_ckpt)):
            return
        poses = self._orbit_poses()
        for tag, transform in (("gt", pose_gt), ("aligned", pose_est), ("unaligned", None)):
            try:
                render_pair_views(src_ckpt, tgt_ckpt, poses, transform, scene_dir, tag,
                                  self.config.dataset or "objaverse", factor=8,
                                  device=self.device)
            except Exception as e:  # noqa: BLE001 — one tag must not drop the others
                print(f"[eval] video {tag} skipped: {e}")

    def _agg_and_write(self, per_scene: dict, fgr_per_scene: dict) -> dict:
        def agg(d):
            if not d:
                return {}
            r = [v["R_error_deg"] for v in d.values()]
            t = [v["t_error"] for v in d.values()]
            return {"R_mean": float(np.mean(r)), "R_med": float(np.median(r)),
                    "t_mean": float(np.mean(t)), "t_med": float(np.median(t)),
                    "num_pairs": len(d)}

        metrics = {"per_scene": per_scene, "aggregate": agg(per_scene)}
        with open(os.path.join(self.output_dir, "metrics_test.json"), "w") as f:
            json.dump(metrics, f, indent=2)
        if fgr_per_scene:
            with open(os.path.join(self.output_dir, "fgr_metrics_test.json"), "w") as f:
                json.dump({"per_scene": fgr_per_scene, "aggregate": agg(fgr_per_scene)}, f,
                          indent=2)
        print(f"[eval] aggregate: {metrics['aggregate']}")
        return metrics


def dump_keypoint_clouds(scene_dir: str, pred: dict, pose_est: np.ndarray,
                         pose_gt: np.ndarray) -> None:
    """Keypoint and overlap-filtered clouds: src_xyz / tgt_xyz / *_kp_warped,
    the red + green composites, noisy_point_cloud_{pred,gt} and the
    overlap >= 0.5 point_cloud_{pred,gt}."""
    from dregnerf_tpu_torch.io.ply import write_ply

    red, green = np.array([1.0, 0.0, 0.0]), np.array([0.0, 1.0, 0.0])
    sv, tv = pred["src_valid"].astype(bool), pred["tgt_valid"].astype(bool)
    src_kp, tgt_kp = pred["src_kp"][sv], pred["tgt_kp"][tv]
    src_warp, tgt_warp = pred["src_kp_warped"][-1][sv], pred["tgt_kp_warped"][-1][tv]

    def dump(name, pts, cols=None):
        write_ply(os.path.join(scene_dir, name), pts, cols)

    def two_colours(a, b):
        return np.concatenate([np.tile(red, (len(a), 1)), np.tile(green, (len(b), 1))])

    dump("src_xyz.ply", src_kp)
    dump("tgt_xyz.ply", tgt_kp)
    dump("src_kp_warped.ply", src_warp)
    dump("tgt_kp_warped.ply", tgt_warp)
    dump("all_src_xyz.ply", np.concatenate([src_kp, tgt_warp]), two_colours(src_kp, tgt_warp))
    dump("all_tgt_xyz.ply", np.concatenate([src_warp, tgt_kp]), two_colours(src_warp, tgt_kp))

    overlap = np.concatenate([pred["src_overlap"][-1][sv], pred["tgt_overlap"][-1][tv]]) >= 0.5
    src_pred = src_kp @ pose_est[:3, :3].T + pose_est[:3, 3]
    fused_pred = np.concatenate([src_pred, tgt_kp])
    dump("noisy_point_cloud_pred.ply", fused_pred, two_colours(src_pred, tgt_kp))
    dump("point_cloud_pred.ply", fused_pred[overlap], np.tile(green, (int(overlap.sum()), 1)))
    src_gt = src_kp @ pose_gt[:3, :3].T + pose_gt[:3, 3]
    fused_gt = np.concatenate([src_gt, tgt_kp])
    dump("noisy_point_cloud_gt.ply", fused_gt, np.tile(red, (len(fused_gt), 1)))
    dump("point_cloud_gt.ply", fused_gt[overlap], np.tile(red, (int(overlap.sum()), 1)))


def main(argv=None) -> dict:
    from dregnerf_tpu_torch.datasets.register_pairs import NeRFRegDataset

    config = config_parser(argv)
    dataset = NeRFRegDataset(config.root_dir, config.dataset or "objaverse", config.json_dir,
                             subject_id=config.scene or None, split="test", seed=config.seed)
    return RegEvaluator(config, dataset).evaluate()


if __name__ == "__main__":
    main()
