"""Stage-3 end-to-end quality experiment (twin of
scripts/experiments/stage3_fleet.py): the whole DReg-NeRF pipeline on a
synthetic fleet of scenes, ending in held-out registration accuracy.

  1. render N scenes in two geometry families: even scenes are sphere
     clusters (`fixtures.random_spheres(100 + i)`), odd scenes box
     clusters (`fixtures.random_boxes(200 + i)`);
  2. train 2 NGP blocks a scene, each in its own random world frame
     (stage 1);
  3. extract voxel_grid / voxel_mask / ply artifacts of each block
     (stage 2) into the `regdata` tree NeRFRegDataset reads;
  4. train NeRFRegTr on the train scenes' pairs (stage 3), its learning
     rate halved at 1/2 and 3/4 of the run;
  5. register the held-out scenes in both block orders, RegTr with and
     without the colour ICP polish against the FGR/RANSAC baseline, and
     write metrics_test.json and fgr_metrics_test.json.

On the card, from the repo root (knobs in the environment, JAX's names
and defaults):

  STAGE3_SCENES=8 STAGE3_TEST_SCENES=2 ... python -m dregnerf_tpu_torch.scripts.experiments.stage3_fleet

`--device cpu` runs it on the CPU. Knobs: STAGE3_SCENES (16),
STAGE3_TEST_SCENES (4), STAGE3_NGP_ITERS (4000), STAGE3_BUDGET (2^17),
STAGE3_VIEWS (100), STAGE3_IMG (192), STAGE3_REG_ITERS (12000),
STAGE3_WORK (stage3_fleet_torch in the temporary directory),
STAGE3_LAYOUT (L8F4 or L4F8), STAGE3_RLE (the run-length step
render_step / min_extent, e.g. 0.00169; empty: off), STAGE3_ACCUM (bf16), STAGE3_MARCH (capped), STAGE3_LR (1e-4),
STAGE3_EXPNAME (stage3), STAGE3_WARM (a checkpoint to start stage 3 from),
STAGE3_TRAIN_DEADLINE (epoch seconds). The results go to
experiments/stage3_torch/.

Deliberate differences from the JAX script:
  * scenes are rendered in memory (`fixtures.render_views(spheres=)`) and
    split by `datasets/base.make_blocks` with exactly the arguments that
    `objaverse.load_blocks(multi_blocks=True, num_blocks=2)` passes, as
    the card's machine has no imageio to write and read the PNGs; the
    blocks are the same, and world_frame_transforms.json is written as
    the loader writes it;
  * no `commit_progress`: the script never runs git; what it writes under
    experiments/stage3_torch/ is committed by hand;
  * the port's own `runtime/resilience.Watchdog`;
  * the work directory defaults to stage3_fleet_torch under
    `tempfile.gettempdir()` (TMPDIR), not a fixed path, and a cached
    block is reused only when the knobs it was trained under
    (block_knobs.json beside its checkpoint: layout, run-length step,
    accumulator, marcher, views, image size, budget, seed and the test
    hooks) equal this run's; a block trained under other knobs is
    deleted and trained again;
  * each stage's wall seconds go to stage_seconds.json beside the metrics;
  * `Knobs` carries the knobs into every function, with a few sizes of
    its own (`grid`, `ngp_flags`, `reg_flags`, `baseline_draws`) that
    stay at JAX's values unless a caller shrinks them for a test, and
    `stage3` takes an optional NeRFRegTr in place of the default one.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from dregnerf_tpu_torch.datasets import fixtures, objaverse
from dregnerf_tpu_torch.datasets.base import make_blocks
from dregnerf_tpu_torch.datasets.register_pairs import NeRFRegDataset
from dregnerf_tpu_torch.device import resolve_device
from dregnerf_tpu_torch.runtime.checkpoint import load_checkpoint
from dregnerf_tpu_torch.runtime.config import config_parser
from dregnerf_tpu_torch.runtime.resilience import Watchdog

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
OUT = os.path.join(REPO, "experiments", "stage3_torch")
LAYOUTS = {
    "L8F4": dict(n_levels=8, n_features=4, per_level_scale=2.1),
    "L4F8": dict(n_levels=4, n_features=8, per_level_scale=5.66),
}
FOV_X = 0.9  # fixtures.render_views' default field of view, the scene's camera_angle_x
ICP_VOXEL = 2.0 / 128 * 2  # 2 cells of the 128^3 grid over the [-1, 1] aabb


@dataclasses.dataclass
class Knobs:
    """The experiment's sizes: JAX's STAGE3_* knobs (`from_env`) and the
    test-size hooks `grid` (PackedGridConfig fields over the layout's),
    `ngp_flags` and `reg_flags` (CLI flags after the script's own) and
    `baseline_draws` (the block orders of each held-out scene that the
    baseline also registers: JAX's 2, or 1 for the first order only)."""

    scenes: int = 16
    test_scenes: int = 4
    ngp_iters: int = 4000
    budget: int = 1 << 17
    views: int = 100
    img: int = 192
    reg_iters: int = 12000
    work: str = os.path.join(tempfile.gettempdir(), "stage3_fleet_torch")
    layout: str = "L8F4"
    rle: str = ""
    accum: str = "bf16"
    march: str = "capped"
    lr: str = "1e-4"
    expname: str = "stage3"
    warm: str = ""
    train_deadline: Optional[str] = None
    out: str = OUT
    grid: dict = dataclasses.field(default_factory=dict)
    ngp_flags: tuple = ()
    reg_flags: tuple = ()
    baseline_draws: int = 2

    @classmethod
    def from_env(cls, env=None) -> "Knobs":
        env = os.environ if env is None else env
        d = cls()
        return cls(
            scenes=int(env.get("STAGE3_SCENES", d.scenes)),
            test_scenes=int(env.get("STAGE3_TEST_SCENES", d.test_scenes)),
            ngp_iters=int(env.get("STAGE3_NGP_ITERS", d.ngp_iters)),
            budget=int(env.get("STAGE3_BUDGET", d.budget)),
            views=int(env.get("STAGE3_VIEWS", d.views)),
            img=int(env.get("STAGE3_IMG", d.img)),
            reg_iters=int(env.get("STAGE3_REG_ITERS", d.reg_iters)),
            work=env.get("STAGE3_WORK", d.work),
            layout=env.get("STAGE3_LAYOUT", d.layout),
            rle=env.get("STAGE3_RLE", d.rle),
            accum=env.get("STAGE3_ACCUM", d.accum),
            march=env.get("STAGE3_MARCH", d.march),
            lr=env.get("STAGE3_LR", d.lr),
            expname=env.get("STAGE3_EXPNAME", d.expname),
            warm=env.get("STAGE3_WARM", d.warm),
            train_deadline=env.get("STAGE3_TRAIN_DEADLINE"),
        )

    def block_knobs(self, seed: int) -> dict:
        """What a trained block depends on, as block_knobs.json holds it."""
        return json.loads(json.dumps(dict(
            layout=self.layout, rle=self.rle, accum=self.accum, march=self.march,
            views=self.views, img=self.img, budget=self.budget, seed=seed,
            grid=self.grid, ngp_flags=self.ngp_flags)))

    def ngp_model(self):
        """The blocks' NGPConfig: full-width 2^19-row tables at the layout,
        the table-gradient accumulator and the run-length step."""
        from dregnerf_tpu_torch.models.ngp import NGPConfig
        from dregnerf_tpu_torch.ops.packed_grid import PackedGridConfig

        grid = dict(LAYOUTS[self.layout], grad_accum=self.accum, **self.grid)
        if self.rle:
            grid["rle_step_u"] = float(self.rle)
        return NGPConfig(grid=PackedGridConfig(**grid))


def _ckpt_step(path: str) -> int:
    """The step in a checkpoint's meta (0 if unreadable): model.ckpt is
    the latest copy, written at every periodic save, so its existence
    alone does not mean the block finished."""
    try:
        return int(load_checkpoint(path)[1].get("step", 0))
    except (OSError, ValueError, KeyError):
        return 0


def _read_json(path: str):
    """The JSON value at `path`, or None if it is missing or unreadable."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _record(path: str, key: str, value) -> None:
    """Set `key` in the JSON object at `path` (created if missing)."""
    rec = _read_json(path) or {}
    rec[key] = value
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=2, sort_keys=True)


def scene_names(knobs: Knobs) -> list:
    return [f"scene_{i:02d}" for i in range(knobs.scenes)]


def scene_shapes(s_idx: int):
    """Even scenes are sphere clusters, odd scenes box clusters (so the
    held-out set holds both families)."""
    if s_idx % 2 == 0:
        return fixtures.random_spheres(100 + s_idx)
    return fixtures.random_boxes(200 + s_idx)


def scene_blocks(data_root: str, scene: str, s_idx: int, knobs: Knobs) -> dict:
    """{split: [block 0, block 1]} of scene `s_idx`, rendered in memory and
    split as objaverse.load_blocks(root, scene, split, 1, True, 2) splits
    the files fixtures.make_scene writes (the frames in
    <data_root>/<scene>/world_frame_transforms.json)."""
    images, c2w = fixtures.render_views(knobs.views, knobs.img, seed=s_idx,
                                        spheres=scene_shapes(s_idx))
    c2w = c2w.astype(np.float32)[:, :3, :4]
    K = objaverse.intrinsics(knobs.img, knobs.img, FOV_X)
    data_dir = os.path.join(data_root, scene)
    os.makedirs(data_dir, exist_ok=True)
    return {split: make_blocks(data_dir, images, c2w, K, split, 2, objaverse.VAL_INTERVAL,
                               objaverse.OPENGL, objaverse.SYNTHETIC, scene)
            for split in ("train", "test")}


def stage1_and_2(knobs: Knobs, device=None) -> str:
    """Train and extract both blocks of every scene (blocks cached under
    the same knobs and their artifacts are kept) and lay out the regdata
    tree; returns its root."""
    from dregnerf_tpu_torch.extract.sample_grid import (
        extract_voxel_features,
        save_voxel_artifacts,
    )
    from dregnerf_tpu_torch.runtime.ngp_trainer import NGPTrainer, load_field_from_checkpoint

    device = resolve_device(device)
    data_root = os.path.join(knobs.work, "data")
    out_root = os.path.join(knobs.work, "out")
    reg_root = os.path.join(knobs.work, "regdata")
    model = knobs.ngp_model()
    for s_idx, scene in enumerate(scene_names(knobs)):
        blocks = scene_blocks(data_root, scene, s_idx, knobs)
        cfg = config_parser([
            "--dataset", "objaverse", "--root_dir", data_root,
            "--scene", scene, "--expname", scene, "--out_dir", out_root,
            "--factor", "1", "--aabb=-1.0,-1.0,-1.0,1.0,1.0,1.0",
            "--max_iterations", str(knobs.ngp_iters),
            "--sample_budget", str(knobs.budget), "--max_march_steps", "1024",
            "--grid_resolution", "128", "--init_num_rays", "1024",
            "--max_num_rays", str(1 << 15),
            # a checkpoint every 1000 steps: a restart resumes the block
            "--n_tensorboard", "500", "--n_validation", "1000000",
            "--n_checkpoint", "1000", *knobs.ngp_flags,
        ])
        block_dirs = []
        for k, (tr, te) in enumerate(zip(blocks["train"], blocks["test"])):
            out_dir = os.path.join(out_root, scene, f"block_{k}")
            block_dirs.append(out_dir)
            ckpt = os.path.join(out_dir, "model", "model.ckpt")
            voxels = os.path.join(out_dir, "voxel_grid.pt")
            seed = 1000 * s_idx + k
            knobs_path = os.path.join(out_dir, "block_knobs.json")
            if os.path.exists(out_dir) and _read_json(knobs_path) != knobs.block_knobs(seed):
                print(f"[stage1] {scene} block_{k}: trained under other knobs, trained again",
                      flush=True)
                shutil.rmtree(out_dir)

            if not os.path.exists(ckpt) or _ckpt_step(ckpt) < knobs.ngp_iters:
                os.makedirs(out_dir, exist_ok=True)
                with open(knobs_path, "w") as f:
                    json.dump(knobs.block_knobs(seed), f, indent=2, sort_keys=True)
                t0 = time.time()
                trainer = NGPTrainer(cfg, tr, te, output_dir=out_dir, device=device)
                trainer.model_config = model
                trainer.render_config = dataclasses.replace(
                    trainer.render_config, march_compaction=knobs.march)
                trainer.init_params(torch.Generator(device=device).manual_seed(seed))
                trainer.setup_optimizer()
                trainer.train()
                with Watchdog(900, name=f"{scene}-val"):
                    psnr = trainer.validate(knobs.ngp_iters)
                print(f"[stage1] {scene} block_{k}: val PSNR {psnr:.2f} "
                      f"({time.time() - t0:.0f}s)", flush=True)
                _record(os.path.join(knobs.out, "stage1_psnr.json"), f"{scene}/block_{k}",
                        round(float(psnr), 2))
            else:
                print(f"[stage1] {scene} block_{k}: cached", flush=True)

            # stage 2 from the checkpoint, again when the checkpoint is newer
            if os.path.exists(voxels) and os.path.getmtime(voxels) >= os.path.getmtime(ckpt):
                print(f"[stage2] {scene} block_{k}: cached", flush=True)
                continue
            params, grid, meta, model_cfg, _ = load_field_from_checkpoint(ckpt, device)
            with Watchdog(900, name=f"{scene}-extract"):
                ex = extract_voxel_features(params, model_cfg, grid, meta,
                                            torch.Generator().manual_seed(7),
                                            surface_chunk=8192, device=device)
            save_voxel_artifacts(out_dir, ex)
            n = int((ex["surface_mask"] & ex["density_mask"]).sum())
            print(f"[stage2] {scene} block_{k}: {n} surface voxels", flush=True)

        # the regdata layout NeRFRegDataset reads
        img_meta = os.path.join(reg_root, "images", scene)
        os.makedirs(img_meta, exist_ok=True)
        shutil.copyfile(os.path.join(data_root, scene, "world_frame_transforms.json"),
                        os.path.join(img_meta, "world_frame_transforms.json"))
        for k, d in enumerate(block_dirs):
            dst = os.path.join(reg_root, "nerf_models", scene, f"block_{k}")
            os.makedirs(os.path.join(dst, "model"), exist_ok=True)
            for rel in (os.path.join("model", "model.ckpt"), "voxel_grid.pt",
                        "voxel_mask.pt", "voxel_point_cloud.ply"):
                shutil.copyfile(os.path.join(d, rel), os.path.join(dst, rel))
    return reg_root


def merged_dataset(reg_root: str, scenes: list, split: str, seed: int = 0) -> NeRFRegDataset:
    """One NeRFRegDataset over `scenes`, its host block cache sized to
    hold every block (2 a scene)."""
    ds = None
    for s in scenes:
        one = NeRFRegDataset(reg_root, subject_id=s, split=split, seed=seed)
        if ds is None:
            ds = one
        else:
            ds.meta.extend(one.meta)
    ds.cache_blocks = max(64, 2 * len(scenes) + 8)
    return ds


def _rss_mb() -> float:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return round(int(line.split()[1]) / 1024.0, 1)
    except OSError:
        pass
    return -1.0


def stage3(reg_root: str, knobs: Knobs, device=None, model=None):
    """Train NeRFRegTr (`model`, default the config's) on the train scenes'
    pairs, validating on the held-out ones; returns (trainer, val
    dataset, test scene names)."""
    from dregnerf_tpu_torch.runtime.reg_optim import run_sized_schedule
    from dregnerf_tpu_torch.runtime.reg_trainer import RegTrainer

    names = scene_names(knobs)
    train_scenes = names[: knobs.scenes - knobs.test_scenes]
    test_scenes = names[knobs.scenes - knobs.test_scenes:]
    train_ds = merged_dataset(reg_root, train_scenes, "train", seed=3)
    val_ds = merged_dataset(reg_root, test_scenes, "test", seed=4)

    epochs = max(1, knobs.reg_iters // len(train_ds))
    cfg = config_parser([
        "--dataset", "objaverse", "--root_dir", reg_root,
        "--expname", knobs.expname, "--out_dir", os.path.join(knobs.work, "regout"),
        "--aabb=-1.0,-1.0,-1.0,1.0,1.0,1.0", "--robust_loss",
        "--epochs", str(epochs),
        "--n_tensorboard", "100", "--n_validation", "500",
        "--n_checkpoint", "1000", "--lr", knobs.lr,
        # every held-out pair: model_best picks the evaluated weights
        "--val_fraction", "1.0",
        # the device grid cache holds every block of the fleet
        "--reg_device_cache", str(2 * knobs.scenes + 8), *knobs.reg_flags,
    ])
    trainer = RegTrainer(cfg, train_ds, val_ds, model=model, device=resolve_device(device))
    # the halvings at 1/2 and 3/4 of this run (the default ones, 34000 k,
    # never come within a fleet run)
    trainer.set_lr_schedule(run_sized_schedule(knobs.reg_iters))

    # a warm start, only while this run has no checkpoint of its own
    if knobs.warm and not os.path.exists(trainer.ckpt_manager.latest_path):
        flat, meta = load_checkpoint(knobs.warm)
        trainer._load_flat(trainer.optimizer.flat, flat, "params::")
        trainer.set_lr_schedule(run_sized_schedule(knobs.reg_iters))
        print(f"[stage3] warm start from {knobs.warm} (step {meta.get('step')})", flush=True)

    curve_path = os.path.join(knobs.out, f"{knobs.expname}_val_curve.json")

    def on_validate(iteration, score):
        _record(curve_path, str(iteration), {
            "val_neg_rre": round(float(score), 4), "rss_mb": _rss_mb(),
            "grid_uploads": trainer._dev_uploads, "grid_evictions": trainer._dev_evictions})

    trainer.on_validate = on_validate
    trainer.train_deadline = _train_deadline(knobs)
    trainer.train()
    return trainer, val_ds, test_scenes


def _train_deadline(knobs: Knobs) -> Optional[float]:
    """Wall-clock end (epoch s) of stage-3 training, or None: the knob,
    else <out>/train_deadline_epoch.txt while it is under 6 h old."""
    val = knobs.train_deadline
    if val is None:
        path = os.path.join(knobs.out, "train_deadline_epoch.txt")
        try:
            if time.time() - os.path.getmtime(path) < 6 * 3600:
                with open(path) as f:
                    val = f.read().strip()
            else:
                print(f"[stage3] ignoring stale {path}", flush=True)
        except OSError:
            return None
    if not val:
        return None
    deadline = float(val)
    print(f"[stage3] train deadline in {(deadline - time.time()) / 60:.1f} min", flush=True)
    return deadline


def _agg(rows: list) -> dict:
    r = np.array([x["RRE"] for x in rows])
    t = np.array([x["RTE"] for x in rows])
    out = {"R_mean": float(r.mean()), "R_med": float(np.median(r)), "R_std": float(r.std()),
           "R_max": float(r.max()), "t_mean": float(t.mean()), "t_med": float(np.median(t)),
           "t_std": float(t.std())}
    # rows without an ICP result count with their raw error
    ri = np.array([x.get("RRE_icp", x["RRE"]) for x in rows])
    ti = np.array([x.get("RTE_icp", x["RTE"]) for x in rows])
    out["icp"] = {"R_mean": float(ri.mean()), "R_med": float(np.median(ri)),
                  "t_mean": float(ti.mean()), "t_med": float(np.median(ti))}
    out["pairs"] = rows
    return out


def evaluate(trainer, val_ds, test_scenes: list, knobs: Knobs) -> Optional[dict]:
    """Held-out RRE/RTE of RegTr (from model_best.ckpt when there is one)
    with and without the ICP polish, against the FGR/RANSAC baseline, each
    scene in both block orders; writes metrics_test.json and
    fgr_metrics_test.json and returns both, or None without a stage-3
    checkpoint."""
    from dregnerf_tpu_torch.geometry import se3
    from dregnerf_tpu_torch.io.ply import read_ply
    from dregnerf_tpu_torch.registration.icp import icp_refine
    from dregnerf_tpu_torch.registration.pipeline import best_global_registration
    from dregnerf_tpu_torch.runtime.reg_trainer import to_device

    dev = trainer.device
    eval_ckpt = "final"
    best = trainer.ckpt_manager.best_path
    if os.path.exists(best):
        flat, meta = load_checkpoint(best)
        trainer._load_flat(trainer.optimizer.flat, flat, "params::")
        eval_ckpt = f"best@{int(meta.get('step', -1))}"
    elif not os.path.exists(trainer.ckpt_manager.latest_path):
        # stage 3 never trained (a restart after the deadline): random
        # weights would overwrite the held-out metrics with noise
        print("[eval] no stage-3 checkpoint: skipping the held-out evaluation", flush=True)
        return None
    print(f"[eval] checkpoint: {eval_ckpt}", flush=True)

    def err(T, item):
        rre, rte = se3.pose_error(torch.as_tensor(np.asarray(T, np.float32)[:3, :4]),
                                  torch.as_tensor(np.asarray(item["pose"], np.float32)[:3, :4]))
        return float(rre), float(rte)

    reg_rows, fgr_rows = [], []
    with Watchdog(900, name="stage3-eval") as wd:
        for i in range(len(val_ds)):
            for draw, order in enumerate([(0, 1), (1, 0)]):
                wd.beat()
                val_ds.fixed_order = order
                item = val_ds[i]
                batch = (trainer._to_device_cached(item) if "src_cache_key" in item
                         else to_device(item, dev))
                t0 = time.time()
                pose, rre, rte = trainer._eval(batch)
                pose = pose.float().cpu().numpy()
                row = {"scene": item["scene"], "draw": draw, "RRE": float(rre),
                       "RTE": float(rte), "time_s": time.time() - t0}
                src_pts, src_cols = read_ply(item["src_ply_path"])
                tgt_pts, tgt_cols = read_ply(item["tgt_ply_path"])
                t0 = time.time()
                T_icp, icp_rms, icp_cnt = icp_refine(
                    src_pts, tgt_pts, pose, voxel_size=ICP_VOXEL, src_colors=src_cols,
                    tgt_colors=tgt_cols, device=dev)
                if T_icp is not None:
                    rre_i, rte_i = err(T_icp, item)
                    row.update(RRE_icp=rre_i, RTE_icp=rte_i, icp_rms=float(icp_rms),
                               icp_inliers=int(icp_cnt), icp_time_s=time.time() - t0)
                reg_rows.append(row)

                # the classical baseline: the FGR/RANSAC race on geometry
                # alone, then the same colour-aware ICP polish
                if draw >= knobs.baseline_draws:
                    continue
                t0 = time.time()
                T, ginfo = best_global_registration(src_pts, tgt_pts, refine=False, device=dev)
                dt_fgr = time.time() - t0
                if T is not None:
                    rre_f, rte_f = err(T, item)
                    frow = {"scene": item["scene"], "draw": draw, "RRE": rre_f, "RTE": rte_f,
                            "time_s": dt_fgr, "winner": ginfo.get("winner")}
                    T_fi, _, _ = icp_refine(src_pts, tgt_pts, np.asarray(T)[:3, :4],
                                            voxel_size=ICP_VOXEL, src_colors=src_cols,
                                            tgt_colors=tgt_cols, device=dev)
                    if T_fi is not None:
                        frow["RRE_icp"], frow["RTE_icp"] = err(T_fi, item)
                    fgr_rows.append(frow)
                else:
                    fgr_rows.append({"scene": item["scene"], "draw": draw, "RRE": 180.0,
                                     "RTE": 10.0, "error": "fgr failed", "time_s": dt_fgr})
            val_ds.fixed_order = None

    reg = {"test_scenes": test_scenes, "iters": knobs.reg_iters, "eval_ckpt": eval_ckpt,
           **_agg(reg_rows)}
    fgr = {"test_scenes": test_scenes, **_agg(fgr_rows)}
    os.makedirs(knobs.out, exist_ok=True)
    with open(os.path.join(knobs.out, "metrics_test.json"), "w") as f:
        json.dump(reg, f, indent=2)
    with open(os.path.join(knobs.out, "fgr_metrics_test.json"), "w") as f:
        json.dump(fgr, f, indent=2)
    print(json.dumps({"regtr": {k: reg[k] for k in ("R_mean", "R_med", "t_mean", "t_med")},
                      "regtr_icp": reg["icp"],
                      "fgr": {k: fgr[k] for k in ("R_mean", "R_med", "t_mean", "t_med")},
                      "fgr_icp": fgr["icp"]}), flush=True)
    return {"regtr": reg, "fgr": fgr}


def main(argv=None, knobs: Optional[Knobs] = None, reg_model=None) -> Optional[dict]:
    """The whole experiment at `knobs` (default: from the environment);
    returns evaluate()'s result."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    knobs = Knobs.from_env() if knobs is None else knobs
    device = resolve_device(args.device)
    seconds_path = os.path.join(knobs.out, "stage_seconds.json")
    t0 = time.time()
    reg_root = stage1_and_2(knobs, device)
    t1 = time.time()
    _record(seconds_path, "stage1_and_2", round(t1 - t0, 1))
    trainer, val_ds, test_scenes = stage3(reg_root, knobs, device, reg_model)
    t2 = time.time()
    _record(seconds_path, "stage3", round(t2 - t1, 1))
    result = evaluate(trainer, val_ds, test_scenes, knobs)
    _record(seconds_path, "evaluate", round(time.time() - t2, 1))
    return result


if __name__ == "__main__":
    main()
