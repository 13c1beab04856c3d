"""Registration (NeRFRegTr) training, stage 3 (port of
dregnerf_tpu/runtime/reg_trainer.py).

Four losses with weights {overlap 1, nerf_cont 1, feature 0.1, corr 1};
clip_by_global_norm(0.1) then AdamW (lr 1e-4, weight decay 1e-4) with
optax's piecewise-constant schedule (halved at 34000 k, k = 1..4), under a
guard that skips a step with a nonfinite loss or gradient
(`runtime/reg_optim.py`); RRE/RTE validation on a subsample of the val
pairs in both block orders; checkpoints with the JAX keys, the InfoNCE W
and optax's optimizer state, so that either package resumes the other's.

Visibility labels come from the voxel masks (`grid_visibility`, the
default) or from marching the blocks' NeRF checkpoints
(`--visibility exact`). With batch size 1 and grid labels the train split
is read through `get_raw`: grids and masks stay on the device in an LRU
(`--reg_device_cache` blocks) and the jitter and rigid perturbation run
there (`device_augment`). `--reg_batch_size` > 1 loops over the pairs of
a step and takes the gradient of their mean loss (what JAX's vmap
computes); its metrics are the means, with the first pair's pose error.

train() runs each step through the retry wrapper (an emergency checkpoint
on a fatal error) under the hang watchdog (`--watchdog_s`;
runtime/resilience.py), and the steps of `--profile_steps` (counted from
0 by `iteration`) under profiling.trace (<output_dir>/profile). Scalars
go to log.txt and log.jsonl, and with `--enable_tensorboard` to a
tensorboardX event file under
<out_dir>/logs/<expname>. `--enable_visdom` starts the live pose viewer
(utils/pose_server.py) on `--visdom_port`; each validate() pushes the
first pair it scores.

With `--mesh_shape N` (N ranks under torchrun) a step trains N pairs, one
a rank, through the data-parallel step of parallel/regtr_dp.py: every rank
draws the same epoch permutation and takes its pair of each group of N
(the remainder pairs are dropped), as a host batch without the
device-cached augmentation; rank 0's initial weights are broadcast, and
only rank 0 logs, validates and writes checkpoints while the others wait
at a barrier. As in JAX, `--visibility exact` and `--reg_batch_size` > 1
refuse a mesh.
"""
from __future__ import annotations

import json
import os
import time
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
import torch

from dregnerf_tpu_torch.geometry import se3
from dregnerf_tpu_torch.losses import registration as L
from dregnerf_tpu_torch.losses.visibility import grid_visibility
from dregnerf_tpu_torch.models.regtr import NeRFRegTr
from dregnerf_tpu_torch.parallel.mesh import barrier, is_main
from dregnerf_tpu_torch.runtime import profiling, reg_graph
from dregnerf_tpu_torch.runtime.logging import ScalarLogger
from dregnerf_tpu_torch.runtime.resilience import Watchdog, run_with_retries

BATCH_KEYS = ("src_grid", "tgt_grid", "src_mask", "tgt_mask", "pose")
LOSS_WEIGHTS = {"overlap": 1.0, "nerf_cont": 1.0, "feature": 0.1, "corr": 1.0}
ADAM_PREFIX = "optimizer::1/0/"  # optax chain(clip, adamw): adam state, then the schedule's
SCHEDULE_COUNT_KEY = "optimizer::1/2/count"


def make_reg_model(config, dtype: torch.dtype = torch.float32) -> NeRFRegTr:
    """NeRFRegTr at the config's embedding flags (every other field at its
    default: resnet50, 6 layers, 8 heads, ...), computing in `dtype`."""
    return NeRFRegTr(
        pos_emb_type=config.position_embedding_type,
        d_model=config.position_embedding_dim,
        pos_emb_scaling=config.position_embedding_scaling,
        num_downsample=config.num_downsample,
        dtype=dtype,
    )


def to_device(item: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """The model's inputs of a dataset item (and its pose) on `device`."""
    return {k: torch.as_tensor(item[k], device=device) for k in BATCH_KEYS}


def compute_losses(model: NeRFRegTr, infonce_W: torch.Tensor, batch: Dict[str, torch.Tensor],
                   aabb: torch.Tensor, grid_resolution: int, robust: bool = True,
                   visibility_fns: tuple | None = None,
                   warped_visibility_fns: tuple | None = None, solve_pose: bool = True):
    """The four losses; returns (total, losses, pred). `losses` also holds
    `feature_matches`, a diagnostic outside the total. `solve_pose` goes to
    the model's forward.

    visibility_fns: optional (src, tgt) callables points [..., 3] -> labels
    [...]; default the voxel-mask lookup. warped_visibility_fns: optional
    separate label fns for the per-layer warped keypoints (the
    nerf-consistency term, which carries no gradient); without them one
    call per side labels the keypoints and the warped keypoints together.
    Labels carry no gradient. The pose is in no loss."""
    pred = model(batch, solve_pose=solve_pose)
    with profiling.annotate("regtr.losses"):
        pose_gt = batch["pose"][:3, :4]
        pose_gt_inv = se3.se3_inv(pose_gt)
        src_kp, tgt_kp = pred["src_kp"], pred["tgt_kp"]  # [N, 3]
        src_valid, tgt_valid = pred["src_valid"], pred["tgt_valid"]
        src_warped, tgt_warped = pred["src_kp_warped"], pred["tgt_kp_warped"]  # [L, N, 3]
        n_layers = src_warped.shape[0]

        if visibility_fns is not None:
            src_vis, tgt_vis = visibility_fns
        else:
            def src_vis(pts):
                return grid_visibility(pts, batch["src_mask"], aabb, grid_resolution)

            def tgt_vis(pts):
                return grid_visibility(pts, batch["tgt_mask"], aabb, grid_resolution)
        with torch.no_grad():
            if warped_visibility_fns is not None:
                src_wvis, tgt_wvis = warped_visibility_fns
                src_gt, tgt_gt = src_vis(src_kp), tgt_vis(tgt_kp)
                src_tilde, tgt_tilde = src_wvis(src_warped.detach()), tgt_wvis(tgt_warped.detach())
            else:  # one call per side on [1 + L, N, 3]
                src_labels = src_vis(torch.cat([src_kp[None], src_warped.detach()]))
                tgt_labels = tgt_vis(torch.cat([tgt_kp[None], tgt_warped.detach()]))
                src_gt, src_tilde = src_labels[0], src_labels[1:]
                tgt_gt, tgt_tilde = tgt_labels[0], tgt_labels[1:]

        losses = {}
        losses["overlap"] = L.overlap_bce(
            torch.cat([pred["src_overlap"][-1], pred["tgt_overlap"][-1]]),
            torch.cat([src_gt, tgt_gt]), torch.cat([src_valid, tgt_valid]))
        losses["nerf_cont"] = 0.5 * (
            L.nerf_consistency(src_tilde, src_gt.expand(n_layers, -1), src_valid)
            + L.nerf_consistency(tgt_tilde, tgt_gt.expand(n_layers, -1), tgt_valid))

        # InfoNCE radii scale with the subsample level's cell (never under the
        # reference's 0.2), read from the model's level tensor on the device
        cell = model.init_subsample_cell * torch.pow(2.0, pred["ds_level"].to(torch.float32))
        r_p = torch.clamp(1.25 * cell, min=0.2)
        src_warped_gt = se3.se3_transform(pose_gt, src_kp)
        losses["feature"], n_match = L.infonce_loss(
            infonce_W, pred["src_feats"][-1, 0].float(), pred["tgt_feats"][-1, 0].float(),
            src_warped_gt, tgt_kp, src_valid, tgt_valid, r_p=r_p, r_n=2.0 * r_p,
            return_stats=True)
        losses["feature_matches"] = n_match.to(torch.float32)

        tgt_warped_gt = se3.se3_transform(pose_gt_inv, tgt_kp)
        losses["corr"] = (
            L.correspondence_loss(src_warped[-1], src_warped_gt, src_gt, src_valid, robust)
            + L.correspondence_loss(tgt_warped[-1], tgt_warped_gt, tgt_gt, tgt_valid, robust))

        total = sum(losses[k] * LOSS_WEIGHTS[k] for k in LOSS_WEIGHTS)
        return total, losses, pred


def exact_visibility_fns(contexts, buffer_size: int = 1 << 16) -> tuple:
    """(src, tgt) label fns over ((ctx, model_cfg, rcfg) of each side) that
    march camera-to-point rays through the side's NeRF."""
    from dregnerf_tpu_torch.losses.visibility import exact_visibility_ctx

    return tuple((lambda pts, c=c, m=m, r=r: exact_visibility_ctx(c, m, r, pts, buffer_size))
                 for c, m, r in contexts)


def make_exact_visibility_fns(src_ckpt: str, tgt_ckpt: str, max_cameras: int = 128,
                              buffer_size: int = 1 << 16, device=None):
    """(src, tgt) label fns that march camera-to-point rays through the two
    NeRF checkpoints, each loaded once."""
    from dregnerf_tpu_torch.losses.visibility import load_visibility_context

    return exact_visibility_fns([load_visibility_context(p, max_cameras, device)
                                 for p in (src_ckpt, tgt_ckpt)], buffer_size)


class RegTrainer:
    """Runs on `device` (default: the config's --device, else cuda).
    `model` replaces the config's NeRFRegTr (a narrower one in tests); its
    weights are drawn with flax's initializers from the config's seed,
    unless a checkpoint is loaded.

    On the card, the device-cached step at batch 1 with grid labels and no
    mesh runs as a CUDA graph (runtime/reg_graph.py); `graph_captures` and
    `graph_replays` count its captures and replays."""

    # class-level, so that a trainer made without __init__ reads them too
    _graph = None  # the device-cached step's reg_graph.StepGraph
    graph_captures = 0
    graph_replays = 0

    def __init__(self, config, train_dataset, val_dataset, output_dir: Optional[str] = None,
                 model: Optional[NeRFRegTr] = None, device=None):
        from dregnerf_tpu_torch.models.regtr import params_from_jax, random_jax_params
        from dregnerf_tpu_torch.parallel.mesh import mesh_and_device, mesh_ranks
        from dregnerf_tpu_torch.runtime.checkpoint import CheckpointManager
        from dregnerf_tpu_torch.runtime.reg_optim import GuardedAdamW

        self.config = config
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset
        self.visibility = config.visibility
        self.batch_size = max(int(config.reg_batch_size), 1)
        if self.visibility == "exact" and self.batch_size > 1:
            raise ValueError("--visibility exact supports reg_batch_size=1 (the reference "
                             "trains at batch 1; exact labels march Nc rays per keypoint)")
        if mesh_ranks(config) > 1:
            if self.visibility == "exact":
                raise ValueError("--mesh_shape with --visibility exact is not supported yet")
            if self.batch_size > 1:
                raise ValueError("--mesh_shape shards one pair per rank; leave "
                                 "--reg_batch_size at 1 (pairs per step = mesh size)")
        self.mesh, self.device = mesh_and_device(config, device)  # --mesh_shape: a pair a rank
        self.output_dir = output_dir or os.path.join(config.out_dir, config.expname)
        os.makedirs(self.output_dir, exist_ok=True)
        self.ckpt_manager = CheckpointManager(os.path.join(self.output_dir, "model"))
        self.aabb = torch.tensor(config.aabb, dtype=torch.float32, device=self.device)

        self.model = model if model is not None else make_reg_model(
            config, torch.bfloat16 if config.bf16 else torch.float32)
        self.grid_resolution = int(train_dataset[0]["src_grid"].shape[0])
        rng = np.random.default_rng(config.seed)
        self.model.load_state_dict(params_from_jax(random_jax_params(self.model, rng),
                                                   self.model))
        self.model.to(self.device)
        self.infonce_W = L.init_infonce_W(rng, self.model.d_model,
                                          device=self.device).requires_grad_(True)
        self.param_keys = [k for k, _ in self.model.named_parameters()]
        self.optimizer = GuardedAdamW([*self.model.parameters(), self.infonce_W], config.lr)
        if self.mesh is not None:
            self.mesh.broadcast_(self.optimizer.flat)
        self.iteration = 0
        self.on_validate = None  # optional (iteration, score) callback after a validation
        self.train_deadline = None  # optional wall-clock end of train(), epoch seconds

        self.log_txt = os.path.join(self.output_dir, "log.txt")
        self.log_path = os.path.join(self.output_dir, "log.jsonl")
        self.logger = ScalarLogger(os.path.join(config.out_dir, "logs", config.expname),
                                   enable_tensorboard=config.enable_tensorboard)
        self.pose_viz = None
        if config.enable_visdom:
            from dregnerf_tpu_torch.utils.pose_server import PoseVizServer

            self.pose_viz = PoseVizServer(port=config.visdom_port)
            print(f"[reg_trainer] live pose viewer at http://127.0.0.1:{self.pose_viz.port}/",
                  flush=True)
        self._vis_cache: "OrderedDict[str, object]" = OrderedDict()
        self._vis_cache_size = int(config.vis_cache_size)
        self._vis_static = None  # (model_cfg, rcfg) of the first NeRF checkpoint
        self._dev_cache: "OrderedDict[str, tuple]" = OrderedDict()
        self._dev_cache_size = int(config.reg_device_cache)
        self._dev_uploads = 0
        self._dev_evictions = 0
        self._aug_gen = torch.Generator(device=self.device).manual_seed(config.seed + 77)

    def set_lr_schedule(self, schedule: dict) -> None:
        """A fresh optimizer over the parameters under the {step: scale}
        schedule, with zero moments and counts (what JAX's experiment does
        when it swaps in its run-sized chain and rebuilds its step)."""
        from dregnerf_tpu_torch.runtime.reg_optim import GuardedAdamW

        self._graph = None  # it updates the old optimizer's state
        self.optimizer = GuardedAdamW(self.optimizer.leaves, self.config.lr, schedule)

    # ----------------------------------------------------------------- steps
    def _step(self, batches, visibility_fns=None, warped_visibility_fns=None,
              solve_pose: bool = True) -> Dict:
        """Forward, losses and backward over the pairs `batches`, then the
        guarded update; the metrics as 0-dim device tensors. With
        `solve_pose` False (the CUDA graph's body) the first pair's Kabsch
        moments, `pose_moments`, stand where R_error and t_error would."""
        grad, total, losses, pose = self.pair_grads(batches, visibility_fns,
                                                    warped_visibility_fns, solve_pose)
        with profiling.annotate("regtr.optimizer"):
            finite = self.optimizer.step(grad, total)
            errors = (self.pose_metrics(pose, batches[0]["pose"]) if solve_pose
                      else {"pose_moments": pose})
        return {**losses, "total": total, **errors,
                "skipped_nonfinite": (~finite).to(torch.float32)}

    @staticmethod
    def pose_metrics(pose: torch.Tensor, pose_gt: torch.Tensor) -> Dict:
        """R_error (degrees) and t_error of a predicted [3, 4] pose."""
        rre, rte = se3.pose_error(pose.float(), pose_gt[:3, :4])
        return {"R_error": rre, "t_error": rte}

    def pair_grads(self, batches, visibility_fns=None, warped_visibility_fns=None,
                   solve_pose: bool = True):
        """Forward, losses and backward over the pairs `batches`: (the flat
        gradient of their mean total, the total, the losses (means over the
        pairs), the first pair's predicted pose, or with `solve_pose` False
        its per-layer Kabsch moments)."""
        n = len(batches)
        leaves = self.optimizer.leaves
        grad, totals, all_losses, pose = None, [], [], None
        for batch in batches:
            total, losses, pred = compute_losses(
                self.model, self.infonce_W, batch, self.aabb, self.grid_resolution,
                self.config.robust_loss, visibility_fns, warped_visibility_fns, solve_pose)
            with profiling.annotate("regtr.backward"):
                g = self.optimizer.flat_grad(torch.autograd.grad(
                    total / n if n > 1 else total, leaves))
            grad = g if grad is None else grad + g
            totals.append(total.detach())
            all_losses.append({k: v.detach() for k, v in losses.items()})
            if pose is None:
                pose = (pred["pose"][-1].detach() if solve_pose
                        else tuple(m.detach() for m in pred["pose_moments"]))
        total = totals[0] if n == 1 else torch.stack(totals).mean()
        losses = all_losses[0] if n == 1 else {
            k: torch.stack([ls[k] for ls in all_losses]).mean() for k in all_losses[0]}
        return grad, total, losses, pose

    def _to_device_cached(self, item: Dict) -> Dict[str, torch.Tensor]:
        """The batch of an item with cache keys: `_cached_sides` and the pose."""
        return {**self._cached_sides(item),
                "pose": torch.as_tensor(item["pose"], device=self.device)}

    def _cached_sides(self, item: Dict) -> Dict[str, torch.Tensor]:
        """The grids and masks of an item with cache keys, LRU-cached on the
        device (uploaded once per block while it stays cached)."""
        def dev(key, grid, mask):
            hit = self._dev_cache.pop(key, None)
            if hit is None:
                hit = (torch.as_tensor(grid, device=self.device),
                       torch.as_tensor(mask, device=self.device))
                self._dev_uploads += 1
            self._dev_cache[key] = hit
            while len(self._dev_cache) > max(self._dev_cache_size, 1):
                self._dev_cache.popitem(last=False)
                self._dev_evictions += 1
                if self._dev_evictions == 1:
                    print(f"[reg_trainer] device grid cache evicting (size "
                          f"{self._dev_cache_size}): raise --reg_device_cache to hold every "
                          "block", flush=True)
            return hit

        sg, sm = dev(item["src_cache_key"], item["src_grid"], item["src_mask"])
        tg, tm = dev(item["tgt_cache_key"], item["tgt_grid"], item["tgt_mask"])
        return {"src_grid": sg, "src_mask": sm, "tgt_grid": tg, "tgt_mask": tm}

    def _jitter(self, aug: Dict) -> tuple[float, float]:
        """The (scale, clip) of an item's jitter; scale 0 when it asks for none."""
        ds = self.train_dataset
        js = float(getattr(ds, "jitter_scale", 0.005)) if aug.get("jitter", True) else 0.0
        return js, float(getattr(ds, "jitter_clip", 0.05))

    def _augment(self, batch: Dict, aug: Dict) -> Dict:
        """`device_augment` of both sides (jitter noise from the trainer's
        device generator unless the item asks for no jitter)."""
        from dregnerf_tpu_torch.datasets.register_pairs import device_augment

        js, clip = self._jitter(aug)
        out = dict(batch)
        for side in ("src", "tgt"):
            grid, mask = batch[f"{side}_grid"], batch[f"{side}_mask"]
            noise = (torch.randn(mask.shape[0], 3, generator=self._aug_gen, device=self.device)
                     if js else None)
            p = torch.as_tensor(aug[f"p_{side}"], device=self.device)
            out[f"{side}_grid"] = device_augment(grid, mask, p, noise, js, clip)
        return out

    def _get_vis_ctx(self, path: str):
        """LRU-cached VisibilityContext of one NeRF checkpoint; every
        checkpoint must share the first one's model and render configs."""
        from dregnerf_tpu_torch.losses.visibility import load_visibility_context

        if path in self._vis_cache:
            self._vis_cache.move_to_end(path)
            return self._vis_cache[path]
        ctx, model_cfg, rcfg = load_visibility_context(
            path, int(self.config.vis_max_cameras), self.device)
        if self._vis_static is None:
            self._vis_static = (model_cfg, rcfg)
        elif self._vis_static != (model_cfg, rcfg):
            raise ValueError(f"NeRF checkpoint {path} has configs {(model_cfg, rcfg)} != "
                             f"fleet configs {self._vis_static}; exact visibility needs a "
                             "config-homogeneous NeRF fleet")
        self._vis_cache[path] = ctx
        while len(self._vis_cache) > self._vis_cache_size:
            self._vis_cache.popitem(last=False)
        return ctx

    def _exact_step(self, batch: Dict, item: Dict) -> Dict:
        """A step with labels marched through the blocks' NeRFs (the
        warped keypoints take the voxel-mask labels unless
        --vis_exact_warped); guarded like every step."""
        ctxs = [self._get_vis_ctx(item[f"{side}_nerf_path"]) for side in ("src", "tgt")]
        vis_fns = exact_visibility_fns([(c, *self._vis_static) for c in ctxs],
                                       int(self.config.vis_buffer_size))
        warped = None
        if not self.config.vis_exact_warped:
            warped = tuple((lambda pts, s=side: grid_visibility(
                pts, batch[f"{s}_mask"], self.aabb, self.grid_resolution))
                for side in ("src", "tgt"))
        return self._step([batch], vis_fns, warped)

    def train_iteration(self, item: Dict) -> Dict:
        """One step on the pair `item`; under --mesh_shape, this rank's pair
        of the step (parallel/regtr_dp.py)."""
        cached = "aug" in item  # a get_raw item: the device-cached path
        with profiling.annotate("regtr.step"):
            if cached and self._graphed():
                return self._graph_step(item)
            with profiling.annotate("regtr.inputs"):
                batch = (self._augment(self._to_device_cached(item), item["aug"]) if cached
                         else to_device(item, self.device))
            if cached:
                return self._step([batch])
            if self.visibility == "exact":
                return self._exact_step(batch, item)
            if self.mesh is not None:
                from dregnerf_tpu_torch.parallel.regtr_dp import dp_reg_step

                return dp_reg_step(self.mesh, self, batch)
            return self._step([batch])

    def _graphed(self) -> bool:
        """Whether the device-cached step runs as a CUDA graph: on the card, at
        batch 1, with grid labels and no mesh."""
        return (torch.device(self.device).type in reg_graph.DEVICE_TYPES
                and self.batch_size == 1 and self.mesh is None and self.visibility != "exact")

    def _graph_step(self, item: Dict) -> Dict:
        """The device-cached step as a replay of its CUDA graph, captured anew
        when its inputs' shapes, the jitter or the optimizer change."""
        with profiling.annotate("regtr.inputs"):
            sides, matrices = self._cached_sides(item), reg_graph.matrices(item)
            jitter = self._jitter(item["aug"])
            g = self._graph
            if (g is None or g.optimizer is not self.optimizer
                    or g.key != reg_graph.key(sides, matrices, jitter)):
                self._graph = None  # the old graph's memory goes first
                g = self._graph = reg_graph.StepGraph(self, sides, matrices, jitter)
            g.fill(sides, matrices, self._aug_gen)
        return g.step(self)

    def train_iteration_batch(self, items) -> Dict:
        """One step over several pairs (the gradient of their mean loss)."""
        return self._step([to_device(it, self.device) for it in items])

    @torch.inference_mode()
    def _eval(self, batch: Dict):
        pose = self.model(batch)["pose"][-1]
        rre, rte = se3.pose_error(pose.float(), batch["pose"][:3, :4])
        return pose, rre, rte

    # ------------------------------------------------------------------ loop
    def train(self) -> None:
        cfg = self.config
        max_iterations = cfg.epochs * max(len(self.train_dataset), 1)
        self.load_checkpoint()
        rng = np.random.default_rng(cfg.seed)
        t0 = time.time()
        score: Optional[float] = None  # no validation yet: never "best"
        bsz = self.batch_size if self.mesh is None else self.mesh.size  # one pair a rank
        if bsz > 1:
            n_pairs = len(self.train_dataset)
            if n_pairs < bsz:
                raise ValueError(f"batched RegTr training needs >= {bsz} train pairs, got "
                                 f"{n_pairs}; shrink --reg_batch_size or add scenes")
            if n_pairs % bsz:
                print(f"[reg_trainer] dropping {n_pairs % bsz}/{n_pairs} remainder pairs per "
                      f"epoch (batch size {bsz})", flush=True)
        use_raw = (bsz == 1 and self.visibility != "exact" and self.mesh is None
                   and self._dev_cache_size > 0 and hasattr(self.train_dataset, "get_raw"))
        fetch = self.train_dataset.get_raw if use_raw else self.train_dataset.__getitem__
        if use_raw:
            print(f"[reg_trainer] device-resident grid cache on (<= {self._dev_cache_size} "
                  "blocks, augmentation on the device)", flush=True)
        deadline = self.train_deadline
        window = profiling.StepWindow(cfg.profile_steps,
                                      os.path.join(self.output_dir, "profile"))
        with Watchdog(cfg.watchdog_s, name=cfg.expname) as wd, window:
            while self.iteration < max_iterations:
                if deadline is not None and time.time() >= deadline:
                    print(f"[reg_trainer] train deadline reached at iteration "
                          f"{self.iteration}/{max_iterations}: stopping early", flush=True)
                    break
                order = rng.permutation(len(self.train_dataset))
                if bsz > 1:
                    order = order[: len(order) - len(order) % bsz].reshape(-1, bsz)
                for i in order:
                    if self.mesh is not None:  # this rank's pair only is read
                        i = i[self.mesh.rank]
                    window.begin(self.iteration)
                    if i.ndim:
                        metrics = run_with_retries(
                            lambda i=i: self.train_iteration_batch(
                                [self.train_dataset[int(j)] for j in i]),
                            on_failure=lambda exc: self.save_checkpoint())
                    else:
                        metrics = run_with_retries(
                            lambda i=i: self.train_iteration(fetch(int(i))),
                            on_failure=lambda exc: self.save_checkpoint())
                    window.end(self.iteration)
                    self.iteration += 1
                    if self.iteration % cfg.n_tensorboard == 0:
                        self.log_scalars(metrics, time.time() - t0)
                    if self.iteration % cfg.n_validation == 0:
                        if is_main(self.mesh):
                            score = self.validate()
                            if self.on_validate is not None:
                                try:  # bookkeeping must not stop training
                                    self.on_validate(self.iteration, score)
                                except Exception as exc:  # noqa: BLE001
                                    print(f"[reg_trainer] on_validate failed: {exc}",
                                          flush=True)
                        barrier(self.mesh)
                    if self.iteration % cfg.n_checkpoint == 0:
                        self.save_checkpoint(score)
                        barrier(self.mesh)
                    if self.iteration >= max_iterations:
                        break
                    if deadline is not None and time.time() >= deadline:
                        break
                    wd.beat()
        self.save_checkpoint(score)
        barrier(self.mesh)

    def validate(self, fraction: float | None = None) -> float:
        """Mean RRE/RTE over a random subsample of the val pairs (default
        --val_fraction), both block orders when the dataset can fix them;
        returns -mean(RRE), the model_best score."""
        n = len(self.val_dataset)
        if n == 0:
            return 0.0
        if fraction is None:
            fraction = float(self.config.val_fraction)
        rng = np.random.default_rng(self.iteration)
        ids = rng.choice(n, max(1, int(n * fraction)), replace=False)
        both = hasattr(self.val_dataset, "meta")
        orders = [(0, 1), (1, 0)] if both else [None]
        rres, rtes = [], []
        viz_pair = None
        for i in ids:
            for order in orders:
                if order is not None:
                    self.val_dataset.fixed_order = order
                item = self.val_dataset[int(i)]
                if "src_cache_key" in item and self._dev_cache_size > 0:
                    batch = self._to_device_cached(item)
                else:
                    batch = to_device(item, self.device)
                pose, rre, rte = self._eval(batch)
                if viz_pair is None:
                    viz_pair = (batch, pose)
                rres.append(float(rre))
                rtes.append(float(rte))
            if both:
                self.val_dataset.fixed_order = None
        if self.pose_viz is not None and viz_pair is not None:
            self._push_pose_viz(*viz_pair)
        line = (f"[val] iter {self.iteration} RRE {np.mean(rres):.3f} deg (med "
                f"{np.median(rres):.3f}) RTE {np.mean(rtes):.4f} (med {np.median(rtes):.4f}) "
                f"over {len(rres)} pairs")
        self._log_line(line)
        return -float(np.mean(rres))

    def _push_pose_viz(self, batch: Dict, pose_pred: torch.Tensor) -> None:
        """The live registration view: the tgt cloud (gray), the src cloud
        under the ground-truth transform (blue) and under the prediction
        (magenta), and the two transforms as frusta joined by their centres'
        segment. The clouds are the voxel centres of the masks' indices as
        the masks come, flat [R^3], which is what the JAX package draws."""
        from dregnerf_tpu_torch.utils.pose_server import point_trace, visualize_cameras

        a = self.aabb.cpu().numpy().reshape(-1)
        res = self.grid_resolution

        def centers(mask):
            idx = np.argwhere(mask.cpu().numpy())
            return (idx + 0.5) / res * (a[3:] - a[:3])[None] + a[:3][None]

        def xf(T, pts):
            return pts @ T[:3, :3].T + T[:3, 3][None]

        gt = batch["pose"].float().cpu().numpy()
        pred = pose_pred.float().cpu().numpy()
        src, tgt = centers(batch["src_mask"]), centers(batch["tgt_mask"])
        traces = [
            point_trace(tgt, "#999999", seed=1),
            point_trace(xf(gt, src), "#4488ff", seed=2),
            point_trace(xf(pred, src), "#ff44cc", seed=2),
        ]
        visualize_cameras(self.pose_viz, self.iteration, poses=[gt, pred], cam_depth=0.15,
                          colors=("#4488ff", "#ff44cc"), extra_traces=traces)

    def _log_line(self, line: str) -> None:
        print(line, flush=True)
        with open(self.log_txt, "a") as f:
            f.write(line + "\n")

    def log_scalars(self, metrics: Dict, elapsed: float) -> None:
        values = {k: float(v) for k, v in metrics.items()}
        if not is_main(self.mesh):
            return
        self._log_line(f"iter {self.iteration} | "
                       + " | ".join(f"{k} {v:.4f}" for k, v in values.items())
                       + f" | {elapsed:.1f}s")
        with open(self.log_path, "a") as f:
            f.write(json.dumps({"iter": self.iteration, **values, "elapsed": elapsed}) + "\n")
        if self.logger.writer is not None:
            for k, v in values.items():
                self.logger.writer.add_scalar(f"train/{k}", v, self.iteration)

    # ----------------------------------------------------------- checkpoints
    def _state_tree(self, flat: torch.Tensor) -> dict:
        """{"model": flax tree, "infonce_W": array} of a flat tensor in the
        optimizer's layout (parameters, mu or nu)."""
        from dregnerf_tpu_torch.models.regtr import params_to_jax

        *views, w = self.optimizer.split(flat)
        return {"model": params_to_jax(self.model, dict(zip(self.param_keys, views))),
                "infonce_W": np.array(w.detach().cpu())}

    def _load_flat(self, flat: torch.Tensor, ckpt: Dict[str, np.ndarray], prefix: str) -> None:
        """Fill a flat optimizer-layout tensor from the checkpoint tree under
        `prefix` (`<prefix>model/...` and `<prefix>infonce_W`)."""
        from dregnerf_tpu_torch.models.regtr import params_from_jax
        from dregnerf_tpu_torch.runtime.checkpoint import tree_under

        state = params_from_jax(tree_under(ckpt, prefix + "model/"), self.model)
        *views, w = self.optimizer.split(flat)
        with torch.no_grad():
            for key, view in zip(self.param_keys, views):
                view.copy_(state[key])
            w.copy_(torch.as_tensor(ckpt[prefix + "infonce_W"]))

    def save_checkpoint(self, score: Optional[float] = None) -> None:
        """Step-stamped, latest and (score given and best) best copies; score
        None never touches model_best.ckpt (scores are -RRE, negative).
        Written by rank 0 only under --mesh_shape."""
        if not is_main(self.mesh):
            return
        opt = self.optimizer
        state = {
            "params": self._state_tree(opt.flat),
            "optimizer": {"1": {
                "0": {"count": opt.count.cpu().numpy(), "mu": self._state_tree(opt.mu),
                      "nu": self._state_tree(opt.nu)},
                "2": {"count": opt.schedule_count.cpu().numpy()}}},
        }
        meta = {
            "aabb": self.aabb.cpu().tolist(),
            "grid_resolution": self.grid_resolution,
            "d_model": self.config.position_embedding_dim,
            "num_downsample": self.config.num_downsample,
        }
        self.ckpt_manager.save(self.iteration, state, meta, score)

    def load_checkpoint(self) -> None:
        """Resume from --ckpt_path, else the latest copy, if there is one:
        the parameters, the optimizer state unless --no_load_opt, the step."""
        from dregnerf_tpu_torch.runtime.checkpoint import load_checkpoint

        path = self.ckpt_manager.resolve(self.config.ckpt_path)
        if path is None:
            return
        flat, meta = load_checkpoint(path)
        opt = self.optimizer
        self._load_flat(opt.flat, flat, "params::")
        if not self.config.no_load_opt:
            self._load_flat(opt.mu, flat, ADAM_PREFIX + "mu/")
            self._load_flat(opt.nu, flat, ADAM_PREFIX + "nu/")
            opt.count.fill_(int(flat[ADAM_PREFIX + "count"]))
            opt.schedule_count.fill_(int(flat[SCHEDULE_COUNT_KEY]))
        self.iteration = int(meta["step"])
        print(f"resumed RegTrainer from iteration {self.iteration}", flush=True)
