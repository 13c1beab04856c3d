"""Per-block radiance-field training runtime (port of
dregnerf_tpu/runtime/ngp_trainer.py).

The field is `--field`'s family (models/fields.py): Instant-NGP (the
default; `NGPConfig` with the packed grid, or with Instant-NGP's published
xor-hash grid, `HashGridConfig()`, under `--encoder xor_hash`), or the
8x256 vanilla MLP, with
the D-NeRF warp under "dnerf" (bf16 operands unless --no_bf16). A scene
with `timestamps` (the dnerf loader) gives each ray its image's time.

One step: sample pixels, blend synthetic RGBA over a random background,
generate rays, march + render with stratified jitter, Huber loss over the
alive rays, backward (the packed table's gradient goes through kernel K1
or K1p and, at coarse levels, the run-length backward, as `grad_accum` and
`rle_backward` say, ops/packed_grid.py; the hash table's through K6,
ops/hash_encoding.py), Adam (lr 1e-2, eps 1e-15) under the x0.33
multistep schedule at {1/2, 3/4, 9/10} of training. Every 16 steps the
occupancy grid gets an EMA update (all cells below step 256). The ray
bucket follows the sample budget in powers of two, from a count read back
once every 8 steps with one interval of lag, so the host never waits for
the step it just queued.

The step's random draws (`StepDraws`) are tensors; the trainer draws them
on the device from its own `torch.Generator`. On one CUDA device with no
mesh the step from the draws to Adam's update is one CUDA graph per ray
bucket (runtime/ngp_graph.py): the occupancy update writes the grid in
place, and the draws and the learning rate go into the graph's static
inputs before each replay; `graph_captures` and `graph_replays` count
its captures and replays. `train()` runs each step
through the retry wrapper (an emergency checkpoint on a fatal error) under
the hang watchdog (`--watchdog_s`; runtime/resilience.py). Scalars go to
the ScalarLogger (the printed line, log.txt, and tensorboard with
`--enable_tensorboard`) and to log.jsonl.

With `--mesh_shape N` (N ranks under torchrun) each step is the
data-parallel step of parallel/ngp_dp.py: rank 0's initial weights are
broadcast, each rank draws `num_rays // N` rays from a generator of its
own, the occupancy update draws from the trainer's generator (the same on
every rank), and only rank 0 logs, validates and writes checkpoints while
the others wait at a barrier. The fleet of blocks is
runtime/fleet_trainer.py.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from dregnerf_tpu_torch.datasets.base import SceneData
from dregnerf_tpu_torch.device import resolve_device
from dregnerf_tpu_torch.geometry.cameras import image_rays, rays_from_pixels
from dregnerf_tpu_torch.models import ngp
from dregnerf_tpu_torch.models.fields import get_field
from dregnerf_tpu_torch.models.mlp_nerf import VanillaNeRFConfig
from dregnerf_tpu_torch.ops import occupancy
from dregnerf_tpu_torch.ops.contraction import contract_inv
from dregnerf_tpu_torch.ops.hash_encoding import HashGridConfig
from dregnerf_tpu_torch.ops.packed_grid import PackedGridConfig
from dregnerf_tpu_torch.parallel.mesh import barrier, is_main, mesh_and_device
from dregnerf_tpu_torch.render.renderer import (
    RenderConfig,
    render_image_chunked,
    render_rays,
)
from dregnerf_tpu_torch.runtime.checkpoint import (
    CheckpointManager,
    leaves_with_paths,
    load_checkpoint,
    unflatten,
)
from dregnerf_tpu_torch.runtime import ngp_graph, profiling
from dregnerf_tpu_torch.runtime.logging import ScalarLogger
from dregnerf_tpu_torch.runtime.resilience import Watchdog, run_with_retries

OCC_UPDATE_INTERVAL = 16
OCC_WARMUP_STEPS = 256
BATCH_SYNC_INTERVAL = 8
OCC_EVAL_CHUNK = 1 << 16
BASE_LR = 1e-2


def huber(x: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """smooth_l1, elementwise."""
    absx = x.abs()
    return torch.where(absx < delta, 0.5 * x * x / delta, absx - 0.5 * delta)


def mse_to_psnr(x: torch.Tensor) -> torch.Tensor:
    return -10.0 / math.log(10.0) * torch.log(x)


def multistep_lr(base_lr: float, max_steps: int, gamma: float = 0.33) -> Callable[[int], float]:
    """Learning rate of update i (0-based): base_lr times gamma for every
    boundary floor(max_steps * {0.5, 0.75, 0.9}) <= i (boundaries that
    coincide count once, as in the reference's dict of boundaries)."""
    bounds = {int(max_steps * 0.5): gamma, int(max_steps * 0.75): gamma,
              int(max_steps * 0.9): gamma}

    def lr(i: int) -> float:
        return base_lr * math.prod(g for b, g in bounds.items() if i >= b)

    return lr


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """`lr` into every parameter group; a device learning rate (a CUDA
    graph's) is written in place."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


class StepDraws(NamedTuple):
    """The random inputs of one training step."""

    img_id: torch.Tensor  # [R] int64
    x: torch.Tensor  # [R] int64
    y: torch.Tensor  # [R] int64
    bg: torch.Tensor  # [3] f32
    jitter: torch.Tensor  # [R, 1] f32


def draw_spec(num_rays: int) -> StepDraws:
    """The (shape, dtype) of each of a step's draws at `num_rays` rays."""
    ray = ((num_rays,), torch.int64)
    return StepDraws(img_id=ray, x=ray, y=ray, bg=((3,), torch.float32),
                     jitter=((num_rays, 1), torch.float32))


def draw_step_inputs(generator: torch.Generator, num_rays: int, num_images: int,
                     height: int, width: int, device,
                     out: StepDraws | None = None) -> StepDraws:
    """A step's draws from `generator`; with `out` (draws of num_rays rays),
    drawn into its tensors, in the same order from the same stream."""
    out = out or StepDraws(*(None,) * len(StepDraws._fields))

    def randint(high, buf):
        return torch.randint(0, high, (num_rays,), generator=generator, device=device, out=buf)

    return StepDraws(
        img_id=randint(num_images, out.img_id), x=randint(width, out.x),
        y=randint(height, out.y),
        bg=torch.rand(3, generator=generator, device=device, out=out.bg),
        jitter=torch.rand(num_rays, 1, generator=generator, device=device, out=out.jitter))


def step_loss(params, model_config, render_config: RenderConfig,
              grid: occupancy.OccupancyGrid, aabb: torch.Tensor, images: torch.Tensor,
              c2ws: torch.Tensor, K: torch.Tensor, draws: StepDraws,
              synthetic: bool, opengl: bool, field=ngp,
              timestamps: torch.Tensor | None = None):
    """(loss, metrics) of one step: Huber over alive rays / (n_alive * 3).
    With `timestamps` [N_img], each ray renders at its image's time."""
    with profiling.annotate("ngp.rays"):
        rgba = images[draws.img_id, draws.y, draws.x].to(torch.float32) / 255.0
        if synthetic:
            pixels = rgba[:, :3] * rgba[:, 3:4] + draws.bg * (1.0 - rgba[:, 3:4])
        else:
            pixels = rgba[:, :3]
        rays = rays_from_pixels(draws.x, draws.y, K, c2ws[draws.img_id], opengl)
    out, aux = render_rays(params, model_config, grid, rays.origins, rays.viewdirs,
                           aabb, render_config, background=draws.bg,
                           stratified=True, jitter=draws.jitter, device=aabb.device,
                           field=field,
                           times=None if timestamps is None else timestamps[draws.img_id])
    profiling.count("ngp.live_samples", aux["n_samples"])
    profiling.count("ngp.sample_buffer", aux["buffer_rows"])
    with profiling.annotate("ngp.loss"):
        alive = (aux["ray_counts"] > 0).to(torch.float32)
        n_alive = alive.sum()
        denom = torch.clamp(n_alive, min=1.0) * 3.0
        diff = out.rgb - pixels
        loss = (huber(diff) * alive[:, None]).sum() / denom
        sq = (diff.detach() ** 2 * alive[:, None]).sum() / denom
        psnr = mse_to_psnr(sq)
    return loss, {"psnr": psnr, "sq": sq, "n_samples": aux["n_samples"],
                  "alive_rays": n_alive}


def _host_reader(t: torch.Tensor) -> Callable[[], int]:
    """Start copying scalar `t` to the host; the returned call waits for
    that copy only (not for work queued after it) and gives its value."""
    if t.device.type != "cuda":
        return lambda: int(t)
    host = torch.empty((), dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def read() -> int:
        done.synchronize()
        return int(host)

    return read


class NGPTrainer:
    """Trains one NeRF block on `device` (default cuda, see
    dregnerf_tpu_torch.device; `config.device` is read when the argument
    is None). On one CUDA device with no mesh the step runs as a CUDA
    graph (runtime/ngp_graph.py); `graph_captures` and `graph_replays`
    count its captures and replays, and `replayed_launches` what the
    replays ran of each kernel (derived from what each graph's recording
    launched: a replay runs no kernel wrapper)."""

    _graph = None  # the single-device step's ngp_graph.StepGraphs
    graph_captures = 0
    graph_replays = 0
    replayed_launches: dict = {}  # replaced, never changed in place

    def __init__(self, config, scene: SceneData, val_scene: Optional[SceneData] = None,
                 output_dir: Optional[str] = None, device=None):
        self.mesh, self.device = mesh_and_device(config, device)  # no mesh unless --mesh_shape
        self.config = config
        self.scene = scene
        self.val_scene = val_scene
        self.output_dir = output_dir or os.path.join(config.out_dir, config.expname)
        os.makedirs(self.output_dir, exist_ok=True)
        self.ckpt_manager = CheckpointManager(os.path.join(self.output_dir, "model"))
        self.generator = torch.Generator(device=self.device).manual_seed(config.seed)
        # the rays' draws: the trainer's generator on one device, a stream
        # of each rank's own under --mesh_shape
        self.ray_generator = self.generator if self.mesh is None else torch.Generator(
            device=self.device).manual_seed(config.seed + 1 + self.mesh.rank)

        self.setup_bounding_box()
        self.build_networks()
        if self.mesh is not None:
            for p in leaves_with_paths(self.params).values():
                self.mesh.broadcast_(p.data)
        self.setup_optimizer()
        dev = self.device
        self.images = torch.as_tensor(scene.images, device=dev)  # uint8, resident
        self.c2ws = torch.as_tensor(scene.camtoworlds, dtype=torch.float32, device=dev)
        self.K = torch.as_tensor(scene.K, dtype=torch.float32, device=dev)
        ts = getattr(scene, "timestamps", None)
        self.timestamps = None if ts is None else torch.as_tensor(
            ts, dtype=torch.float32, device=dev)
        self.num_rays = int(config.init_num_rays)
        self.step = 0
        self._pending_n_samples = None
        self.log_path = os.path.join(self.output_dir, "log.jsonl")
        self.logger = ScalarLogger(os.path.join(config.out_dir, "logs", config.expname),
                                   text_path=os.path.join(self.output_dir, "log.txt"),
                                   enable_tensorboard=config.enable_tensorboard)

    # ------------------------------------------------------------------ setup
    def setup_bounding_box(self) -> None:
        cfg = self.config
        aabb = np.asarray(cfg.aabb, np.float32)
        self.aabb = torch.as_tensor(aabb, device=self.device)
        self.contraction = "un_bounded_sphere" if cfg.unbounded else "aabb"
        diag = float(np.linalg.norm(aabb[3:] - aabb[:3]))
        self.render_step_size = diag / cfg.max_march_steps
        self.near_plane = getattr(self.scene, "near", 0.0) or 0.0
        self.far_plane = getattr(self.scene, "far", 1e10) or 1e10

    def build_networks(self) -> None:
        cfg = self.config
        self.field = get_field(cfg.field)
        dtype = torch.bfloat16 if cfg.bf16 else torch.float32
        if cfg.field == "ngp" and cfg.encoder == "xor_hash":
            self.model_config = ngp.NGPConfig(grid=HashGridConfig(), unbounded=cfg.unbounded,
                                              compute_dtype=dtype)
        elif cfg.field == "ngp":
            rle_step_u = 0.0
            if cfg.rle_backward and not cfg.unbounded:
                extent = float(np.min(np.asarray(cfg.aabb, np.float32)[3:]
                                      - np.asarray(cfg.aabb, np.float32)[:3]))
                rle_step_u = self.render_step_size / max(extent, 1e-9)
            self.model_config = ngp.NGPConfig(
                grid=PackedGridConfig(grad_accum=cfg.grad_accum, rle_step_u=rle_step_u),
                unbounded=cfg.unbounded, compute_dtype=dtype)
        else:
            self.model_config = VanillaNeRFConfig(warp=cfg.field == "dnerf",
                                                  compute_dtype=dtype)
        self.init_params(torch.Generator(device=self.device).manual_seed(cfg.seed))
        self.grid = occupancy.init_grid(cfg.grid_resolution, self.device)
        self.render_config = RenderConfig(
            contraction=self.contraction,
            render_step_size=self.render_step_size,
            buffer_size=cfg.sample_budget,
            max_steps=cfg.max_march_steps,
            near_plane=self.near_plane,
            far_plane=self.far_plane,
            chunk_size=cfg.test_chunk_size,
            march_compaction=cfg.march_compaction or "capped",
            k_cap=min(512, cfg.max_march_steps),
        )

    def init_params(self, generator: torch.Generator) -> None:
        """Random weights of `model_config`'s field, as trainable leaves."""
        self.params = self.field.init(self.model_config, generator, self.device)
        for p in leaves_with_paths(self.params).values():
            p.requires_grad_(True)

    def setup_optimizer(self) -> None:
        self.lr_at = multistep_lr(BASE_LR, self.config.max_iterations)
        self.optimizer = torch.optim.Adam(leaves_with_paths(self.params).values(), lr=BASE_LR,
                                          betas=(0.9, 0.999), eps=1e-15)

    # ------------------------------------------------------------- train step
    def apply_gradients(self, step: int | None) -> None:
        """Adam update number `step` with the scheduled learning rate; None
        keeps the rate set (a CUDA graph's body, whose device learning rate
        is written before each replay)."""
        if step is not None:
            set_lr(self.optimizer, self.lr_at(step))
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)

    @torch.no_grad()
    def update_occupancy(self, step: int, **draws) -> None:
        """The EMA update of step `step` (warmup below OCC_WARMUP_STEPS),
        with the draws of occupancy.update_grid from the trainer's
        generator unless given, written in place into the grid's tensors
        (which a CUDA graph of the step reads)."""
        cfg = self.config
        params = self.field.prepare_params(self.params, self.model_config)

        # the density at no time: a D-NeRF field is not warped here
        def occ_fn(u: torch.Tensor) -> torch.Tensor:
            return torch.cat([
                self.field.query_density(params, contract_inv(c, self.aabb, self.contraction),
                                         self.aabb, self.model_config).reshape(-1)
                * self.render_step_size
                for c in u.split(OCC_EVAL_CHUNK)])

        grid = occupancy.update_grid(
            self.grid, occ_fn, warmup=step < OCC_WARMUP_STEPS,
            n_samples=min(cfg.grid_resolution**3 // 4, 1 << 17),
            generator=self.generator, **draws)
        self.grid.occs.copy_(grid.occs)
        self.grid.binary.copy_(grid.binary)

    def train_iteration(self, step: int, draws: StepDraws | None = None) -> dict:
        """One training step (on `draws`, else on rays drawn here: the
        bucket's, or this rank's share of it under --mesh_shape); returns
        its metrics as device tensors (plus the ray bucket it ran with)."""
        with profiling.annotate("ngp.step"):
            if step % OCC_UPDATE_INTERVAL == 0:
                with profiling.annotate("ngp.occupancy"):
                    self.update_occupancy(step)
            bucket = self.num_rays
            if ngp_graph.engages(self):
                if self._graph is None or self._graph.optimizer is not self.optimizer:
                    self._graph = None  # the old graphs' memory goes first
                    self._graph = ngp_graph.StepGraphs(self)
                metrics = self._graph.step(self, step, bucket, draws)
                self._feed_back(step, bucket, metrics["n_samples"])
                metrics["num_rays"] = bucket
                return metrics
            if draws is None:
                n = bucket if self.mesh is None else max(bucket // self.mesh.size, 1)
                draws = draw_step_inputs(self.ray_generator, n, self.scene.num_images,
                                         self.scene.height, self.scene.width, self.device)
            if self.mesh is None:
                loss, metrics = step_loss(
                    self.params, self.model_config, self.render_config, self.grid,
                    self.aabb, self.images, self.c2ws, self.K, draws,
                    self.scene.synthetic, self.scene.opengl, self.field, self.timestamps)
                with profiling.annotate("ngp.backward"):
                    loss.backward()
                metrics["loss"] = loss.detach()
            else:
                from dregnerf_tpu_torch.parallel.ngp_dp import dp_train_step

                metrics = dp_train_step(
                    self.mesh, self.params, self.model_config, self.render_config, self.grid,
                    self.aabb, self.images, self.c2ws, self.K, draws, self.scene.synthetic,
                    self.scene.opengl, self.field, self.timestamps)
            with profiling.annotate("ngp.optimizer"):
                self.apply_gradients(step)
                self._feed_back(step, bucket, metrics["n_samples"])
            metrics["num_rays"] = bucket
            return metrics

    def _feed_back(self, step: int, bucket: int, n_samples: torch.Tensor) -> None:
        """The ray bucket feedback, from the count saved at the previous
        sync (every BATCH_SYNC_INTERVAL steps; its host read waits for that
        copy only)."""
        if step % BATCH_SYNC_INTERVAL:
            return
        prev = self._pending_n_samples
        self._pending_n_samples = (bucket, _host_reader(n_samples))
        if prev is not None:
            prev_bucket, n = prev[0], prev[1]()
            if n > 0:
                ideal = prev_bucket * self.config.sample_budget / n
                new_bucket = 1 << int(round(math.log2(max(ideal, 1))))
                self.num_rays = int(np.clip(new_bucket, self.config.init_num_rays,
                                            self.config.max_num_rays))

    def train(self) -> None:
        """The step loop under the hang watchdog (a stale heartbeat exits the
        process with code 86 for a supervisor to resume it; --watchdog_s 0
        disables it); a step that fails for good saves a checkpoint first.
        The scalars' host read every n_tensorboard steps also keeps the
        heartbeat honest: a wedged device blocks there. The steps of
        --profile_steps run under profiling.trace (<output_dir>/profile)."""
        cfg = self.config
        start = self.load_checkpoint()
        t0 = time.time()
        window = profiling.StepWindow(cfg.profile_steps,
                                      os.path.join(self.output_dir, "profile"))
        with Watchdog(cfg.watchdog_s, name=cfg.expname) as wd, window:
            for step in range(start, cfg.max_iterations):
                window.begin(step)
                metrics = run_with_retries(lambda: self.train_iteration(step),
                                           on_failure=lambda exc: self.save_checkpoint(step))
                window.end(step)
                self.step = step + 1
                if step % cfg.n_tensorboard == 0:
                    self.log_scalars(step, {
                        "train/loss": float(metrics["loss"]),
                        "train/psnr": float(metrics["psnr"]),
                        "train/num_rays": metrics["num_rays"],
                        "train/n_samples": int(metrics["n_samples"]),
                        "train/alive_ray_mask": int(metrics["alive_rays"]),
                        "elapsed_s": time.time() - t0,
                    })
                if (step + 1) % cfg.n_validation == 0:
                    if is_main(self.mesh):
                        self.validate(step + 1)
                    barrier(self.mesh)
                if (step + 1) % cfg.n_checkpoint == 0 or step + 1 == cfg.max_iterations:
                    self.save_checkpoint(step + 1)
                    barrier(self.mesh)
                wd.beat()

    # ------------------------------------------------------------------ infra
    def log_scalars(self, step: int, scalars: dict) -> None:
        if not is_main(self.mesh):
            return
        self.logger.log_scalars(step, scalars)
        with open(self.log_path, "a") as f:
            f.write(json.dumps({"step": step, **scalars}) + "\n")

    def validate(self, step: int) -> float:
        """PSNR of view 0 of the validation scene (at its time, when the
        scene has timestamps), rendered with the rows marcher at
        test_chunk_size * min(256, max_steps) samples a chunk."""
        scene = self.val_scene or self.scene
        ts = getattr(scene, "timestamps", None)
        dev = self.device
        rays = image_rays(torch.as_tensor(scene.K, dtype=torch.float32, device=dev),
                          torch.as_tensor(scene.camtoworlds[0], dtype=torch.float32,
                                          device=dev),
                          scene.height, scene.width, scene.opengl)
        eval_cfg = dataclasses.replace(self.render_config, march_compaction="rows")
        rgb, _, _ = render_image_chunked(
            self.params, self.model_config, self.grid,
            rays.origins.reshape(-1, 3), rays.viewdirs.reshape(-1, 3), self.aabb,
            eval_cfg, torch.ones(3, device=dev),
            eval_buffer_size=self.config.test_chunk_size
            * min(256, self.render_config.max_steps),
            device=dev, field=self.field, time=None if ts is None else float(ts[0]))
        rgb = rgb.reshape(scene.height, scene.width, 3).cpu().numpy()
        gt = np.asarray(scene.images[0], np.float32) / 255.0
        if scene.synthetic:
            gt = gt[..., :3] * gt[..., 3:4] + np.ones(3) * (1 - gt[..., 3:4])
        val_psnr = -10.0 * math.log10(float(np.mean((rgb - gt) ** 2)))
        self.log_scalars(step, {"val/psnr": val_psnr})
        return val_psnr

    def compose_meta(self) -> dict:
        cfg = self.config
        return {
            "aabb": self.aabb.cpu().tolist(),
            "unbounded": bool(cfg.unbounded),
            "grid_resolution": cfg.grid_resolution,
            "contraction_type": self.contraction,
            "near_plane": self.near_plane,
            "far_plane": min(self.far_plane, 1e10),
            "render_step_size": self.render_step_size,
            "alpha_thre": 0.0,
            "cone_angle": cfg.cone_angle,
            "max_march_steps": int(cfg.max_march_steps),
            "num_rays": int(self.num_rays),
            "camera_poses": np.asarray(self.scene.camtoworlds).tolist(),
            "block_id": self.scene.block_id,
            "field": cfg.field,
            "model_config": (ngp.config_to_meta(self.model_config) if cfg.field == "ngp"
                             else {"warp": self.model_config.warp, "bf16": bool(cfg.bf16)}),
        }

    def _optimizer_tree(self) -> dict:
        """The Adam state in optax's layout (chain(scale_by_adam,
        scale_by_schedule)): `0/count`, `0/mu/<param>`, `0/nu/<param>` and
        `1/count`, so the JAX package resumes from it; empty before the
        first update."""
        paths = leaves_with_paths(self.params)
        state = {k: self.optimizer.state.get(p) for k, p in paths.items()}
        if not all(state.values()):
            return {}
        count = np.int32(int(next(iter(state.values()))["step"]))
        return {"0": {"count": count,
                      "mu": {k: s["exp_avg"] for k, s in state.items()},
                      "nu": {k: s["exp_avg_sq"] for k, s in state.items()}},
                "1": {"count": count}}

    def save_checkpoint(self, step: int, score: Optional[float] = None) -> None:
        """Written by rank 0 only under --mesh_shape."""
        if not is_main(self.mesh):
            return
        state = {
            "model": self.params,
            "occupancy": {"occs": self.grid.occs, "binary": self.grid.binary},
            "optimizer": self._optimizer_tree(),
        }
        self.ckpt_manager.save(step, state, self.compose_meta(), score)

    def load_checkpoint(self) -> int:
        """Resume from a checkpoint of either package (the optimizer state
        too, unless --no_load_opt or the checkpoint has none)."""
        path = self.ckpt_manager.resolve(self.config.ckpt_path)
        if path is None:
            return 0
        flat, meta = load_checkpoint(path)
        paths = leaves_with_paths(self.params)
        with torch.no_grad():
            for k, p in paths.items():
                p.copy_(torch.as_tensor(flat[f"model::{k}"], dtype=torch.float32))
        self._graph = None  # its graphs read the state replaced here
        if not self.config.no_load_opt and "optimizer::0/count" in flat:
            count = float(flat["optimizer::0/count"])
            # a capturable Adam (the CUDA graph's) keeps its counts on the device
            count_device = (self.device if self.optimizer.param_groups[0].get("capturable")
                            else "cpu")
            for k, p in paths.items():
                self.optimizer.state[p] = {
                    "step": torch.tensor(count, device=count_device),
                    **{name: torch.as_tensor(flat[f"optimizer::0/{m}/{k}"],
                                             dtype=torch.float32, device=self.device)
                       for name, m in (("exp_avg", "mu"), ("exp_avg_sq", "nu"))}}
        self.grid = occupancy.occupancy_from_numpy(
            flat["occupancy::occs"], flat["occupancy::binary"], self.device)
        self.num_rays = int(meta.get("num_rays", self.num_rays))
        print(f"resumed from step {meta['step']} (ray bucket {self.num_rays})",
              flush=True)
        return int(meta["step"])


def load_field_from_checkpoint(path: str, device=None):
    """(params, grid, meta, model_config, render_config) from one checkpoint
    written by either package, of any field family (meta["field"])."""
    dev = resolve_device(device)
    flat, meta = load_checkpoint(path)
    field_name = meta.get("field", "ngp")
    mc = dict(meta.get("model_config", {}))
    if field_name == "ngp":
        mc.setdefault("unbounded", bool(meta.get("unbounded", False)))
        model_cfg = ngp.config_from_meta(mc)
    else:
        model_cfg = VanillaNeRFConfig(
            warp=bool(mc.get("warp", field_name == "dnerf")),
            compute_dtype=torch.bfloat16 if mc.get("bf16", True) else torch.float32)
    params = get_field(field_name).params_from_jax(unflatten(flat, "model::"), dev)
    grid = occupancy.occupancy_from_numpy(flat["occupancy::occs"],
                                          flat["occupancy::binary"], dev)
    render_cfg = RenderConfig(
        contraction=meta["contraction_type"],
        render_step_size=float(meta["render_step_size"]),
        near_plane=float(meta.get("near_plane", 0.0) or 0.0),
        far_plane=float(meta.get("far_plane", 1e10) or 1e10),
        max_steps=int(meta.get("max_march_steps", 1024)),
    )
    return params, grid, meta, model_cfg, render_cfg
