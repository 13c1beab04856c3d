#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

  python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. the device: require CUDA, print the card's name and power limit;
  2. the build: compile every source of dregnerf_tpu_torch/csrc (nvcc for
     each kernel, g++ for the host C++ of FGR/RANSAC, all started
     together), and check in `cuobjdump -sass` that K1p
     issues one 16-byte bf16x8 reduction per 8 features;
  3. each kernel against its plain version at the main path's shapes
     (2^18 rows of 64 floats; tables of 4096 and 2^19 rows), with times,
     the memory-traffic bound and the one-call library time: K1 (f32
     scatter, ops/scatter_add.py), K1p (bf16 scatter, same module; per
     slot on random data, bit for bit on small integers; also its device
     time in the profiler and the wrapper's host time a call, and level 0's
     run-length call with its run count on the device) and
     K2p (row gather, ops/gather_rows.py); K2 (the packed encoder over its
     vertex table, ops/packed_grid.py) at L4F8 on 2^18 ray-coherent points:
     its forward, rows and unpack launches bit for bit against their plain
     versions, their times and bounds, the whole encoder's forward and
     backward against the pack path's, and a profiled forward and backward
     without any of PACK_PATH_KERNELS; and K6 (the xor-hash encoder's
     forward and table-gradient backward, ops/hash_encoding.py) at
     HashGridConfig() on 2^18 ray-coherent points: the forward within
     K6_TOL["out"] of the plain version's max, the backward within
     K6_TOL["grad"], its support (dL/denc = 1) equal to the corner rows of
     hash_corners with a nonzero weight, and its launch counts;
  4. small-input references: one tiny training step on the card against
     the same step on the CPU, under grad_accum "pallas" in f32 and at the
     CLI defaults (bf16 MLPs, grad_accum "bf16", the run-length backward on
     level 0); the CPU path is held against the JAX package by
     tests/test_torch_*.py;
  5. training at the CLI defaults at full width (L4F8, 2^19 tables,
     2^18-sample budget, 1024 march steps, 128^3 grid, bf16 MLPs,
     grad_accum "bf16" with the run-length backward at level 0) on the
     36-view 128 px fixture scene: 64 steps, 2 more (an occupancy update,
     and a step that may capture a new bucket's graph), 7 more under
     torch.profiler (the device's busy share and the kernels that take
     most of a step),
     one validate() render; every step a replay of the trainer's CUDA
     graph (runtime/step_graph.py, one capture a ray bucket), each steady
     step's (49-63, no occupancy update) graph recorded with 4 K1p launches
     and one of each of K2's, the host launching none outside a capture, no
     K2p or K1, no roll or K2p in the profiled steps, the
     run-length backward counted once a steady step, its overflow
     fallback counted; in the profiled steps the profiler counts on the
     device each port kernel as often as the replayed graphs' recordings
     launched it (this holds in every profiled phase);
  6. stage 2 on that block, trained on to step 1024: its checkpoint saved
     and loaded back through load_field_from_checkpoint,
     Evaluator.evaluate() on the test views, then Evaluator.sample_points()
     (voxel extraction over every occupied voxel from the training cameras,
     and the artifacts written), and a second surface pass over the same
     points for its rate and the scores;
  7. multi-block scenes (`multi-block`): the fixture split by the port's
     k-means into two blocks (labels checked against sklearn's, hard-coded
     here), each in its own world frame from world_frame_transforms.json
     (rigid, the cameras mapped within 1e-6, the spheres inside the aabb);
     both blocks trained to MB_STEPS through train_ngp_nerf.train_blocks
     at SHAPE_FLAGS (K1p 4 and K2 1/1/1 launches in every step without an
     occupancy update, K2's forward held bit for bit against its plain
     version in one step of each block, that step run eagerly),
     evaluated and extracted
     through eval_ngp_nerf.eval_blocks; the frame check (at least
     MB_FRAME_SHARE of block 0's surface voxels near block 1's under
     T1 T0^-1, at most MB_SWAPPED_SHARE under T0 T1^-1); the pair read
     by NeRFRegDataset with its pose from the written frames, and
     RegEvaluator.evaluate() with --icp_refine on seeded weights (the
     classical baseline's RRE/RTE on two NeRFs trained in their frames);
  8. novel views of that pair (`novel views`): one 100 x 100 frame of
     block 0 from its first training camera through synthesize_novel_views
     on the card and on the CPU (PSNR at least NV_PSNR_MIN, opacity over
     0.5 on at least NV_OPACITY_SHARE_MIN of the pixels), then
     RegEvaluator.evaluate() with --render_videos: every src, tgt and pair
     frame and depth of the gt, aligned and unaligned orbits on disk at
     its shape, the mp4 exactly when ffmpeg is on PATH, K2's forward
     launches counted, render_pair_views timed;
  9. the `compact` and `quota` training marchers (`marchers`): at 2^15 rays
     x 1024 steps and a 2^18 budget on a trained block's grid, the card
     against the CPU (equal samples, t_start within 1e-6), each one's
     cumsum timed; MARCH_STEPS full-width steps under each and
     under `capped` (finite losses, K1p 4 and K2 1/1/1 launches a step);
  9b. the fleet (`fleet`): the fixture's two k-means blocks trained
     together on the card through train_ngp_nerf.train_fleet (--multi_blocks
     --fleet) at SHAPE_FLAGS, FLEET_STEPS fleet steps at the CLI defaults:
     K1p 4 and K2 1/1/1 launches in every block-step, K2's forward bit for
     bit against its plain version at step 1 of block 0, each block's
     first step held against one NGPTrainer step from the same state on the
     same draws (loss 1e-3 relative, the table gradient within
     GRAD_NORM_TOL of its norm, MLP gradients within GRAD_NORM_TOL of their
     max), ms a fleet step and a
     block-step, the idle share of 8 profiled fleet steps, each block's val
     PSNR and checkpoint read back bit for bit;
 9c. the stage-3 fleet (`stage3 fleet`): the twin of
     scripts/experiments/stage3_fleet.py at its defaults (L8F4 blocks: K1p
     on rows 32 wide over 8 levels and K2 at 4 features, a width no other
     phase runs)
     on two scenes, scene_00 (spheres) to train on and scene_01 (boxes)
     held out, 36 views of 128 px: the scenes' shape lists, the box
     scene's RGBA byte for byte _trace's; its stage1_and_2 (each block to
     S3_NGP_STEPS, every block with surface voxels; K1p 8 and K2 1/1/1
     launches in every step without an occupancy update, the calls of
     S3_CHECK_STEP, run eagerly, held against their plain versions: K2's
     forward bit for bit, each level's K1p within its slot bound), the
     regdata tree, its stage3 (S3_REG_STEPS
     steps, finite losses) and evaluate (scene_01 in both block orders,
     RegTr with and without the ICP polish; the FGR/RANSAC baseline on the
     first order only, S3_BASELINE_DRAWS), the metrics files written; the
     pairs' RRE/RTE and the seconds;
 10. stage 3 on the grid that phase 6 extracted on the card: a two-block
     scene (the block, and a copy whose occupied xyz a known SE(3) moves),
     loaded through NeRFRegDataset; seeded flax-layout weights saved as a
     JAX-layout checkpoint and read by the eval twin (RegEvaluator); the
     full-width NeRFRegTr forward in bf16 and in f32 (TF32 off) with a
     rigid-pose check, ms a pair, peak memory, FLOPs against the peak rate
     and the top kernels of a profiled forward; RegEvaluator.evaluate()
     with --icp_refine (the ICP polish and the classical baseline, its
     fgr_metrics_test.json); the card against the CPU at R = 32 (a crop of
     the grid), in f32 and in bf16, with stated tolerances;
 11. classical registration on that pair's voxel point clouds
     (`classical`): icp_refine from the RegTr pose, global_colored_icp and
     best_global_registration(refine=True) on the card, timed (wall, CUDA
     events, one profiled icp_refine, the host's FGR/RANSAC seconds apart,
     the bound of a fused distance-and-argmin kernel); the card against the
     CPU (CLASSICAL_PARITY_TOL; the coarse race tie-aware: the CPU's
     score of each card pose within the tolerance of the card's, the
     card's best seed among the CPU's best, and each seed whose race
     scores differ replayed iteration by iteration from the card's poses,
     every iteration's poses agreeing or its nearest-neighbour choices
     differing only at near-ties within TIE_REL_GAP); the results against
     the known pose (CLASSICAL_TOL); no race candidate may carry an error;
 12. stage-3 training on that pair (`register train`): RegTrainer at full
     width in bf16 from the config, 2 + 10 steps on the device-cached,
     augmented path (finite losses, no skipped step, the parameters moved,
     optimizer count 12) with ms a step, peak memory, FLOPs of a step
     against the bf16 peak, and the idle share, device operations and top
     kernels of one profiled step; one step on a batch whose rgb holds a
     NaN (parameters, moments and counts bit for bit unchanged);
     validate() with the pose viewer on (--enable_visdom on a free port;
     its /state.json read back: the step, 3 point and 3 line traces),
     save_checkpoint, load_checkpoint and RegEvaluator on the
     trained weights; one f32 step (TF32 off) from the trainer's state, card
     against CPU on the R = 32 crop, within REG_STEP_TOL; two steps with --visibility exact
     through the phase-6 block's NeRF (K2's forward must launch, K2p not;
     its first call on the table of each field held bit for bit against
     its plain version on the path's own inputs, and timed alone against
     its bytes bound), their labels against the voxel-mask labels and K2
     in the profiler;
 12b. the mesh (`mesh`), parallel/ at world size 1 under NCCL (a file://
     store in the temporary directory): the stage-1 DP step at full width
     against step_loss on the same draws (samples equal, loss within
     MESH_LOSS_REL, the gradients as the fleet's first step), the sharded
     surface pass on MESH_SURFACE_POINTS voxels
     of the multi-block phase's block 0 against compute_surface_mask
     (equal), sharded_attention at 2048 tokens against the plain formula
     (equal) and a full-width registration DP step in f32 (cuDNN TF32
     off) against the trainer's single-pair step (its gradient within
     REG_STEP_TOL's grad_norm_rel, the update Adam's on it bit for bit;
     beside it, two single-pair gradients at the same parameters, the
     card's spread from run to run);
     then two ranks under gloo on cuda:0
     (NCCL refuses two ranks on one card): MESH_DP_STEPS stage-1 DP steps
     and one f32 registration DP step, each step's mean gradient held
     against the mean-of-shards one computed in this process on the
     ranks' draws and pairs at the same parameters, the parameters Adam's
     steps on the ranks' gradients bit for bit, and the two ranks equal
     bit for bit (checksums after an all_gather). K1p/K2 launches are
     counted around each DP step and the surface pass (4/1/1/1 a DP step,
     one K2 forward a density query);
 13. training under grad_accum "pallas" without the run-length backward
     (64 steps): K1 must launch 4 times a step; then K1p's device time at
     each case of phase 3, the kernel alone in torch.profiler;
 14. the other fields (`fields`): card against CPU, the full-width xor-hash
     encoder on 2^16 points (corner rows equal; output and table gradient
     within FIELDS_TOL) and one f32 step of --field vanilla and of --field
     dnerf at FIELDS_SMALL; then --field vanilla and --field dnerf at full
     width (8x256, bf16) at SHAPE_FLAGS, FIELD_STEPS steps each (dnerf on
     the fixture with times i/35, validated on DNERF_VAL_VIEWS at their
     times): finite losses, every parameter moved, ms a step, 8 profiled
     steps (with their `mlp.rows` and `mlp.warp_rows` counters: every
     buffer row a step, warped under dnerf), peak memory, MLP FLOPs a step
     against the f32 peak, train and
     val PSNR, the checkpoint read back bit for bit; and the xor-hash NGP
     at full width, built by the trainer from `--encoder xor_hash`,
     trained to HASH_STEPS, profiled, saved ("encoder": "xor_hash"),
     evaluated and extracted through Evaluator, with its surface rays/s;
     K1, K1p, K2p and K2 launch in none of it, K6 forward and backward in all
     of its training; a `fields` JSON line;
 15. a JSON line of every kernel with its host launches on its path (the
     wrappers' counters: a CUDA graph's replay runs none), apart from them
     the launches that the training steps' replays ran (`replayed`,
     derived from what each graph's recording launched), time, plain
     time, bound and library time; the card's line; and last
     {"ok": true, "device": {...}}.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import functools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM bf16 dense, tensor cores
K1_TOL = 1e-5  # relative to max |out|: atomics sum in a varying order
TRAIN_STEPS = 64
STEADY = range(49, TRAIN_STEPS)  # after the last occupancy update in the run, at step 48
PROFILE_STEPS = 8  # after TRAIN_STEPS, before the next occupancy update
PROFILE_TOP = 15
PROFILE_PAD_S = 0.1  # host seconds around a profiled window's launches (device_ms)
# the __global__ functions of dregnerf_tpu_torch/csrc
PORT_KERNELS = ("scatter_add_rows_f32x4", "scatter_add_rows_bf16x8", "gather_rows_f32x4",
                "hash_grid_fwd", "hash_grid_bwd", "packed_grid_fwd", "packed_grid_rows",
                "packed_grid_unpack")
# K6 against its plain version, relative to the plain version's max |value|:
# the forward's corner rows are equal (8-corner sums in another order), the
# backward's atomics sum in a varying order
K6_TOL = {"out": 1e-6, "grad": 1e-5}
K6_RAYS, K6_RUN = 1 << 14, 16  # rays of K6's points, consecutive samples a ray
# device operations of the packed encoder's forward and backward on the
# card that would mean the packed table or its products were back: its
# rolls, the cat of corner rows, K2p, the einsum's batched GEMV and GEMM
PACK_PATH_KERNELS = ("roll_cuda_kernel", "CatArrayBatchedCopy", "gather_rows_f32x4", "gemv",
                     "gemm")
PALLAS_STEPS = 64
EXTRACT_STEPS = 1024  # the default-trained block is extracted at this step
REG_WARMUP, REG_TIMED = 2, 10  # registration forwards before and under the clock
REG_ROTATION = (30.0, (1.0, 2.0, 0.5))  # block 1 = block 0 moved: degrees about an axis,
REG_TRANSLATION = (0.1, 0.0, 0.0)  # then this translation
PARITY_R = 32  # the card-against-CPU crop
REG_TRAIN_WARMUP, REG_TRAIN_TIMED = 2, 10  # registration train steps before and under the clock
REG_EXACT_STEPS = 2  # steps with --visibility exact
LOSS_NAMES = ("overlap", "nerf_cont", "feature", "corr", "total")
# one f32 train step from the bf16 trainer's parameters, Adam moments and
# counts, card against CPU at PARITY_R, full width: each loss term and the
# total within 1e-4 relative, the global gradient norm within 1e-4
# relative; the updated parameters within 2.5e-4 (at most 2 lr plus the
# decay term) and at least 99.9 % of them within 1e-6. From zero moments
# the step is nearly lr sign(g) everywhere, and how many elements have a
# sign at the devices' rounding noise varies with the crop; from the
# moments the share read 0.999919-1.0 on five crops, 0.995208 with cuDNN's
# TF32 on (probes/reg_step_parity.py)
REG_STEP_TOL = {"losses_rel": 1e-4, "grad_norm_rel": 1e-4, "params_abs": 2.5e-4,
                "params_tight": 1e-6, "params_tight_share": 0.999}
# card against CPU at PARITY_R, full width (stated before the first chip run;
# group counts, the level and the validity masks are exact in both dtypes):
# f32 with TF32 off, conditioned features within 1e-3 of their max |value|;
# bf16 on both, features within 0.25 (LayerNorm outputs of order 1, bf16
# steps of 2^-8 through 6 layers) and the pose to 10 degrees and 0.05
PARITY_TOL = {
    "float32": {"features_rel": 1e-3, "keypoints": 1e-5, "pose_entries": 1e-3},
    "bfloat16": {"features": 0.25, "keypoints": 1e-5, "rotation_deg": 10.0,
                 "translation": 0.05},
}
# the classical phase (stated before the first chip run): against the known
# pose, global_colored_icp within 2 deg and 0.02 and best_global_registration
# within the JAX test's 3 deg and 0.05 (tests/test_reg_training.py); card
# against CPU on the same inputs and seed: icp_refine's pose within 0.05 deg
# and 1e-4 and its joint score within 1e-4 + 1e-4 |score|, and each of
# global_colored_icp's 24 coarse scores within the same (a converged score
# is the f32 rounding of |x|^2 - 2 x.y + |y|^2 under a square root)
CLASSICAL_TOL = {"gicp": (2.0, 0.02), "race": (3.0, 0.05)}
CLASSICAL_PARITY_TOL = {"rotation_deg": 0.05, "translation": 1e-4, "score_abs": 1e-4,
                        "score_rel": 1e-4}
# the coarse race's paths, card against CPU: a seed whose race score differs
# between the devices is replayed one ICP iteration at a time, both devices
# starting each iteration from the card's pose. An iteration passes when the
# next poses agree within CLASSICAL_PARITY_TOL, or when the two devices'
# nearest-neighbour choices differ only on source points whose two candidate
# joint distances d2 (in f64 on the CPU) lie within TIE_REL_GAP of each
# other, relative to |x|^2 + |y|^2: the size of the terms the f32 formula
# |x|^2 - 2 x.y + |y|^2 cancels, which sets its rounding (a few f32 ulps,
# 1.2e-7 each, of that size)
TIE_REL_GAP = 2e-6
# icp_refine's card-against-CPU init: the known pose after this error (degrees
# about an axis, then a translation), as a trained RegTr would leave it
ICP_INIT_ERROR = (8.0, (1.0, -1.0, 0.5), (0.03, 0.02, -0.03))
# the multi-block phase (stated before its first chip run): the 36-view
# fixture split by k-means into two blocks of 18 views (labels as
# sklearn's KMeans(n_init=10, random_state=0) gives them), each block
# trained to MB_STEPS in its own world frame and extracted. The frame
# check: at least MB_FRAME_SHARE of block 0's surface voxels must land
# within MB_FRAME_RADIUS voxel widths of a block-1 surface voxel under
# T1 T0^-1, and at most MB_SWAPPED_SHARE under the swapped T0 T1^-1 (a
# wrong map). Three runs read 0.5465-0.6007 and 0.1018-0.1162 at 3 widths.
FIXTURE36_K2 = [0] * 8 + [1] * 18 + [0] * 10
MB_STEPS = EXTRACT_STEPS
MB_CHECK_STEP = 1  # the step whose K2 forward is held against its plain version (no occupancy update)
MB_LEVELS = 4
MB_FRAME_RADIUS = 3.0
MB_FRAME_SHARE = 0.3
MB_SWAPPED_SHARE = 0.2
MARCH_STEPS = 8  # full-width steps under each training marcher
FLEET_STEPS = 128  # fleet steps of the two-block fleet (every block-step K1p/K2 4/1/1/1)
# two full-width steps' gradients on the card from the same state on the
# same draws (_grads_agree): the table gradient within GRAD_NORM_TOL of the
# reference's norm, each MLP leaf within GRAD_NORM_TOL of its max (the
# reference phase's bf16 tolerance). The mesh phase holds each of the two
# gloo ranks' MESH_DP_STEPS mean gradients so against the one-process
# mean-of-shards gradient at the same parameters, and the ranks' losses
# within 1e-6 relative of it; the registration DP steps' gradients within
# REG_STEP_TOL's grad_norm_rel of the norm
GRAD_NORM_TOL = 1e-2
MESH_LOSS_REL = 1e-5  # one full-width step's loss repeats on the card to 1e-7, not bit for bit
MESH_DP_STEPS = 3
MESH_SURFACE_POINTS = 8192
MESH_RANK_TIMEOUT_S = 420
N_ROWS, WIDTH = 1 << 18, 64  # rows of one encoder level's gather or scatter a step
# (table rows, run length of equal slots) of the four encoder levels of a
# step: a ray's steps per cell at each level (1024 steps over a 2-unit box)
STEP_LEVELS = [(4096, 37), (1 << 19, 7), (1 << 19, 1), (1 << 19, 1)]
KERNEL_CASES = sorted({(4096, 1), (1 << 19, 1), (4096, 37), (1 << 19, 7)})
SHAPE_FLAGS = [
    "--dataset", "objaverse", "--aabb=-1.0,-1.0,-1.0,1.0,1.0,1.0",
    "--max_iterations", "100000", "--sample_budget", str(1 << 18),
    "--max_march_steps", "1024", "--grid_resolution", "128", "--init_num_rays", "4096",
    "--max_num_rays", str(1 << 15), "--march_compaction", "capped",
]
# the fields phase (stated before its first chip run). Card against CPU:
# the full-width xor-hash encoder (16 levels x 2^19 rows x 2 features) on
# 2^16 points in [-0.05, 1.05]^3: corner rows equal; the output within
# FIELDS_TOL["hash_out"] of its max |value| (each point's 8-corner sum in
# another order) and the table gradient within FIELDS_TOL["hash_grad"] of
# its max (up to ~128 f32 adds a row at level 0, in another order); one
# f32 step (TF32 off) of each MLP field at FIELDS_SMALL on the same draws:
# equal sample counts, the loss within 1e-4 relative, every gradient leaf
# within 1e-4 (vanilla) or 5e-4 (dnerf: the warped x enters posenc at up
# to 2^(L-1)) of its max, the bounds the CPU tests hold the port to
# against the JAX package (tests/test_torch_fields.py)
FIELDS_TOL = {"hash_out": 1e-6, "hash_grad": 1e-5, "loss_rel": 1e-4,
              "grad": {"vanilla": 1e-4, "dnerf": 5e-4}}
FIELDS_SMALL = dict(net_depth=6, net_width=32, net_width_condition=16, posenc_xyz=4,
                    posenc_dir=2, warp_depth=2, warp_width=16, posenc_time=2)
FIELD_STEPS = 128  # full-width steps of --field vanilla and of --field dnerf
HASH_STEPS = 512  # the hash-grid NGP trains to this step, then is extracted
DNERF_VAL_VIEWS = (10, 30)  # the dnerf phase's val views (times 10/35 and 30/35)
NV_FACTOR = 8  # the evaluator's render size: 100 x 100 at objaverse's intrinsics
NV_PSNR_MIN = 35.0  # dB, card against CPU on one frame of a trained block
NV_OPACITY_SHARE_MIN = 0.05  # of that frame's pixels with opacity over 0.5
NV_TAGS = ("gt", "aligned", "unaligned")
NV_ORBIT = 12  # cameras of the evaluator's orbit
NV_K2_PER_RENDER = 2  # 2 chunks of 8192 rays (10^4 padded), one K2 forward each
# the stage-3 fleet phase: the twin of scripts/experiments/stage3_fleet.py at
# its defaults (L8F4: 8 levels of packed rows 32 wide) on two scenes, scene_00
# (spheres) to train on and scene_01 (boxes) held out, at the fixture's
# 36 views of 128 px, each block trained to S3_NGP_STEPS (every block must
# extract surface voxels) and NeRFRegTr to S3_REG_STEPS
S3_VIEWS, S3_IMG = 36, 128
S3_NGP_STEPS = 512  # 512 and 1024 tried: every block extracts surface voxels at both
S3_REG_STEPS = 8
S3_LEVELS = 8
S3_WIDTH = 32
S3_CHECK_STEP = 1  # the step whose K1p and K2 calls are held against their plain versions
S3_BASELINE_DRAWS = 1  # block orders the host-side baseline also registers (the twin's: 2)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds of fn() over `iters` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float = 0.0) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3


def run_slots(torch, rows: int, run: int, g) -> "torch.Tensor":
    """N_ROWS slots in runs of `run` equal slots, as marched samples give."""
    starts = torch.randint(0, rows, (-(-N_ROWS // run),), generator=g, device="cuda")
    return starts.repeat_interleave(run)[:N_ROWS].to(torch.int32).contiguous()


def per_step(results: dict, levels) -> dict:
    """Sum of one call per encoder level of (ms, plain_ms, library_ms,
    bound_ms[, host_us])."""
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "host_us")
    width = len(results[levels[0]])
    return {key: sum(results[lv][i] for lv in levels) for i, key in enumerate(keys[:width])}


def k1_phase(torch, dev) -> dict:
    """K1 against index_add_ at the main path's shapes; the per-step
    figure sums one call per encoder level (STEP_LEVELS)."""
    from dregnerf_tpu_torch.ops.scatter_add import scatter_add, scatter_add_plain

    g = torch.Generator(device=dev).manual_seed(0)
    src = torch.randn(N_ROWS, WIDTH, generator=g, device=dev)
    results, max_err = {}, 0.0
    for rows, run in KERNEL_CASES:
        idx = run_slots(torch, rows, run, g)
        idx64 = idx.long()
        got = scatter_add(idx, src, rows)
        want = scatter_add_plain(idx, src, rows)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = K1_TOL * want.abs().max().item()
        check(err <= tol, f"K1 rows={rows} run={run}: max abs err {err} > {tol}")
        max_err = max(max_err, err)
        ms = cuda_ms(lambda: scatter_add(idx, src, rows))
        plain_ms = cuda_ms(lambda: scatter_add_plain(idx, src, rows))
        lib_ms = cuda_ms(lambda: torch.zeros(rows, WIDTH, device=dev).index_add_(0, idx64, src))
        bound = bound_ms(N_ROWS * 4 + N_ROWS * WIDTH * 4 + rows * WIDTH * 4, N_ROWS * WIDTH)
        results[(rows, run)] = (ms, plain_ms, lib_ms, bound)
        print(f"K1 table_rows={rows} run={run}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, index_add_ {lib_ms:.4f} ms, bound {bound:.4f} ms "
              f"(bytes), max abs err {err:.3e} (tol {tol:.3e})", flush=True)
    out = per_step(results, STEP_LEVELS)
    print(f"K1 per step (4 levels): kernel {out['ms']:.4f} ms, plain {out['plain_ms']:.4f} "
          f"ms, index_add_ {out['library_ms']:.4f} ms, bound {out['bound_ms']:.4f} ms",
          flush=True)
    return dict(out, max_abs_err=max_err)


def device_ms(torch, fn, kernel: str, iters: int = 20, attempts: int = 3) -> float:
    """Mean device milliseconds a launch of the kernels whose name starts
    with `kernel`, over `iters` calls of fn() in torch.profiler (the kernel
    alone: no zero fill, no host time). A warm-up cycle of `iters` calls
    precedes the recorded one, whose every launch must be seen.

    The profiler drops device events that fall outside its window on the
    host's clock, and the card's timestamps can sit off that clock by most
    of a millisecond (0.73 ms seen on the H100): without a margin the last
    launches of a short window are lost. So the host sleeps PROFILE_PAD_S
    on each side of the launches of both cycles; a session that still
    misses a launch is run again, up to `attempts` sessions."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                time.sleep(PROFILE_PAD_S)
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                time.sleep(PROFILE_PAD_S)
                prof.step()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.key.startswith(kernel)]
        launched = sum(e.count for e in events)
        if launched == iters:
            return sum(e.self_device_time_total for e in events) / launched / 1e3
        print(f"profiler saw {launched} {kernel} launches in {iters} calls; again", flush=True)
    raise RuntimeError(f"check failed: profiler saw {launched} {kernel} launches in {iters} "
                       f"calls in each of {attempts} sessions")


def host_us(torch, fn, iters: int = 200, rounds: int = 5) -> float:
    """Host microseconds of one call of fn(): the time to enqueue `iters`
    calls, the device left to finish after the clock stops; the median of
    `rounds` such means (the host's clock varies more than the device's)."""
    fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        means.append((time.perf_counter() - t0) / iters * 1e6)
        torch.cuda.synchronize()
    return statistics.median(means)


def k1p_inputs(torch, src, slots: dict) -> dict:
    """K1p's five cases on the rows `src`: {(table rows, run): (idx, rows,
    keyword arguments)}. Four scatter src at the slots of KERNEL_CASES; the
    fifth is level 0's call on the default path as ops/rle.py makes it: the
    run sums of src at the slots of runs of 37 at 4096 rows (max_runs rows,
    past n_runs padded with the skipped slot -1), bounded by the run count
    on the device, with the 2^18 direct rows as the alternative that the
    device-side flag of `rle_scatter_add_safe` would pick on an overflow."""
    from dregnerf_tpu_torch.ops.packed_grid import RLE_MIN_RUN
    from dregnerf_tpu_torch.ops.rle import run_length_segment_sum

    inputs = {case: (slots[case], src, {}) for case in KERNEL_CASES}
    # level 0 on the default path: expected run 22.76 (PERF.md), max_runs = 2 N / 22.76
    check(22.76 >= RLE_MIN_RUN, "level 0 takes the run-length backward")
    level0 = slots[(4096, 37)]
    max_runs = int(2 * N_ROWS / 22.76)
    run_idx, run_sum, n_runs = run_length_segment_sum(level0, src, max_runs)
    check(int(n_runs) <= max_runs, f"level 0: {int(n_runs)} runs over max_runs {max_runs}")
    inputs[(4096, "rle")] = (run_idx, run_sum.contiguous(),
                             {"alt": (n_runs > max_runs, level0, src), "count": n_runs})
    return inputs


def k1p_slot_error(torch, got, want, idx, x, rows: int):
    """(|got - want| elementwise, its largest ratio to the slot bound) of a
    K1p result against its plain version on rows (idx, x): per slot hit k
    times, 2 ((1 + 2^-8)^(k-1) - 1) sum|x| (see k1p_phase)."""
    valid = (idx >= 0) & (idx < rows)
    slot = idx[valid].long()
    k = torch.bincount(slot, minlength=rows).float()[:, None]
    abs_sum = torch.zeros(rows, x.shape[1], device=x.device).index_add_(0, slot,
                                                                         x[valid].abs())
    tol = 2.0 * torch.expm1(math.log1p(2.0**-8) * (k - 1).clamp(min=0)) * abs_sum
    err = (got.float() - want.float()).abs()
    return err, (err / tol.clamp(min=1e-30)).max().item()


def k1p_phase(torch, dev) -> dict:
    """K1p against its plain version (the serial bf16 scatter) at the five
    cases of k1p_inputs, on two sets of rows.

    Random rows: per slot hit k times, |kernel - plain| <= 2 ((1 +
    2^-8)^(k-1) - 1) sum|src|, as each of the k - 1 rounded bf16 adds is off
    by at most 2^-8 of its exact sum, in the kernel's order and in the
    serial one (tests/test_torch_scatter_bf16.py holds every order of the
    serial adds to it). Rows of integers in {-1, 0, 1}: bit for bit, since
    every partial sum of a slot, in any order, is an integer within
    +-256 (checked), which bf16 holds exactly; so a lost or repeated add
    shows even where k is large and the bound wide.

    Each case of the random rows is timed back to back (ms) and by the
    wrapper's host time a call (host_us); k1p_device_phase adds the kernel
    alone in the profiler. The bound counts idx and src of the rows
    scattered (the in-range rows, up to the count) read and the bf16 table
    written (the caller's cast to f32 is not counted)."""
    from dregnerf_tpu_torch.ops.scatter_add import scatter_add_bf16, scatter_add_bf16_plain

    g = torch.Generator(device=dev).manual_seed(1)
    src = torch.randn(N_ROWS, WIDTH, generator=g, device=dev)
    slots = {case: run_slots(torch, *case, g) for case in KERNEL_CASES}
    ints = torch.randint(-1, 2, (N_ROWS, WIDTH), generator=g, device=dev).float()
    reach = 0.0
    for (rows, run), (idx, x, kw) in k1p_inputs(torch, ints, slots).items():
        valid = idx >= 0
        slot, v = idx[valid].long(), x[valid]
        for part in (v.clamp(min=0), (-v).clamp(min=0)):
            reach = max(reach, torch.zeros(rows, WIDTH, device=dev).index_add_(0, slot, part)
                        .max().item())
        check(reach <= 256, f"K1p rows={rows} run={run}: integer partial sums reach {reach}")
        check(torch.equal(scatter_add_bf16(idx, x, rows, **kw),
                          scatter_add_bf16_plain(idx, x, rows)),
              f"K1p rows={rows} run={run}: not bit for bit on integer rows")
    print(f"K1p bit for bit with its plain version on integer rows in {{-1, 0, 1}} at every "
          f"case (a slot's partial sums within +-{reach:.0f})", flush=True)
    inputs = k1p_inputs(torch, src, slots)
    results, calls, max_err, worst = {}, {}, 0.0, 0.0
    for (rows, run), (idx, x, kw) in inputs.items():
        valid = idx >= 0
        n_valid = int(valid.sum())
        got = scatter_add_bf16(idx, x, rows, **kw)
        want = scatter_add_bf16_plain(idx, x, rows)  # the flag is false: the runs fit
        torch.cuda.synchronize()
        err, ratio = k1p_slot_error(torch, got, want, idx, x, rows)
        check(ratio <= 1.0, f"K1p rows={rows} run={run}: error over the slot bound")
        max_err, worst = max(max_err, err.max().item()), max(worst, ratio)
        lib_idx, lib_src = idx[:n_valid].long(), x[:n_valid]  # in-range rows lead
        check(bool(valid[:n_valid].all()), "in-range rows lead")

        call = calls[(rows, run)] = functools.partial(scatter_add_bf16, idx, x, rows, **kw)
        ms = cuda_ms(call)
        h_us = host_us(torch, call)
        plain_ms = cuda_ms(lambda: scatter_add_bf16_plain(idx, x, rows), iters=5, warmup=1)
        lib_ms = cuda_ms(lambda: torch.zeros(rows, WIDTH, dtype=torch.bfloat16, device=dev)
                         .index_add_(0, lib_idx, lib_src.bfloat16()))
        bound = bound_ms(n_valid * 4 + n_valid * WIDTH * 4 + rows * WIDTH * 2, n_valid * WIDTH)
        results[(rows, run)] = (ms, plain_ms, lib_ms, bound, h_us)
        print(f"K1p table_rows={rows} run={run} ({idx.numel()} rows, {n_valid} in range): "
              f"kernel {ms:.4f} ms back to back, {h_us:.2f} us host a call; plain "
              f"{plain_ms:.4f} ms, bf16 index_add_ {lib_ms:.4f} ms, bound {bound:.4f} ms "
              f"(bytes), max abs err {err.max().item():.3e}, worst err/slot bound "
              f"{ratio:.4f}", flush=True)
    levels = [(4096, "rle")] + STEP_LEVELS[1:]
    out = per_step(results, levels)
    print(f"K1p per step (level 0 run sums + levels 1-3): kernel {out['ms']:.4f} ms back to "
          f"back, {out['host_us']:.2f} us host; plain "
          f"{out['plain_ms']:.4f} ms, bf16 index_add_ {out['library_ms']:.4f} ms, bound "
          f"{out['bound_ms']:.4f} ms", flush=True)
    cases = [dict(zip(("table_rows", "run", "ms", "plain_ms", "library_ms", "bound_ms",
                       "host_us"), (rows, run, *r)))
             for (rows, run), r in results.items()]
    return dict(out, max_abs_err=max_err, worst_tol_ratio=worst, cases=cases, calls=calls)


def k1p_device_phase(torch, k1p: dict) -> None:
    """K1p's device ms a call, the kernel alone in torch.profiler (no zero
    fill, no host time), for each case of k1p_phase and summed per step
    (into k1p["device_ms"]). It runs after every host-timed phase, so that
    no profiler session precedes a host timing."""
    calls = k1p.pop("calls")
    by_case = {(c["table_rows"], c["run"]): c for c in k1p["cases"]}
    for (rows, run), case in by_case.items():
        case["device_ms"] = device_ms(torch, calls[(rows, run)], "scatter_add_rows_bf16")
        print(f"K1p table_rows={rows} run={run}: {case['device_ms']:.4f} ms device (kernel "
              f"alone)", flush=True)
    k1p["device_ms"] = sum(by_case[lv]["device_ms"] for lv in [(4096, "rle")] + STEP_LEVELS[1:])
    print(f"K1p per step (level 0 run sums + levels 1-3): {k1p['device_ms']:.4f} ms device",
          flush=True)


def k1p_sass_phase() -> str:
    """The reductions K1p's built library issues, from `cuobjdump -sass`:
    exactly one 16-byte vector reduction of eight bf16 values (one per 8
    features of a row), and no other atomic or reduction. Returns its line."""
    from dregnerf_tpu_torch.ops import native

    cuobjdump = os.path.join(os.path.dirname(native.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(native.library_path("scatter_add_bf16"))],
                          capture_output=True, text=True, check=True, timeout=120).stdout
    ops = [line.split(";")[0].strip() for line in sass.splitlines()
           if "RED" in line or "ATOM" in line]
    check(len(ops) == 1 and "REDG.E.ADD.BF16x8" in ops[0],
          f"K1p should issue one REDG.E.ADD.BF16x8 and no other reduction: {ops}")
    print(f"K1p SASS (cuobjdump -sass): {ops[0]}", flush=True)
    return ops[0]


def k2p_phase(torch, dev) -> dict:
    """K2p against index_select (its plain version, and the one library
    call of the same function), bit for bit. The bound counts idx read,
    each distinct table row read once and the output written."""
    from dregnerf_tpu_torch.ops.gather_rows import gather_rows, gather_rows_plain

    g = torch.Generator(device=dev).manual_seed(2)
    results = {}
    for rows, run in KERNEL_CASES:
        table = torch.randn(rows, WIDTH, generator=g, device=dev)
        idx = run_slots(torch, rows, run, g)
        got = gather_rows(table, idx)
        want = gather_rows_plain(table, idx)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"K2p rows={rows} run={run}: not equal to index_select")
        distinct = int(torch.unique(idx).numel())
        ms = cuda_ms(lambda: gather_rows(table, idx))
        plain_ms = cuda_ms(lambda: gather_rows_plain(table, idx))
        bound = bound_ms(N_ROWS * 4 + distinct * WIDTH * 4 + N_ROWS * WIDTH * 4)
        results[(rows, run)] = (ms, plain_ms, plain_ms, bound)
        print(f"K2p table_rows={rows} run={run} ({distinct} distinct rows): kernel {ms:.4f} "
              f"ms, index_select (plain and library) {plain_ms:.4f} ms, bound {bound:.4f} ms "
              f"(bytes), equal", flush=True)
    out = per_step(results, STEP_LEVELS)
    print(f"K2p per step (4 levels): kernel {out['ms']:.4f} ms, index_select "
          f"{out['plain_ms']:.4f} ms, bound {out['bound_ms']:.4f} ms", flush=True)
    return dict(out, max_abs_err=0.0)


def k6_points(torch, g) -> "torch.Tensor":
    """K6_RAYS * K6_RUN = 2^18 points in [0, 1]^3, K6_RUN consecutive
    samples a ray at the training march's step (sqrt(3) / 1024 in the unit
    box), as the marcher hands them to the encoder."""
    starts = torch.rand(K6_RAYS, 3, generator=g, device="cuda") * 0.8 + 0.1
    dirs = torch.nn.functional.normalize(torch.randn(K6_RAYS, 3, generator=g, device="cuda"),
                                         dim=-1)
    steps = torch.arange(K6_RUN, device="cuda", dtype=torch.float32) * (math.sqrt(3) / 1024)
    return (starts[:, None] + dirs[:, None] * steps[None, :, None]).reshape(-1, 3).contiguous()


def k6_phase(torch, dev) -> dict:
    """K6 forward and backward at HashGridConfig() on k6_points: against
    the plain version (hash_encode_plain and its autograd backward), and
    the library calls on the same rows and weights (index_select and the
    8-corner sum; index_put_ with accumulate). The bound counts positions
    read and the f32 encoding written (or its gradient read): each
    distinct row read or added is unseen."""
    from dregnerf_tpu_torch.ops import hash_encoding as H

    cfg = H.HashGridConfig()
    g = torch.Generator(device=dev).manual_seed(6)
    x = k6_points(torch, g)
    n = x.shape[0]
    table = (torch.rand(cfg.n_levels * cfg.table_size, cfg.n_features, generator=g,
                        device=dev) * 2 - 1).requires_grad_(True)
    dout = torch.randn(n, cfg.out_dim, generator=g, device=dev)
    before = (H.hash_encode.launches, H.hash_encode.grad_launches)
    got = H.hash_encode(table, x, cfg)
    got.backward(dout)
    got_grad, table.grad = table.grad, None
    check((H.hash_encode.launches, H.hash_encode.grad_launches) == (before[0] + 1, before[1] + 1),
          f"K6 launches {H.hash_encode.launches, H.hash_encode.grad_launches} after {before}")
    want = H.hash_encode_plain(table, x, cfg)
    want.backward(dout)
    want_grad, table.grad = table.grad, None
    out_err = ((got - want).abs().max() / want.abs().max()).item()
    grad_err = ((got_grad - want_grad).abs().max() / want_grad.abs().max()).item()
    check(out_err <= K6_TOL["out"], f"K6 forward err {out_err} of max")
    check(grad_err <= K6_TOL["grad"], f"K6 backward err {grad_err} of max")
    # the rows: with dL/denc = 1 and weights >= 0, the gradient is nonzero
    # exactly at the rows of the corners with a nonzero weight
    rows, w = H.hash_corners(x, cfg)
    support = torch.zeros(table.shape[0], dtype=torch.bool, device=dev)
    support[rows[w > 0]] = True
    ones = H.hash_encode(table, x, cfg)
    ones.backward(torch.ones_like(ones))
    rows_equal = bool(torch.equal(table.grad.abs().sum(-1) > 0, support))
    table.grad = None
    check(rows_equal, "K6's corner rows differ from hash_corners'")

    t = table.detach()
    flat, wf = rows.reshape(-1), w.reshape(n, cfg.n_levels, 8, 1)
    src = (wf * dout.reshape(n, cfg.n_levels, 1, cfg.n_features)).reshape(-1, cfg.n_features)

    tt = t.clone().requires_grad_(True)
    y = H.hash_encode_plain(tt, x, cfg)

    def plain_bwd():  # autograd's backward of the plain forward, kept
        tt.grad = None
        y.backward(dout, retain_graph=True)

    def k6_bwd():
        H._launch("hash_grid_bwd_f32", x, dout, torch.zeros_like(t), cfg)

    fwd = {"ms": cuda_ms(lambda: H.hash_encode(t, x, cfg)),
           "plain_ms": cuda_ms(lambda: H.hash_encode_plain(t, x, cfg)),
           "library_ms": cuda_ms(lambda: (t.index_select(0, flat).reshape(
               n, cfg.n_levels, 8, cfg.n_features) * wf).sum(2)),
           "bound_ms": bound_ms(n * (12 + 4 * cfg.out_dim)),
           "device_ms": device_ms(torch, lambda: H.hash_encode(t, x, cfg), "hash_grid_fwd"),
           "max_abs_err": out_err}
    bwd = {"ms": cuda_ms(k6_bwd), "plain_ms": cuda_ms(plain_bwd),
           "library_ms": cuda_ms(lambda: torch.zeros_like(t).index_put_((flat,), src,
                                                                         accumulate=True)),
           "bound_ms": bound_ms(n * (12 + 4 * cfg.out_dim)),
           "device_ms": device_ms(torch, k6_bwd, "hash_grid_bwd"), "max_abs_err": grad_err}
    for name, r in (("forward", fwd), ("backward", bwd)):
        print(f"K6 {name} at {n} points x {cfg.n_levels} levels: kernel {r['ms']:.4f} ms "
              f"(alone {r['device_ms']:.4f}), plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms (bytes), err "
              f"{r['max_abs_err']:.3e} of max", flush=True)
    print("K6 corner rows equal to hash_corners' (the backward's support)", flush=True)
    return {"forward": fwd, "backward": bwd, "rows_equal": rows_equal}


def k2_phase(torch, dev) -> dict:
    """K2 at the main path's shapes (L4F8 with the CLI defaults'
    accumulators: bf16, the run-length backward at level 0) on k6_points:
    each launch against its plain version, bit for bit (the same f32
    operations in the same order); each one's time, alone in the profiler
    and against its bound in bytes (forward N (12 + 4LF): positions read,
    the encoding written, each corner row unseen; rows N (12 + 4LF + 4L +
    32LF); unpack 36F a table row: G read, dV written), and its plain
    version's; the whole encoder's forward and backward against the pack
    path's (pack_table, K2p, the einsum, the same accumulators); and one
    profiled forward and backward, in which no kernel of PACK_PATH_KERNELS
    may run."""
    from dregnerf_tpu_torch.ops import packed_grid as P

    cfg = P.PackedGridConfig(grad_accum="bf16", rle_step_u=math.sqrt(3) / 1024)
    g = torch.Generator(device=dev).manual_seed(10)
    x = k6_points(torch, g)
    n, L, F = x.shape[0], cfg.n_levels, cfg.n_features
    table = torch.rand(cfg.total_rows, F, generator=g, device=dev) * 2 - 1
    dout = torch.randn(n, cfg.out_dim, generator=g, device=dev)
    grads = [torch.randn(int(t), 8 * F, generator=g, device=dev) for t in cfg.level_table_sizes()]
    k2 = P.vertex_encode
    before = (k2.launches, k2.rows_launches, k2.unpack_launches)
    out = P._k2_forward(table, x, cfg)
    slots, rows = P._k2_rows(x, dout, cfg)
    dv = P._k2_unpack(grads, cfg, x.device)
    torch.cuda.synchronize()
    after = (k2.launches, k2.rows_launches, k2.unpack_launches)
    check(after == tuple(b + 1 for b in before), f"K2 launches {after} after {before}")
    want_slots, want_rows = P.k2_rows_plain(x, dout, cfg)
    equal = {"forward": torch.equal(out, P.k2_forward_plain(table, x, cfg)),
             "rows": torch.equal(slots, want_slots) and torch.equal(rows, want_rows),
             "unpack": torch.equal(dv, P.k2_unpack_plain(grads, cfg))}
    check(all(equal.values()), f"K2 against its plain versions (equal): {equal}")
    del out, slots, rows, dv, want_slots, want_rows
    launches = {
        "forward": (lambda: P._k2_forward(table, x, cfg), lambda: P.k2_forward_plain(table, x, cfg),
                    "void packed_grid_fwd<", n * (12 + 4 * L * F)),
        "rows": (lambda: P._k2_rows(x, dout, cfg), lambda: P.k2_rows_plain(x, dout, cfg),
                 "void packed_grid_rows<", n * (12 + 4 * L * F + 4 * L + 32 * L * F)),
        "unpack": (lambda: P._k2_unpack(grads, cfg, x.device),
                   lambda: P.k2_unpack_plain(grads, cfg), "void packed_grid_unpack<",
                   cfg.total_rows * 36 * F)}
    results = {}
    for name, (kernel, plain, key, nbytes) in launches.items():
        r = results[name] = {"ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain),
                             "device_ms": device_ms(torch, kernel, key),
                             "bound_ms": bound_ms(nbytes)}
        print(f"K2 {name} at {n} points, L{L}F{F}: kernel {r['ms']:.4f} ms (alone "
              f"{r['device_ms']:.4f}), plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"(bytes), equal to its plain version", flush=True)
    tv = table.clone().requires_grad_(True)

    def k2_encoder():
        tv.grad = None
        P.vertex_encode(tv, x, cfg).backward(dout)

    def pack_encoder():
        tv.grad = None
        P.packed_encode(P.pack_table(tv, cfg), x, cfg).backward(dout)

    encoder = {"ms": cuda_ms(k2_encoder), "pack_path_ms": cuda_ms(pack_encoder)}
    _, kernels, _, _ = profiled(torch, k2_encoder, 1, "K2 encoder forward and backward", "call")
    packing = [e.key[:60] for e in kernels if any(k in e.key for k in PACK_PATH_KERNELS)]
    check(not packing, f"the K2 encoder ran the pack path's kernels: {packing}")
    print(f"K2 encoder forward and backward (bf16, RLE level 0): {encoder['ms']:.4f} ms, the pack "
          f"path {encoder['pack_path_ms']:.4f} ms; its {len(kernels)} kinds of device operation "
          f"hold none of {PACK_PATH_KERNELS}", flush=True)
    return dict(results, encoder=encoder, equal=equal)


def _record_scatters(packed_grid, seen: dict):
    """Wrap packed_grid.level_backward so that each level's scatter records
    (slot, g, table_rows) under the device's type; returns the original."""
    real = packed_grid.level_backward

    def spy(config, level, n):
        scatter = real(config, level, n)

        def recorded(slot, g, table_rows):
            seen.setdefault(slot.device.type, {})[level] = (slot.long(), g, table_rows)
            return scatter(slot, g, table_rows)
        return recorded

    packed_grid.level_backward = spy
    return real


def reference_phase(torch, dev, defaults: bool) -> None:
    """One tiny training step with the same weights and draws on the card
    and on the CPU: equal sample counts, loss and PSNR, gradients.

    defaults=False: f32 MLPs, grad_accum "pallas" (K1); loss and PSNR 1e-4
    relative, every gradient 1e-4 of its max (f32 sums in another order).
    defaults=True: the CLI defaults, bf16 MLPs and grad_accum "bf16" with
    the run-length backward on level 0 and K1p on level 1; loss and PSNR
    1e-3 relative; the table gradient within the bf16 bound, per packed
    slot hit k times by rows g: (k + 1) 2^-7 sum|g| (k roundings of the
    adds and of the addends, whose cotangents may round to neighbouring
    bf16 values), carried to the vertex table through pack_table; MLP
    gradients 1e-2 of their max (bf16 operands). The card's table gradient
    comes through K2 (one launch of each of its three), with no K2p."""
    from dregnerf_tpu_torch.datasets.fixtures import make_scene_data
    from dregnerf_tpu_torch.models import ngp
    from dregnerf_tpu_torch.ops import occupancy
    from dregnerf_tpu_torch.ops import packed_grid
    from dregnerf_tpu_torch.render.renderer import RenderConfig
    from dregnerf_tpu_torch.runtime.ngp_trainer import draw_step_inputs, step_loss

    steps = 64
    scene = make_scene_data("train", num_views=8, image_size=32)
    grid_cfg = packed_grid.PackedGridConfig(
        n_levels=2, log2_table_size=10, base_resolution=4, per_level_scale=2.0,
        grad_accum="bf16" if defaults else "pallas",
        rle_step_u=(2 * math.sqrt(3) / steps) / 2.0 if defaults else 0.0)
    if defaults:
        check(packed_grid.rle_expected_run(grid_cfg, 0) >= packed_grid.RLE_MIN_RUN
              > packed_grid.rle_expected_run(grid_cfg, 1), "RLE on level 0 only")
    cfg = ngp.NGPConfig(grid=grid_cfg,
                        compute_dtype=torch.bfloat16 if defaults else torch.float32)
    params_cpu = ngp.init_ngp(cfg, torch.Generator().manual_seed(0), "cpu")
    params_cpu["table"] = params_cpu["table"] * 1000.0
    g = torch.Generator().manual_seed(1)
    binary = torch.rand(16, 16, 16, generator=g) < 0.6
    draws_cpu = draw_step_inputs(g, 256, scene.num_images, scene.height, scene.width, "cpu")
    rcfg = RenderConfig(render_step_size=2 * math.sqrt(3) / steps, buffer_size=1 << 13,
                        max_steps=steps, march_compaction="capped", k_cap=steps)
    out, seen = {}, {}
    real = _record_scatters(packed_grid, seen)
    try:
        for d in ("cpu", dev):
            params = {k: ([w.detach().to(d).requires_grad_(True) for w in v]
                          if isinstance(v, list) else v.detach().to(d).requires_grad_(True))
                      for k, v in params_cpu.items()}
            grid = occupancy.OccupancyGrid(torch.zeros(16**3, device=d), binary.to(d))
            draws = type(draws_cpu)(*(t.to(d) for t in draws_cpu))
            before = _kernel_launches()
            loss, m = step_loss(params, cfg, rcfg, grid,
                                torch.tensor([-1.0, -1, -1, 1, 1, 1], device=d),
                                torch.as_tensor(scene.images, device=d),
                                torch.as_tensor(scene.camtoworlds, device=d),
                                torch.as_tensor(scene.K, device=d), draws, True, True)
            loss.backward()
            ran = [_kernel_launches()[k] - before[k] for k in PACKED_KERNELS]
            out[str(d)] = (loss.item(), m["psnr"].item(), int(m["n_samples"]),
                           [p.grad.cpu() for p in ngp.parameters(params)], ran)
    finally:
        packed_grid.level_backward = real
    (l0, p0, n0, g0, _), (l1, p1, n1, g1, ran) = out["cpu"], out[str(dev)]
    want_ran = [0, 2, 0, 1, 1, 1] if defaults else [2, 0, 0, 1, 1, 1]
    check(ran == want_ran, f"reference: launches {PACKED_KERNELS} {ran}, expected {want_ran}")
    check(n0 == n1, f"reference: n_samples cpu {n0} vs cuda {n1}")
    rel = 1e-3 if defaults else 1e-4
    check(math.isclose(l0, l1, rel_tol=rel), f"reference: loss cpu {l0} vs cuda {l1}")
    check(math.isclose(p0, p1, rel_tol=rel), f"reference: psnr cpu {p0} vs cuda {p1}")
    worst, table_ratio = 0.0, None
    for i, (a, b) in enumerate(zip(g0, g1)):
        if defaults and i == 0:
            bound = _bf16_table_bound(torch, packed_grid, grid_cfg, seen["cpu"])
            err = (a - b).abs()
            check(bool((err <= bound).all()), "reference: table gradient over the bf16 bound")
            table_ratio = (err / bound.clamp(min=1e-30)).max().item()
            continue
        err = (a - b).abs().max().item() / max(a.abs().max().item(), 1e-30)
        worst = max(worst, err)
    check(worst <= (1e-2 if defaults else 1e-4), f"reference: gradient rel err {worst}")
    label = "CLI defaults (bf16, RLE)" if defaults else "pallas f32"
    extra = f", table err / bf16 bound {table_ratio:.4f}" if defaults else ""
    print(f"reference step [{label}]: loss cpu {l0:.6f} cuda {l1:.6f}, n_samples {n0}, "
          f"launches K1/K1p/K2p/K2 {ran}, max grad err {worst:.2e} of max |g|{extra}", flush=True)


def profiled(torch, fn, calls: int, label: str, unit: str):
    """fn(), which makes `calls` calls of what is measured, under
    torch.profiler; prints its wall and device busy ms a call, the device's
    idle share, the device operations a call and the PROFILE_TOP kernels.
    Returns (device busy ms a call, the device events by device time, the
    host events by self time, wall ms a call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)  # margins for the card's clock offset, as in device_ms
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        time.sleep(PROFILE_PAD_S)
    events = prof.key_averages()
    # device-side events, without the ranges that annotate the host's
    # calls (such as Optimizer.step), which span kernels counted already
    kernels = sorted((e for e in events
                      if e.device_type == DeviceType.CUDA and not e.is_user_annotation),
                     key=lambda e: -e.self_device_time_total)
    host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)
    busy_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels) / calls
    print(f"{label}: {wall_us / calls / 1e3:.3f} ms/{unit} wall (profiled), device busy "
          f"{busy_us / calls / 1e3:.3f} ms/{unit}, idle share of the profiled {unit}s "
          f"{1 - busy_us / wall_us:.4f}, {launches:.0f} device operations a {unit} of "
          f"{len(kernels)} kinds", flush=True)
    for e in kernels[:PROFILE_TOP]:
        print(f"  {e.self_device_time_total / calls / 1e3:8.3f} ms/{unit} "
              f"{e.self_device_time_total / max(busy_us, 1e-9):6.1%} x{e.count // calls:<4d} "
              f"{e.key[:100]}", flush=True)
    return busy_us / calls / 1e3, kernels, host, wall_us / calls / 1e3


def profile_phase(torch, trainer, first_step: int) -> tuple[float, float]:
    """Where a training step's device time goes: the steps up to
    `first_step` + PROFILE_STEPS after the occupancy update of step
    `first_step` and the step after it, under torch.profiler; prints the
    device's busy share of the window and the kernels that take most of it,
    and returns the device's busy ms and the wall ms a profiled step. (The
    feedback of step `first_step` may move the ray bucket; the step after
    it then captures that bucket's CUDA graph, outside the window.)"""
    trainer.train_iteration(first_step)
    trainer.train_iteration(first_step + 1)
    steps = range(first_step + 2, first_step + 1 + PROFILE_STEPS)
    before = _ngp_marks(trainer)
    busy_ms, kernels, _, wall_ms = profiled(
        torch, lambda: [trainer.train_iteration(step) for step in steps], len(steps),
        f"profile: steps {steps.start}-{steps.stop - 1}", "step")
    for e in kernels:  # the port's own kernels, wherever they rank
        if any(name in e.key for name in PORT_KERNELS):
            print(f"  port kernel {e.key[:40]}: {e.self_device_time_total / len(steps) / 1e3:.4f} "
                  f"ms/step device, x{e.count // len(steps)} a step", flush=True)
    if hasattr(trainer.model_config, "grid") and hasattr(trainer.model_config.grid, "grad_accum"):
        # the packed grid through K2: no packed table is built (no roll) and
        # K2p gathers nothing; the GEMMs and GEMVs left are the step's others
        packing = [e.key[:60] for e in kernels
                   if "roll_cuda_kernel" in e.key or "gather_rows_f32x4" in e.key]
        check(not packing, f"profiled steps: the packed table's kernels ran: {packing}")
        products = {e.key[:60]: round(e.self_device_time_total / len(steps) / 1e3, 4)
                    for e in kernels if "gemv" in e.key or "xmma" in e.key}
        print(f"  no roll and no K2p in the profiled steps; GEMV and xmma GEMM kernels "
              f"(ms/step): {products}", flush=True)
    # the replays' launches, counted on the device, against what the
    # replayed graphs' recordings launched; the host launches none
    host, replayed, captures, replays = _ngp_launches(trainer, before, tuple(PORT_KERNEL_OF))
    on_device = tuple(sum(e.count for e in kernels if kernel in e.key)
                      for kernel in PORT_KERNEL_OF.values())
    print(f"  port kernels on the device in the profiled steps {on_device}, replayed "
          f"(derived) {replayed}, host launches {host} of {tuple(PORT_KERNEL_OF)}; "
          f"{replays} replays", flush=True)
    check(replays == len(steps) and captures == 0 and not any(host) and on_device == replayed,
          f"profiled steps: {replays} replays, {captures} captures, port kernels on the device "
          f"{on_device}, replayed {replayed}, host {host}")
    return busy_ms, wall_ms


# K1p's and K2's launch counters (runtime/ngp_trainer.py::launch_counters)
K1P_K2 = ("scatter_add_bf16", "packed_grid_fwd", "packed_grid_rows", "packed_grid_unpack")
# each launch counter's kernel, as the profiler names it
PORT_KERNEL_OF = {"scatter_add": "scatter_add_rows_f32x4",
                  "scatter_add_bf16": "scatter_add_rows_bf16x8",
                  "gather_rows": "gather_rows_f32x4", "hash_grid_fwd": "hash_grid_fwd",
                  "hash_grid_bwd": "hash_grid_bwd", "packed_grid_fwd": "packed_grid_fwd",
                  "packed_grid_rows": "packed_grid_rows",
                  "packed_grid_unpack": "packed_grid_unpack"}


def k1p_k2_step(levels: int) -> tuple:
    """The K1P_K2 launches of a training step at `levels` packed levels
    under grad_accum bf16: K1p once a level (the run-length level's through
    its chosen rows), K2's forward, rows and unpack once each."""
    return (levels, 1, 1, 1)


def _ngp_marks(trainer) -> tuple:
    """What `_ngp_launches` counts from: the kernels' host launches, the
    launches the trainer's replays ran, its captures and its replays."""
    from dregnerf_tpu_torch.runtime import ngp_trainer

    return (ngp_trainer.launches(), dict(trainer.replayed_launches), trainer.graph_captures,
            trainer.graph_replays)


def _ngp_launches(trainer, before: tuple, kernels=K1P_K2) -> tuple:
    """(host, replayed, captures, replays) since the marks `before`: `host`
    the launches of each of `kernels` that its wrapper counted where it
    launched (a capture's warm-up and its recording launch one step's each,
    a replay none); `replayed` those the replays ran, a derived number:
    each replay counted with what its graph's recording launched
    (NGPTrainer.replayed_launches)."""
    host, replayed, captures, replays = _ngp_marks(trainer)
    return (tuple(host[k] - before[0][k] for k in kernels),
            tuple(replayed.get(k, 0) - before[1].get(k, 0) for k in kernels),
            captures - before[2], replays - before[3])


def _ngp_step_ok(counts: tuple, want: tuple) -> bool:
    """Whether a step without an occupancy update (its `_ngp_launches`)
    launched each kernel as often as `want` says, n: as a replay of a graph
    whose recording held n, the host launching none but at a capture (n for
    its warm-up, n for its recording), or eagerly, the host launching n."""
    host, replayed, captures, replays = counts
    return (replays in (0, 1) and all(r == n * replays for r, n in zip(replayed, want))
            and all(h == n * (2 * captures + 1 - replays) for h, n in zip(host, want)))


def _scenes():
    from dregnerf_tpu_torch.datasets.fixtures import make_scene_data

    return (make_scene_data("train", num_views=36, image_size=128),
            make_scene_data("test", num_views=36, image_size=128))


def train_default_phase(torch, out_dir: str):
    """The CLI defaults at full width; returns (trainer, config, the host
    launches of K1, K1p, K2p and K2 over the TRAIN_STEPS steps, and those of
    K1p and K2 that the replays ran, derived)."""
    from dregnerf_tpu_torch.ops import packed_grid
    from dregnerf_tpu_torch.runtime import ngp_trainer, profiling
    from dregnerf_tpu_torch.runtime.config import config_parser
    from dregnerf_tpu_torch.runtime.ngp_trainer import NGPTrainer

    scene, val_scene = _scenes()
    cfg = config_parser(SHAPE_FLAGS + ["--expname", "chip_smoke_default", "--out_dir", out_dir])
    trainer = NGPTrainer(cfg, scene, val_scene)  # default device: cuda
    grid_cfg = trainer.model_config.grid
    check(trainer.device.type == "cuda", f"trainer on {trainer.device}")
    check(grid_cfg.grad_accum == "bf16" and grid_cfg.rle_step_u > 0
          and trainer.model_config.compute_dtype == torch.bfloat16,
          f"CLI defaults: {grid_cfg}, {trainer.model_config.compute_dtype}")
    rle_levels = [l for l in range(grid_cfg.n_levels)
                  if packed_grid.rle_expected_run(grid_cfg, l) >= packed_grid.RLE_MIN_RUN]
    print(f"default config: grad_accum bf16, rle_step_u {grid_cfg.rle_step_u:.7f}, expected "
          f"runs {[round(packed_grid.rle_expected_run(grid_cfg, l), 2) for l in range(4)]}, "
          f"RLE at levels {rle_levels}", flush=True)
    check(rle_levels == [0], f"RLE at levels {rle_levels}, expected [0]")

    # the steady steps' run-length counters (`rle.calls`, and `rle.direct`,
    # the calls whose overflow flag sent K1p to the direct rows), read after
    # the loop: the step is a CUDA graph's replay, which runs no Python, and
    # counts them after each replay
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_kernel_launches()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(TRAIN_STEPS + 1)]
    metrics, per_step_launches, steady_rle = [], [], {}
    start = _ngp_marks(trainer)
    t0 = time.perf_counter()
    marks[0].record()
    for step in range(TRAIN_STEPS):
        before = _ngp_marks(trainer)
        with profiling.collect({}) as counts:
            metrics.append(trainer.train_iteration(step))
        marks[step + 1].record()
        per_step_launches.append(_ngp_launches(trainer, before))
        if step in STEADY:
            for name in ("rle.calls", "rle.direct"):
                steady_rle.setdefault(name, []).extend(counts.get(name, []))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ngp_trainer.launches()
    replayed = dict(zip(K1P_K2, _ngp_launches(trainer, start)[1]))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    losses = [float(m["loss"]) for m in metrics]
    psnrs = [float(m["psnr"]) for m in metrics]
    n_samples = [int(m["n_samples"]) for m in metrics]
    step_ms = [marks[i].elapsed_time(marks[i + 1]) for i in range(TRAIN_STEPS)]
    bad = [(s, per_step_launches[s]) for s in STEADY
           if not _ngp_step_ok(per_step_launches[s], k1p_k2_step(4))]
    check(not bad, f"steady steps (step, (host, replayed, captures, replays)) whose K1p/K2 "
          f"launches are not 4/1/1/1: {bad}")
    check(launches["scatter_add"] == 0 and launches["gather_rows"] == 0,
          f"K1 or K2p ran on the default path: {launches}")
    check(all(math.isfinite(x) for x in losses), "non-finite loss")
    first, last = sum(losses[:8]) / 8, sum(losses[-8:]) / 8
    check(last < first, f"loss did not fall: first 8 {first}, last 8 {last}")
    rle_calls, overflow = (sum(int(v) for v in steady_rle.get(name, []))
                           for name in ("rle.calls", "rle.direct"))
    check(rle_calls == len(STEADY), f"{rle_calls} run-length calls in {len(STEADY)} steady steps")
    check(trainer.graph_replays == TRAIN_STEPS, f"{trainer.graph_replays} graph replays in "
          f"{TRAIN_STEPS} steps")
    steady_ms = sum(step_ms[i] for i in STEADY) / len(STEADY)
    sps = sum(n_samples[i] for i in STEADY) / (sum(step_ms[i] for i in STEADY) / 1e3)
    print(f"train [CLI defaults]: {TRAIN_STEPS} steps in {wall:.3f} s wall, "
          f"{wall / TRAIN_STEPS * 1e3:.2f} ms/step overall; steps 49-63 (no occupancy update) "
          f"{steady_ms:.2f} ms/step device, {sps:.1f} samples/s; ray bucket "
          f"{trainer.num_rays} (ran {metrics[-1]['num_rays']}); loss first 8 {first:.5f} last "
          f"8 {last:.5f}; train psnr {psnrs[0]:.3f} -> {psnrs[-1]:.3f}; host launches {launches}, "
          f"replayed (derived) {replayed}, K1p/K2 4/1/1/1 in every steady step (its graph's "
          f"recording); level-0 overflow fallback in {overflow} of "
          f"{rle_calls} steady steps; {trainer.graph_captures} CUDA graph captures, "
          f"{trainer.graph_replays} replays; peak device memory {peak_gib:.2f} GiB", flush=True)

    # the profiled steps' own wall: their bucket may be the next one up
    # from the steady steps', where a step has more device work
    busy_ms, profiled_ms = profile_phase(torch, trainer, TRAIN_STEPS)
    print(f"idle share of the profiled steps at bucket {trainer.num_rays}: 1 - {busy_ms:.3f} "
          f"(busy) / {profiled_ms:.3f} (wall, ms/step) = {1 - busy_ms / profiled_ms:.4f}",
          flush=True)
    t2 = time.perf_counter()
    val_psnr = trainer.validate(TRAIN_STEPS)
    check(math.isfinite(val_psnr), f"val psnr {val_psnr}")
    print(f"validate: val psnr {val_psnr:.3f}, {time.perf_counter() - t2:.3f} s", flush=True)
    return trainer, cfg, launches, replayed


def extract_phase(torch, trainer, cfg) -> None:
    """Stage 2 on the default-trained block, through its checkpoint. The
    block trains on to EXTRACT_STEPS first: after 64 steps no sample of
    it carries half a ray's weight, so its surface mask is empty."""
    import numpy as np

    from dregnerf_tpu_torch.eval_ngp_nerf import Evaluator
    from dregnerf_tpu_torch.extract import sample_grid as sg

    first = TRAIN_STEPS + 1 + PROFILE_STEPS
    t0 = time.perf_counter()
    losses = [trainer.train_iteration(step)["loss"] for step in range(first, EXTRACT_STEPS)]
    torch.cuda.synchronize()
    print(f"train on to step {EXTRACT_STEPS}: {time.perf_counter() - t0:.3f} s, loss "
          f"{float(losses[0]):.5f} -> {float(losses[-1]):.5f}, val psnr "
          f"{trainer.validate(EXTRACT_STEPS):.3f}", flush=True)
    trainer.save_checkpoint(EXTRACT_STEPS)
    _reset_kernel_launches()
    t0 = time.perf_counter()
    ev = Evaluator(cfg, trainer.output_dir, trainer.val_scene)
    check(ev.device.type == "cuda", f"evaluator on {ev.device}")
    result = ev.evaluate()
    torch.cuda.synchronize()
    check(math.isfinite(result["psnr"]), f"eval psnr {result['psnr']}")
    print(f"evaluate: {result['num_views']} test views, psnr {result['psnr']:.3f}, ssim "
          f"{result['ssim']:.4f}, lpips_rand_alex {result['lpips_rand_alex']:.5f}, lpips "
          f"{result['lpips']}, {time.perf_counter() - t0:.3f} s, launches "
          f"{_kernel_launches()}", flush=True)
    eval_launches = _kernel_launches()

    _reset_kernel_launches()
    t1 = time.perf_counter()
    extracted = ev.sample_points()  # extract_voxel_features, then save_voxel_artifacts
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = _kernel_launches()
    points, cams = extracted["points"], np.asarray(ev.meta["camera_poses"], np.float32)
    # the surface scores of the same points, in a second surface pass of
    # the same settings: its rate, and the scores' spread
    aabb = torch.as_tensor(ev.meta["aabb"], dtype=torch.float32, device=ev.device)
    scores = sg.compute_surface_mask(ev.params, ev.model_config, ev.grid, aabb,
                                     sg.extraction_render_config(ev.meta), points, cams,
                                     chunk=min(cfg.test_chunk_size, 8192), return_scores=True)
    t3 = time.perf_counter()
    clear = np.abs(scores - sg.SURFACE_CUTOFF) > 1e-4
    check(bool(((scores >= sg.SURFACE_CUTOFF) == extracted["surface_mask"])[clear].all()),
          "the surface scores disagree with sample_points' surface mask")
    n_surface = int((extracted["surface_mask"] & extracted["density_mask"]).sum())
    n_density = int(extracted["density_mask"].sum())
    rays = len(points) * len(cams)
    print(f"extract: Evaluator.sample_points() {t2 - t1:.3f} s over {len(points)} occupied "
          f"voxels and {len(cams)} cameras, launches {launches}; {n_surface} surface "
          f"voxels, {n_density} density voxels; wrote "
          f"{[os.path.basename(p) for p in extracted['written']]}; surface pass alone "
          f"{rays} rays in {t3 - t2:.3f} s ({rays / (t3 - t2):.1f} rays/s, 64 samples a ray, "
          f"chunk {min(cfg.test_chunk_size, 8192)} clamped to {(1 << 17) // 64} rays), score "
          f"max {scores.max():.4f}, 99th percentile {np.percentile(scores, 99):.4f}",
          flush=True)
    for name, counts in (("evaluation", eval_launches), ("extraction", launches)):
        check(counts["packed_grid_fwd"] > 0 and counts["gather_rows"] == 0,
              f"{name} launched no K2 forward, or K2p: {counts}")
    check(n_surface > 0 and n_density > 0, "empty voxel masks")
    grid = torch.load(os.path.join(trainer.output_dir, "voxel_grid.pt"))
    res = cfg.grid_resolution
    check(tuple(grid.shape) == (res, res, res, 7), f"voxel_grid.pt {tuple(grid.shape)}")
    check(bool(torch.isfinite(grid).all()), "voxel_grid.pt not finite")


def _block_recorder(torch, record_step: int, levels: int = MB_LEVELS, k1p_checks=None):
    """Wrap NGPTrainer.train_iteration for the multi-block and stage-3
    fleet phases: each step's (step, its K1p and K2 `_ngp_launches`, CUDA
    events, loss) per trainer, and, in step `record_step` of each trainer,
    its K2 forward (the step's first) held bit for bit against K2's plain
    forward on the call's own inputs. With a dict
    `k1p_checks`, each level's K1p call of that step (its first `levels`)
    is held against the plain serial bf16 scatter on its own inputs
    (k1p_slot_error) and recorded there by trainer as (table shape, rows,
    worst ratio to the slot bound). Step `record_step` runs eagerly: the
    other steps are replays of the trainer's CUDA graph, which run no
    Python, so no wrapper would see their calls. Returns (steps by
    trainer, checks by trainer, restore)."""
    from dregnerf_tpu_torch.ops import packed_grid, rle
    from dregnerf_tpu_torch.ops.scatter_add import _chosen, scatter_add_bf16, scatter_add_bf16_plain
    from dregnerf_tpu_torch.runtime import step_graph
    from dregnerf_tpu_torch.runtime.ngp_trainer import NGPTrainer

    real_step, real_forward = NGPTrainer.train_iteration, packed_grid._k2_forward
    real_scatter = scatter_add_bf16
    steps, checks, current = {}, {}, [None]

    def forward(table, x, config):
        out = real_forward(table, x, config)
        calls = checks.get(current[0])
        if calls is not None and not calls:
            calls.append((tuple(table.shape), int(x.shape[0]),
                          torch.equal(out, packed_grid.k2_forward_plain(table, x, config))))
        return out

    def scatter(idx, src, table_rows, alt=None, count=None):
        out = real_scatter(idx, src, table_rows, alt=alt, count=count)
        calls = k1p_checks.get(current[0])
        if calls is not None and len(calls) < levels:
            rows_idx, rows_src = _chosen(idx, src, alt, count)
            want = scatter_add_bf16_plain(rows_idx, rows_src, table_rows)
            _, ratio = k1p_slot_error(torch, out, want, rows_idx, rows_src, table_rows)
            calls.append(((table_rows, src.shape[1]), int(rows_idx.numel()), ratio))
        return out

    def step(self, i):
        key = id(self)
        if i == record_step:
            checks.setdefault(key, [])
            if k1p_checks is not None:
                k1p_checks.setdefault(key, [])
            current[0] = key
        before = _ngp_marks(self)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graphed = step_graph.DEVICE_TYPES
        if i == record_step:
            step_graph.DEVICE_TYPES = ()
        try:
            out = real_step(self, i)
        finally:
            current[0] = None
            step_graph.DEVICE_TYPES = graphed
        end.record()
        steps.setdefault(key, []).append((i, _ngp_launches(self, before), start, end,
                                          out["loss"]))
        return out

    def restore():
        NGPTrainer.train_iteration = real_step
        packed_grid._k2_forward = real_forward
        packed_grid.scatter_add_bf16 = rle.scatter_add_bf16 = real_scatter

    NGPTrainer.train_iteration = step
    packed_grid._k2_forward = forward
    if k1p_checks is not None:
        packed_grid.scatter_add_bf16 = rle.scatter_add_bf16 = scatter
    return steps, checks, restore


def _replayed_total(steps: dict) -> dict:
    """The K1p and K2 launches that the replays of `_block_recorder`'s
    steps ran, derived (each replay counted with what its graph's
    recording launched)."""
    return {k: sum(r[1][1][j] for rec in steps.values() for r in rec)
            for j, k in enumerate(K1P_K2)}


def _sphere_reach(np, T) -> float:
    """The largest |coordinate| of the fixture's spheres in the frame T."""
    from dregnerf_tpu_torch.datasets.fixtures import SPHERES

    T = np.asarray(T, np.float64)
    return max(float(np.max(np.abs(T[:3, :3] @ c + T[:3, 3])) + r) for c, r, _ in SPHERES)


def _voxel_centres(np, idx, res: int):
    """World centres [N, 3] of flat voxel indices ix*R^2 + iy*R + iz of the
    +-1 box."""
    ijk = np.stack([idx // (res * res), (idx // res) % res, idx % res], -1)
    return (ijk + 0.5) / res * 2.0 - 1.0


def _nearest(torch, a, b):
    """Distance from each row of a [N, 3] to its nearest row of b [M, 3]."""
    if not len(b):
        return torch.full((len(a),), math.inf, dtype=a.dtype, device=a.device)
    return torch.cat([torch.cdist(c, b).min(dim=1).values for c in a.split(4096)])


def frame_shares(torch, np, blocks: list, frames: dict, res: int, dev) -> dict:
    """{map: share of block 0's surface-voxel centres carried to within
    MB_FRAME_RADIUS voxel widths of a block-1 surface-voxel centre} for
    T1 T0^-1 and the swapped T0 T1^-1."""
    idx = [torch.load(os.path.join(b, "voxel_mask.pt")).numpy() for b in blocks]
    pts = [torch.as_tensor(_voxel_centres(np, i, res), device=dev) for i in idx]
    t0, t1 = (np.asarray(frames[k], np.float64) for k in (0, 1))
    out = {}
    for name, m in (("T1 T0^-1", t1 @ np.linalg.inv(t0)), ("T0 T1^-1", t0 @ np.linalg.inv(t1))):
        m = torch.as_tensor(m, device=dev)
        near = _nearest(torch, pts[0] @ m[:3, :3].T + m[:3, 3], pts[1])
        out[name] = float((near <= MB_FRAME_RADIUS * 2.0 / res).double().mean())
    return out


def multi_block_phase(torch, out_dir: str) -> dict:
    """The multi-block pipeline on the 36-view 128 px fixture (see the
    module docstring, phase 7). Returns the K1p and K2 launches of its
    run, its timings, and the bit-for-bit K2 checks."""
    import numpy as np

    from dregnerf_tpu_torch.datasets import objaverse
    from dregnerf_tpu_torch.datasets.base import (
        apply_world_frame,
        cluster_cameras,
        make_blocks,
        read_world_frame_transforms,
        split_indices,
    )
    from dregnerf_tpu_torch.datasets.fixtures import render_views
    from dregnerf_tpu_torch.datasets.register_pairs import NeRFRegDataset
    from dregnerf_tpu_torch.eval_nerf_regtr import RegEvaluator, save_reg_checkpoint
    from dregnerf_tpu_torch.eval_ngp_nerf import Evaluator, eval_blocks
    from dregnerf_tpu_torch.models.regtr import random_jax_params
    from dregnerf_tpu_torch.runtime.config import config_parser
    from dregnerf_tpu_torch.runtime.ngp_trainer import OCC_UPDATE_INTERVAL
    from dregnerf_tpu_torch.runtime.reg_trainer import make_reg_model
    from dregnerf_tpu_torch.train_ngp_nerf import train_blocks

    subject = "fixture_scene"
    data_dir = os.path.join(out_dir, "images", subject)
    os.makedirs(data_dir)
    t0 = time.perf_counter()
    images, c2w = render_views(36, 128)
    c2w = c2w.astype(np.float32)[:, :3, :4]
    K = objaverse.intrinsics(128, 128, 0.9)
    splits = {split: make_blocks(data_dir, images, c2w, K, split, 2, objaverse.VAL_INTERVAL,
                                 objaverse.OPENGL, objaverse.SYNTHETIC, subject)
              for split in ("train", "test")}
    labels = cluster_cameras(c2w, 2)
    check(labels.tolist() == FIXTURE36_K2, f"k-means labels {labels.tolist()}")
    sizes = {s: [b.num_images for b in blocks] for s, blocks in splits.items()}
    check(sizes == {"train": [17, 17], "test": [1, 1]}, f"block sizes {sizes}")
    frames = read_world_frame_transforms(data_dir)
    check(sorted(frames) == [0, 1], f"world_frame_transforms.json blocks {sorted(frames)}")
    for k, T in frames.items():
        orth = np.abs(T[:3, :3] @ T[:3, :3].T - np.eye(3)).max()
        check(T.shape == (4, 4) and orth < 1e-6 and abs(np.linalg.det(T[:3, :3]) - 1) < 1e-6
              and np.array_equal(T[3], [0, 0, 0, 1]), f"frame {k} not rigid: {T}")
    cam_err = 0.0
    for split, blocks in splits.items():
        for b in blocks:
            ids = np.flatnonzero(labels == b.block_id)
            ids = ids[split_indices(len(ids), split, objaverse.VAL_INTERVAL)]
            want = apply_world_frame(c2w[ids], frames[b.block_id].astype(np.float64))
            cam_err = max(cam_err, float(np.abs(b.camtoworlds - want).max()))
    check(cam_err <= 1e-6, f"block cameras off their frames by {cam_err}")
    reach = [_sphere_reach(np, frames[k]) for k in (0, 1)]
    check(max(reach) < 1.0, f"the spheres reach {reach} in the blocks' frames: outside the aabb")
    print(f"multi-block split: labels {labels.tolist()}, train/test views a block {sizes}, "
          f"cameras within {cam_err:.2e} of the frames' map, spheres reach {reach[0]:.4f} and "
          f"{reach[1]:.4f} of the +-1 aabb; {time.perf_counter() - t0:.3f} s", flush=True)

    flags = SHAPE_FLAGS + ["--root_dir", os.path.join(out_dir, "images"), "--scene", subject,
                           "--out_dir", os.path.join(out_dir, "nerf_models"), "--expname",
                           subject, "--max_iterations", str(MB_STEPS), "--n_checkpoint",
                           str(MB_STEPS), "--n_validation", str(1 << 30), "--n_tensorboard",
                           str(MB_STEPS // 4)]
    cfg = config_parser(flags)
    res = cfg.grid_resolution
    steps, checks, restore = _block_recorder(torch, MB_CHECK_STEP)
    timings = {}
    real_sample = Evaluator.sample_points

    def sample_points(self):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_sample(self)
        torch.cuda.synchronize()
        timings[self.model_dir] = time.perf_counter() - t
        return out

    Evaluator.sample_points = sample_points
    _reset_kernel_launches()
    try:
        t1 = time.perf_counter()
        trainers = train_blocks(cfg, splits["train"], splits["test"])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        train_launches = _kernel_launches()
        model_dirs = [t.output_dir for t in trainers]
        results = eval_blocks(cfg, model_dirs, splits["test"])
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    finally:
        restore()
        Evaluator.sample_points = real_sample
    launches = _kernel_launches()
    check(len(trainers) == 2 and all(t.device.type == "cuda" for t in trainers),
          "two blocks trained on the card")
    check(launches["gather_rows"] == 0 and launches["scatter_add"] == 0,
          f"multi-block: K2p or K1 launched: {launches}")
    per_block = []
    for k, trainer in enumerate(trainers):
        rec = steps[id(trainer)]
        check([r[0] for r in rec] == list(range(MB_STEPS)), f"block {k}: steps run")
        steady = [r for r in rec if r[0] % OCC_UPDATE_INTERVAL]
        bad = [r[:2] for r in steady if not _ngp_step_ok(r[1], k1p_k2_step(MB_LEVELS))]
        check(not bad, f"block {k}: steps without an occupancy update whose K1p/K2 launches "
              f"(host, replayed, captures, replays) are not 4/1/1/1: {bad[:8]}")
        calls = checks.get(id(trainer), [])
        check(len(calls) == 1 and all(eq for _, _, eq in calls),
              f"block {k}: K2 against its plain forward at step {MB_CHECK_STEP}: {calls}")
        late = [r for r in steady if r[0] >= MB_STEPS - 64]
        ms = statistics.mean(r[2].elapsed_time(r[3]) for r in late)
        val_psnr = trainer.validate(MB_STEPS)
        check(math.isfinite(val_psnr), f"block {k}: val psnr {val_psnr}")
        metrics, extracted = results[k]
        n_surface = int((extracted["surface_mask"] & extracted["density_mask"]).sum())
        cams = len(trainer.scene.camtoworlds)
        rays = len(extracted["points"]) * cams
        grid = torch.load(os.path.join(model_dirs[k], "voxel_grid.pt"))
        check(tuple(grid.shape) == (res,) * 3 + (7,) and bool(torch.isfinite(grid).all()),
              f"block {k}: voxel_grid.pt {tuple(grid.shape)}")
        check(n_surface > 0, f"block {k}: empty surface mask at step {MB_STEPS}")
        check(math.isfinite(metrics["psnr"]), f"block {k}: eval psnr {metrics['psnr']}")
        per_block.append({"ms_per_step": ms, "val_psnr": val_psnr, "eval_psnr": metrics["psnr"],
                          "surface_voxels": n_surface, "occupied_voxels": len(extracted["points"]),
                          "cameras": cams, "extract_s": timings[model_dirs[k]],
                          "rays_per_s": rays / timings[model_dirs[k]], "k2_checked": calls})
        print(f"multi-block block {k}: {MB_STEPS} steps, steps {MB_STEPS - 64}-{MB_STEPS - 1} "
              f"without an occupancy update {ms:.2f} ms/step device at bucket "
              f"{trainer.num_rays}; val psnr {val_psnr:.3f}, eval psnr {metrics['psnr']:.3f} "
              f"({metrics['num_views']} test view); K1p/K2 4/1/1/1 in each of {len(steady)} "
              f"steps without an occupancy update; K2 bit for bit against its plain forward at step "
              f"{MB_CHECK_STEP} on {[(shape, n) for shape, n, _ in calls]}; extraction "
              f"{timings[model_dirs[k]]:.3f} s over {len(extracted['points'])} occupied voxels "
              f"and {cams} cameras ({rays / timings[model_dirs[k]]:.1f} rays/s), "
              f"{n_surface} surface voxels", flush=True)
    replayed = _replayed_total(steps)
    print(f"multi-block: train_blocks {t2 - t1:.3f} s, eval_blocks {t3 - t2:.3f} s; host "
          f"launches in training {train_launches}, in the whole run {launches}; "
          f"replayed (derived) {replayed}", flush=True)

    shares = frame_shares(torch, np, model_dirs, frames, res, trainers[0].device)
    print(f"multi-block frames: share of block 0's surface voxels within {MB_FRAME_RADIUS} voxel "
          f"widths of block 1's after T1 T0^-1 {shares['T1 T0^-1']:.4f} (stated minimum "
          f"{MB_FRAME_SHARE}), after the swapped T0 T1^-1 {shares['T0 T1^-1']:.4f} (stated "
          f"maximum {MB_SWAPPED_SHARE})", flush=True)
    check(shares["T1 T0^-1"] >= MB_FRAME_SHARE and shares["T0 T1^-1"] <= MB_SWAPPED_SHARE,
          f"frame check: shares {shares}")

    # the pair through stage 3: the pose from the port's own frames
    ckpt = os.path.join(out_dir, "chip_smoke_mb_reg", "model", "model.ckpt")
    reg_cfg = config_parser(["--out_dir", out_dir, "--expname", "chip_smoke_mb_reg",
                             "--root_dir", out_dir, "--scene", subject, "--ckpt_path", ckpt,
                             "--icp_refine"])
    dataset = NeRFRegDataset(out_dir, subject_id=subject, split="test", seed=reg_cfg.seed)
    check(len(dataset) == 1, "NeRFRegDataset reads the trained pair")
    item = dataset[0]
    src, tgt = item["block_list"]
    want = frames[tgt].astype(np.float64) @ np.linalg.inv(frames[src].astype(np.float64))
    pose_err = float(np.abs(item["pose"] - want).max())
    check(pose_err <= 1e-6, f"pair pose off tgt_T inv(src_T) by {pose_err}")
    rng = np.random.default_rng(0)
    d = reg_cfg.position_embedding_dim
    save_reg_checkpoint(ckpt, random_jax_params(make_reg_model(reg_cfg), rng),
                        (rng.standard_normal((d, d)) * 0.1).astype(np.float32), {"step": 0})
    ev = RegEvaluator(reg_cfg, dataset)
    t4 = time.perf_counter()
    agg = ev.evaluate()["aggregate"]
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    with open(os.path.join(ev.output_dir, "fgr_metrics_test.json")) as f:
        fgr = json.load(f)
    base = fgr["per_scene"].get(subject, {})
    check(agg["num_pairs"] == 1 and math.isfinite(agg["R_mean"])
          and os.path.exists(os.path.join(ev.output_dir, "metrics_test.json")),
          f"RegEvaluator.evaluate() on the trained pair: {agg}")
    check(all(math.isfinite(base.get(k, math.nan)) for k in ("R_error_deg", "t_error")),
          f"classical baseline on the trained pair: {base}")
    print(f"multi-block pair (blocks {src} -> {tgt}): pose within {pose_err:.2e} of "
          f"tgt_T inv(src_T); {int(item['src_mask'].sum())} and {int(item['tgt_mask'].sum())} "
          f"surface voxels; RegEvaluator.evaluate() --icp_refine {t5 - t4:.3f} s: random "
          f"weights RRE {agg['R_mean']:.4f} deg, RTE {agg['t_mean']:.5f}; classical baseline "
          f"RRE {base['R_error_deg']:.4f} deg, RTE {base['t_error']:.5f} in "
          f"{base['time']:.3f} s, winner {base['winner']}", flush=True)
    return {"launches": launches, "train_launches": train_launches, "replayed": replayed,
            "blocks": per_block,
            "frame_shares": shares, "baseline": {k: base[k] for k in ("R_error_deg", "t_error",
                                                                       "winner")},
            "grid": trainers[0].grid, "model_dirs": model_dirs, "subject": subject,
            "reg_ckpt": ckpt}


def stage3_fleet_phase(torch, out_dir: str) -> dict:
    """The twin of the stage-3 experiment at full width and small depth
    (see the module docstring): the scenes' shapes and the box scene's
    RGBA, its stage1_and_2, stage3 and evaluate with K1p and K2 held
    against their plain versions at L8F4's width, the regdata tree, finite
    losses and the metrics files. Returns the launches, seconds and the
    held-out pairs' errors."""
    import numpy as np

    from dregnerf_tpu_torch.datasets import fixtures
    from dregnerf_tpu_torch.runtime.ngp_trainer import OCC_UPDATE_INTERVAL
    from dregnerf_tpu_torch.runtime.reg_trainer import RegTrainer
    from dregnerf_tpu_torch.scripts.experiments import stage3_fleet as twin

    knobs = twin.Knobs(scenes=2, test_scenes=1, ngp_iters=S3_NGP_STEPS, views=S3_VIEWS,
                       img=S3_IMG, reg_iters=S3_REG_STEPS, baseline_draws=S3_BASELINE_DRAWS,
                       work=os.path.join(out_dir, "stage3_fleet"),
                       out=os.path.join(out_dir, "stage3_fleet_out"))
    model = knobs.ngp_model()
    check(model.grid.n_levels == S3_LEVELS and 8 * model.grid.n_features == S3_WIDTH
          and model.grid.log2_table_size == 19 and model.grid.grad_accum == "bf16"
          and model.grid.rle_step_u == 0.0, f"the twin's default blocks: {model.grid}")

    shapes = [twin.scene_shapes(i) for i in range(knobs.scenes)]
    kinds = [[np.shape(size) for _, size, _ in scene] for scene in shapes]
    check(3 <= len(kinds[0]) <= 5 and all(k == () for k in kinds[0])
          and 3 <= len(kinds[1]) <= 5 and all(k == (3,) for k in kinds[1]),
          f"scene shapes: {kinds}")
    t0 = time.perf_counter()
    images, c2w = fixtures.render_views(S3_VIEWS, S3_IMG, seed=1, spheres=shapes[1])
    want = np.stack([(fixtures._trace(*fixtures.view_rays(c, S3_IMG), shapes[1])
                      .reshape(S3_IMG, S3_IMG, 4) * 255).astype(np.uint8) for c in c2w])
    check(images.tobytes() == want.tobytes(), "the box scene's RGBA != _trace's")
    check(float((images[..., 3] > 0).mean()) > 0.05, "the box scene covers no pixels")
    print(f"stage3 fleet scenes: scene_00 {len(kinds[0])} spheres, scene_01 {len(kinds[1])} "
          f"boxes; the box scene's {S3_VIEWS} RGBA views byte for byte _trace's "
          f"({float((images[..., 3] > 0).mean()):.3f} of the pixels covered); "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    k1p_checks = {}
    steps, k2_checks, restore = _block_recorder(torch, S3_CHECK_STEP, S3_LEVELS, k1p_checks)
    reg_metrics, real_iteration = [], RegTrainer.train_iteration

    def reg_iteration(self, item):
        out = real_iteration(self, item)
        reg_metrics.append(out)
        return out

    RegTrainer.train_iteration = reg_iteration
    _reset_kernel_launches()
    try:
        t1 = time.perf_counter()
        reg_root = twin.stage1_and_2(knobs)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        ngp_launches = _kernel_launches()
        trainer, val_ds, test_scenes = twin.stage3(reg_root, knobs)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        result = twin.evaluate(trainer, val_ds, test_scenes, knobs)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
    finally:
        restore()
        RegTrainer.train_iteration = real_iteration
    seconds = {"stage1_and_2": t2 - t1, "stage3": t3 - t2, "evaluate": t4 - t3}
    launches = _kernel_launches()
    check(launches["gather_rows"] == 0 and launches["scatter_add"] == 0,
          f"stage3 fleet: K2p or K1 launched: {launches}")

    check(len(steps) == 2 * knobs.scenes, f"{len(steps)} blocks trained")
    ms, k2_checked, k1p_checked = [], [], []
    for key, rec in steps.items():
        check([r[0] for r in rec] == list(range(S3_NGP_STEPS)), "stage3 fleet: block steps run")
        steady = [r for r in rec if r[0] % OCC_UPDATE_INTERVAL]
        bad = [r[:2] for r in steady if not _ngp_step_ok(r[1], k1p_k2_step(S3_LEVELS))]
        check(not bad, f"stage3 fleet: steps without an occupancy update whose K1p/K2 launches "
              f"(host, replayed, captures, replays) are not {S3_LEVELS}/1/1/1: {bad[:8]}")
        losses = torch.stack([r[4] for r in rec]).tolist()
        check(all(map(math.isfinite, losses)), "stage3 fleet: a non-finite stage-1 loss")
        ms.append(statistics.mean(r[2].elapsed_time(r[3]) for r in steady[-64:]))
        k2, k1p = k2_checks.get(key, []), k1p_checks.get(key, [])
        check(len(k2) == 1 and all(eq for _, _, eq in k2)
              and all(8 * shape[1] == S3_WIDTH for shape, _, _ in k2),
              f"stage3 fleet: K2 against its plain forward at step {S3_CHECK_STEP}: {k2}")
        check(len(k1p) == S3_LEVELS and all(r <= 1.0 for _, _, r in k1p)
              and all(shape[1] == S3_WIDTH for shape, _, _ in k1p),
              f"stage3 fleet: K1p against its plain version at step {S3_CHECK_STEP}: {k1p}")
        k2_checked += k2
        k1p_checked += k1p

    surface = {}
    for scene in twin.scene_names(knobs):
        frames = os.path.join(reg_root, "images", scene, "world_frame_transforms.json")
        check(os.path.exists(frames), f"regdata: {frames}")
        for k in range(2):
            block = os.path.join(reg_root, "nerf_models", scene, f"block_{k}")
            for rel in ("model/model.ckpt", "voxel_grid.pt", "voxel_mask.pt",
                        "voxel_point_cloud.ply"):
                check(os.path.getsize(os.path.join(block, rel)) > 0, f"regdata: {block}/{rel}")
            surface[f"{scene}/block_{k}"] = int(
                torch.load(os.path.join(block, "voxel_mask.pt")).numel())
    check(all(n > 0 for n in surface.values()),
          f"stage3 fleet: a block with no surface voxel at step {S3_NGP_STEPS}: {surface}")

    check(len(reg_metrics) == S3_REG_STEPS, f"{len(reg_metrics)} stage-3 steps")
    reg_losses = [{k: float(m[k]) for k in (*LOSS_NAMES, "skipped_nonfinite")}
                  for m in reg_metrics]
    check(all(math.isfinite(m[k]) for m in reg_losses for k in LOSS_NAMES)
          and not any(m["skipped_nonfinite"] for m in reg_losses),
          f"stage3 fleet: stage-3 losses {reg_losses}")
    check(result is not None, "stage3 fleet: no held-out evaluation")
    for name in ("metrics_test.json", "fgr_metrics_test.json", "stage1_psnr.json"):
        check(os.path.exists(os.path.join(knobs.out, name)), f"stage3 fleet: {name} written")
    pairs = {side: [{k: p.get(k) for k in ("scene", "draw", "RRE", "RTE", "RRE_icp", "RTE_icp",
                                           "winner", "error")}
                    for p in result[side]["pairs"]] for side in ("regtr", "fgr")}
    check(len(pairs["regtr"]) == 2 and len(pairs["fgr"]) == S3_BASELINE_DRAWS
          and all(math.isfinite(p["RRE"]) and math.isfinite(p["RTE"]) for p in pairs["regtr"]),
          f"stage3 fleet: held-out pairs {pairs}")
    with open(os.path.join(knobs.out, "stage1_psnr.json")) as f:
        psnr = json.load(f)
    print(f"stage3 fleet: {2 * knobs.scenes} L8F4 blocks of {S3_NGP_STEPS} steps, "
          f"{statistics.mean(ms):.2f} ms/step device (steps without an occupancy update, last "
          f"64 a block; {[round(x, 2) for x in ms]}), val PSNR {psnr}, surface voxels "
          f"{surface}; K1p/K2 {S3_LEVELS}/1/1/1 in every such step, K2's forward bit for "
          f"bit against its plain version and K1p within its slot bound (worst ratio "
          f"{max(r for _, _, r in k1p_checked):.4f}) on each level's call of step "
          f"{S3_CHECK_STEP} of every block ({len(k2_checked)} + {len(k1p_checked)} calls, "
          f"rows {S3_WIDTH} wide); stage 3: {S3_REG_STEPS} steps, total loss "
          f"{reg_losses[0]['total']:.4f} -> {reg_losses[-1]['total']:.4f}; host launches in "
          f"stage 1-2 {ngp_launches}, in the whole run {launches}; replayed (derived) "
          f"{_replayed_total(steps)}; seconds "
          f"{ {k: round(v, 3) for k, v in seconds.items()} }", flush=True)
    print(f"stage3 fleet held-out {test_scenes}: RegTr (both block orders) {pairs['regtr']}; "
          f"baseline (first {S3_BASELINE_DRAWS}) {pairs['fgr']}", flush=True)
    return {"launches": launches, "replayed": _replayed_total(steps), "seconds": seconds,
            "ms_per_step": ms, "surface_voxels": surface, "val_psnr": psnr, "pairs": pairs,
            "k1p_worst_ratio": max(r for _, _, r in k1p_checked),
            "index_checks": len(k2_checked) + len(k1p_checked)}


def novel_views_phase(torch, multi: dict, out_dir: str) -> dict:
    """The multi-block pair's NeRFs rendered (see the module docstring,
    phase 8): one frame card against CPU, then RegEvaluator.evaluate()
    with --render_videos; returns K2's forward launches and the render times."""
    import shutil

    import numpy as np

    from dregnerf_tpu_torch.datasets.register_pairs import NeRFRegDataset
    from dregnerf_tpu_torch.eval_nerf_regtr import RegEvaluator
    from dregnerf_tpu_torch.render import novel_views
    from dregnerf_tpu_torch.runtime.checkpoint import load_checkpoint
    from dregnerf_tpu_torch.runtime.config import config_parser
    from dregnerf_tpu_torch.utils.png import read_png

    # card against CPU: block 0 from its first training camera
    ckpt0 = os.path.join(multi["model_dirs"][0], "model", "model.ckpt")
    _, meta = load_checkpoint(ckpt0)
    pose = np.asarray(meta["camera_poses"], np.float32)[:1]
    renders = []  # (rgb, opacity, depth) of the card's render, then the CPU's
    real_render = novel_views.render_image_chunked

    def recorded(*args, **kwargs):
        out = real_render(*args, **kwargs)
        renders.append([t.float().cpu().numpy() for t in out])
        return out

    novel_views.render_image_chunked = recorded
    seconds = {}
    try:
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            paths = novel_views.synthesize_novel_views(
                ckpt0, pose, os.path.join(out_dir, "novel_views", dev), "objaverse", NV_FACTOR,
                device=dev)
            torch.cuda.synchronize()
            seconds[dev] = time.perf_counter() - t0
            check(len(paths) == 1 and read_png(paths[0]).shape == (100, 100, 3),
                  f"synthesize_novel_views on {dev}: {paths}")
    finally:
        novel_views.render_image_chunked = real_render
    check(len(renders) == 2, f"{len(renders)} renders for one frame on two devices")
    (rgb, opacity, depth), (rgb_c, _, depth_c) = renders
    err = np.abs(rgb - rgb_c)
    psnr = -10.0 * math.log10(max(float(np.mean(err ** 2)), 1e-20))
    derr = np.abs(depth - depth_c)
    share = float(np.mean(opacity > 0.5))
    print(f"novel views [card against CPU, block 0 from its first training camera, "
          f"{rgb.shape[0]} rays]: rgb max abs err {err.max():.3e}, mean {err.mean():.3e}, PSNR "
          f"{psnr:.3f} dB (stated minimum {NV_PSNR_MIN}); depth max abs err {derr.max():.3e}, "
          f"mean {derr.mean():.3e}; opacity > 0.5 on {share:.4f} of the pixels (stated minimum "
          f"{NV_OPACITY_SHARE_MIN}); {seconds['cuda']:.3f} s on the card, {seconds['cpu']:.3f} "
          f"s on the CPU (load and one render)", flush=True)
    check(psnr >= NV_PSNR_MIN and share >= NV_OPACITY_SHARE_MIN and np.isfinite(rgb).all()
          and np.isfinite(depth).all(),
          f"novel views card against CPU: PSNR {psnr}, opacity share {share}")

    # the evaluator's --render_videos on the pair, timed through a spy
    subject = multi["subject"]
    cfg = config_parser(["--out_dir", out_dir, "--expname", "chip_smoke_mb_videos",
                         "--root_dir", out_dir, "--scene", subject, "--ckpt_path",
                         multi["reg_ckpt"], "--render_videos"])
    dataset = NeRFRegDataset(out_dir, subject_id=subject, split="test", seed=cfg.seed)
    ev = RegEvaluator(cfg, dataset)
    spans = []
    real_pair = novel_views.render_pair_views

    def timed_pair(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_pair(*args, **kwargs)
        torch.cuda.synchronize()
        spans.append(time.perf_counter() - t)
        return out

    novel_views.render_pair_views = timed_pair
    try:
        t1 = time.perf_counter()
        _reset_kernel_launches()
        ev.evaluate()
        counts = _kernel_launches()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    finally:
        novel_views.render_pair_views = real_pair
    scene_dir = os.path.join(ev.output_dir, subject)
    ffmpeg = shutil.which("ffmpeg") is not None
    for tag in NV_TAGS:
        for side in ("src", "tgt"):
            sub = os.path.join(scene_dir, f"{tag}_{side}_images")
            for i in range(NV_ORBIT):
                frame = os.path.join(sub, f"frame_{i:04d}.png")
                depth_path = os.path.join(sub, f"depth_{i:04d}.npy")
                check(os.path.exists(frame) and read_png(frame).shape == (100, 100, 3)
                      and os.path.exists(depth_path)
                      and np.load(depth_path).shape == (100, 100),
                      f"--render_videos: {tag} {side} frame {i} missing or misshapen")
            check(len(os.listdir(sub)) == 2 * NV_ORBIT, f"{sub}: {sorted(os.listdir(sub))}")
        pair_dir = os.path.join(scene_dir, f"{tag}_images")
        frames = sorted(f for f in os.listdir(pair_dir) if f.startswith("frame_"))
        check(len(frames) == NV_ORBIT and all(
            read_png(os.path.join(pair_dir, f)).shape == (100, 400, 3) for f in frames),
            f"--render_videos: {tag} pair frames {frames}")
        mp4 = os.path.exists(os.path.join(scene_dir, f"{tag}_src_tgt_rgb_depth.mp4"))
        check(mp4 == ffmpeg, f"{tag}: mp4 written {mp4}, ffmpeg on PATH {ffmpeg}")
    n_renders = len(NV_TAGS) * 2 * NV_ORBIT
    render_s = sum(spans)
    rays = n_renders * 100 * 100
    check(len(spans) == len(NV_TAGS), f"render_pair_views ran {len(spans)} times")
    launches = counts["packed_grid_fwd"]
    check(launches > 0 and counts["scatter_add"] == counts["scatter_add_bf16"]
          == counts["gather_rows"] == 0,
          f"--render_videos launches (K2's forward must launch, K1, K1p and K2p not): {counts}")
    print(f"novel views [RegEvaluator.evaluate() --render_videos, {len(NV_TAGS)} tags x "
          f"{NV_ORBIT} orbit cameras x 2 NeRFs = {n_renders} renders of 100 x 100]: every "
          f"frame, depth and pair frame written; mp4 {'written (ffmpeg on PATH)' if ffmpeg else 'not written (no ffmpeg on PATH)'}; "
          f"K2 forward launches {launches} (expected {NV_K2_PER_RENDER} a render = "
          f"{NV_K2_PER_RENDER * n_renders}), K1, K1p and K2p none; render_pair_views "
          f"{render_s:.3f} s "
          f"({[round(x, 3) for x in spans]} s a tag): {n_renders / render_s:.2f} renders/s, "
          f"{len(NV_TAGS) * NV_ORBIT / render_s:.2f} pair frames/s, {rays / render_s:.1f} "
          f"rays/s; evaluate() {t2 - t1:.3f} s in all", flush=True)
    return {"k2_launches": launches, "render_s": render_s, "renders": n_renders,
            "rays_per_s": rays / render_s, "psnr_card_cpu": psnr, "opacity_share": share,
            "ffmpeg": ffmpeg}


def marcher_phase(torch, grid, out_dir: str) -> dict:
    """The "compact" and "quota" training marchers: at the training shapes
    (2^15 rays, 1024 steps, a 2^18 budget, a trained block's 128^3 grid) the
    card against the CPU on the same rays and jitter; the time of each one's
    cumsum (flat for compact, by rows for quota); then MARCH_STEPS full-width
    training steps under each and under "capped" from the same start.
    Returns the K1p and K2 launches of each marcher's steps."""
    from dregnerf_tpu_torch.ops import ray_march
    from dregnerf_tpu_torch.ops.occupancy import OccupancyGrid
    from dregnerf_tpu_torch.runtime.config import config_parser
    from dregnerf_tpu_torch.runtime.ngp_trainer import NGPTrainer

    rays, steps, budget = 1 << 15, 1024, 1 << 18
    g = torch.Generator().manual_seed(5)
    target = torch.rand(rays, 3, generator=g) * 1.6 - 0.8
    origins = torch.randn(rays, 3, generator=g)
    origins = 3.0 * origins / origins.norm(dim=-1, keepdim=True)
    dirs = target - origins
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    jitter = torch.rand(rays, 1, generator=g)
    aabb = torch.tensor([-1.0, -1, -1, 1, 1, 1])
    step = 2.0 * math.sqrt(3.0) / steps
    cpu_grid = OccupancyGrid(grid.occs.cpu(), grid.binary.cpu())
    dev = grid.binary.device
    out = {}
    for mode in ("compact", "quota"):
        args = ("aabb", step, budget, steps)
        want = ray_march.march_rays(origins, dirs, cpu_grid, aabb, *args, jitter=jitter,
                                    compaction=mode)
        got, wall, ms = device_call(torch, lambda: ray_march.march_rays(
            origins.to(dev), dirs.to(dev), grid, aabb.to(dev), *args, jitter=jitter.to(dev),
            compaction=mode))
        t_err = float((got.t_start.cpu() - want.t_start).abs().max())
        same = (torch.equal(got.ray_id.cpu(), want.ray_id)
                and torch.equal(got.valid.cpu(), want.valid)
                and int(got.num_samples) == int(want.num_samples))
        check(same and t_err <= 1e-6, f"{mode} marcher card against CPU: samples equal {same}, "
              f"t_start err {t_err}")
        print(f"march [{mode}] at {rays} rays x {steps} steps, budget {budget}: card equals "
              f"the CPU ({int(want.num_samples)} samples, t_start within {t_err:.1e}); "
              f"{ms:.3f} ms on the card (first call, {wall:.3f} ms wall)", flush=True)
    mask = torch.rand(rays, steps, device=dev) < 0.3
    flat_ms = cuda_ms(lambda: torch.cumsum(mask.reshape(-1).to(torch.int32), 0,
                                           dtype=torch.int32))
    rows_ms = cuda_ms(lambda: torch.cumsum(mask.to(torch.int32), dim=1, dtype=torch.int32))
    print(f"march cumsum over [{rays}, {steps}] (int32): the flat scan of compact "
          f"{flat_ms:.4f} ms, the row scan of quota {rows_ms:.4f} ms", flush=True)
    del mask

    scene, val_scene = _scenes()
    for mode in ("capped", "compact", "quota"):
        cfg = config_parser(SHAPE_FLAGS + ["--expname", f"chip_smoke_{mode}", "--out_dir",
                                           out_dir, "--march_compaction", mode])
        trainer = NGPTrainer(cfg, scene, val_scene)
        torch.cuda.synchronize()
        _reset_kernel_launches()
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(MARCH_STEPS + 1)]
        per_step, losses = [], []
        marks[0].record()
        for i in range(MARCH_STEPS):
            before = _ngp_marks(trainer)
            m = trainer.train_iteration(i)
            marks[i + 1].record()
            losses.append(m["loss"])
            per_step.append(_ngp_launches(trainer, before))
        torch.cuda.synchronize()
        losses = [float(x) for x in losses]
        check(all(math.isfinite(x) for x in losses), f"{mode}: losses {losses}")
        check(all(_ngp_step_ok(p, k1p_k2_step(4)) for p in per_step[1:]),
              f"{mode}: K1p/K2 launches (host, replayed, captures, replays) a step {per_step}")
        ms = statistics.mean(marks[i].elapsed_time(marks[i + 1]) for i in range(1, MARCH_STEPS))
        replayed = {k: sum(p[1][j] for p in per_step) for j, k in enumerate(K1P_K2)}
        out[mode] = {"launches": _kernel_launches(), "replayed": replayed, "ms_per_step": ms}
        print(f"train [{mode}]: {MARCH_STEPS} steps from scratch at bucket {cfg.init_num_rays}, "
              f"steps 1-{MARCH_STEPS - 1} {ms:.2f} ms/step device; losses "
              f"{[round(x, 5) for x in losses]}; K1p/K2 launches a step (host, replayed "
              f"(derived), captures, replays) {per_step}", flush=True)
        del trainer
        torch.cuda.empty_cache()
    return out


def _bf16_table_bound(torch, packed_grid, grid_cfg, levels: dict):
    """Per vertex-table entry, the bound of the difference of two
    bf16-accumulated table gradients of the same rows: a packed slot hit k
    times by rows g differs by at most (k + 1) 2^-7 sum|g| (k roundings of
    the adds and of the addends, whose cotangents may round to neighbouring
    bf16 values), carried to the vertex table through pack_table. `levels`:
    {level: (slot, g, table_rows)} of one run's scatters."""
    tols = []
    for level in range(grid_cfg.n_levels):
        slot, gl, rows = levels[level]
        slot, gl = slot.cpu(), gl.float().cpu()
        k = torch.bincount(slot, minlength=rows).float()[:, None]
        tols.append((k + 1.0) * 2.0**-7
                    * torch.zeros(rows, gl.shape[1]).index_add_(0, slot, gl.abs()))
    vt = torch.zeros(grid_cfg.total_rows, grid_cfg.n_features, requires_grad=True)
    sum((p * t).sum() for p, t in zip(packed_grid.pack_table(vt, grid_cfg), tols)).backward()
    return vt.grad


def _grads_agree(torch, packed_grid, grid_cfg, got: list, want: list, levels: list,
                 label: str) -> dict:
    """Two full-width steps' gradients on the card, from the same state on
    the same draws. The card's backward is not deterministic: two runs of
    one step give the same loss and samples but cotangents up to about
    1.5e-10 apart (the compositor's atomics), so the per-slot bf16 bound of
    _bf16_table_bound holds on all but the slots of the smallest sums.
    Required: the table gradient within GRAD_NORM_TOL of the reference's
    norm, and every MLP leaf within GRAD_NORM_TOL of its max (the reference
    phase's bf16 tolerance); the entries over the bf16 bound (the mean of
    the bounds of `levels`, each one run's scatters, as many as the
    gradient averages) are counted."""
    bound = sum(_bf16_table_bound(torch, packed_grid, grid_cfg, lv) for lv in levels) / len(levels)
    a, b = got[0].float().cpu(), want[0].float().cpu()
    err = (a - b).abs()
    norm = (err.norm() / b.norm().clamp(min=1e-30)).item()
    check(norm <= GRAD_NORM_TOL, f"{label}: table gradient {norm} of its norm apart")
    mlp = 0.0
    for x, y in zip(got[1:], want[1:]):
        scale = max(y.abs().max().item(), 1e-30)
        mlp = max(mlp, (x.float().cpu() - y.float().cpu()).abs().max().item() / scale)
    check(mlp <= GRAD_NORM_TOL, f"{label}: MLP gradient rel err {mlp}")
    return {"table_rel_norm": norm, "over_bf16_bound": int((err > bound).sum()),
            "entries": err.numel(), "mlp_rel_err": mlp}


def fleet_phase(torch, out_dir: str) -> dict:
    """The fleet (see the module docstring, phase 9b): the fixture's two
    k-means blocks trained together on the card through
    train_ngp_nerf.train_fleet (what train() runs under --multi_blocks
    --fleet; the on-disk loader needs imageio, which the card's machine
    lacks, so the blocks are made in memory as in the multi-block phase)."""
    import numpy as np

    from dregnerf_tpu_torch.datasets import objaverse
    from dregnerf_tpu_torch.datasets.base import make_blocks
    from dregnerf_tpu_torch.datasets.fixtures import render_views
    from dregnerf_tpu_torch.models import ngp
    from dregnerf_tpu_torch.ops import packed_grid
    from dregnerf_tpu_torch.parallel import fleet as pfleet
    from dregnerf_tpu_torch.runtime import fleet_trainer
    from dregnerf_tpu_torch.runtime.config import config_parser
    from dregnerf_tpu_torch.runtime.ngp_trainer import (
        NGPTrainer,
        OCC_UPDATE_INTERVAL,
        draw_step_inputs,
        launches as host_launches,
        step_loss,
    )
    from dregnerf_tpu_torch.train_ngp_nerf import train_fleet

    subject = "fixture_fleet"
    data_dir = os.path.join(out_dir, "images", subject)
    os.makedirs(data_dir)
    images, c2w = render_views(36, 128)
    K = objaverse.intrinsics(128, 128, 0.9)
    splits = {split: make_blocks(data_dir, images, c2w.astype(np.float32)[:, :3, :4], K, split,
                                 2, objaverse.VAL_INTERVAL, objaverse.OPENGL,
                                 objaverse.SYNTHETIC, subject)
              for split in ("train", "test")}
    cfg = config_parser(SHAPE_FLAGS + [
        "--root_dir", os.path.join(out_dir, "images"), "--scene", subject, "--out_dir",
        os.path.join(out_dir, "fleet_models"), "--expname", subject, "--multi_blocks",
        "--fleet", "--max_iterations", str(FLEET_STEPS), "--n_tensorboard",
        str(FLEET_STEPS // 4)])

    # record each block-step (launches, CUDA events), the first step's
    # state, draws and gradients, and block 0's K2 forward at step 1
    real_block_step, real_fleet_step = pfleet.block_step, fleet_trainer.fleet_train_step
    real_forward = packed_grid._k2_forward
    block_rec, fleet_rec, first, k2_calls, current = [], [], {}, [], [None]

    def forward(table, x, config):
        out = real_forward(table, x, config)
        if current[0] == (1, 0) and not k2_calls:
            k2_calls.append((tuple(table.shape), int(x.shape[0]),
                             torch.equal(out, packed_grid.k2_forward_plain(table, x, config))))
        return out

    def block_step(trainer, step, num_rays, draws=None):
        k = fleet_index[id(trainer)]
        if step == 0:
            scene = trainer.scene
            draws = draw_step_inputs(trainer.generator, num_rays, scene.num_images,
                                     scene.height, scene.width, trainer.device)
            rec = first[k] = {
                "params": {n: ([w.detach().clone() for w in v] if isinstance(v, list)
                               else v.detach().clone()) for n, v in trainer.params.items()},
                "grid": type(trainer.grid)(*(t.clone() for t in trainer.grid)),
                "draws": draws}
            real_apply = trainer.apply_gradients

            def apply(i):
                rec["grads"] = [p.grad.detach().clone() for p in ngp.parameters(trainer.params)]
                trainer.apply_gradients = real_apply
                real_apply(i)

            trainer.apply_gradients = apply
        current[0] = (step, k)
        before = host_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            out = real_block_step(trainer, step, num_rays, draws)
        finally:
            current[0] = None
        end.record()
        if step == 0:
            first[k]["loss"] = out["loss"]
        after = host_launches()
        block_rec.append((step, k, tuple(after[n] - before[n] for n in K1P_K2), start, end))
        return out

    def fleet_step(trainers, step, num_rays, draws=None):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_fleet_step(trainers, step, num_rays, draws)
        end.record()
        fleet_rec.append((step, start, end))
        return out

    real_init = NGPTrainer.__init__
    fleet_index = {}

    def init(self, *args, **kwargs):  # number the blocks' trainers as they are built
        real_init(self, *args, **kwargs)
        fleet_index[id(self)] = len(fleet_index)

    NGPTrainer.__init__ = init
    pfleet.block_step, fleet_trainer.fleet_train_step = block_step, fleet_step
    packed_grid._k2_forward = forward
    _reset_kernel_launches()
    try:
        t0 = time.perf_counter()
        fleet = train_fleet(cfg, splits["train"], splits["test"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        NGPTrainer.__init__ = real_init
        pfleet.block_step, fleet_trainer.fleet_train_step = real_block_step, real_fleet_step
        packed_grid._k2_forward = real_forward
    launches = _kernel_launches()
    trainers = fleet.trainers
    check(len(trainers) == 2 and all(t.device.type == "cuda" for t in trainers)
          and fleet.blocks == [0, 1], f"fleet: blocks {fleet.blocks} on the card")
    check(launches["scatter_add"] == 0 and launches["gather_rows"] == 0,
          f"K1 or K2p ran in the fleet at the CLI defaults: {launches}")
    bad = [(s, k, n) for s, k, n, _, _ in block_rec if n != k1p_k2_step(MB_LEVELS)]
    check(len(block_rec) == 2 * FLEET_STEPS and not bad,
          f"fleet: {len(block_rec)} block-steps, K1p/K2 launches other than 4/1/1/1: {bad[:8]}")
    check(len(k2_calls) == 1 and all(eq for _, _, eq in k2_calls),
          f"fleet: K2 against its plain forward at step 1 of block 0: {k2_calls}")
    quiet = [r for r in fleet_rec if r[0] % OCC_UPDATE_INTERVAL and r[0] >= FLEET_STEPS // 2]
    fleet_ms = statistics.mean(a.elapsed_time(b) for _, a, b in quiet)
    block_ms = statistics.mean(a.elapsed_time(b) for s, _, _, a, b in block_rec
                               if s % OCC_UPDATE_INTERVAL and s >= FLEET_STEPS // 2)

    # each block's first step against one NGPTrainer step from the same
    # state on the same draws (the reference phase's defaults tolerance)
    first_step = []
    for k, t in enumerate(trainers):
        rec = first[k]
        params = {n: ([w.clone().requires_grad_(True) for w in v] if isinstance(v, list)
                      else v.clone().requires_grad_(True)) for n, v in rec["params"].items()}
        seen = {}
        real = _record_scatters(packed_grid, seen)
        try:
            loss, _ = step_loss(params, t.model_config, t.render_config, rec["grid"], t.aabb,
                                t.images, t.c2ws, t.K, rec["draws"], t.scene.synthetic,
                                t.scene.opengl)
            loss.backward()
        finally:
            packed_grid.level_backward = real
        l0, l1 = loss.item(), rec["loss"].item()
        check(math.isclose(l0, l1, rel_tol=1e-3), f"fleet block {k}: first loss {l1} vs {l0}")
        agree = _grads_agree(torch, packed_grid, t.model_config.grid, rec["grads"],
                             [p.grad for p in ngp.parameters(params)], [seen["cuda"]],
                             f"fleet block {k} step 0")
        first_step.append({"loss": l1, "reference_loss": l0, **agree})
    del first

    blocks = []
    for k, t in enumerate(trainers):
        _check_checkpoint_round_trip(torch, t, FLEET_STEPS)
        blocks.append({"val_psnr": fleet.val_psnr[k], "first_step": first_step[k]})
        check(math.isfinite(fleet.val_psnr[k]), f"fleet block {k}: val psnr {fleet.val_psnr[k]}")
    busy_ms, _, _, profiled_ms = profiled(
        torch, lambda: [pfleet.fleet_train_step(trainers, s, cfg.init_num_rays)
                        for s in range(FLEET_STEPS + 1, FLEET_STEPS + 1 + PROFILE_STEPS)],
        PROFILE_STEPS, f"fleet profile: fleet steps {FLEET_STEPS + 1}-"
        f"{FLEET_STEPS + PROFILE_STEPS}", "fleet step")
    out = {"fleet_ms": fleet_ms, "block_ms": block_ms, "busy_ms": busy_ms,
           "profiled_ms": profiled_ms, "idle_share": 1 - busy_ms / fleet_ms, "wall_s": wall,
           "launches": launches, "blocks": blocks, "k2_checked": k2_calls}
    print(f"fleet: {FLEET_STEPS} fleet steps of 2 blocks at {cfg.init_num_rays} rays a block "
          f"in {wall:.3f} s wall (with the checkpoints and the validations); fleet steps "
          f"{FLEET_STEPS // 2}-{FLEET_STEPS - 1} without an occupancy update "
          f"{fleet_ms:.3f} ms/fleet step, {block_ms:.3f} ms/block-step (CUDA events); device "
          f"busy {busy_ms:.3f} ms/fleet step (profiled), idle share {out['idle_share']:.4f}; "
          f"val psnr {[round(b['val_psnr'], 3) for b in blocks]}; K1p/K2 4/1/1/1 in each of "
          f"{len(block_rec)} block-steps, launches {launches}; K2 bit for bit against its "
          f"plain forward at step 1 of block 0 on {[(s, n) for s, n, _ in k2_calls]}; "
          f"first step against NGPTrainer's: {first_step}; checkpoints read back bit for bit",
          flush=True)
    return out


def _set_opt_state(trainer, state: list) -> None:
    """The registration trainer's state back to _opt_state's copies."""
    opt = trainer.optimizer
    for x, y in zip((opt.flat, opt.mu, opt.nu, opt.count, opt.schedule_count), state):
        x.copy_(y)


def _spy_reg_steps(trainer) -> list:
    """Records (flat gradient, total) of every update of the registration
    trainer's optimizer, in the list returned."""
    seen, real = [], trainer.optimizer.step

    def step(grad, loss):
        seen.append((grad.detach().clone(), loss.detach().clone()))
        return real(grad, loss)

    trainer.optimizer.step = step
    return seen


def _rel_norm(torch, got, want) -> float:
    """|got - want| / |want|, in float64."""
    got, want = got.double(), want.double().to(got.device)
    return (torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)).item()


def _snapshot_params(trainer) -> list:
    from dregnerf_tpu_torch.models import ngp

    return [p.detach().clone() for p in ngp.parameters(trainer.params)]


def _bits_checksum(torch, tensors) -> "torch.Tensor":
    """An int64 checksum of the tensors' bits (f32 words summed)."""
    return sum(t.detach().float().reshape(-1).view(torch.int32).to(torch.int64).sum()
               for t in tensors).reshape(1)


def mesh_world1_phase(torch, out_dir: str, block_dir: str, root: str, subject: str) -> dict:
    """The mesh (see the module docstring, phase 12b), first at world size 1
    under NCCL: the stage-1 DP step, a chunk of the sharded surface pass,
    the registration DP step and sharded_attention against their one-device
    paths on the same inputs."""
    import numpy as np
    import torch.distributed as dist

    from dregnerf_tpu_torch.datasets.register_pairs import NeRFRegDataset
    from dregnerf_tpu_torch.extract.sample_grid import (
        compute_surface_mask,
        extraction_render_config,
        occupied_voxel_points,
    )
    from dregnerf_tpu_torch.models import ngp
    from dregnerf_tpu_torch.ops import packed_grid
    from dregnerf_tpu_torch.parallel.mesh import make_mesh
    from dregnerf_tpu_torch.parallel.ngp_dp import dp_train_step
    from dregnerf_tpu_torch.parallel.regtr_dp import dp_reg_step
    from dregnerf_tpu_torch.parallel.sp_attention import sharded_attention
    from dregnerf_tpu_torch.runtime.config import config_parser
    from dregnerf_tpu_torch.runtime.ngp_trainer import (
        NGPTrainer,
        draw_step_inputs,
        load_field_from_checkpoint,
        step_loss,
    )
    from dregnerf_tpu_torch.runtime.reg_trainer import RegTrainer, to_device

    out = {}
    dist.init_process_group("nccl", init_method=f"file://{os.path.join(out_dir, 'nccl_store')}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(1)
        check(mesh.device == torch.device("cuda", 0) and dist.get_backend() == "nccl",
              f"mesh {mesh}, backend {dist.get_backend()}")

        # stage 1 at full width: the DP step against step_loss on the same draws
        scene, _ = _scenes()
        trainer = NGPTrainer(config_parser(SHAPE_FLAGS + ["--expname", "chip_smoke_mesh",
                                                          "--out_dir", out_dir]), scene)
        trainer.update_occupancy(0)
        draws = draw_step_inputs(trainer.generator, trainer.num_rays, scene.num_images,
                                 scene.height, scene.width, trainer.device)
        runs = {}
        for name in ("single", "dp"):
            seen = {}
            real = _record_scatters(packed_grid, seen)
            try:
                if name == "single":
                    loss, m = step_loss(trainer.params, trainer.model_config,
                                        trainer.render_config, trainer.grid, trainer.aabb,
                                        trainer.images, trainer.c2ws, trainer.K, draws, True,
                                        True)
                    loss.backward()
                    m["loss"] = loss.detach()
                else:
                    _reset_kernel_launches()
                    m = dp_train_step(mesh, trainer.params, trainer.model_config,
                                      trainer.render_config, trainer.grid, trainer.aabb,
                                      trainer.images, trainer.c2ws, trainer.K, draws)
                    dp_launches = _kernel_launches()
            finally:
                packed_grid.level_backward = real
            runs[name] = (m, [p.grad.clone() for p in ngp.parameters(trainer.params)],
                          seen["cuda"])
            trainer.optimizer.zero_grad(set_to_none=True)
        (ms, gs, seen_s), (md, gd, _) = runs["single"], runs["dp"]
        check(int(ms["n_samples"]) == int(md["n_samples"]) > 0
              and math.isclose(ms["loss"].item(), md["loss"].item(), rel_tol=MESH_LOSS_REL),
              f"mesh DP step: loss {ms['loss'].item()} / {md['loss'].item()}, samples "
              f"{int(ms['n_samples'])} / {int(md['n_samples'])}")
        check(dp_launches == _packed_launches(MB_LEVELS, 1, 1),
              f"mesh DP step: launches {dp_launches}, not K1p/K2 {MB_LEVELS}/1/1/1")
        out["dp_step"] = {"loss": md["loss"].item(), "single_loss": ms["loss"].item(),
                          "n_samples": int(md["n_samples"]), "launches": dp_launches,
                          **_grads_agree(torch, packed_grid, trainer.model_config.grid, gd, gs,
                                         [seen_s], "mesh DP step")}
        del trainer, runs, gs, gd, seen_s

        # a chunk of the sharded surface pass against compute_surface_mask
        params, grid, meta, model_cfg, _ = load_field_from_checkpoint(
            os.path.join(block_dir, "model", "model.ckpt"))
        aabb = torch.as_tensor(meta["aabb"], dtype=torch.float32, device="cuda")
        rcfg = extraction_render_config(meta)
        points, _ = occupied_voxel_points(grid, aabb, rcfg.contraction,
                                          torch.Generator().manual_seed(0))
        points = points[:MESH_SURFACE_POINTS]
        cams = np.asarray(meta["camera_poses"], np.float32)
        scores = [compute_surface_mask(params, model_cfg, grid, aabb, rcfg, points, cams,
                                       return_scores=True)]
        _reset_kernel_launches()
        scores.append(compute_surface_mask(params, model_cfg, grid, aabb, rcfg, points, cams,
                                           return_scores=True, mesh=mesh))
        surface_launches = _kernel_launches()
        check(np.array_equal(scores[0], scores[1]),
              f"mesh surface pass: {np.abs(scores[0] - scores[1]).max()} off")
        # one density query (a K2 forward) for each chunk of
        # compute_surface_mask's default 2^17 // 64 rays and each camera
        calls = -(-len(points) // ((1 << 17) // 64)) * len(cams)
        check(surface_launches == _packed_launches(forward=calls),
              f"mesh surface pass: launches {surface_launches}, {calls} density queries")
        out["surface"] = {"points": len(points), "cameras": len(cams),
                          "surface": int((scores[0] >= 0.5).sum()),
                          "launches": surface_launches}
        del params, grid

        # sharded_attention against the plain formula, at the model's width
        g = torch.Generator(device="cuda").manual_seed(3)
        n, d, heads = 2048, 256, 8
        q, k, v = (torch.randn(n, d, generator=g, device="cuda") for _ in range(3))
        qv, kv = torch.arange(n, device="cuda") < 1500, torch.arange(n, device="cuda") < 1200
        got = sharded_attention(mesh, q, k, v, qv, kv, heads)
        dh = d // heads
        qh, kh, vh = (x.reshape(n, heads, dh).transpose(0, 1)[None] for x in (q, k, v))
        logits = (qh @ kh.transpose(-1, -2)) / torch.full((1,), math.sqrt(dh), device="cuda")
        logits = torch.where(kv[None, None, None, :], logits, -1e9)
        want = (torch.softmax(logits, -1) @ vh)[0].transpose(0, 1).reshape(n, d) * qv[:, None]
        check(torch.equal(got, want), "mesh sharded_attention != local attention")
        out["attention"] = {"tokens": n, "equal": True}

        # the registration DP step against the trainer's single-pair step, in
        # f32 with cuDNN's TF32 off (as the register-train phase's parity
        # step: two bf16 forwards of one pair differ by up to 1.5e-3 in their
        # losses on the card)
        torch.backends.cudnn.allow_tf32 = False
        cfg = config_parser(["--root_dir", root, "--scene", subject, "--out_dir", out_dir,
                             "--expname", "chip_smoke_mesh_reg", "--no_bf16"])
        train_ds = NeRFRegDataset(root, subject_id=subject, split="train", seed=cfg.seed)
        reg = RegTrainer(cfg, train_ds, [])
        batch = to_device(train_ds[0], reg.device)
        opt = reg.optimizer
        state = _opt_state(reg)
        seen = _spy_reg_steps(reg)
        single = {k: float(v) for k, v in reg._step([batch]).items()}
        _set_opt_state(reg, state)
        dp = {k: float(v) for k, v in dp_reg_step(mesh, reg, batch).items()}
        grad_rel = _rel_norm(torch, seen[1][0], seen[0][0])
        rel = max(abs(dp[k] - single[k]) / max(abs(single[k]), 1e-12) for k in LOSS_NAMES)
        check(dp["skipped_nonfinite"] == single["skipped_nonfinite"] == 0.0
              and int(opt.count) == 1, f"mesh RegTr step: {dp}")
        check(grad_rel <= REG_STEP_TOL["grad_norm_rel"] and rel <= REG_STEP_TOL["losses_rel"],
              f"mesh RegTr step: gradients {grad_rel} of the norm apart, losses {rel} relative")
        # the update is Adam's on the reduced gradient, from the same state
        after = opt.flat.clone()
        _set_opt_state(reg, state)
        opt.step(*seen[1])
        check(torch.equal(opt.flat, after), "mesh RegTr step: the update is not the optimizer's "
              "on the DP step's gradient")
        # the card's spread from run to run: the single-pair gradient twice
        # at the same parameters (no update between)
        _set_opt_state(reg, state)
        repeat = [reg.pair_grads([batch])[0] for _ in range(2)]
        repeat_rel = _rel_norm(torch, repeat[1], repeat[0])
        out["reg_step"] = {"grad_rel_norm": grad_rel, "repeat_rel_norm": repeat_rel,
                           "losses_rel": rel, "total": dp["total"]}
        del repeat
        del reg, state, after, batch, seen
    finally:
        torch.backends.cudnn.allow_tf32 = True
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    print(f"mesh [world 1, NCCL]: DP step against step_loss on the same "
          f"{out['dp_step']['n_samples']} samples: loss within {MESH_LOSS_REL} relative, "
          f"gradients and launches {out['dp_step']}; surface pass over "
          f"{out['surface']['points']} voxels x {out['surface']['cameras']} cameras equal "
          f"({out['surface']['surface']} at S >= 0.5)"
          f", launches {surface_launches}; sharded_attention on {n} tokens equal; RegTr DP "
          f"step: gradient within {out['reg_step']['grad_rel_norm']:.3e} of the single-pair "
          f"step's norm (two single-pair gradients at the same parameters: "
          f"{out['reg_step']['repeat_rel_norm']:.3e} apart), losses within "
          f"{out['reg_step']['losses_rel']:.2e} relative, the update Adam's on it bit for bit",
          flush=True)
    return out


def _mesh_rank(rank: int, store: str, root: str, subject: str, out_dir: str) -> None:
    """A rank of the two-rank gloo run on cuda:0 (mesh_phase): MESH_DP_STEPS
    stage-1 DP steps at full width, then one registration DP step. Writes
    to out_dir/rank_<rank>.pt its draws, each DP step's kernel launches
    (the counts set to 0 just before the step and read just after), the
    losses and the checksums of the parameters after an all_gather; rank 0
    also each step's mean gradient and the parameters, and the registration
    step's reduced gradient, total and parameters."""
    import torch
    import torch.distributed as dist

    from dregnerf_tpu_torch.datasets.register_pairs import NeRFRegDataset
    from dregnerf_tpu_torch.models import ngp
    from dregnerf_tpu_torch.parallel import ngp_dp
    from dregnerf_tpu_torch.runtime import ngp_trainer
    from dregnerf_tpu_torch.runtime.config import config_parser
    from dregnerf_tpu_torch.runtime.reg_trainer import RegTrainer

    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=2, rank=rank)
    try:
        scene, _ = _scenes()
        trainer = ngp_trainer.NGPTrainer(config_parser(SHAPE_FLAGS + [
            "--expname", f"chip_smoke_mesh_rank{rank}", "--out_dir", out_dir,
            "--mesh_shape", "2"]), scene)
        mesh = trainer.mesh
        draws, metrics, grads, launches = [], [], [], []
        real_draw, real_dp = ngp_trainer.draw_step_inputs, ngp_dp.dp_train_step

        def draw(*args, **kwargs):
            d = real_draw(*args, **kwargs)
            draws.append([t.cpu() for t in d])
            return d

        def dp_step(*args, **kwargs):
            _reset_kernel_launches()
            out = real_dp(*args, **kwargs)
            launches.append(_kernel_launches())
            return out

        real_apply = trainer.apply_gradients

        def apply(step):
            if rank == 0:
                grads.append([p.grad.cpu() for p in ngp.parameters(trainer.params)])
            real_apply(step)

        ngp_trainer.draw_step_inputs, ngp_dp.dp_train_step = draw, dp_step
        trainer.apply_gradients = apply
        try:
            for step in range(MESH_DP_STEPS):
                m = trainer.train_iteration(step)
                metrics.append({k: float(m[k]) for k in ("loss", "n_samples", "alive_rays")})
        finally:
            ngp_trainer.draw_step_inputs, ngp_dp.dp_train_step = real_draw, real_dp
        params = _snapshot_params(trainer)
        sums = mesh.all_gather_rows(_bits_checksum(torch, params)).cpu().tolist()
        del trainer

        torch.backends.cudnn.allow_tf32 = False  # f32, as mesh_world1_phase's RegTr step
        cfg = config_parser(["--root_dir", root, "--scene", subject, "--out_dir", out_dir,
                             "--expname", f"chip_smoke_mesh_reg{rank}", "--mesh_shape", "2",
                             "--no_bf16"])
        ds = NeRFRegDataset(root, subject_id=subject, split="train", seed=cfg.seed)
        reg = RegTrainer(cfg, ds, [])
        seen = _spy_reg_steps(reg)
        items = [ds[0], ds[0]]  # the step's pairs: every rank fetches both, in this order
        reg_metrics = {k: float(v) for k, v in reg.train_iteration(items[rank]).items()}
        reg_sums = mesh.all_gather_rows(_bits_checksum(torch, [reg.optimizer.flat])).cpu().tolist()
        out = {"draws": draws, "metrics": metrics, "launches": launches, "sums": sums,
               "reg_metrics": reg_metrics, "reg_sums": reg_sums, "device": str(mesh.device),
               "backend": dist.get_backend()}
        if rank == 0:
            out.update(grads=grads, params=[p.cpu() for p in params],
                       reg_grad=seen[0][0].cpu(), reg_total=seen[0][1].cpu(),
                       reg_flat=reg.optimizer.flat.cpu())
        torch.save(out, os.path.join(out_dir, f"rank_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def mesh_phase(torch, out_dir: str, block_dir: str, root: str, subject: str) -> dict:
    """Phase 12b: mesh_world1_phase, then two ranks under gloo on cuda:0 (NCCL
    refuses two ranks on one card), held against the mean-of-shards steps
    computed here in one process on the ranks' own draws and pairs."""
    import dataclasses
    import multiprocessing

    from dregnerf_tpu_torch.datasets.register_pairs import NeRFRegDataset
    from dregnerf_tpu_torch.models import ngp
    from dregnerf_tpu_torch.ops import packed_grid
    from dregnerf_tpu_torch.runtime.config import config_parser
    from dregnerf_tpu_torch.runtime.ngp_trainer import NGPTrainer, StepDraws, step_loss
    from dregnerf_tpu_torch.runtime.reg_trainer import RegTrainer, to_device

    out = mesh_world1_phase(torch, out_dir, block_dir, root, subject)
    ranks_dir = os.path.join(out_dir, "mesh_ranks")
    os.makedirs(ranks_dir)
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_mesh_rank, args=(r, os.path.join(ranks_dir, "store"), root,
                                                   subject, ranks_dir)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(MESH_RANK_TIMEOUT_S)
    finally:
        hung = [p.is_alive() for p in procs]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    check(not any(hung) and all(p.exitcode == 0 for p in procs),
          f"mesh ranks: hung {hung}, exit codes {[p.exitcode for p in procs]}")
    ranks_s = time.perf_counter() - t0
    res = [torch.load(os.path.join(ranks_dir, f"rank_{r}.pt"), weights_only=False)
           for r in range(2)]
    check(all(r["device"] == "cuda:0" and r["backend"] == "gloo" for r in res),
          f"mesh ranks on {[(r['device'], r['backend']) for r in res]}")
    check(res[0]["sums"] == res[1]["sums"] and res[0]["sums"][0] == res[0]["sums"][1]
          and res[0]["reg_sums"][0] == res[0]["reg_sums"][1] and res[0]["reg_sums"]
          == res[1]["reg_sums"], f"mesh ranks' checksums {[r['sums'] for r in res]} "
          f"{[r['reg_sums'] for r in res]}")
    want = _packed_launches(MB_LEVELS, 1, 1)
    check(all(len(r["launches"]) == MESH_DP_STEPS and all(x == want for x in r["launches"])
              for r in res), f"mesh ranks: DP steps' launches {[r['launches'] for r in res]}, "
          f"not K1p/K2 {MB_LEVELS}/1/1/1 in each")
    check(all(r["metrics"] == res[0]["metrics"] for r in res), "mesh ranks' metrics differ")

    # each step's mean-of-shards gradient in this process, at the ranks'
    # parameters (the one-process trainer steps with the ranks' own mean
    # gradient, so it holds their state bit for bit: checked at the end)
    scene, _ = _scenes()
    ref = NGPTrainer(config_parser(SHAPE_FLAGS + ["--expname", "chip_smoke_mesh_ref",
                                                  "--out_dir", out_dir]), scene)
    local_rcfg = dataclasses.replace(ref.render_config,
                                     buffer_size=ref.render_config.buffer_size // 2)
    ref.update_occupancy(0)  # the ranks' step 0 updates the grid first
    losses, step_grads = [], []
    for step in range(MESH_DP_STEPS):
        shard_grads, shard_seen, shard_loss = [], [], []
        for r in range(2):
            seen = {}
            real = _record_scatters(packed_grid, seen)
            try:
                d = StepDraws(*(t.to(ref.device) for t in res[r]["draws"][step]))
                loss, _ = step_loss(ref.params, ref.model_config, local_rcfg, ref.grid,
                                    ref.aabb, ref.images, ref.c2ws, ref.K, d, True, True)
                g = torch.autograd.grad(loss, ngp.parameters(ref.params))
            finally:
                packed_grid.level_backward = real
            shard_grads.append(g)
            shard_seen.append(seen["cuda"])
            shard_loss.append(loss.item())
        mean = [(a + b) / 2 for a, b in zip(*shard_grads)]
        step_grads.append(_grads_agree(torch, packed_grid, ref.model_config.grid,
                                       res[0]["grads"][step], mean, shard_seen,
                                       f"mesh ranks step {step}"))
        losses.append(sum(shard_loss) / 2)
        del shard_grads, mean
        for p, g in zip(ngp.parameters(ref.params), res[0]["grads"][step]):
            p.grad = g.to(ref.device)
        ref.apply_gradients(step)
    got = [m["loss"] for m in res[0]["metrics"]]
    check(all(math.isclose(a, b, rel_tol=1e-6) for a, b in zip(got, losses)),
          f"mesh ranks: losses {got} against the one-process {losses}")
    for a, b in zip(res[0]["params"], _snapshot_params(ref)):
        check(torch.equal(a, b.cpu()), "mesh ranks: parameters are not Adam's steps on their "
              "mean gradients")
    del ref

    cfg = config_parser(["--root_dir", root, "--scene", subject, "--out_dir", out_dir,
                         "--expname", "chip_smoke_mesh_reg_ref", "--no_bf16"])
    ds = NeRFRegDataset(root, subject_id=subject, split="train", seed=cfg.seed)
    torch.backends.cudnn.allow_tf32 = False
    reg = RegTrainer(cfg, ds, [])
    pair = [ds[0], ds[0]]  # the ranks' fetches, in their order
    grads, totals = [], []
    for item in pair:
        g, total, _, _ = reg.pair_grads([to_device(item, reg.device)])
        grads.append(g)
        totals.append(total)
    reg_grad_rel = _rel_norm(torch, res[0]["reg_grad"].to(reg.device), (grads[0] + grads[1]) / 2)
    reg_total = (totals[0] + totals[1]).item() / 2
    check(reg_grad_rel <= REG_STEP_TOL["grad_norm_rel"]
          and math.isclose(res[0]["reg_metrics"]["total"], reg_total,
                           rel_tol=REG_STEP_TOL["losses_rel"])
          and res[0]["reg_metrics"]["skipped_nonfinite"] == 0.0,
          f"mesh ranks: RegTr gradient {reg_grad_rel} of the norm off the mean-of-shards one, "
          f"total {res[0]['reg_metrics']['total']} vs {reg_total}")
    del grads
    reg.optimizer.step(res[0]["reg_grad"].to(reg.device), res[0]["reg_total"].to(reg.device))
    check(torch.equal(reg.optimizer.flat.cpu(), res[0]["reg_flat"]),
          "mesh ranks: RegTr parameters are not Adam's step on the reduced gradient")
    torch.backends.cudnn.allow_tf32 = True
    del reg
    torch.cuda.empty_cache()
    rank_launches = {k: sum(x[k] for r in res for x in r["launches"]) for k in want}
    out["launches"] = {k: out["dp_step"]["launches"][k] + out["surface"]["launches"][k]
                       + rank_launches[k] for k in want}
    out["ranks"] = {"seconds": ranks_s, "losses": got, "step_grads": step_grads,
                    "launches": rank_launches, "reg_grad_rel_norm": reg_grad_rel}
    print(f"mesh [2 ranks, gloo on cuda:0]: {ranks_s:.3f} s for both ranks' runs; "
          f"{MESH_DP_STEPS} stage-1 DP steps: losses {got} (one-process {losses}), K1p/K2 "
          f"{MB_LEVELS}/1/1/1 in each step of each rank; each step's mean gradient "
          f"against the one-process mean-of-shards one at the same parameters {step_grads}; "
          f"parameters Adam's steps on those gradients bit for bit, equal on both ranks "
          f"(checksum {res[0]['sums'][0]}); RegTr DP step: gradient within "
          f"{reg_grad_rel:.3e} of the mean-of-shards one's norm, parameters Adam's step on it "
          f"bit for bit, ranks equal; mesh phase launches {out['launches']}", flush=True)
    return out


def _rigid(np, degrees: float, axis, translation):
    """4x4 rotation of `degrees` about `axis`, then `translation`."""
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    a = np.deg2rad(degrees)
    out = np.eye(4)
    out[:3, :3] = np.eye(3) + np.sin(a) * k + (1 - np.cos(a)) * k @ k
    out[:3, 3] = translation
    return out


def build_reg_scene(torch, block_dir: str, root: str, subject: str):
    """<root>/nerf_models/<subject>/block_{0,1}: block 0 is the artifacts
    of `block_dir` as stage 2 wrote them, block 1 a copy whose occupied
    voxels' xyz (and point cloud) a known SE(3) T moves;
    world_frame_transforms.json holds {0: I, 1: T}. Returns T."""
    import shutil

    import numpy as np

    from dregnerf_tpu_torch.datasets.base import save_world_frame_transforms
    from dregnerf_tpu_torch.io.ply import read_ply, write_ply

    T = _rigid(np, REG_ROTATION[0], REG_ROTATION[1], REG_TRANSLATION)
    scene = os.path.join(root, "nerf_models", subject)
    blocks = [os.path.join(scene, f"block_{b}") for b in (0, 1)]
    for b in blocks:
        os.makedirs(os.path.join(b, "model"))
        for name in ("voxel_mask.pt", os.path.join("model", "model.ckpt")):
            shutil.copyfile(os.path.join(block_dir, name), os.path.join(b, name))
    for name in ("voxel_grid.pt", "voxel_point_cloud.ply"):
        shutil.copyfile(os.path.join(block_dir, name), os.path.join(blocks[0], name))
    grid = torch.load(os.path.join(block_dir, "voxel_grid.pt"))
    idx = torch.load(os.path.join(block_dir, "voxel_mask.pt"))
    rot, trans = torch.as_tensor(T[:3, :3], dtype=torch.float32), torch.as_tensor(
        T[:3, 3], dtype=torch.float32)
    flat = grid.reshape(-1, 7).clone()
    flat[idx, :3] = flat[idx, :3] @ rot.T + trans
    torch.save(flat.reshape(grid.shape), os.path.join(blocks[1], "voxel_grid.pt"))
    pts, cols = read_ply(os.path.join(block_dir, "voxel_point_cloud.ply"))
    write_ply(os.path.join(blocks[1], "voxel_point_cloud.ply"), pts @ T[:3, :3].T + T[:3, 3],
              cols)
    save_world_frame_transforms(scene, {0: np.eye(4), 1: T})
    return T


def _check_rigid(torch, pose, label: str) -> float:
    """Finite [L, 3, 4] poses whose rotations are orthonormal with det 1
    (within 1e-4); returns the largest |R R^T - I|."""
    pose = pose.float()
    check(bool(torch.isfinite(pose).all()), f"{label}: non-finite pose")
    rot = pose[..., :3]
    orth = (rot @ rot.transpose(-1, -2) - torch.eye(3, device=pose.device)).abs().max().item()
    det = (torch.linalg.det(rot) - 1.0).abs().max().item()
    check(orth <= 1e-4 and det <= 1e-4, f"{label}: |R R^T - I| {orth}, |det - 1| {det}")
    return orth


def reg_forward_stats(torch, model, batch, label: str, peak_flops: float) -> None:
    """Prints the forward of `model` on `batch`: ms a pair over REG_TIMED forwards
    after REG_WARMUP (CUDA events), peak device memory above what was
    allocated before, the FLOPs of its convolutions and matmuls
    (torch.utils.flop_counter) and their time at `peak_flops`, and the top
    kernels of one profiled forward."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.inference_mode():
        for _ in range(REG_WARMUP):
            out = model(batch)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REG_TIMED):
            out = model(batch)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / REG_TIMED
        peak_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
        orth = _check_rigid(torch, out["pose"], f"register [{label}]")
        with FlopCounterMode(display=False) as counter:
            model(batch)
    flops = counter.get_total_flops()
    by_module = {k: sum(v.values()) for k, v in counter.get_flop_counts().items()}
    fpn = by_module.get("NeRFRegTr.fpn3d", 0)
    finest = sum(by_module.get(f"NeRFRegTr.fpn3d.{m}", 0) for m in ("lateral1", "smooth1"))
    bound = flops / peak_flops * 1e3
    pose = out["pose"][-1].float().cpu().numpy()
    print(f"register [{label}]: {ms:.3f} ms a pair ({REG_TIMED} forwards after {REG_WARMUP}), "
          f"peak device memory {peak_gib:.3f} GiB above {base / 2**30:.3f} GiB; level "
          f"{int(out['ds_level'])}, valid tokens {int(out['src_valid'].sum())} / "
          f"{int(out['tgt_valid'].sum())}; {flops / 1e12:.4f} TFLOP in convolutions and "
          f"matmuls (FPN {fpn / 1e12:.4f}, of which lateral1 + smooth1 {finest / 1e12:.4f}), "
          f"bound {bound:.3f} ms at {peak_flops / 1e12:.0f} TFLOP/s = {bound / ms:.4f} of "
          f"the measured; |R R^T - I| {orth:.2e}; last-layer pose {pose.round(5).tolist()}",
          flush=True)
    with torch.inference_mode():
        _, _, host, _ = profiled(torch, lambda: model(batch), 1, f"register [{label}] profile",
                              "forward")
    for e in host[:5]:  # the host operations of most self time
        print(f"  host {e.self_cpu_time_total / 1e3:8.3f} ms x{e.count:<5d} {e.key[:80]}",
              flush=True)


def reg_parity_phase(torch, models: dict, item: dict) -> None:
    """The full-width model on the card and on the CPU, same weights, on
    a PARITY_R^3 crop of both grids centred on the occupied voxel nearest
    the occupied centroid (the surface shell may leave the centroid
    itself empty). Tolerances in PARITY_TOL."""
    import copy

    import numpy as np

    r = item["src_grid"].shape[0]
    occ = np.argwhere(item["src_mask"].reshape(r, r, r))
    centre = occ[np.argmin(((occ - occ.mean(0)) ** 2).sum(1))]
    lo = np.clip(centre - PARITY_R // 2, 0, r - PARITY_R)
    window = tuple(slice(a, a + PARITY_R) for a in lo)
    data = {}
    for side in ("src", "tgt"):
        data[f"{side}_grid"] = np.ascontiguousarray(item[f"{side}_grid"][window])
        data[f"{side}_mask"] = np.ascontiguousarray(
            item[f"{side}_mask"].reshape(r, r, r)[window].reshape(-1))
    n_occ = int(data["src_mask"].sum())
    check(n_occ >= 100, f"parity crop holds {n_occ} occupied voxels")
    for dtype, model in models.items():
        cpu_model = copy.deepcopy(model).cpu()
        with torch.inference_mode():
            t0 = time.perf_counter()
            got = model({k: torch.as_tensor(v, device="cuda") for k, v in data.items()})
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            want = cpu_model({k: torch.as_tensor(v) for k, v in data.items()})
            t2 = time.perf_counter()
        got = {k: v.cpu() for k, v in got.items()}
        check(int(got["ds_level"]) == int(want["ds_level"]), f"parity [{dtype}]: level")
        for key in ("src_valid", "tgt_valid"):
            check(torch.equal(got[key], want[key]), f"parity [{dtype}]: {key}")
        feat_err = max((got[k].float() - want[k].float()).abs().max().item()
                       for k in ("src_feats", "tgt_feats"))
        feat_max = max(want[k].float().abs().max().item() for k in ("src_feats", "tgt_feats"))
        kp_err = max((got[k] - want[k]).abs().max().item() for k in ("src_kp", "tgt_kp"))
        pose_err = (got["pose"] - want["pose"]).abs().max().item()
        _check_rigid(torch, got["pose"], f"parity [{dtype}] card")
        # the angle of R_card^T R_cpu from both its sine (the skew part) and
        # cosine: arccos alone floors near 0.07 deg for f32 rotations
        rel = got["pose"][..., :3].double().transpose(-1, -2) @ want["pose"][..., :3].double()
        skew = rel - rel.transpose(-1, -2)
        sin = torch.stack([skew[..., 2, 1], skew[..., 0, 2], skew[..., 1, 0]], -1).norm(dim=-1) / 2
        cos = (rel.diagonal(dim1=-2, dim2=-1).sum(-1) - 1) / 2
        rot_deg = torch.rad2deg(torch.atan2(sin, cos)).max().item()
        trans_err = (got["pose"][..., 3] - want["pose"][..., 3]).norm(dim=-1).max().item()
        print(f"parity [{dtype}] R={PARITY_R} crop at {lo.tolist()} ({n_occ} occupied src "
              f"voxels): level {int(got['ds_level'])} equal, valid tokens "
              f"{int(got['src_valid'].sum())} / {int(got['tgt_valid'].sum())} equal; features "
              f"max abs err {feat_err:.3e} (max |value| {feat_max:.3f}), keypoints "
              f"{kp_err:.3e}, pose entries {pose_err:.3e}, rotation {rot_deg:.4f} deg, "
              f"translation {trans_err:.3e}; card {t1 - t0:.3f} s, CPU {t2 - t1:.3f} s",
              flush=True)
        tol = PARITY_TOL[dtype]
        errors = {"features_rel": feat_err / feat_max, "features": feat_err,
                  "keypoints": kp_err, "pose_entries": pose_err, "rotation_deg": rot_deg,
                  "translation": trans_err}
        over = {k: errors[k] for k, bound in tol.items() if errors[k] > bound}
        check(not over, f"parity [{dtype}]: over the tolerance {tol}: {over}")


def register_phase(torch, block_dir: str, out_dir: str) -> tuple[str, str]:
    """Stage 3 on the block stage 2 extracted on the card (see the module
    docstring, phase 10); returns the pair's (root, subject)."""
    import numpy as np

    from dregnerf_tpu_torch.datasets.register_pairs import NeRFRegDataset
    from dregnerf_tpu_torch.eval_nerf_regtr import RegEvaluator, save_reg_checkpoint
    from dregnerf_tpu_torch.models.regtr import random_jax_params
    from dregnerf_tpu_torch.ops.voxel_subsample import masked_select_strided
    from dregnerf_tpu_torch.runtime.config import config_parser
    from dregnerf_tpu_torch.runtime.reg_trainer import make_reg_model, to_device

    root, subject = os.path.join(out_dir, "reg_scene"), "chip_smoke_pair"
    T = build_reg_scene(torch, block_dir, root, subject)
    ckpt = os.path.join(out_dir, "chip_smoke_reg", "model", "model.ckpt")
    cfg = config_parser(["--out_dir", out_dir, "--expname", "chip_smoke_reg", "--root_dir",
                         root, "--scene", subject, "--ckpt_path", ckpt, "--icp_refine"])
    dataset = NeRFRegDataset(root, subject_id=subject, split="test", seed=cfg.seed)
    check(len(dataset) == 1, "the two-block scene loads")

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    tree = random_jax_params(make_reg_model(cfg), rng)
    d = cfg.position_embedding_dim
    save_reg_checkpoint(ckpt, tree, (rng.standard_normal((d, d)) * 0.1).astype(np.float32),
                        {"step": 0})
    t1 = time.perf_counter()
    ev = RegEvaluator(cfg, dataset)  # default device: cuda; the checkpoint via params_from_jax
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    model = ev.model
    check(ev.device.type == "cuda" and all(p.is_cuda for p in model.parameters())
          and model.dtype == torch.bfloat16, "RegEvaluator: bf16 model on the card")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"register: weights drawn and saved {t1 - t0:.3f} s ({n_params} parameters, "
          f"{os.path.getsize(ckpt) / 2**20:.1f} MiB), RegEvaluator built {t2 - t1:.3f} s",
          flush=True)

    item = dataset[0]
    batch = to_device(item, ev.device)
    gt = np.asarray(item["pose"], np.float64)
    check(np.allclose(gt, T if item["block_list"] == [0, 1] else np.linalg.inv(T), atol=1e-5),
          "ground-truth pose of the pair")
    for side in ("src", "tgt"):
        mask = batch[f"{side}_mask"]
        selected = int(masked_select_strided(mask, model.max_input_points)[1].sum())
        print(f"register {side}: {int(mask.sum())} occupied voxels of {mask.numel()}, "
              f"{selected} selected (cap {model.max_input_points}, strided)", flush=True)

    reg_forward_stats(torch, model, batch, "bf16", BF16_FLOPS)
    t3 = time.perf_counter()
    metrics = ev.evaluate()
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    agg = metrics["aggregate"]
    check(agg["num_pairs"] == 1 and math.isfinite(agg["R_mean"])
          and os.path.exists(os.path.join(ev.output_dir, "metrics_test.json")),
          f"RegEvaluator.evaluate(): {agg}")
    entry = metrics["per_scene"][subject]
    check(all(k in entry for k in ("R_error_icp_deg", "t_error_icp", "icp_rms", "icp_inliers",
                                   "icp_time")), f"--icp_refine: per-scene keys {sorted(entry)}")
    with open(os.path.join(ev.output_dir, "fgr_metrics_test.json")) as f:
        fgr = json.load(f)
    check(fgr["aggregate"]["num_pairs"] == 1 and subject in fgr["per_scene"],
          f"fgr_metrics_test.json: {fgr}")
    base = fgr["per_scene"][subject]
    print(f"RegEvaluator.evaluate() --icp_refine: {t4 - t3:.3f} s wall for {agg['num_pairs']} "
          f"pair (forward {entry['time']:.4f} s, ICP polish {entry['icp_time']:.3f} s), RRE "
          f"{agg['R_mean']:.4f} deg, RTE {agg['t_mean']:.5f} (random weights: no accuracy "
          f"expected), after ICP {entry['R_error_icp_deg']:.4f} deg, "
          f"{entry['t_error_icp']:.5f} ({entry['icp_inliers']} inliers); classical baseline "
          f"{base['R_error_deg']:.4f} deg, {base['t_error']:.5f} in {base['time']:.3f} s, "
          f"winner {base['winner']}; wrote "
          f"{sorted(os.listdir(os.path.join(ev.output_dir, subject)))} and "
          f"{sorted(f for f in os.listdir(ev.output_dir) if f.endswith('.json'))}", flush=True)

    f32 = make_reg_model(cfg, torch.float32)
    f32.load_state_dict(model.state_dict())
    f32.to(ev.device).eval()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # cuDNN convolutions default to TF32
    try:
        reg_forward_stats(torch, f32, batch, "f32, TF32 off", F32_FLOPS)
        reg_parity_phase(torch, {"float32": f32, "bfloat16": model}, item)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return root, subject


def pose_gap(np, a, b) -> tuple[float, float]:
    """(degrees, translation) between two [3|4, 4] poses; the angle from
    both the sine and the cosine of the relative rotation."""
    a, b = np.asarray(a, np.float64)[:3], np.asarray(b, np.float64)[:3]
    rel = a[:, :3].T @ b[:, :3]
    skew = rel - rel.T
    sin = np.linalg.norm([skew[2, 1], skew[0, 2], skew[1, 0]]) / 2
    cos = (np.trace(rel) - 1) / 2
    return float(np.degrees(np.arctan2(sin, cos))), float(np.linalg.norm(a[:, 3] - b[:, 3]))


def device_call(torch, fn):
    """(fn(), wall ms, CUDA-event ms) from a synchronised start."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, start.elapsed_time(end)


def _scores_close(a: float, b: float) -> bool:
    tol = CLASSICAL_PARITY_TOL
    return abs(a - b) <= tol["score_abs"] + tol["score_rel"] * abs(a)


def classical_phase(torch, root: str, subject: str, out_dir: str) -> None:
    """Classical registration on the register phase's pair (its voxel point
    clouds and known pose): icp_refine from the RegTr pose that the register
    phase's evaluate() wrote, global_colored_icp and one
    best_global_registration(refine=True) on the card, timed; the card
    against the CPU (CLASSICAL_PARITY_TOL); the accuracy against the known
    pose (CLASSICAL_TOL)."""
    import numpy as np

    from dregnerf_tpu_torch.datasets.register_pairs import NeRFRegDataset
    from dregnerf_tpu_torch.io.ply import read_ply

    from dregnerf_tpu_torch.runtime.config import config_parser

    item = NeRFRegDataset(root, subject_id=subject, split="test", seed=config_parser([]).seed)[0]
    src, src_cols = read_ply(item["src_ply_path"])
    tgt, tgt_cols = read_ply(item["tgt_ply_path"])
    gt = np.asarray(item["pose"], np.float64)[:3, :4]
    with open(os.path.join(out_dir, "chip_smoke_reg", "eval", subject,
                           "transformation_est.json")) as f:
        written = json.load(f)
    check(np.allclose(written["pose_gt"], gt, atol=1e-5),
          "the classical phase reads the register phase's pair")
    classical_checks(torch, src, src_cols, tgt, tgt_cols, gt,
                     np.asarray(written["pose_est"], np.float32))


def classical_checks(torch, src, src_cols, tgt, tgt_cols, gt, regtr) -> None:
    """See classical_phase."""
    import numpy as np

    from dregnerf_tpu_torch.registration import global_icp, pipeline
    from dregnerf_tpu_torch.registration.icp import _prep, icp_refine, score_pose_feat

    voxel = 2.0 / 128 * 2  # the evaluator's ICP voxel at --grid_resolution 128
    colors = dict(src_colors=src_cols, tgt_colors=tgt_cols)
    n_src, n_tgt = min(len(src), 4096), min(len(tgt), 4096)
    print(f"classical: {len(src)} / {len(tgt)} points (src / tgt), colours "
          f"{src_cols.dtype if src_cols is not None else None}, voxel {voxel}", flush=True)

    def joint_score(pose, dev):
        """icp_refine's winner score of `pose`: the joint (xyz, 0.5 rgb) score
        on the points that icp_refine's seed picks."""
        rng = np.random.default_rng(0)
        s, sc, sv = _prep(src, src_cols, 4096, rng)
        t, tc, tv = _prep(tgt, tgt_cols, 4096, rng)
        args = [torch.as_tensor(a, device=dev) for a in (s, t, 0.5 * sc, 0.5 * tc, sv, tv,
                                                          np.asarray(pose, np.float32))]
        return float(score_pose_feat(*args))

    # icp_refine from the RegTr pose: twice on the card (the first call
    # creates the cuBLAS and cuSOLVER handles), then profiled
    runs = [device_call(torch, lambda: icp_refine(src, tgt, regtr, voxel_size=voxel,
                                                  device="cuda", **colors)) for _ in range(2)]
    (refined, rms, cnt), wall, ev = runs[1]
    busy, _, _, _ = profiled(torch, lambda: icp_refine(src, tgt, regtr, voxel_size=voxel,
                                                    device="cuda", **colors),
                          1, "classical icp_refine profile", "call")
    # the bound of a fused distance-and-argmin kernel: 2 (3 + 3) operations
    # per (run, src, tgt) pair and iteration, 6 runs of 30 iterations, and
    # the score of 7 candidates, in f32; the inputs are a few hundred KB
    flops = 2 * 6 * n_src * n_tgt * (30 * 6 + 7)
    bound = bound_ms(0.0, flops)
    err = pose_gap(np, refined, gt) if refined is not None else (math.nan, math.nan)
    print(f"classical icp_refine from the RegTr pose (card): {wall:.3f} ms wall, {ev:.3f} ms "
          f"CUDA events (first call {runs[0][1]:.3f} ms wall), device busy {busy:.3f} ms; "
          f"RRE {err[0]:.4f} deg, RTE {err[1]:.5f} against the known pose (RegTr pose "
          f"{pose_gap(np, regtr, gt)[0]:.4f} deg); rms {rms:.6f}, {cnt} inliers; bound of a "
          f"fused distance-and-argmin kernel {bound:.4f} ms ({flops / 1e9:.3f} GFLOP at "
          f"{F32_FLOPS / 1e12:.0f} TFLOP/s, operations) = {bound / busy:.4f} of the busy time",
          flush=True)

    # card against CPU, icp_refine from a RegTr-quality init
    off = _rigid(np, ICP_INIT_ERROR[0], ICP_INIT_ERROR[1], ICP_INIT_ERROR[2])
    init = (off @ np.vstack([gt, [0, 0, 0, 1]]))[:3].astype(np.float32)
    card, _, _ = device_call(torch, lambda: icp_refine(src, tgt, init, voxel_size=voxel,
                                                       device="cuda", **colors))
    t0 = time.perf_counter()
    cpu = icp_refine(src, tgt, init, voxel_size=voxel, device="cpu", **colors)
    cpu_s = time.perf_counter() - t0
    check(card[0] is not None and cpu[0] is not None, "icp_refine from a RegTr-quality init")
    gap = pose_gap(np, card[0], cpu[0])
    scores = joint_score(card[0], "cuda"), joint_score(cpu[0], "cpu")
    tol = CLASSICAL_PARITY_TOL
    print(f"classical icp_refine card against CPU (init {ICP_INIT_ERROR[0]} deg, "
          f"{np.linalg.norm(ICP_INIT_ERROR[2]):.4f} off): rotation {gap[0]:.2e} deg "
          f"(tolerance {tol['rotation_deg']}), translation {gap[1]:.2e} "
          f"({tol['translation']}), joint score {scores[0]:.6e} / {scores[1]:.6e} (gap "
          f"{abs(scores[0] - scores[1]):.2e}), rms {card[1]:.6f} / {cpu[1]:.6f}, inliers "
          f"{card[2]} / {cpu[2]}; to the known pose {pose_gap(np, card[0], gt)[0]:.4f} deg; "
          f"CPU {cpu_s:.3f} s", flush=True)
    check(gap[0] <= tol["rotation_deg"] and gap[1] <= tol["translation"]
          and _scores_close(*scores), f"icp_refine card against CPU: {gap}, {scores}")

    # global_colored_icp: its coarse race recorded on the card, re-run on the CPU
    races = []
    real_race = global_icp._coarse_race

    def recorded(*args, **kwargs):
        out = real_race(*args, **kwargs)
        races.append((args, kwargs, out))
        return out

    global_icp._coarse_race = recorded
    try:
        runs = [device_call(torch, lambda: global_icp.global_colored_icp(
            src, tgt, device="cuda", **colors)) for _ in range(2)]
    finally:
        global_icp._coarse_race = real_race
    (T_g, ginfo), wall, ev = runs[1]
    args, kwargs, (_, card_scores) = races[1]
    t0 = time.perf_counter()
    _, cpu_scores = real_race(*[a.cpu() if isinstance(a, torch.Tensor) else a for a in args],
                              **kwargs)
    cpu_s = time.perf_counter() - t0
    card_scores, cpu_scores = card_scores.tolist(), cpu_scores.tolist()
    n_coarse = args[0].shape[0], args[1].shape[0]
    flops = 2 * 24 * n_coarse[0] * n_coarse[1] * 6 * (20 + 1)
    err = pose_gap(np, T_g, gt)
    worst = max(abs(a - b) for a, b in zip(card_scores, cpu_scores))
    print(f"classical global_colored_icp (card): {wall:.3f} ms wall, {ev:.3f} ms CUDA events "
          f"(first call {runs[0][1]:.3f} ms), coarse race {ginfo['coarse_time_s'] * 1e3:.3f} ms "
          f"at {n_coarse} points (bound of a fused kernel {bound_ms(0.0, flops):.4f} ms); seed "
          f"{ginfo['coarse_seed']}, coarse score {ginfo['coarse_best_score']:.6f}; RRE "
          f"{err[0]:.4f} deg, RTE {err[1]:.5f} (tolerance {CLASSICAL_TOL['gicp']}); coarse "
          f"scores card against CPU: largest gap {worst:.2e} over 24 seeds, best seed "
          f"{int(np.argmin(card_scores))} / {int(np.argmin(cpu_scores))} (CPU race "
          f"{cpu_s:.3f} s)", flush=True)
    check(err[0] <= CLASSICAL_TOL["gicp"][0] and err[1] <= CLASSICAL_TOL["gicp"][1],
          f"global_colored_icp against the known pose: {err}")
    race_parity(torch, np, args, kwargs, races[1][2][0], card_scores, cpu_scores)

    # best_global_registration(refine=True): host FGR/RANSAC seconds apart
    host_s = [0.0]

    def host_timed(fn):
        def call(*args, **kwargs):
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            host_s[0] += time.perf_counter() - t
            return out
        return call

    real = pipeline.run_registration, pipeline.run_ransac_registration
    pipeline.run_registration, pipeline.run_ransac_registration = map(host_timed, real)
    try:
        (T_b, info), wall, _ = device_call(torch, lambda: pipeline.best_global_registration(
            src, tgt, icp_voxel=voxel, refine=True, device="cuda", **colors))
    finally:
        pipeline.run_registration, pipeline.run_ransac_registration = real
    cands = info["candidates"]
    errors = [c for c in cands if "error" in c]
    check(not errors, f"race candidates with an error: {errors}")
    check(T_b is not None, f"best_global_registration: no pose, {cands}")
    err = pose_gap(np, T_b, gt)
    print(f"classical best_global_registration(refine=True) (card): {wall / 1e3:.3f} s wall, "
          f"of which FGR/RANSAC on the host {host_s[0]:.3f} s and the rest (ICP and scores on "
          f"the card, the host's preparation) {wall / 1e3 - host_s[0]:.3f} s; winner "
          f"{info['winner']}, ICP {info.get('icp')}; RRE {err[0]:.4f} deg, RTE {err[1]:.5f} "
          f"(tolerance {CLASSICAL_TOL['race']}); candidates (method, voxel, dir, score, RRE "
          f"deg) {[(c['method'], c['voxel'], c.get('dir'), c['score'], round(pose_gap(np, c['T'], gt)[0], 3) if 'T' in c else None) for c in cands]}",
          flush=True)
    check(err[0] <= CLASSICAL_TOL["race"][0] and err[1] <= CLASSICAL_TOL["race"][1],
          f"best_global_registration against the known pose: {err}")


def race_step(torch, args, pose, it: int, iters: int):
    """Iteration `it` of `global_icp._coarse_race`'s icp_core run on its
    recorded inputs `args`, from poses [K, 3, 4] on their device, with that
    iteration's annealed gate: (next poses [K, 3, 4], the target each
    source point chose [K, N], in the joint space as icp_core chooses it)."""
    from dregnerf_tpu_torch.registration.icp import _sq_dist, icp_core

    src, tgt, src_c, tgt_c, sv, tv, _, gate0, gate1 = args
    k, dev = pose.shape[0], src.device
    start = torch.as_tensor(gate0, dtype=torch.float32, device=dev).expand(k)
    end = torch.as_tensor(gate1, dtype=torch.float32, device=dev).expand(k)
    frac = torch.arange(iters, dtype=torch.float32, device=dev) / float(max(iters - 1, 1))
    gate = start + (end - start) * frac[it]  # icp_core's gate row `it`, before its square
    nxt, _, _ = icp_core(src, tgt, src_c, tgt_c, sv, tv, pose, gate, gate, iters=1)
    moved = torch.matmul(src.float(), pose[:, :, :3].transpose(-1, -2)) + pose[:, None, :, 3]
    tgt_f = torch.cat([tgt.float().expand(k, *tgt.shape),
                       tgt_c.float().expand(k, *tgt_c.shape[-2:])], dim=-1)
    tgt_sq = torch.where(tv, (tgt_f * tgt_f).sum(-1), torch.inf)
    src_f = torch.cat([moved, src_c.float().expand(k, *src_c.shape[-2:])], dim=-1)
    return nxt, _sq_dist(src_f, tgt_f, tgt_sq).argmin(dim=-1)


def tie_gaps(np, args_cpu, pose, nn_a, nn_b) -> list:
    """For each seed, the relative gaps (see TIE_REL_GAP) between the two
    candidates of every source point on which the choices nn_a and nn_b
    [K, N] differ, in f64 from the CPU's inputs, under poses [K, 3, 4]."""
    src, tgt, src_c, tgt_c = (np.asarray(a.cpu(), np.float64) for a in args_cpu[:4])
    pose, nn_a, nn_b = (np.asarray(x.cpu()) for x in (pose, nn_a, nn_b))
    out = []
    for k in range(pose.shape[0]):
        rows = np.flatnonzero(nn_a[k] != nn_b[k])
        x = np.concatenate([src[rows] @ pose[k, :, :3].astype(np.float64).T
                            + pose[k, :, 3].astype(np.float64),
                            src_c[rows] if src_c.ndim == 2 else src_c[k, rows]], -1)
        cands = [np.concatenate([tgt[nn[k, rows]], tgt_c[nn[k, rows]]], -1)
                 for nn in (nn_a, nn_b)]
        d2 = [((x - y) ** 2).sum(-1) for y in cands]
        size = (x * x).sum(-1) + np.maximum(*[(y * y).sum(-1) for y in cands])
        out.append(np.abs(d2[0] - d2[1]) / size)
    return out


def judge_iteration(np, args_cpu, pose, card, cpu, seeds) -> list:
    """Each of `seeds`' (passes, how, largest tie gap) for one iteration
    that the card and the CPU ran from the same poses [K, 3, 4]: card and
    cpu are (next poses, choices) of race_step. It passes on the poses
    (within CLASSICAL_PARITY_TOL), or on a near-tie (the choices differ,
    and only where the candidates lie within TIE_REL_GAP)."""
    tol = CLASSICAL_PARITY_TOL
    gaps = tie_gaps(np, args_cpu, pose, card[1], cpu[1])
    out = []
    for k in seeds:
        rot, trans = pose_gap(np, card[0][k].cpu(), cpu[0][k].cpu())
        worst = float(gaps[k].max()) if len(gaps[k]) else 0.0
        if rot <= tol["rotation_deg"] and trans <= tol["translation"]:
            out.append((True, "poses", worst))
        elif len(gaps[k]) and worst <= TIE_REL_GAP:
            out.append((True, "tie", worst))
        else:
            out.append((False, f"poses {rot:.3e} deg, {trans:.3e} apart; {len(gaps[k])} "
                               f"choices differ", worst))
    return out


def race_parity(torch, np, args, kwargs, card_poses, card_scores, cpu_scores) -> None:
    """The coarse race card against CPU, tie-aware. Scores: the CPU's score
    of every card pose within the tolerance of the card's, and the card's
    best seed among the CPU's best (no path in this). Paths: each seed
    whose race scores differ between the devices is replayed iteration by
    iteration from the card's poses (judge_iteration)."""
    import inspect

    from dregnerf_tpu_torch.registration import global_icp
    from dregnerf_tpu_torch.registration.icp import score_pose_feat

    args_cpu = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
    rescored = score_pose_feat(*args_cpu[:6], card_poses.cpu()).tolist()
    best = int(np.argmin(card_scores))
    check(all(map(_scores_close, card_scores, rescored)),
          f"coarse race: the CPU's scores of the card's poses {rescored} against the card's "
          f"{card_scores}")
    check(_scores_close(min(rescored), rescored[best]),
          f"coarse race: the card's best seed {best} scores {rescored[best]} on the CPU, the "
          f"CPU's best {min(rescored)}")
    replay = [k for k, (a, b) in enumerate(zip(card_scores, cpu_scores))
              if not _scores_close(a, b)]
    iters = kwargs.get("iters", inspect.signature(global_icp._coarse_race)
                       .parameters["iters"].default)
    kinds, worst = {"poses": 0, "tie": 0}, 0.0
    if replay:
        pose = args[6].float()
        for it in range(iters):
            card = race_step(torch, args, pose, it, iters)
            cpu = race_step(torch, args_cpu, pose.cpu(), it, iters)
            for k, (ok, how, gap) in zip(replay, judge_iteration(np, args_cpu, pose, card, cpu,
                                                                 replay)):
                check(ok, f"coarse race seed {k}, iteration {it}: the card and the CPU differ "
                          f"from the same pose with no near-tie ({how}; largest gap {gap:.3e})")
                kinds[how] += 1
                worst = max(worst, gap)
            pose = card[0]
        end = max(pose_gap(np, pose[k].cpu(), card_poses[k].cpu())[0] for k in replay)
        print(f"classical coarse race replay: seeds {replay}, {iters} iterations each: "
              f"{kinds['poses']} passed on the poses, {kinds['tie']} on a near-tie; largest tie "
              f"gap {worst:.3e} (stated {TIE_REL_GAP}); the replayed card path ends "
              f"{end:.2e} deg from the race's", flush=True)
    print(f"classical coarse race card against CPU: the CPU's scores of the card's poses within "
          f"{max(abs(a - b) for a, b in zip(card_scores, rescored)):.2e}; best seed {best} "
          f"(CPU {int(np.argmin(rescored))}); {len(replay)} seeds needed a replay, largest tie "
          f"gap {worst:.3e}", flush=True)


def _opt_state(trainer) -> list:
    """Copies of the trainer's parameters, moments and both counts."""
    opt = trainer.optimizer
    return [x.clone() for x in (opt.flat, opt.mu, opt.nu, opt.count, opt.schedule_count)]


def parity_crop(np, item, centre=None):
    """(the PARITY_R^3 crop of a pair item around `centre`, default the
    occupied src voxel nearest their mean; the crop's low corner)."""
    r = item["src_grid"].shape[0]
    occ = np.argwhere(item["src_mask"].reshape(r, r, r))
    if centre is None:
        centre = occ[np.argmin(((occ - occ.mean(0)) ** 2).sum(1))]
    lo = np.clip(np.asarray(centre) - PARITY_R // 2, 0, r - PARITY_R)
    window = tuple(slice(a, a + PARITY_R) for a in lo)
    crop = {"pose": item["pose"]}
    for side in ("src", "tgt"):
        crop[f"{side}_grid"] = np.ascontiguousarray(item[f"{side}_grid"][window])
        crop[f"{side}_mask"] = np.ascontiguousarray(
            item[f"{side}_mask"].reshape(r, r, r)[window].reshape(-1))
    return crop, lo


def reg_step_parity(torch, trainer, item, centre=None, moments: bool = True) -> dict:
    """One f32 step on the card and on the CPU from the trainer's
    parameters, and with `moments` its Adam moments and counts, on the
    PARITY_R^3 crop of the pair around `centre` (default: the occupied src
    voxel nearest their mean); the caller sets TF32. Prints and returns the
    errors of REG_STEP_TOL, the share of parameters within params_tight,
    both gradients and both updated parameter buffers (on the host).
    From zero moments Adam's first step moves an element by
    lr g_c / (|g_c| + eps) (g_c the clipped gradient): nearly lr sign(g_c)
    whatever the gradient's size, so an element whose gradient is at the
    devices' rounding noise lands 2 lr apart when the signs differ; from
    the trainer's moments the step moves smoothly with the gradient."""
    import numpy as np

    from dregnerf_tpu_torch.runtime.reg_trainer import RegTrainer, make_reg_model, to_device

    crop, lo = parity_crop(np, item, centre)
    n_occ = int(crop["src_mask"].sum())
    check(n_occ >= 100, f"train parity crop holds {n_occ} occupied voxels")
    state = ("flat", "mu", "nu", "count", "schedule_count") if moments else ("flat",)
    out = {}
    for dev in ("cuda", "cpu"):
        tr = RegTrainer(trainer.config, [crop], [], output_dir=trainer.output_dir + f"_{dev}",
                        model=make_reg_model(trainer.config, torch.float32), device=dev)
        for name in state:  # the bf16 run's state, in f32
            getattr(tr.optimizer, name).copy_(getattr(trainer.optimizer, name))
        grads = []
        real = tr.optimizer.step

        def spy(grad, loss, real=real, grads=grads):
            grads.append(grad.detach().cpu().clone())
            return real(grad, loss)

        tr.optimizer.step = spy
        t0 = time.perf_counter()
        m = tr._step([to_device(crop, tr.device)])
        out[dev] = ({k: float(v) for k, v in m.items()}, grads[0], tr.optimizer.flat.cpu(),
                    time.perf_counter() - t0)
        del tr
    (mg, gg, pg, tg), (mc, gc, pc, tc) = out["cuda"], out["cpu"]
    check(mg["skipped_nonfinite"] == mc["skipped_nonfinite"] == 0.0, "train parity: skipped")
    check(mg["feature_matches"] == mc["feature_matches"], "train parity: feature_matches")
    loss_err = max(abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-3)
                   for k in ("overlap", "nerf_cont", "feature", "corr", "total"))
    ng, nc = (torch.linalg.vector_norm(g.double()).item() for g in (gg, gc))
    norm_err = abs(ng - nc) / nc
    grad_err = torch.linalg.vector_norm((gg - gc).double()).item() / nc
    d = (pg - pc).abs()
    outside = d > REG_STEP_TOL["params_tight"]
    tight = 1.0 - outside.double().mean().item()
    per_leaf = zip([int(x.sum()) for x in outside.split(trainer.optimizer.numels)],
                   trainer.param_keys + ["infonce_W"], trainer.optimizer.numels)
    top = sorted((t for t in per_leaf if t[0]), reverse=True)[:3]
    start = "the trainer's moments" if moments else "zero moments"
    print(f"register train parity [f32, TF32 {'on' if torch.backends.cudnn.allow_tf32 else 'off'}"
          f", from {start}] R={PARITY_R} crop at "
          f"{lo.tolist()} ({n_occ} occupied src voxels): losses card "
          f"{[round(mg[k], 6) for k in LOSS_NAMES]} CPU {[round(mc[k], 6) for k in LOSS_NAMES]} "
          f"(max rel err {loss_err:.3e}), feature_matches {mg['feature_matches']:.0f}, grad norm "
          f"card {ng:.6f} CPU {nc:.6f} (rel err {norm_err:.3e}; |g_card - g_cpu| / |g_cpu| "
          f"{grad_err:.3e}), updated parameters max abs err {d.max().item():.3e}, share within "
          f"{REG_STEP_TOL['params_tight']:g} {tight:.6f} ({int(outside.sum())} outside, most in "
          f"{[(n, k, size) for k, n, size in top]}: name, outside, size); card {tg:.3f} s, CPU "
          f"{tc:.3f} s", flush=True)
    return {"errors": {"losses_rel": loss_err, "grad_norm_rel": norm_err,
                       "params_abs": d.max().item()},
            "grad_rel": grad_err, "tight": tight, "crop": lo.tolist(), "occupied": n_occ,
            "grads": (gg, gc), "params": (pg, pc), "norms": (ng, nc)}


def reg_train_parity_phase(torch, trainer, item) -> None:
    """One f32 step (TF32 off) on the card and on the CPU from the trainer's
    state, on a PARITY_R^3 crop of the pair: every loss term, the global
    gradient norm and the updated parameters within REG_STEP_TOL."""
    p = reg_step_parity(torch, trainer, item)
    over = {k: v for k, v in p["errors"].items() if v > REG_STEP_TOL[k]}
    check(not over and p["tight"] >= REG_STEP_TOL["params_tight_share"],
          f"train parity over {REG_STEP_TOL}: {p['errors']}, share {p['tight']}")


def register_train_phase(torch, root: str, subject: str, out_dir: str) -> dict:
    """Stage-3 training at full width in bf16 on the register phase's pair
    (see the module docstring, phase 12). Returns the K2 forward launches
    of the exact-visibility steps and K2's times and bounds on that path."""
    import numpy as np
    from torch.utils.flop_counter import FlopCounterMode

    from dregnerf_tpu_torch.datasets.register_pairs import NeRFRegDataset
    from dregnerf_tpu_torch.eval_nerf_regtr import RegEvaluator
    from dregnerf_tpu_torch.losses.visibility import exact_visibility_ctx, grid_visibility
    from dregnerf_tpu_torch.ops import packed_grid
    from dregnerf_tpu_torch.runtime.config import config_parser
    from dregnerf_tpu_torch.runtime.reg_trainer import RegTrainer, to_device

    flags = ["--root_dir", root, "--scene", subject, "--out_dir", out_dir, "--val_fraction",
             "1.0"]
    cfg = config_parser(flags + ["--expname", "chip_smoke_reg_train", "--enable_visdom",
                                 "--visdom_port", "0"])
    train_ds = NeRFRegDataset(root, subject_id=subject, split="train", seed=cfg.seed)
    val_ds = NeRFRegDataset(root, subject_id=subject, split="test", seed=cfg.seed)
    t0 = time.perf_counter()
    trainer = RegTrainer(cfg, train_ds, val_ds)  # default device: cuda; model from the config
    torch.cuda.synchronize()
    n_params = trainer.optimizer.flat.numel()
    check(trainer.device.type == "cuda" and trainer.model.dtype == torch.bfloat16
          and trainer.optimizer.flat.is_cuda, "RegTrainer: bf16 model on the card")
    print(f"register train: RegTrainer built {time.perf_counter() - t0:.3f} s ({n_params} "
          f"parameters with infonce_W, one flat f32 buffer)", flush=True)

    # the device-cached, augmented train path: get_raw items, as train() fetches them
    start = trainer.optimizer.flat.clone()
    metrics = [trainer.train_iteration(train_ds.get_raw(0)) for _ in range(REG_TRAIN_WARMUP)]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(REG_TRAIN_TIMED + 1)]
    t1 = time.perf_counter()
    marks[0].record()
    for i in range(REG_TRAIN_TIMED):
        metrics.append(trainer.train_iteration(train_ds.get_raw(0)))
        marks[i + 1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    peak_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    step_ms = [marks[i].elapsed_time(marks[i + 1]) for i in range(REG_TRAIN_TIMED)]
    values = [{k: float(v) for k, v in m.items()} for m in metrics]
    bad = [(i, k) for i, m in enumerate(values) for k in (*LOSS_NAMES, "feature_matches")
           if not math.isfinite(m[k])]
    check(not bad, f"register train: nonfinite losses {bad}")
    check(all(m["skipped_nonfinite"] == 0.0 for m in values), "register train: a step skipped")
    count = int(trainer.optimizer.count)
    check(count == int(trainer.optimizer.schedule_count) == REG_TRAIN_WARMUP + REG_TRAIN_TIMED,
          f"optimizer::1/0/count {count} after {REG_TRAIN_WARMUP + REG_TRAIN_TIMED} steps")
    moved = (trainer.optimizer.flat - start).abs()
    check(moved.max().item() > 0, "register train: the parameters did not change")
    check(trainer._dev_uploads == 2 and len(trainer._dev_cache) == 2,
          f"device cache: {trainer._dev_uploads} uploads, {len(trainer._dev_cache)} blocks")
    print(f"register train [bf16, device-cached + augmented]: {REG_TRAIN_TIMED} steps after "
          f"{REG_TRAIN_WARMUP}: {statistics.mean(step_ms):.3f} ms/step (CUDA events; min "
          f"{min(step_ms):.3f}, max {max(step_ms):.3f}), {wall / REG_TRAIN_TIMED * 1e3:.3f} "
          f"ms/step host wall; peak device memory {peak_gib:.3f} GiB above "
          f"{base / 2**30:.3f} GiB resident; total first {values[0]['total']:.5f} last "
          f"{values[-1]['total']:.5f}; losses of the last step "
          f"{ {k: round(values[-1][k], 5) for k in (*LOSS_NAMES, 'feature_matches')} }; "
          f"level cell r_p from ds_level; optimizer count {count}; parameters moved up to "
          f"{moved.max().item():.3e} (mean {moved.mean().item():.3e}); grid uploads "
          f"{trainer._dev_uploads}", flush=True)
    del start, moved

    item = train_ds.get_raw(0)  # an eager step: a CUDA graph's replay dispatches no operator
    with FlopCounterMode(display=False) as counter:
        trainer._step([trainer._augment(trainer._to_device_cached(item), item["aug"])])
    flops = counter.get_total_flops()
    bound = flops / BF16_FLOPS * 1e3
    mean_ms = statistics.mean(step_ms)
    print(f"register train FLOPs: {flops / 1e12:.4f} TFLOP a step in convolutions and matmuls "
          f"(forward and backward), bound {bound:.3f} ms at {BF16_FLOPS / 1e12:.0f} TFLOP/s = "
          f"{bound / mean_ms:.4f} of the measured {mean_ms:.3f} ms", flush=True)
    busy_ms, _, host, _ = profiled(torch, lambda: trainer.train_iteration(train_ds.get_raw(0)), 1,
                                "register train profile", "step")
    print(f"register train idle share of the unprofiled steps: 1 - {busy_ms:.3f} (busy, "
          f"profiled) / {mean_ms:.3f} = {1 - busy_ms / mean_ms:.4f}", flush=True)
    for e in host[:5]:
        print(f"  host {e.self_cpu_time_total / 1e3:8.3f} ms x{e.count:<5d} {e.key[:80]}",
              flush=True)

    # the guard on the card: a batch whose rgb holds a NaN changes nothing
    bad_item = train_ds[0]
    bad_item["src_grid"].reshape(-1, 7)[np.flatnonzero(bad_item["src_mask"])[0], 3] = np.nan
    before = _opt_state(trainer)
    m = trainer.train_iteration(bad_item)
    same = [torch.equal(a, b) for a, b in zip(_opt_state(trainer), before)]
    check(float(m["skipped_nonfinite"]) == 1.0 and all(same),
          f"NaN guard: skipped {float(m['skipped_nonfinite'])}, unchanged "
          f"(params, mu, nu, count, schedule count) {same}")
    print(f"register train NaN guard: total {float(m['total'])}, skipped_nonfinite 1, "
          f"parameters, mu, nu and both counts bit for bit unchanged (count "
          f"{int(trainer.optimizer.count)})", flush=True)
    del before

    trainer.iteration = int(trainer.optimizer.count)  # as train() would count them
    t2 = time.perf_counter()
    score = trainer.validate(fraction=1.0)
    t3 = time.perf_counter()
    check(math.isfinite(score), f"validate score {score}")
    state = read_pose_viewer(trainer.pose_viz.port)
    kinds = [t["kind"] for t in state["traces"]]
    lines = [t for t in state["traces"] if t["kind"] == "lines"]
    check(state["step"] == trainer.iteration and kinds.count("points") == 3
          and len(lines) == 3 and sum(bool(t.get("dash")) for t in lines) == 1,
          f"pose viewer state: step {state['step']} (iteration {trainer.iteration}), {kinds}")
    print(f"register train pose viewer (--enable_visdom, port {trainer.pose_viz.port}): "
          f"/state.json at step {state['step']} holds {kinds.count('points')} point traces "
          f"({[len(t['points']) for t in state['traces'] if t['kind'] == 'points']} points) "
          f"and {len(lines)} line traces (two frustum sets, the centre segment)", flush=True)
    trainer.pose_viz.close()
    trainer.save_checkpoint(score)
    t4 = time.perf_counter()
    ckpt = os.path.join(trainer.output_dir, "model", "model.ckpt")
    params = trainer.optimizer.flat.clone()
    trainer.optimizer.flat.zero_()
    trainer.load_checkpoint()
    check(torch.equal(trainer.optimizer.flat, params)
          and trainer.iteration == int(trainer.optimizer.count),
          "load_checkpoint: parameters and step as saved")
    ev_cfg = config_parser(flags + ["--expname", "chip_smoke_reg_train_eval", "--ckpt_path",
                                    ckpt])
    ev = RegEvaluator(ev_cfg, val_ds)
    ev_state = ev.model.state_dict()
    check(all(torch.equal(ev_state[k], p) for k, p in zip(trainer.param_keys,
                                                          trainer.optimizer.split(params))),
          "RegEvaluator: the trained weights")
    agg = ev.evaluate()["aggregate"]
    t5 = time.perf_counter()
    check(math.isfinite(agg["R_mean"]), f"RegEvaluator.evaluate() of the trained model: {agg}")
    print(f"register train: validate {t3 - t2:.3f} s (score {score:.4f}, -mean RRE over both "
          f"block orders), save_checkpoint {t4 - t3:.3f} s "
          f"({os.path.getsize(ckpt) / 2**20:.1f} MiB), load_checkpoint + RegEvaluator + "
          f"evaluate {t5 - t4:.3f} s (RRE {agg['R_mean']:.4f} deg, RTE {agg['t_mean']:.5f})",
          flush=True)
    del ev, ev_state, params
    torch.cuda.empty_cache()

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # cuDNN convolutions default to TF32
    try:
        item = val_ds[0]
        reg_train_parity_phase(torch, trainer, item)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    del trainer
    torch.cuda.empty_cache()

    # two steps with labels marched through the phase-6 block's NeRF; each
    # K2 forward of the path keeps its inputs and output (first call per table)
    exact = RegTrainer(config_parser(flags + ["--expname", "chip_smoke_reg_exact",
                                              "--visibility", "exact"]), train_ds, val_ds)
    forwards, calls = {}, [0]
    real_forward = packed_grid._k2_forward
    k2 = packed_grid.vertex_encode

    def recorded(table, x, config):
        out = real_forward(table, x, config)
        calls[0] += 1
        forwards.setdefault(table.data_ptr(), (table, x, config, out))
        return out

    packed_grid._k2_forward = recorded
    before = k2.launches
    exact_s = []
    try:
        for _ in range(REG_EXACT_STEPS):
            t6 = time.perf_counter()
            m = exact.train_iteration(train_ds[0])
            torch.cuda.synchronize()
            exact_s.append(time.perf_counter() - t6)
            check(all(math.isfinite(float(m[k])) for k in LOSS_NAMES)
                  and float(m["skipped_nonfinite"]) == 0.0, f"exact step: {m}")
    finally:
        packed_grid._k2_forward = real_forward
    launched = k2.launches - before
    check(launched > 0 and launched == calls[0],
          f"exact visibility: {launched} K2 forward launches, {calls[0]} forward calls")
    item = train_ds[0]
    # K2 on the path's own tables and points, bit for bit against its plain forward
    sides = {exact._get_vis_ctx(item[f"{side}_nerf_path"]).params["table"].data_ptr(): side
             for side in ("src", "tgt")}
    check(set(forwards) == set(sides),
          f"exact visibility read {len(forwards)} tables, the fields hold {len(sides)}")
    for ptr, (table, x, config, out) in forwards.items():
        check(torch.equal(out, packed_grid.k2_forward_plain(table, x, config)),
              f"K2 on the exact path at {sides[ptr]}: not equal to its plain forward")
    print(f"register train [--visibility exact]: K2's forward held bit for bit against its "
          f"plain version on the first call on each field's table {sorted(sides.values())}: "
          f"{[tuple(t.shape) for t, _, _, _ in forwards.values()]} rows, "
          f"{[int(x.shape[0]) for _, x, _, _ in forwards.values()]} points", flush=True)
    # K2's bound on the path's own calls: positions read and the encoding
    # written; their device time alone in the profiler (at 2^16 points a
    # call the wrapper's host time exceeds the kernel's, so back-to-back
    # calls would time the host)
    exact_calls = []
    for ptr, (table, x, config, _) in forwards.items():
        n = int(x.shape[0])
        exact_calls.append({"table": sides[ptr], "rows": int(table.shape[0]), "points": n,
                            "bound_ms": bound_ms(n * (12 + 4 * config.out_dim)),
                            "ms": device_ms(torch, lambda: real_forward(table, x, config),
                                            "void packed_grid_fwd<")})
    for c in exact_calls:
        print(f"K2 forward exact path {c['table']}: table_rows={c['rows']} points={c['points']}: "
              f"kernel {c['ms'] * 1e3:.2f} us device, bound {c['bound_ms'] * 1e3:.2f} us (bytes)",
              flush=True)
    del forwards
    batch = to_device(item, exact.device)
    shares = []
    with torch.inference_mode():
        pred = exact.model(batch)
        model_cfg, rcfg = exact._vis_static
        for side in ("src", "tgt"):
            kp, valid = pred[f"{side}_kp"], pred[f"{side}_valid"]
            ctx = exact._get_vis_ctx(item[f"{side}_nerf_path"])
            e = exact_visibility_ctx(ctx, model_cfg, rcfg, kp, cfg.vis_buffer_size)[valid]
            g = grid_visibility(kp, batch[f"{side}_mask"], exact.aabb,
                                exact.grid_resolution)[valid]
            shares.append((side, e.mean().item(), g.mean().item(), (e != g).float().mean().item(),
                           int(valid.sum()), int(ctx.cam_origins.shape[0])))
    _, kernels, _, _ = profiled(torch, lambda: exact.train_iteration(train_ds[0]), 1,
                             "register train exact profile", "step")
    k2_events = [e for e in kernels if "packed_grid_fwd" in e.key]
    k2_prof = sum(e.count for e in k2_events)
    k2p_prof = sum(e.count for e in kernels if "gather_rows_f32x4" in e.key)
    check(k2_prof > 0 and k2p_prof == 0,
          f"the profiler saw {k2_prof} K2 forward and {k2p_prof} K2p launches in an exact step")
    k2_us = sum(e.self_device_time_total for e in k2_events) / k2_prof
    mean = {k: statistics.mean(c[k] for c in exact_calls) for k in ("ms", "bound_ms")}
    print(f"K2 forward exact path, mean of the {len(exact_calls)} first calls: kernel "
          f"{mean['ms'] * 1e3:.2f} us device, bound {mean['bound_ms'] * 1e3:.2f} us "
          f"({mean['bound_ms'] / mean['ms']:.2f} of the measured); in the profiled step "
          f"{k2_us:.2f} us a launch", flush=True)
    print(f"register train [--visibility exact]: {REG_EXACT_STEPS} steps in "
          f"{[round(s, 3) for s in exact_s]} s; K2 forward launches {launched} (wrapper count), "
          f"{k2_prof} in the profiled third step, K2p none; labels (side, exact visible share, grid "
          f"visible share, disagreement, valid keypoints, cameras) "
          f"{[(s, round(a, 4), round(b, 4), round(c, 4), n, c_) for s, a, b, c, n, c_ in shares]}",
          flush=True)
    return {"k2_launches": launched, "k2_profiled": k2_prof,
            "k2_exact": dict(mean, profiled_us_a_launch=k2_us, calls=exact_calls)}


def read_pose_viewer(port: int) -> dict:
    """The pose viewer's /state.json, read over localhost."""
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/state.json", timeout=30) as r:
        return json.loads(r.read())


def train_pallas_phase(torch, out_dir: str) -> int:
    """grad_accum "pallas" without RLE at full width: K1 on every level.
    Steps 49-63 have no occupancy update: their ms/step compares with the
    default path's steady steps in the same run."""
    from dregnerf_tpu_torch.ops.scatter_add import scatter_add
    from dregnerf_tpu_torch.runtime.config import config_parser
    from dregnerf_tpu_torch.runtime.ngp_trainer import NGPTrainer

    scene, val_scene = _scenes()
    cfg = config_parser(SHAPE_FLAGS + ["--expname", "chip_smoke_pallas", "--out_dir", out_dir,
                                       "--grad_accum", "pallas", "--no-rle_backward"])
    trainer = NGPTrainer(cfg, scene, val_scene)
    torch.cuda.synchronize()
    scatter_add.launches = 0  # count only this path's launches
    start = _ngp_marks(trainer)
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(PALLAS_STEPS + 1)]
    t0 = time.perf_counter()
    marks[0].record()
    losses = []
    for step in range(PALLAS_STEPS):
        losses.append(trainer.train_iteration(step)["loss"])
        marks[step + 1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = scatter_add.launches
    (_,), (replayed,), captures, replays = _ngp_launches(trainer, start, ("scatter_add",))
    losses = [float(x) for x in losses]
    steady = STEADY
    steady_ms = sum(marks[i].elapsed_time(marks[i + 1]) for i in steady) / len(steady)
    # every step a replay of a graph whose recording launched K1 4 times; the
    # host launched K1 only at the captures (4 for the warm-up, 4 for the
    # recording)
    check(replays == PALLAS_STEPS and replayed == 4 * PALLAS_STEPS
          and launches == 8 * captures,
          f"K1 launched by the host {launches} times ({captures} captures), by {replays} "
          f"replays {replayed} times in {PALLAS_STEPS} steps, expected 4 a step")
    check(all(math.isfinite(x) for x in losses), "non-finite loss")
    first, last = sum(losses[:8]) / 8, sum(losses[-8:]) / 8
    check(last < first, f"loss did not fall: first 8 {first}, last 8 {last}")
    print(f"train [pallas, no RLE]: {PALLAS_STEPS} steps in {wall:.3f} s wall; steps "
          f"{steady.start}-{steady.stop - 1} (no occupancy update) {steady_ms:.2f} ms/step "
          f"device at bucket {trainer.num_rays}; loss first 8 {first:.5f} last 8 {last:.5f}; "
          f"K1 launches: host {launches}, replayed (derived) {replayed}", flush=True)
    return launches, replayed


def fields_parity(torch, dev) -> dict:
    """Phase 14a: the hash encoder at full width and one f32 step of each
    MLP field at FIELDS_SMALL, on the card against the CPU (FIELDS_TOL)."""
    from dregnerf_tpu_torch.datasets.fixtures import make_scene_data
    from dregnerf_tpu_torch.models import fields, mlp_nerf
    from dregnerf_tpu_torch.ops import hash_encoding, occupancy
    from dregnerf_tpu_torch.render.renderer import RenderConfig
    from dregnerf_tpu_torch.runtime.checkpoint import leaves_with_paths
    from dregnerf_tpu_torch.runtime.ngp_trainer import draw_step_inputs, step_loss

    hcfg = hash_encoding.HashGridConfig()
    g = torch.Generator().manual_seed(2)
    x = torch.rand(1 << 16, 3, generator=g) * 1.1 - 0.05
    table = torch.rand(hcfg.n_levels * hcfg.table_size, hcfg.n_features, generator=g) * 2 - 1
    cot = torch.randn(1 << 16, hcfg.out_dim, generator=g)
    res = {}
    for d in ("cpu", dev):
        rows, _ = hash_encoding.hash_corners(x.to(d), hcfg)
        t = table.to(d).detach().requires_grad_(True)
        hash_encoding.hash_encode(t, x.to(d), hcfg).backward(cot.to(d))
        y = hash_encoding.hash_encode(t.detach(), x.to(d), hcfg)
        res[str(d)] = (rows.cpu(), y.cpu(), t.grad.cpu())
    (r0, y0, g0), (r1, y1, g1) = res["cpu"], res[str(dev)]
    out = {"hash_encode": {
        "points": 1 << 16, "rows_equal": bool(torch.equal(r0, r1)),
        "out_err": ((y1 - y0).abs().max() / y0.abs().max()).item(),
        "grad_err": ((g1 - g0).abs().max() / g0.abs().max()).item()}}
    h = out["hash_encode"]
    check(h["rows_equal"], "hash corner rows differ between the card and the CPU")
    check(h["out_err"] <= FIELDS_TOL["hash_out"], f"hash_encode out err {h['out_err']}")
    check(h["grad_err"] <= FIELDS_TOL["hash_grad"], f"hash_encode grad err {h['grad_err']}")

    steps = 64
    scene = make_scene_data("train", num_views=8, image_size=32)
    times = torch.arange(scene.num_images, dtype=torch.float32) / (scene.num_images - 1)
    rcfg = RenderConfig(render_step_size=2 * math.sqrt(3) / steps, buffer_size=1 << 13,
                        max_steps=steps, march_compaction="capped", k_cap=steps)
    binary = torch.rand(16, 16, 16, generator=g) < 0.6
    draws_cpu = draw_step_inputs(g, 256, scene.num_images, scene.height, scene.width, "cpu")
    for name in ("vanilla", "dnerf"):
        field = fields.get_field(name)
        mcfg = mlp_nerf.VanillaNeRFConfig(**FIELDS_SMALL, warp=name == "dnerf")
        weights = mlp_nerf.params_to_numpy(
            field.init(mcfg, torch.Generator().manual_seed(0), "cpu"))
        r = {}
        for d in ("cpu", dev):
            params = field.params_from_jax(weights, d)
            leaves = leaves_with_paths(params)
            for p in leaves.values():
                p.requires_grad_(True)
            loss, m = step_loss(
                params, mcfg, rcfg, occupancy.OccupancyGrid(torch.zeros(16**3, device=d),
                                                              binary.to(d)),
                torch.tensor([-1.0, -1, -1, 1, 1, 1], device=d),
                torch.as_tensor(scene.images, device=d),
                torch.as_tensor(scene.camtoworlds, device=d), torch.as_tensor(scene.K, device=d),
                type(draws_cpu)(*(t.to(d) for t in draws_cpu)), True, True, field=field,
                timestamps=times.to(d) if name == "dnerf" else None)
            loss.backward()
            r[str(d)] = (loss.item(), int(m["n_samples"]),
                         {k: p.grad.cpu() for k, p in leaves.items()})
        (l0, n0, g0), (l1, n1, g1) = r["cpu"], r[str(dev)]
        worst = max(((g1[k] - g0[k]).abs().max() / g0[k].abs().max()).item() for k in g0)
        out[f"{name}_step"] = {"loss_cpu": l0, "loss_cuda": l1, "n_samples": n0,
                               "worst_grad_err": worst}
        check(n0 == n1, f"{name} step: n_samples cpu {n0} vs cuda {n1}")
        check(math.isclose(l0, l1, rel_tol=FIELDS_TOL["loss_rel"]),
              f"{name} step: loss cpu {l0} vs cuda {l1}")
        check(worst <= FIELDS_TOL["grad"][name], f"{name} step: gradient err {worst}")
    print(f"fields parity: hash_encode rows equal, out err {h['out_err']:.3e}, table grad err "
          f"{h['grad_err']:.3e} of max; f32 steps card vs CPU: "
          + ", ".join(f"{n} loss {out[f'{n}_step']['loss_cuda']:.6f} (cpu "
                      f"{out[f'{n}_step']['loss_cpu']:.6f}), worst grad err "
                      f"{out[f'{n}_step']['worst_grad_err']:.3e}" for n in ("vanilla", "dnerf")),
          flush=True)
    return out


def mlp_macs(c) -> int:
    """Multiply-adds of one sample's forward through a VanillaNeRFConfig
    field (the warp included when the config has one)."""
    macs, in_dim = 0, c.xyz_dim
    for i in range(c.net_depth):
        macs += in_dim * c.net_width
        in_dim = c.net_width + (c.xyz_dim if c.skip_after(i) else 0)
    macs += c.net_width * (1 + c.net_width)  # sigma, bottleneck
    in_dim = c.net_width + c.dir_dim
    for _ in range(c.net_depth_condition):
        macs += in_dim * c.net_width_condition
        in_dim = c.net_width_condition
    macs += in_dim * 3
    if c.warp:
        in_dim = c.xyz_dim + c.time_dim
        for _ in range(c.warp_depth):
            macs += in_dim * c.warp_width
            in_dim = c.warp_width
        macs += in_dim * 3
    return macs


# the packed grid's kernels: K1, K1p, K2p and K2's three
PACKED_KERNELS = ("scatter_add", "scatter_add_bf16", "gather_rows", "packed_grid_fwd",
                  "packed_grid_rows", "packed_grid_unpack")


def _kernel_launches():
    """The host launches of PACKED_KERNELS since the last reset."""
    from dregnerf_tpu_torch.runtime.ngp_trainer import launches

    counts = launches()
    return {k: counts[k] for k in PACKED_KERNELS}


def _packed_launches(k1p: int = 0, forward: int = 0, backward: int = 0) -> dict:
    """PACKED_KERNELS' launches when K1p launches `k1p` times, K2's forward
    `forward` times and its rows and unpack `backward` times each."""
    return {"scatter_add": 0, "scatter_add_bf16": k1p, "gather_rows": 0,
            "packed_grid_fwd": forward, "packed_grid_rows": backward,
            "packed_grid_unpack": backward}


def _reset_kernel_launches():
    from dregnerf_tpu_torch.runtime.ngp_trainer import launch_counters

    for name in PACKED_KERNELS:
        fn, attr = launch_counters()[name]
        setattr(fn, attr, 0)


def train_timed(torch, trainer, steps: range) -> dict:
    """Train `steps` with a CUDA event after each; returns the losses,
    train PSNRs and peak memory, and the steady ms a step and samples a
    step over the last 32 steps without an occupancy update (those next
    to the profiled ones that follow)."""
    from dregnerf_tpu_torch.runtime.ngp_trainer import OCC_UPDATE_INTERVAL

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(len(steps) + 1)]
    t0 = time.perf_counter()
    marks[0].record()
    metrics = []
    for i, step in enumerate(steps):
        metrics.append(trainer.train_iteration(step))
        marks[i + 1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step_ms = [marks[i].elapsed_time(marks[i + 1]) for i in range(len(steps))]
    quiet = [i for i in range(max(len(steps) - 32, 0), len(steps))
             if steps[i] % OCC_UPDATE_INTERVAL]
    losses = [float(m["loss"]) for m in metrics]
    check(all(math.isfinite(v) for v in losses), f"non-finite loss in {losses}")
    return {"wall_s": wall, "losses": losses,
            "psnr": [float(m["psnr"]) for m in metrics],
            "steady_ms": sum(step_ms[i] for i in quiet) / len(quiet),
            "samples": sum(int(metrics[i]["n_samples"]) for i in quiet) / len(quiet),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "bucket": int(metrics[-1]["num_rays"])}


def _check_checkpoint_round_trip(torch, trainer, step: int) -> str:
    """Save the trainer's checkpoint at `step`, read it back through
    load_field_from_checkpoint: every parameter bit for bit. Returns its path."""
    from dregnerf_tpu_torch.runtime.checkpoint import leaves_with_paths
    from dregnerf_tpu_torch.runtime.ngp_trainer import load_field_from_checkpoint

    trainer.save_checkpoint(step)
    path = os.path.join(trainer.output_dir, "model", "model.ckpt")
    params, _, meta, model_cfg, _ = load_field_from_checkpoint(path, trainer.device)
    want, got = leaves_with_paths(trainer.params), leaves_with_paths(params)
    check(sorted(got) == sorted(want) and all(torch.equal(got[k], want[k].detach())
                                              for k in want),
          f"{path}: the parameters read back differ")
    check(model_cfg == trainer.model_config, f"{path}: config {model_cfg}")
    check(meta["step"] == step, f"{path}: step {meta['step']}")
    return path


def mlp_field_phase(torch, out_dir: str, name: str) -> dict:
    """Phases 14b and 14c: --field `name` at full width (8x256, bf16) at
    SHAPE_FLAGS on the 36-view 128 px fixture (dnerf: every view at time
    i/35, validated on views DNERF_VAL_VIEWS at their times)."""
    import numpy as np

    from dregnerf_tpu_torch.datasets import dnerf_synthetic, objaverse
    from dregnerf_tpu_torch.datasets.fixtures import render_views
    from dregnerf_tpu_torch.runtime import ngp_trainer, profiling
    from dregnerf_tpu_torch.runtime.checkpoint import leaves_with_paths
    from dregnerf_tpu_torch.runtime.config import config_parser

    if name == "dnerf":
        images, c2w = render_views(36, 128)
        c2w, K = c2w.astype(np.float32)[:, :3, :4], objaverse.intrinsics(128, 128, 0.9)
        times = np.arange(36, dtype=np.float32) / 35
        view = list(DNERF_VAL_VIEWS)
        scene = dnerf_synthetic.scene_from_arrays(images, c2w, K, times, "train")
        val_scene = dnerf_synthetic.scene_from_arrays(images[view], c2w[view], K, times[view],
                                                      "test")
    else:
        scene, val_scene = _scenes()
    cfg = config_parser(SHAPE_FLAGS + ["--expname", f"chip_smoke_{name}", "--out_dir", out_dir,
                                       "--field", name])
    trainer = ngp_trainer.NGPTrainer(cfg, scene, val_scene)
    mcfg = trainer.model_config
    check(trainer.device.type == "cuda" and type(mcfg).__name__ == "VanillaNeRFConfig"
          and mcfg.warp == (name == "dnerf") and mcfg.compute_dtype == torch.bfloat16
          and mcfg.net_width == 256, f"--field {name}: {mcfg} on {trainer.device}")
    before = {k: p.detach().clone() for k, p in leaves_with_paths(trainer.params).items()}
    _reset_kernel_launches()
    run = train_timed(torch, trainer, range(FIELD_STEPS))
    profiling.reset()
    busy_ms, profiled_ms = profile_phase(torch, trainer, FIELD_STEPS)
    counters = profiling.snapshot()["counters"]
    profiling.reset()
    profiled_bucket = trainer.num_rays
    # the profiled steps (no occupancy update among them) replay the graph,
    # which counts the recording's rows again: every buffer row through the
    # trunk, and under dnerf through the warp first
    rows = (PROFILE_STEPS - 1) * cfg.sample_budget
    mlp_rows = (counters.get("mlp.rows"), counters.get("mlp.warp_rows", 0))
    check(mlp_rows == (rows, rows if name == "dnerf" else 0),
          f"--field {name}: profiled steps counted (mlp.rows, mlp.warp_rows) {mlp_rows}, "
          f"expected {rows} rows")
    step = FIELD_STEPS + 1 + PROFILE_STEPS
    flops = 2 * mlp_macs(mcfg) * 3 * run["samples"]  # forward 2 MACs, backward twice that
    # validate() through a spy on its render call: the time it renders at
    real_render, seen_times = ngp_trainer.render_image_chunked, []

    def render_spy(*args, **kwargs):
        seen_times.append(kwargs.get("time"))
        return real_render(*args, **kwargs)

    ngp_trainer.render_image_chunked = render_spy
    try:
        t0 = time.perf_counter()
        val_psnr = trainer.validate(step)
        val_s = time.perf_counter() - t0
    finally:
        ngp_trainer.render_image_chunked = real_render
    want_time = float(val_scene.timestamps[0]) if name == "dnerf" else None
    check(seen_times == [want_time], f"validate rendered at {seen_times}, expected {want_time}")
    check(math.isfinite(val_psnr), f"val psnr {val_psnr}")
    moved = {k: not torch.equal(p.detach(), before[k])
             for k, p in leaves_with_paths(trainer.params).items()}
    check(all(moved.values()), f"parameters that did not move: "
          f"{[k for k, v in moved.items() if not v]}")
    launches = _kernel_launches()
    check(not any(launches.values()) and not any(trainer.replayed_launches.values()),
          f"--field {name} launched port kernels: host {launches}, replayed "
          f"{trainer.replayed_launches}")
    _check_checkpoint_round_trip(torch, trainer, step)
    out = {"steps": FIELD_STEPS, "wall_s": run["wall_s"], "steady_ms": run["steady_ms"],
           "busy_ms": busy_ms, "profiled_wall_ms": profiled_ms,
           "idle_share": 1 - busy_ms / profiled_ms,
           "samples_a_step": run["samples"], "bucket": run["bucket"],
           "profiled_bucket": profiled_bucket,
           "peak_gib": run["peak_gib"], "mlp_tflop_a_step": flops / 1e12,
           "f32_peak_share": flops / (run["steady_ms"] / 1e3) / F32_FLOPS,
           "train_psnr_first": run["psnr"][0], "train_psnr_last": run["psnr"][-1],
           "loss_first": run["losses"][0], "loss_last": run["losses"][-1],
           "val_psnr": val_psnr, "val_s": val_s, "val_time": want_time,
           "checkpoint_bit_equal": True, "profiled_mlp_rows": mlp_rows[0],
           "profiled_mlp_warp_rows": mlp_rows[1]}
    if name == "dnerf":
        out["warp_moved"] = all(v for k, v in moved.items() if k.startswith("warp"))
    print(f"--field {name}: {FIELD_STEPS} steps in {run['wall_s']:.3f} s wall; steady "
          f"{run['steady_ms']:.2f} ms/step device ({run['samples']:.0f} samples a step, bucket "
          f"{run['bucket']}); profiled steps {busy_ms:.3f} ms/step busy of {profiled_ms:.3f} "
          f"wall, idle share {out['idle_share']:.4f}, bucket {profiled_bucket}; peak "
          f"{run['peak_gib']:.2f} GiB; MLP {out['mlp_tflop_a_step']:.4f} TFLOP a step = {out['f32_peak_share']:.4f} of the f32 "
          f"peak; train psnr {run['psnr'][0]:.3f} -> {run['psnr'][-1]:.3f}; val psnr "
          f"{val_psnr:.3f} at time {want_time} ({val_s:.3f} s); checkpoint read back bit for "
          f"bit; port kernel launches {launches}; profiled mlp.rows {mlp_rows[0]}, "
          f"mlp.warp_rows {mlp_rows[1]}", flush=True)
    return out


def hash_ngp_phase(torch, out_dir: str) -> dict:
    """Phase 14d: the xor-hash NGP at full width (HashGridConfig(): 16
    levels x 2^19 rows x 2 features, bf16 MLPs), built by the trainer from
    `--encoder xor_hash` at SHAPE_FLAGS, trained to HASH_STEPS, profiled,
    saved, and evaluated and extracted through Evaluator; K1, K1p, K2p and
    K2 must never launch, K6 forward and backward must."""
    import numpy as np

    from dregnerf_tpu_torch.eval_ngp_nerf import Evaluator
    from dregnerf_tpu_torch.extract import sample_grid as sg
    from dregnerf_tpu_torch.ops.hash_encoding import HashGridConfig, hash_encode
    from dregnerf_tpu_torch.runtime.checkpoint import load_checkpoint
    from dregnerf_tpu_torch.runtime.config import config_parser
    from dregnerf_tpu_torch.runtime.ngp_trainer import NGPTrainer

    scene, val_scene = _scenes()
    cfg = config_parser(SHAPE_FLAGS + ["--expname", "chip_smoke_hash", "--out_dir", out_dir,
                                       "--encoder", "xor_hash"])
    trainer = NGPTrainer(cfg, scene, val_scene)
    grid = HashGridConfig()
    check(trainer.model_config.grid == grid
          and trainer.model_config.compute_dtype == torch.bfloat16,
          f"--encoder xor_hash built {trainer.model_config}")
    rows = tuple(trainer.params["table"].shape)
    check(rows == (grid.n_levels * grid.table_size, grid.n_features), f"hash table {rows}")
    _reset_kernel_launches()
    hash_encode.launches = hash_encode.grad_launches = 0
    run = train_timed(torch, trainer, range(HASH_STEPS))
    first, last = sum(run["losses"][:8]) / 8, sum(run["losses"][-8:]) / 8
    check(last < first, f"hash NGP loss did not fall: first 8 {first}, last 8 {last}")
    busy_ms, profiled_ms = profile_phase(torch, trainer, HASH_STEPS)
    profiled_bucket = trainer.num_rays
    step = HASH_STEPS + 1 + PROFILE_STEPS
    val_psnr = trainer.validate(step)
    path = _check_checkpoint_round_trip(torch, trainer, step)
    _, meta = load_checkpoint(path)
    check(meta["model_config"]["encoder"] == "xor_hash", f"meta {meta['model_config']}")

    t0 = time.perf_counter()
    ev = Evaluator(cfg, trainer.output_dir, val_scene)
    check(ev.model_config.grid == grid, f"evaluator {ev.model_config}")
    result = ev.evaluate()
    check(math.isfinite(result["psnr"]), f"eval psnr {result['psnr']}")
    t1 = time.perf_counter()
    extracted = ev.sample_points()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    points, cams = extracted["points"], np.asarray(ev.meta["camera_poses"], np.float32)
    aabb = torch.as_tensor(ev.meta["aabb"], dtype=torch.float32, device=ev.device)
    sg.compute_surface_mask(ev.params, ev.model_config, ev.grid, aabb,
                            sg.extraction_render_config(ev.meta), points, cams,
                            chunk=min(cfg.test_chunk_size, 8192), return_scores=True)
    t3 = time.perf_counter()
    n_surface = int((extracted["surface_mask"] & extracted["density_mask"]).sum())
    check(n_surface > 0, "the hash block has no surface voxel")
    launches = _kernel_launches()
    replayed = trainer.replayed_launches
    check(not any(launches.values()) and not any(replayed.get(k) for k in launches),
          f"the hash NGP launched K1, K1p, K2p or K2: host {launches}, replayed {replayed}")
    launches.update(hash_grid_fwd=hash_encode.launches, hash_grid_bwd=hash_encode.grad_launches)
    # every step a replay of a graph whose recording launched K6 once each
    # way; the host launched K6's backward only at the captures (warm-up and
    # recording), its forward there and in the occupancy updates and the
    # evaluation
    replays, captures = trainer.graph_replays, trainer.graph_captures
    check(replays >= HASH_STEPS and replayed["hash_grid_fwd"] == replayed["hash_grid_bwd"]
          == replays and hash_encode.grad_launches == 2 * captures
          and hash_encode.launches > 2 * captures,
          f"K6 launches: host {launches}, replayed (derived) {replayed} in {replays} replays, "
          f"{captures} captures")
    rays = len(points) * len(cams)
    out = {"steps": HASH_STEPS, "wall_s": run["wall_s"], "steady_ms": run["steady_ms"],
           "busy_ms": busy_ms, "profiled_wall_ms": profiled_ms,
           "idle_share": 1 - busy_ms / profiled_ms,
           "samples_a_step": run["samples"], "bucket": run["bucket"],
           "profiled_bucket": profiled_bucket,
           "peak_gib": run["peak_gib"], "loss_first8": first, "loss_last8": last,
           "train_psnr_last": run["psnr"][-1], "val_psnr": val_psnr,
           "encoder": meta["model_config"]["encoder"], "eval_psnr": result["psnr"],
           "eval_s": t1 - t0, "sample_points_s": t2 - t1, "occupied_voxels": len(points),
           "surface_voxels": n_surface, "density_voxels": int(extracted["density_mask"].sum()),
           "surface_rays_per_s": rays / (t3 - t2), "launches": launches,
           "replayed": {k: replayed[k] for k in ("hash_grid_fwd", "hash_grid_bwd")}}
    print(f"hash NGP: {HASH_STEPS} steps in {run['wall_s']:.3f} s wall; steady "
          f"{run['steady_ms']:.2f} ms/step device ({run['samples']:.0f} samples a step, bucket "
          f"{run['bucket']}); profiled steps {busy_ms:.3f} ms/step busy of {profiled_ms:.3f} "
          f"wall, idle share {out['idle_share']:.4f}, bucket {profiled_bucket}; "
          f"peak {run['peak_gib']:.2f} GiB; loss first 8 {first:.5f} last 8 {last:.5f}; val "
          f"psnr {val_psnr:.3f}; eval psnr {result['psnr']:.3f} ({t1 - t0:.3f} s); "
          f"sample_points {t2 - t1:.3f} s: {n_surface} surface voxels of {len(points)} "
          f"occupied; surface pass {rays} rays in {t3 - t2:.3f} s "
          f"({out['surface_rays_per_s']:.1f} rays/s); port kernel launches {launches}",
          flush=True)
    return out


def fields_phase(torch, dev, out_dir: str) -> dict:
    """Phase 14: the vanilla and D-NeRF fields and the xor-hash NGP."""
    out = fields_parity(torch, dev)
    for name in ("vanilla", "dnerf"):
        out[name] = mlp_field_phase(torch, out_dir, name)
        torch.cuda.empty_cache()
    out["hash_ngp"] = hash_ngp_phase(torch, out_dir)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from dregnerf_tpu_torch.ops import native

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"device: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls must be off")
    dev = torch.device("cuda")
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        torch.cuda.synchronize()
        seconds[name] = round(time.perf_counter() - t0, 3)
        print(f"phase {name}: {seconds[name]} s", flush=True)
        return result

    print(f"build: {native.build_all():.2f} s", flush=True)
    k1p_sass = k1p_sass_phase()
    k1 = timed("K1", k1_phase, torch, dev)
    k1p = timed("K1p", k1p_phase, torch, dev)
    k2p = timed("K2p", k2p_phase, torch, dev)
    k2 = timed("K2", k2_phase, torch, dev)
    k6 = timed("K6", k6_phase, torch, dev)
    timed("reference pallas", reference_phase, torch, dev, False)
    timed("reference defaults", reference_phase, torch, dev, True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
        trainer, cfg, default_launches, default_replayed = timed(
            "train defaults", train_default_phase, torch, out_dir)
        timed("extract", extract_phase, torch, trainer, cfg)
        multi = timed("multi-block", multi_block_phase, torch, out_dir)
        views = timed("novel views", novel_views_phase, torch, multi, out_dir)
        marchers = timed("marchers", marcher_phase, torch, multi.pop("grid"), out_dir)
        fleet = timed("fleet", fleet_phase, torch, out_dir)
        torch.cuda.empty_cache()
        s3 = timed("stage3 fleet", stage3_fleet_phase, torch, out_dir)
        torch.cuda.empty_cache()
        block_dir = trainer.output_dir
        del trainer
        torch.cuda.empty_cache()
        root, subject = timed("register", register_phase, torch, block_dir, out_dir)
        torch.cuda.empty_cache()
        timed("classical", classical_phase, torch, root, subject, out_dir)
        torch.cuda.empty_cache()
        exact = timed("register train", register_train_phase, torch, root, subject, out_dir)
        torch.cuda.empty_cache()
        mesh = timed("mesh", mesh_phase, torch, out_dir, multi["model_dirs"][0], root, subject)
        k1_launches, k1_replayed = timed("train pallas", train_pallas_phase, torch, out_dir)
    timed("K1p device", k1p_device_phase, torch, k1p)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fields_") as out_dir:
        fields = timed("fields", fields_phase, torch, dev, out_dir)
    print(json.dumps({"fields": fields}), flush=True)
    print(json.dumps({"fleet": {k: v for k, v in fleet.items() if k != "k2_checked"},
                      "mesh": mesh, "stage3 fleet": s3}), flush=True)
    print(f"phase seconds: {json.dumps(seconds)}", flush=True)

    # `launches` are the host's (the wrappers' counters); `replayed` those
    # that the training steps' CUDA graph replays ran, derived from what
    # each graph's recording launched
    def entry(name, source, replaces, launches, replayed, k):
        return {"name": name, "route": "cuda", "source": f"dregnerf_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, "replayed": replayed,
                "max_abs_err": k["max_abs_err"],
                "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                "bound_by": "bytes", "library_ms": k["library_ms"]}

    def by_path(name):
        return {"train defaults": default_launches[name],
                "multi-block": multi["launches"][name],
                "fleet": fleet["launches"][name],
                "stage3-fleet": s3["launches"][name],
                "mesh": mesh["launches"][name],
                "compact": marchers["compact"]["launches"][name],
                "quota": marchers["quota"]["launches"][name]}

    def replayed_by_path(name):  # the replays ran K1p and K2 (K1P_K2) only
        return {"train defaults": default_replayed.get(name, 0),
                "multi-block": multi["replayed"].get(name, 0),
                "stage3-fleet": s3["replayed"].get(name, 0),
                "compact": marchers["compact"]["replayed"].get(name, 0),
                "quota": marchers["quota"]["replayed"].get(name, 0)}

    kernels = [
        entry("scatter_add", "scatter_add.cu", "dregnerf_tpu/ops/pallas_scatter.py:122",
              k1_launches, k1_replayed, k1),
        dict(entry("scatter_add_bf16", "scatter_add_bf16.cu",
                   "scripts/perf/probe_pallas_scatter.py:104",
                   default_launches["scatter_add_bf16"], default_replayed["scatter_add_bf16"],
                   k1p),
             launches_by_path=by_path("scatter_add_bf16"),
             replayed_by_path=replayed_by_path("scatter_add_bf16"),
             device_ms=k1p["device_ms"], host_us=k1p["host_us"], sass_reduction=k1p_sass,
             worst_tol_ratio=k1p["worst_tol_ratio"]),
        dict(entry("gather_rows", "gather_rows.cu", "scripts/perf/probe_pallas_gather.py:70",
                   default_launches["gather_rows"], 0, k2p),
             launches_by_path=by_path("gather_rows")),
    ]
    for part, kernel in (("forward", "packed_grid_fwd"), ("rows", "packed_grid_rows"),
                         ("unpack", "packed_grid_unpack")):
        k2_paths = by_path(kernel)
        if part == "forward":
            k2_paths.update({"novel views": views["k2_launches"],
                             "register train exact visibility": exact["k2_launches"]})
        kernels.append(dict(
            entry(f"{kernel}_f32", "packed_grid.cu", "K2p's gather with pack_table's rolls and "
                  "the trilinear einsum (scripts/perf/probe_pallas_gather.py:70)",
                  default_launches[kernel], default_replayed[kernel],
                  dict(k2[part], max_abs_err=0.0, library_ms=None)),
            device_ms=k2[part]["device_ms"], launches_by_path=k2_paths,
            replayed_by_path=replayed_by_path(kernel)))
    kernels[-3].update(
        encoder_fwd_bwd_ms=k2["encoder"],
        multi_block_plain_checks=sum(len(b["k2_checked"]) for b in multi["blocks"]),
        fleet_plain_checks=len(fleet["k2_checked"]),
        exact_path={k: exact["k2_exact"][k] for k in ("ms", "bound_ms", "profiled_us_a_launch")})
    hash_launches, hash_replayed = fields["hash_ngp"]["launches"], fields["hash_ngp"]["replayed"]
    for part, kernel in (("forward", "hash_grid_fwd"), ("backward", "hash_grid_bwd")):
        kernels.append(dict(entry(f"{kernel}_f32", "hash_grid.cu", "none (XLA in the JAX "
                                  "package)", hash_launches[kernel], hash_replayed[kernel],
                                  k6[part]),
                            device_ms=k6[part]["device_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
