"""Argparse flags of the port's entry points (copy of the flags of
dregnerf_tpu/runtime/config.py that the NGP trainer, its evaluator and the
registration trainer and evaluator read: same names and defaults), plus
`--device`, `--profile_steps` and `--encoder`.

Every `--encoder` trains, every `--grad_accum` value with or without
`--rle_backward` (the packed encoder's), and every `--march_compaction`,
`--field` and `--dataset`; `--fleet` trains
the blocks of `--multi_blocks` together, and `--mesh_shape` runs the
trainers and the extraction over the ranks of a torchrun job (parallel/).
"""
from __future__ import annotations

import argparse


def config_parser(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=3407)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--max_iterations", type=int, default=20000)
    p.add_argument("--lr", type=float, default=1e-4,
                   help="registration learning rate (halved at 34000 k updates, k = 1..4)")

    p.add_argument("--dataset", type=str, default="", choices=[
        "mipnerf_360", "nerf_llff_data", "nerf_synthetic", "objaverse", "scannerf",
        "Synthetic_NSVF", "Hypersim", "dtu", "BlendedMVS", "dnerf"])
    p.add_argument("--factor", type=int, default=4, choices=[1, 2, 4, 8])
    p.add_argument("--root_dir", type=str, default="")
    p.add_argument("--scene", type=str, default="")
    p.add_argument("--expname", type=str, default="chair_reg")
    p.add_argument("--aabb", type=lambda s: [float(item) for item in s.split(",")],
                   default=[-1.5, -1.5, -1.5, 1.5, 1.5, 1.5])
    p.add_argument("--test_chunk_size", type=int, default=8192)
    p.add_argument("--unbounded", action="store_true")
    p.add_argument("--cone_angle", type=float, default=0.0)
    p.add_argument("--multi_blocks", action="store_true")
    p.add_argument("--fleet", action="store_true",
                   help="with --multi_blocks: train every block together, the blocks spread "
                   "over the visible CUDA devices (runtime/fleet_trainer.py)")
    p.add_argument("--num_blocks", type=int, default=3)
    p.add_argument("--min_num_blocks", type=int, default=2)
    p.add_argument("--max_num_blocks", type=int, default=4)
    p.add_argument("--json_dir", type=str, default="",
                   help="directory of objaverse.json and obj_id_names.json "
                   "(default: the copies in dregnerf_tpu_torch/datasets/register)")

    # registration
    p.add_argument("--position_embedding_type", type=str, default="sine")
    p.add_argument("--position_embedding_dim", type=int, default=256)
    p.add_argument("--position_embedding_scaling", type=float, default=1.0)
    p.add_argument("--num_downsample", type=int, default=6)
    p.add_argument("--robust_loss", action="store_true")
    p.add_argument("--icp_refine", action="store_true",
                   help="eval: polish each RegTr pose, and the classical baseline's winner, "
                   "with the colour-aware multi-start ICP (registration/icp.py)")
    p.add_argument("--render_videos", action="store_true",
                   help="registration eval: render fused src/tgt novel-view frames and "
                   "videos (gt/aligned/unaligned orbits)")

    p.add_argument("--ckpt_path", type=str, default="")
    p.add_argument("--no_load_opt", action="store_true")
    p.add_argument("--no_load_scheduler", action="store_true",
                   help="accepted, as in the JAX package, where the schedule's count is "
                   "part of the optimizer state (--no_load_opt)")

    p.add_argument("--enable_tensorboard", action="store_true",
                   help="write scalars to a tensorboardX event file under "
                   "<out_dir>/logs/<expname> (when tensorboardX is installed)")
    p.add_argument("--enable_visdom", action="store_true",
                   help="registration training: start the live pose viewer "
                   "(utils/pose_server.py) on --visdom_port")
    p.add_argument("--visdom_port", type=int, default=8097,
                   help="port of the pose viewer (0: any free port)")
    p.add_argument("--n_tensorboard", type=int, default=30)
    p.add_argument("--n_validation", type=int, default=2500)
    p.add_argument("--n_checkpoint", type=int, default=5000)

    p.add_argument("--field", type=str, default="ngp", choices=["ngp", "vanilla", "dnerf"],
                   help="radiance-field family (models/fields.py)")
    p.add_argument("--out_dir", type=str, default="out")
    p.add_argument("--sample_budget", type=int, default=1 << 18)
    p.add_argument("--max_march_steps", type=int, default=1024)
    p.add_argument("--grid_resolution", type=int, default=128)
    p.add_argument("--init_num_rays", type=int, default=256)
    p.add_argument("--max_num_rays", type=int, default=1 << 16)
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--no_bf16", dest="bf16", action="store_false")
    p.add_argument("--encoder", type=str, default="packed", choices=["packed", "xor_hash"],
                   help="NGP grid encoder: the packed 4 x 8 layout (ops/packed_grid.py) or "
                   "Instant-NGP's xor-hash grid, 16 levels x 2 features of 2^19 rows "
                   "(ops/hash_encoding.py, kernel K6, csrc/hash_grid.cu)")
    p.add_argument("--grad_accum", type=str, default="bf16",
                   choices=["f32", "bf16", "sorted", "sorted_bf16", "pallas"],
                   help="table-gradient accumulator of the packed encoder: f32, sorted and "
                   "pallas sum in f32 (kernel K1, csrc/scatter_add.cu), bf16 and sorted_bf16 "
                   "in bf16 (kernel K1p, csrc/scatter_add_bf16.cu); does not apply to "
                   "--encoder xor_hash (K6 sums in f32)")
    p.add_argument("--rle_backward", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="run-length-compressed table gradient at coarse levels of the "
                   "packed encoder (ops/rle.py); does not apply to --encoder xor_hash")
    p.add_argument("--march_compaction", type=str, default="capped",
                   choices=["compact", "capped", "quota", "rows"])

    # registration training
    p.add_argument("--reg_batch_size", type=int, default=1,
                   help="pairs per registration train step (the gradient of their mean "
                   "loss; the reference trains at batch 1)")
    p.add_argument("--reg_device_cache", type=int, default=32,
                   help="voxel-grid blocks kept on the device for registration training, "
                   "with the augmentation applied there; 0 = the host path (each item "
                   "augmented on the host and uploaded)")
    p.add_argument("--val_fraction", type=float, default=0.2,
                   help="fraction of the val pairs per validation; 1.0 on small held-out "
                   "sets, so that model_best is not a one-pair draw")
    p.add_argument("--visibility", type=str, default="grid", choices=["grid", "exact"],
                   help="overlap labels: 'grid' = voxel-mask lookup, 'exact' = march the "
                   "blocks' NeRF checkpoints every step")
    p.add_argument("--vis_max_cameras", type=int, default=128,
                   help="cameras of a NeRF checkpoint used by exact visibility")
    p.add_argument("--vis_buffer_size", type=int, default=1 << 16,
                   help="packed samples per ray chunk of exact visibility")
    p.add_argument("--vis_cache_size", type=int, default=8,
                   help="NeRF contexts kept on the device for exact visibility")
    p.add_argument("--vis_exact_warped", action="store_true",
                   help="exact mode: also march the warped keypoints (the gradient-free "
                   "nerf-consistency labels) instead of the voxel-mask lookup")
    p.add_argument("--mesh_shape", type=str, default="",
                   help="N (or N,1): data parallelism over the N ranks of a torchrun job, "
                   "which must number N (NCCL on CUDA, gloo with --device cpu): the NGP "
                   "step, the extraction's surface pass, one pair a rank in registration "
                   "training, and the blocks of --fleet; '' or 1: one device")
    p.add_argument("--watchdog_s", type=float, default=1200,
                   help="hang watchdog of training: exit with code 86 when a step's "
                   "heartbeat is this many seconds stale, for a supervisor to restart "
                   "and resume from the latest checkpoint; 0 disables it")
    p.add_argument("--profile_steps", type=str, default="",
                   help="START:COUNT: run training steps START .. START+COUNT-1 under "
                   "torch.profiler, writing a TensorBoard trace and the spans' spans.json "
                   "to <output_dir>/profile (runtime/profiling.py); '' profiles none")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda; 'cpu' to run on the CPU)")
    return p.parse_args(argv)
