"""Argparse flags of the port's entry points (copy of the flags of
dregnerf_tpu/runtime/config.py that the NGP trainer, its evaluator and the
registration evaluator read: same names and defaults), plus `--device`.

Every `--grad_accum` value trains, with or without `--rle_backward`. Of
the training marchers only `--march_compaction capped` (the default) is
ported; the others raise NotImplementedError when training starts.
"""
from __future__ import annotations

import argparse


def config_parser(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=3407)
    p.add_argument("--max_iterations", type=int, default=20000)

    p.add_argument("--dataset", type=str, default="", choices=["objaverse"])
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
    p.add_argument("--json_dir", type=str, default="",
                   help="directory of objaverse.json and obj_id_names.json "
                   "(default: the copies in dregnerf_tpu_torch/datasets/register)")

    # registration
    p.add_argument("--position_embedding_type", type=str, default="sine")
    p.add_argument("--position_embedding_dim", type=int, default=256)
    p.add_argument("--position_embedding_scaling", type=float, default=1.0)
    p.add_argument("--num_downsample", type=int, default=6)
    p.add_argument("--icp_refine", action="store_true",
                   help="not ported: raises NotImplementedError (ROADMAP.md queue 1 item 4)")
    p.add_argument("--render_videos", action="store_true",
                   help="not ported: raises NotImplementedError (ROADMAP.md queue 1 item 5)")

    p.add_argument("--ckpt_path", type=str, default="")
    p.add_argument("--no_load_opt", action="store_true")

    p.add_argument("--n_tensorboard", type=int, default=30)
    p.add_argument("--n_validation", type=int, default=2500)
    p.add_argument("--n_checkpoint", type=int, default=5000)

    p.add_argument("--out_dir", type=str, default="out")
    p.add_argument("--sample_budget", type=int, default=1 << 18)
    p.add_argument("--max_march_steps", type=int, default=1024)
    p.add_argument("--grid_resolution", type=int, default=128)
    p.add_argument("--init_num_rays", type=int, default=256)
    p.add_argument("--max_num_rays", type=int, default=1 << 16)
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--no_bf16", dest="bf16", action="store_false")
    p.add_argument("--grad_accum", type=str, default="bf16",
                   choices=["f32", "bf16", "sorted", "sorted_bf16", "pallas"],
                   help="table-gradient accumulator: f32, sorted and pallas sum "
                   "in f32 (kernel K1, csrc/scatter_add.cu), bf16 and sorted_bf16 "
                   "in bf16 (kernel K1p, csrc/scatter_add_bf16.cu)")
    p.add_argument("--rle_backward", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="run-length-compressed table gradient at coarse "
                   "encoder levels (ops/rle.py)")
    p.add_argument("--march_compaction", type=str, default="capped",
                   choices=["compact", "capped", "quota", "rows"])
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda; 'cpu' to run on the CPU)")
    return p.parse_args(argv)
