"""Argparse flags of the NGP trainer (copy of the flags of
dregnerf_tpu/runtime/config.py that the trainer reads: same names and
defaults), plus `--device`.

The port supports `--grad_accum f32|pallas` with `--no-rle_backward`, and
`--march_compaction capped`; the other values keep the reference's names
and defaults and raise NotImplementedError when training starts.
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
                   help="table-gradient accumulator; 'pallas' = kernel K1 "
                   "(csrc/scatter_add.cu), 'f32' = autograd's gather backward")
    p.add_argument("--rle_backward", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="run-length-compressed table gradient (not ported "
                   "yet: pass --no-rle_backward)")
    p.add_argument("--march_compaction", type=str, default="capped",
                   choices=["compact", "capped", "quota", "rows"])
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda; 'cpu' to run on the CPU)")
    return p.parse_args(argv)
