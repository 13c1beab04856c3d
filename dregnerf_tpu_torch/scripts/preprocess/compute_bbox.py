"""Estimate a scene AABB from a COLMAP sparse model (twin of
scripts/preprocess/compute_bbox.py): the 2-98 % point percentiles scaled
by `--scale` about their centre, written to <sparse_dir>/bbox.txt.

  python -m dregnerf_tpu_torch.scripts.preprocess.compute_bbox --sparse_dir <sparse/0>
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from dregnerf_tpu_torch.utils.colmap import compute_aabb_from_points, read_model


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--sparse_dir", required=True, help="COLMAP sparse/0 dir")
    p.add_argument("--scale", type=float, default=1.4)
    args = p.parse_args(argv)

    model = read_model(args.sparse_dir)
    if model.points is None:
        raise SystemExit("model has no points3D")
    aabb = compute_aabb_from_points(model.points, scale=args.scale)
    out = os.path.join(args.sparse_dir, "bbox.txt")
    np.savetxt(out, aabb[None], fmt="%.6f")
    print(f"aabb {aabb.tolist()} -> {out}")


if __name__ == "__main__":
    main()
