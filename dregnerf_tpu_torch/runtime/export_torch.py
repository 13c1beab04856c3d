"""Export checkpoints to the original DReg-NeRF code's torch `model.pth`
layout (port of dregnerf_tpu/runtime/export_torch.py).

That layout is one flat torch dict: the step, the model's tensors, the
occupancy grid and the self-describing render meta (aabb, contraction,
step size, camera poses, ...), so that tools reading those meta fields
work on an exported block. Parameter tensors keep this package's names
and layout (the packed-grid encoder is no tcnn hash table), under 'model'
as flat 'a/b/c' names. The result loads with torch.load's default
weights_only=True: it holds tensors, numbers, strings, lists and dicts.

  python -m dregnerf_tpu_torch.runtime.export_torch CKPT [CKPT ...] [--out PATH]
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from dregnerf_tpu_torch.runtime.checkpoint import load_checkpoint

# meta keys the flat model.pth carries
_REF_META_KEYS = (
    "aabb", "unbounded", "grid_resolution", "contraction_type",
    "near_plane", "far_plane", "render_step_size", "alpha_thre",
    "cone_angle", "camera_poses", "block_id",
)


def export_reference_pth(ckpt_path: str, out_path: Optional[str] = None) -> str:
    """Convert one npz checkpoint (written by either package) to a flat
    `model.pth`; returns the written path (default: model.pth beside it)."""
    flat, meta = load_checkpoint(ckpt_path)
    out: dict = {"step": int(meta.get("step", 0))}

    model = {}
    occupancy = {}
    for name, arr in flat.items():
        t = torch.from_numpy(np.asarray(arr).copy())
        if name.startswith("model::"):
            model[name[len("model::"):].replace("::", "/")] = t
        elif name.startswith("occupancy::"):
            occupancy[name[len("occupancy::"):]] = t
    out["model"] = model
    out["occupancy_grid"] = occupancy

    for k in _REF_META_KEYS:
        if k in meta:
            out[k] = meta[k]
    out["model_config"] = meta.get("model_config", {})
    out["field"] = meta.get("field", "ngp")

    if out_path is None:
        out_path = os.path.join(os.path.dirname(ckpt_path), "model.pth")
    torch.save(out, out_path)
    return out_path


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(
        description="Export npz checkpoints to flat model.pth dicts")
    parser.add_argument("checkpoints", nargs="+")
    parser.add_argument("--out", default=None, help="output path (single checkpoint only)")
    args = parser.parse_args(argv)
    if args.out and len(args.checkpoints) > 1:
        raise SystemExit("--out requires exactly one checkpoint")
    for c in args.checkpoints:
        p = export_reference_pth(c, args.out)
        print(f"wrote {p}")


if __name__ == "__main__":
    main()
