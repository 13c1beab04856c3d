#!/usr/bin/env python3
"""Where the f32 registration-step parity of chip_smoke.py's `register
train` phase comes from, on one CUDA card.

  python3 probes/reg_step_parity.py [--crops N]

Runs chip_smoke.py's phases 5, 6 and 9 (a block trained at the CLI
defaults, extracted, and the two-block registration scene built from it),
then a full-width bf16 RegTrainer for 14 steps on the device-cached path,
as the `register train` phase does before its parity step. Then, through
chip_smoke.reg_step_parity, one f32 step card against CPU on N crops of
the pair (the phase's own crop first, then crops around the occupied
voxels at evenly spaced ranks along x) with cuDNN's TF32 off, each from
the trainer's Adam moments (the phase's step) and from zero moments (a
first step); the phase's crop both ways with TF32 on, a configuration the
parity must reject; then chip_smoke's `multi-block` and `marchers`
phases; then the N crops again from the trainer's moments. Each reading
prints the share of parameters within REG_STEP_TOL's params_tight; after
a first step, where the others lie: "flipped" (the card's and the CPU's
gradients differ in sign), "small" (both clipped gradients under 100 eps,
where Adam's step is not yet lr sign(g)) or neither. Imports nothing of
JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

BF16_STEPS = 14  # the register train phase's optimizer count before its parity step


def outside_by_cause(torch, p) -> tuple:
    """(outside, flipped, small, neither, largest |g_cpu| among the outside
    over the largest of all) for a step's readings."""
    from dregnerf_tpu_torch.runtime.reg_optim import EPS, MAX_GRAD_NORM

    (gg, gc), (pg, pc), (ng, nc) = p["grads"], p["params"], p["norms"]
    out = (pg - pc).abs() > cs.REG_STEP_TOL["params_tight"]
    flipped = out & (torch.sign(gg) != torch.sign(gc))
    clipped = torch.maximum(gg.abs() * min(1.0, MAX_GRAD_NORM / ng),
                            gc.abs() * min(1.0, MAX_GRAD_NORM / nc))
    small = out & ~flipped & (clipped < 100 * EPS)
    largest = gc.abs()[out].max().item() / gc.abs().max().item() if out.any() else 0.0
    return (int(out.sum()), int(flipped.sum()), int(small.sum()),
            int((out & ~flipped & ~small).sum()), f"{largest:.3e}")


def readings(torch, trainer, item, centres, moments: bool, label: str) -> list:
    rows = []
    for c in centres:
        try:
            p = cs.reg_step_parity(torch, trainer, item, c, moments)
        except RuntimeError as e:  # a check inside the step failed: a reading too
            rows.append((None if c is None else c.tolist(), str(e)))
            continue
        row = (p["crop"], p["occupied"], round(p["tight"], 6), f"{p['grad_rel']:.3e}",
               f"{p['errors']['grad_norm_rel']:.3e}", f"{p['errors']['params_abs']:.3e}")
        rows.append(row if moments else row + outside_by_cause(torch, p))
        del p
    cause = "" if moments else ", (outside, flipped, small, neither, largest |g|)"
    print(f"{label}: (crop, occupied, share within 1e-6, |dg|/|g|, norm rel err, params max "
          f"abs err{cause}) {rows}", flush=True)
    return rows


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--crops", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("reg_step_parity: no CUDA device available", file=sys.stderr)
        return 1
    from dregnerf_tpu_torch.datasets.register_pairs import NeRFRegDataset
    from dregnerf_tpu_torch.ops import native
    from dregnerf_tpu_torch.runtime.config import config_parser
    from dregnerf_tpu_torch.runtime.reg_trainer import RegTrainer

    cs.check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls must be off")
    print(f"build: {native.build_all():.2f} s", flush=True)
    with tempfile.TemporaryDirectory(prefix="reg_step_parity_") as out_dir:
        trainer, cfg, _ = cs.train_default_phase(torch, out_dir)
        cs.extract_phase(torch, trainer, cfg)
        block_dir = trainer.output_dir
        del trainer
        torch.cuda.empty_cache()
        root, subject = cs.register_phase(torch, block_dir, out_dir)
        torch.cuda.empty_cache()

        flags = ["--root_dir", root, "--scene", subject, "--out_dir", out_dir,
                 "--val_fraction", "1.0", "--expname", "reg_step_parity"]
        reg_cfg = config_parser(flags)
        train_ds = NeRFRegDataset(root, subject_id=subject, split="train", seed=reg_cfg.seed)
        val_ds = NeRFRegDataset(root, subject_id=subject, split="test", seed=reg_cfg.seed)
        reg = RegTrainer(reg_cfg, train_ds, val_ds)
        for _ in range(BF16_STEPS):
            reg.train_iteration(train_ds.get_raw(0))
        torch.cuda.synchronize()
        item = val_ds[0]
        r = item["src_grid"].shape[0]
        occ = np.argwhere(item["src_mask"].reshape(r, r, r))
        ranked = occ[np.argsort(occ[:, 0], kind="stable")]
        centres = [None] + [ranked[(2 * k + 1) * len(ranked) // (2 * (args.crops - 1))]
                            for k in range(args.crops - 1)]
        torch.backends.cudnn.allow_tf32 = False
        before = readings(torch, reg, item, centres, True, "from the trainer's moments")
        readings(torch, reg, item, centres, False, "from zero moments")
        torch.backends.cudnn.allow_tf32 = True
        readings(torch, reg, item, [None], True, "TF32 on, from the trainer's moments")
        readings(torch, reg, item, [None], False, "TF32 on, from zero moments")
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.empty_cache()

        multi = cs.multi_block_phase(torch, out_dir)
        cs.marcher_phase(torch, multi.pop("grid"), out_dir)
        torch.cuda.empty_cache()
        after = readings(torch, reg, item, centres, True, "from the trainer's moments, after "
                         "the multi-block and marchers phases")
        print(f"readings equal before and after those phases, crop by crop: "
              f"{[a[2:] == b[2:] for a, b in zip(before, after)]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
