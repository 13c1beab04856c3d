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
where Adam's step is not yet lr sign(g)) or neither.

  python3 probes/reg_step_parity.py --decisions [--crops N]

Runs only the phases up to the bf16 trainer, then, on each crop, one f32
forward and the losses card against CPU with every discrete decision of
the step recorded on both devices, in the order the step takes them: the
strided voxel selection, each voxel_downsample level's groups, the
subsample level, the voxel-mask labels of the keypoints and of the warped
keypoints (grid_visibility) and InfoNCE's nearest positives, matches and
ignored pairs. It prints the losses' largest relative gap and each
decision's count of elements that differ, with the first decision that
differs, and for a visibility label that flips, how far the card's and the
CPU's points lie from the nearest cell face (in cells), for a nearest
positive that differs, how close its two candidates lie. Imports nothing of
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


def record_decisions(torch, records: list):
    """Wrap the stage-3 step's discrete decisions so that each call appends
    (name, integer or boolean outputs, continuous inputs) to `records`;
    returns the function that restores them."""
    from dregnerf_tpu_torch.losses import registration as L
    from dregnerf_tpu_torch.models import regtr
    from dregnerf_tpu_torch.ops import voxel_subsample
    from dregnerf_tpu_torch.runtime import reg_trainer

    real = (regtr.masked_select_strided, voxel_subsample.voxel_downsample,
            regtr.hierarchical_subsample, reg_trainer.grid_visibility, L.infonce_loss)

    def select(flat_valid, k):
        idx, valid = real[0](flat_valid, k)
        records.append(("strided selection", torch.cat([idx, valid.long()]), None))
        return idx, valid

    def downsample(points, cell_size):
        out = real[1](points, cell_size)
        records.append((f"voxel_downsample groups (cell {cell_size:g})",
                        out.count.reshape(1).long(), points.xyz / cell_size))
        return out

    def subsample(*args):
        src, tgt, level = real[2](*args)
        records.append(("subsample level and counts",
                        torch.stack([level, src.count.long(), tgt.count.long()]), None))
        return src, tgt, level

    def visibility(points, mask, aabb, resolution, *rest):
        labels = real[3](points, mask, aabb, resolution, *rest)
        u = (points - aabb[:3]) / (aabb[3:] - aabb[:3]) * resolution
        records.append(("grid_visibility labels", labels.long(), u))
        return labels

    def infonce(W, af, pf, axyz, pxyz, av, pv, r_p=0.2, r_n=0.4, return_stats=False):
        d = torch.linalg.vector_norm(axyz[:, None, :] - pxyz[None, :, :], dim=-1)
        d = torch.where(pv[None, :], d, torch.inf)
        idx1 = d.argmin(dim=-1)
        has = (d.gather(1, idx1[:, None])[:, 0] < r_p) & av
        records.append(("InfoNCE nearest positives", idx1, d))
        records.append(("InfoNCE matches", has.long(), None))
        records.append(("InfoNCE pairs within r_n", (d < r_n).long(), None))
        return real[4](W, af, pf, axyz, pxyz, av, pv, r_p=r_p, r_n=r_n,
                       return_stats=return_stats)

    regtr.masked_select_strided, voxel_subsample.voxel_downsample = select, downsample
    regtr.hierarchical_subsample = subsample
    reg_trainer.grid_visibility, L.infonce_loss = visibility, infonce

    def restore():
        (regtr.masked_select_strided, voxel_subsample.voxel_downsample,
         regtr.hierarchical_subsample, reg_trainer.grid_visibility, L.infonce_loss) = real
    return restore


def decisions(torch, trainer, item, centre, devices=("cuda", "cpu")) -> dict:
    """One f32 forward and the losses on a crop, card against CPU, from the
    bf16 trainer's parameters, with the step's discrete decisions recorded
    (record_decisions); prints and returns what differs."""
    import numpy as np

    from dregnerf_tpu_torch.runtime.reg_trainer import (RegTrainer, compute_losses,
                                                        make_reg_model, to_device)

    crop, lo = cs.parity_crop(np, item, centre)
    runs = {}
    for key, dev in zip(("card", "cpu"), devices):
        tr = RegTrainer(trainer.config, [crop], [], output_dir=trainer.output_dir + f"_{key}",
                        model=make_reg_model(trainer.config, torch.float32), device=dev)
        tr.optimizer.flat.copy_(trainer.optimizer.flat)
        records = []
        restore = record_decisions(torch, records)
        try:
            with torch.no_grad():
                total, losses, _ = compute_losses(tr.model, tr.infonce_W,
                                                  to_device(crop, tr.device), tr.aabb,
                                                  tr.grid_resolution, tr.config.robust_loss)
        finally:
            restore()
        runs[key] = ({k: float(v) for k, v in losses.items()} | {"total": float(total)},
                     [(n, out.cpu(), None if x is None else x.detach().float().cpu())
                      for n, out, x in records])
        del tr
    (lg, rg), (lc, rc) = runs["card"], runs["cpu"]
    loss_rel = max(abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-3) for k in cs.LOSS_NAMES)
    cs.check([n for n, _, _ in rg] == [n for n, _, _ in rc], "the decisions' order")
    differ, first = [], None
    for (name, og, xg), (_, oc, xc) in zip(rg, rc):
        n = int((og != oc).sum()) if og.shape == oc.shape else -1
        if n and first is None:
            first = name
        row = (name, n, og.numel())
        if n > 0 and name == "grid_visibility labels":
            flips = og != oc
            face = lambda u: (u - torch.round(u)).abs().min(dim=-1).values  # noqa: E731
            row += (f"card {face(xg[flips]).max().item():.2e} / CPU "
                    f"{face(xc[flips]).max().item():.2e} cells from a face",
                    f"points {((xg - xc)[flips]).abs().max().item():.2e} cells apart")
        if n > 0 and name == "InfoNCE nearest positives":
            rows = torch.nonzero(og != oc)[:, 0]
            pick = [xc[rows, o[rows]] for o in (og, oc)]  # the CPU's distances
            row += (f"the two candidates' distances (CPU) within "
                    f"{((pick[0] - pick[1]).abs() / pick[1]).max().item():.2e} relative",)
        differ.append(row)
    print(f"decisions [f32] crop at {lo.tolist()}: losses card "
          f"{[round(lg[k], 6) for k in cs.LOSS_NAMES]} CPU "
          f"{[round(lc[k], 6) for k in cs.LOSS_NAMES]} (max rel gap {loss_rel:.3e}, tolerance "
          f"{cs.REG_STEP_TOL['losses_rel']}), feature_matches {lg['feature_matches']:.0f} / "
          f"{lc['feature_matches']:.0f}; first decision that differs: {first}; (decision, "
          f"elements that differ, elements) {[r for r in differ if r[1]]} of {len(differ)} "
          f"recorded", flush=True)
    return {"crop": lo.tolist(), "losses_rel": loss_rel, "first": first, "differ": differ}


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--crops", type=int, default=5)
    ap.add_argument("--decisions", action="store_true",
                    help="record the step's discrete decisions card against CPU on each crop")
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
        if args.decisions:
            for c in centres:
                decisions(torch, reg, item, c)
            return 0
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
