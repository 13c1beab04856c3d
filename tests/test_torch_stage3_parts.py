"""The smaller pieces of the port's stage-3 fleet slice, on the CPU: the
registration optimizer's {step: scale} schedule against optax (the
stage-3 experiment's run-sized halvings, and the default schedule
unchanged), the trainer's schedule swap, the compute_bbox twin against
the JAX script, and chip_smoke.py's tie-aware judgement of the coarse
race (ROADMAP queue 3 item 1) on a constructed cloud. A few seconds
alone."""
import importlib.util
import runpy
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dregnerf_tpu.utils import colmap as JC
from dregnerf_tpu_torch.runtime import reg_optim
from dregnerf_tpu_torch.runtime.reg_trainer import RegTrainer
from dregnerf_tpu_torch.scripts.preprocess import compute_bbox

ROOT = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ------------------------------------------------------------------ schedule

RUNS = [2000, 12000, 3, 1]


def _counts(schedule):
    """Counts around every boundary of a schedule, and far past them."""
    return sorted({max(c, 0) for b in schedule for c in (b - 1, b, b + 1)} | {0, 10 ** 6})


@pytest.mark.parametrize("iters", RUNS)
def test_run_sized_schedule_is_optax_piecewise_constant(iters):
    schedule = reg_optim.run_sized_schedule(iters)
    want = optax.piecewise_constant_schedule(
        1e-4, {int(iters * 0.5): 0.5, int(iters * 0.75): 0.5})
    assert schedule == {int(iters * 0.5): 0.5, int(iters * 0.75): 0.5}
    for count in _counts(schedule):
        got = reg_optim.learning_rate(1e-4, torch.tensor(count, dtype=torch.int32), schedule)
        assert got.dtype == torch.float32
        assert float(got) == float(np.float32(want(count))), count


@pytest.mark.parametrize("schedule", [{30: 1.84, 10: 2.2, 20: 1.65},
                                      {30: 2.58, 10: 0.15, 20: 2.2}])
def test_schedule_scales_in_ascending_boundary_order_as_optax(schedule):
    """Scales other than 0.5 on a dict not in ascending order: the f32
    rounding follows optax's sorted boundaries, not the dict's order."""
    want = optax.piecewise_constant_schedule(1e-4, schedule)
    for count in _counts(schedule):
        got = reg_optim.learning_rate(1e-4, torch.tensor(count, dtype=torch.int32), schedule)
        assert float(got) == float(np.float32(want(count))), count


def test_default_schedule_is_unchanged():
    assert reg_optim.LR_SCHEDULE == {34000 * (i + 1): 0.5 for i in range(4)}
    for count in _counts(reg_optim.LR_SCHEDULE):
        c = torch.tensor(count, dtype=torch.int32)
        got = reg_optim.learning_rate(1e-4, c)
        assert torch.equal(got, reg_optim.learning_rate(1e-4, c, reg_optim.LR_SCHEDULE))
        assert float(got) == float(np.float32(1e-4) * 0.5 ** min(4, count // 34000))


@pytest.mark.parametrize("count", [999, 1499])
def test_guarded_adamw_step_under_the_run_sized_schedule_matches_optax(count):
    """Two updates from a state at `count` across a boundary of the
    2000-step run's schedule, against JAX's experiment's exact chain:
    parameters, mu and nu within 1e-6 of their max, the counts exact."""
    iters = 2000
    rng = np.random.default_rng(count)
    shapes = {"a": (3, 4, 5), "b": (7,), "c": (16, 16)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) * 0.01 for k, s in shapes.items()}
             for _ in range(2)]
    mu0 = {k: rng.normal(size=s).astype(np.float32) * 0.01 for k, s in shapes.items()}
    nu0 = {k: rng.uniform(size=s).astype(np.float32) * 1e-4 for k, s in shapes.items()}

    sched = optax.piecewise_constant_schedule(
        1e-4, {int(iters * 0.5): 0.5, int(iters * 0.75): 0.5})
    chain = optax.chain(optax.clip_by_global_norm(0.1), optax.adamw(sched, weight_decay=1e-4))
    state = chain.init(params)
    adam = state[1][0]._replace(count=jnp.int32(count), mu=mu0, nu=nu0)
    state = (state[0], (adam, state[1][1], state[1][2]._replace(count=jnp.int32(count))))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    for g in grads:
        upd, state = chain.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)

    leaves = [torch.tensor(params[k], requires_grad=True) for k in shapes]
    opt = reg_optim.GuardedAdamW(leaves, 1e-4, reg_optim.run_sized_schedule(iters))
    opt.mu.copy_(torch.cat([torch.tensor(mu0[k]).reshape(-1) for k in shapes]))
    opt.nu.copy_(torch.cat([torch.tensor(nu0[k]).reshape(-1) for k in shapes]))
    opt.count.fill_(count)
    opt.schedule_count.fill_(count)
    for g in grads:
        assert bool(opt.step(opt.flat_grad([torch.tensor(g[k]) for k in shapes]),
                             torch.tensor(1.0)))
    adam, sch = state[1][0], state[1][2]
    assert int(opt.count) == int(adam.count) == int(opt.schedule_count) == int(sch.count)
    for got, want in ((leaves, jp), (opt.split(opt.mu), adam.mu), (opt.split(opt.nu), adam.nu)):
        for t, k in zip(got, shapes):
            w = np.asarray(want[k])
            np.testing.assert_allclose(t.detach().numpy(), w, rtol=0,
                                       atol=1e-6 * np.abs(w).max(), err_msg=k)


def test_set_lr_schedule_installs_a_fresh_optimizer_over_the_parameters():
    leaves = [torch.randn(3, 4, requires_grad=True), torch.randn(5, requires_grad=True)]
    trainer = RegTrainer.__new__(RegTrainer)
    trainer.config = SimpleNamespace(lr=1e-4)
    trainer.optimizer = reg_optim.GuardedAdamW(leaves, 1e-4)
    trainer.optimizer.step(torch.ones(17), torch.tensor(1.0))
    before = [t.detach().clone() for t in leaves]
    trainer.set_lr_schedule(reg_optim.run_sized_schedule(10))
    opt = trainer.optimizer
    assert opt.schedule == {5: 0.5, 7: 0.5} and opt.leaves == leaves
    assert int(opt.count) == int(opt.schedule_count) == 0
    assert not opt.mu.any() and not opt.nu.any()
    for t, b, view in zip(leaves, before, opt.split(opt.flat)):
        assert torch.equal(t, b) and t.data_ptr() == view.data_ptr()


# --------------------------------------------------------------- compute_bbox

@pytest.mark.parametrize("scale", [None, 1.1])
def test_compute_bbox_twin_writes_the_jax_scripts_file(tmp_path, monkeypatch, scale):
    rng = np.random.default_rng(11)
    model = JC.SparseModel({1: JC.Camera("PINHOLE", 32, 24, np.array([100.0, 101.0, 16, 12]))},
                           {1: JC.Image(np.array([1.0, 0, 0, 0]), np.zeros(3), 1, "a.png")},
                           rng.normal(size=(300, 3)) * [1.0, 2.0, 0.5] + [0.3, -0.2, 1.0],
                           rng.integers(0, 255, (300, 3)).astype(np.uint8))
    args = [] if scale is None else ["--scale", str(scale)]
    out = {}
    for name in ("jax", "port"):
        sparse = tmp_path / name
        JC.write_model(str(sparse), model, binary=True)
        argv = ["--sparse_dir", str(sparse)] + args
        if name == "jax":
            monkeypatch.setattr(sys, "argv", ["compute_bbox.py"] + argv)
            runpy.run_path(str(ROOT / "scripts" / "preprocess" / "compute_bbox.py"),
                           run_name="__main__")
        else:
            compute_bbox.main(argv)
        out[name] = (sparse / "bbox.txt").read_bytes()
    assert out["port"] == out["jax"] and len(out["jax"].split()) == 6


# ------------------------------------------- the coarse race's near-tie check

def _race_inputs(tie_gap: float):
    """Six source points, each with a target of its own 0.01 away, and a
    seventh target: source point 0 has two candidates 0.3 apart, at joint
    squared distances 0.0225 and 0.0225 (1 + tie_gap) (colours zero)."""
    src = np.array([[0.0, 0, 0], [0.5, 0, 0], [0, 0.5, 0], [0, 0, 0.5], [0.4, 0.4, 0],
                    [0, 0.3, 0.4]], np.float32)
    tgt = src + np.array([0.01, 0, 0], np.float32)
    tgt[0] = [0.15, 0, 0]
    far = np.sqrt(0.0225 * (1 + tie_gap))
    tgt = np.vstack([tgt, [[0.0, -far, 0.0]]]).astype(np.float32)
    t = torch.as_tensor
    return [t(src), t(tgt), torch.zeros(6, 3), torch.zeros(7, 3),
            torch.ones(6, dtype=torch.bool), torch.ones(7, dtype=torch.bool),
            torch.eye(3, 4)[None], 1.0, 1.0]


def test_race_replay_accepts_a_near_tie_and_rejects_a_disagreement_without_one():
    cs = _chip_smoke()
    args = _race_inputs(1e-7)  # point 0 equidistant from targets 0 and 6 to within 1e-7
    pose = args[6]
    cpu = cs.race_step(torch, args, pose, 0, 20)
    assert int(cpu[1][0, 0]) == 0

    # a device that takes the other side of the tie: target 6 a hair closer
    other = list(args)
    other[1] = args[1].clone()
    other[1][6, 1] += 3e-7
    card = cs.race_step(torch, other, pose, 0, 20)
    assert int(card[1][0, 0]) == 6 and torch.equal(card[1][0, 1:], cpu[1][0, 1:])
    rot, trans = cs.pose_gap(np, card[0][0], cpu[0][0])
    assert trans > cs.CLASSICAL_PARITY_TOL["translation"]  # the poses alone would fail
    (ok, how, gap), = cs.judge_iteration(np, args, pose, card, cpu, [0])
    assert ok and how == "tie" and gap <= cs.TIE_REL_GAP

    # a disagreement with no tie: source point 1 moved to another target
    moved = list(args)
    moved[1] = args[1].clone()
    moved[1][1] = torch.tensor([0.4, 0.38, 0.0])
    card = cs.race_step(torch, moved, pose, 0, 20)
    assert int(card[1][0, 1]) != int(cpu[1][0, 1])
    (ok, how, gap), = cs.judge_iteration(np, args, pose, card, cpu, [0])
    assert not ok and gap > cs.TIE_REL_GAP

    # the same choices on both sides pass on the poses
    (ok, how, gap), = cs.judge_iteration(np, args, pose, cpu, cpu, [0])
    assert ok and how == "poses" and gap == 0.0


def test_race_step_is_one_iteration_of_icp_core():
    """race_step from the seed, iterated with its annealed gates, lands on
    icp_core's pose of the whole run."""
    from dregnerf_tpu_torch.registration.icp import icp_core

    cs = _chip_smoke()
    rng = np.random.default_rng(3)
    src = torch.as_tensor(rng.normal(size=(200, 3)).astype(np.float32))
    rot = torch.as_tensor(np.array([[0.99, -0.141, 0], [0.141, 0.99, 0], [0, 0, 1]],
                                   np.float32))
    tgt = src @ rot.T + 0.05
    cols = torch.as_tensor(rng.uniform(size=(200, 3)).astype(np.float32)) * 0.5
    valid = torch.ones(200, dtype=torch.bool)
    seeds = torch.eye(3, 4).expand(2, 3, 4).clone()
    seeds[1, :, 3] = 0.1
    args = [src, tgt, cols, cols, valid, valid, seeds, 0.4, 0.04]
    want, _, _ = icp_core(*args[:7], 0.4, 0.04, iters=6)
    pose = seeds
    for it in range(6):
        pose, _ = cs.race_step(torch, args, pose, it, 6)
    assert torch.equal(pose, want)
