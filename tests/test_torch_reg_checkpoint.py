"""Registration checkpoints across the packages, and the multi-pair step,
on the CPU: a checkpoint the port writes resumes in JAX's RegTrainer and
one JAX writes resumes in the port, with one step on each side compared;
--reg_batch_size 2 against JAX's vmapped step. Tolerances in
torch_reg_common.py (STEP_*)."""
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from torch_reg_common import few_torch_threads  # noqa: F401 (an autouse fixture)
from torch_reg_common import (R, TINY, _flat, assert_step_agrees, fixed_item, jax_params,
                              jax_trainer, jbatch, pair_root, port_params_tree, port_trainer,
                              restore, snapshot)

@pytest.fixture(scope="module")
def crossed(pair_root, tmp_path_factory):
    """The port trains 2 steps and saves; the JAX RegTrainer loads that file
    with its own templates. Checkpoints are removed once read."""
    out = str(tmp_path_factory.mktemp("cross"))
    port = port_trainer(pair_root, out)
    train_ds = port.train_dataset
    for _ in range(2):
        m = port.train_iteration(train_ds[0])
        assert float(m["skipped_nonfinite"]) == 0.0
    port.iteration = 2
    port.save_checkpoint()
    jtr = jax_trainer(pair_root, out, jax_params(port))
    state, meta = jtr.ckpt_manager.load({"params": jtr.params, "optimizer": jtr.opt_state},
                                        path=os.path.join(port.output_dir, "model", "model.ckpt"))
    jtr.params, jtr.opt_state = state["params"], state["optimizer"]
    shutil.rmtree(os.path.join(port.output_dir, "model"))  # 0.4 GB a file at this width
    yield port, jtr, meta
    shutil.rmtree(out)


def test_port_checkpoint_loads_into_jax(crossed):
    port, jtr, meta = crossed
    assert meta["step"] == 2 and meta["grid_resolution"] == R
    assert meta["d_model"] == TINY["d_model"] and meta["num_downsample"] == TINY["num_downsample"]
    assert meta["aabb"] == port.config.aabb
    adam, sched = jtr.opt_state[1][0], jtr.opt_state[1][2]
    assert int(adam.count) == int(sched.count) == 2
    # bit for bit: parameters, mu and nu through the layout maps
    opt = port.optimizer
    for want, flat in ((jtr.params, opt.flat), (adam.mu, opt.mu), (adam.nu, opt.nu)):
        got = _flat(port._state_tree(flat))
        for k, w in _flat(jax.tree_util.tree_map(np.asarray, want)).items():
            np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert np.abs(_flat(port._state_tree(opt.mu))["infonce_W"]).max() > 0


def test_one_step_after_the_port_checkpoint_agrees(crossed, pair_root):
    port, jtr, _ = crossed
    item = fixed_item(pair_root)
    snap = snapshot(port)
    m = port.train_iteration(item)
    params, opt_state, jm = jtr._step_fn(jtr.params, jtr.opt_state, jbatch(item))
    for k in ("overlap", "nerf_cont", "feature", "corr", "total"):
        assert abs(float(m[k]) - float(jm[k])) <= 1e-5 * max(abs(float(jm[k])), 1e-3), k
    assert float(m["feature_matches"]) == float(jm["feature_matches"])
    assert float(m["skipped_nonfinite"]) == float(jm["skipped_nonfinite"]) == 0.0
    assert_step_agrees(port_params_tree(port), params)
    assert int(opt_state[1][0].count) == int(port.optimizer.count) == 3
    restore(port, snap)


def test_jax_checkpoint_resumes_in_the_port(crossed, pair_root, tmp_path):
    """JAX saves (after one step of its own); a new port trainer resumes
    from the file: step, parameters, mu, nu and counts as written; then one
    step on each side agrees."""
    _, jtr, _ = crossed
    item = fixed_item(pair_root, order=(1, 0))
    jtr.params, jtr.opt_state, _ = jtr._step_fn(jtr.params, jtr.opt_state, jbatch(item))
    jtr.iteration = 3
    jtr.save_checkpoint(-12.5)
    path = os.path.join(jtr.output_dir, "model", "model.ckpt")
    assert os.path.exists(os.path.join(jtr.output_dir, "model", "model_best.ckpt"))
    port = port_trainer(pair_root, str(tmp_path), ["--ckpt_path", path], seed=3)
    port.load_checkpoint()
    assert port.iteration == 3
    assert int(port.optimizer.count) == int(port.optimizer.schedule_count) == 3
    adam = jtr.opt_state[1][0]
    for want, flat in ((jtr.params, port.optimizer.flat), (adam.mu, port.optimizer.mu),
                       (adam.nu, port.optimizer.nu)):
        got = _flat(port._state_tree(flat))
        for k, w in _flat(jax.tree_util.tree_map(np.asarray, want)).items():
            np.testing.assert_array_equal(got[k], w, err_msg=k)
    m = port.train_iteration(item)
    params, _, jm = jtr._step_fn(jtr.params, jtr.opt_state, jbatch(item))
    assert abs(float(m["total"]) - float(jm["total"])) <= 1e-5 * abs(float(jm["total"]))
    assert_step_agrees(port_params_tree(port), params)

    fresh = port_trainer(pair_root, str(tmp_path / "noopt"), ["--ckpt_path", path,
                                                              "--no_load_opt"])
    fresh.load_checkpoint()
    assert fresh.iteration == 3 and int(fresh.optimizer.count) == 0
    assert not fresh.optimizer.mu.any()
    np.testing.assert_array_equal(_flat(port_params_tree(fresh))["infonce_W"],
                                  np.asarray(jtr.params["infonce_W"]))


# ----------------------------------------------------------- batch size > 1

def test_batch_of_two_matches_the_jax_vmapped_step(pair_root, tmp_path):
    """--reg_batch_size 2: mean losses, first pair's pose error and the
    updated parameters against JAX's vmapped step (tolerances as one step
    after a checkpoint); then a pair whose rgb holds NaN: both packages
    skip the step, the port's state bit for bit unchanged."""
    extra = ["--reg_batch_size", "2"]
    port = port_trainer(pair_root, str(tmp_path), extra)
    jtr = jax_trainer(pair_root, str(tmp_path), jax_params(port), extra)
    items = [fixed_item(pair_root, (0, 1)), fixed_item(pair_root, (1, 0))]
    m = port.train_iteration_batch(items)
    jm = jtr.train_iteration_batch(items)
    for k in ("overlap", "nerf_cont", "feature", "corr", "total", "R_error", "t_error"):
        assert abs(float(m[k]) - float(jm[k])) <= 1e-4 * max(abs(float(jm[k])), 1e-2), k
    assert float(m["feature_matches"]) == float(jm["feature_matches"])
    assert float(m["skipped_nonfinite"]) == float(jm["skipped_nonfinite"]) == 0.0
    assert_step_agrees(port_params_tree(port), jtr.params)

    bad = dict(items[0])
    bad["src_grid"] = np.array(bad["src_grid"])
    bad["src_grid"][..., 3:] = np.nan
    before = snapshot(port)
    m_bad = port.train_iteration_batch([bad, items[1]])
    jm_bad = jtr.train_iteration_batch([bad, items[1]])
    assert float(m_bad["skipped_nonfinite"]) == float(jm_bad["skipped_nonfinite"]) == 1.0
    for x, b in zip(snapshot(port), before):
        assert torch.equal(x, b)

