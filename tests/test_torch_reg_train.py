"""The port's registration trainer against the JAX package, on the CPU:
the losses and their gradients, the optimizer update and its guard, and
the training loop.

Both packages get the same weights (drawn by the port in flax's layout),
the same numpy batches and the same optimizer state, at the JAX tests'
small width (resnet18, d 64, 2 layers, 4 heads, FFN 128, 512 input
voxels, 128 tokens, 3 levels; R = 16). Tolerances are stated per test.
"""
import json
import math
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dregnerf_tpu.models import regtr as jregtr
from dregnerf_tpu.runtime import reg_trainer as JRT
from dregnerf_tpu_torch.models.regtr import NeRFRegTr, params_to_jax
from dregnerf_tpu_torch.runtime import reg_optim
from dregnerf_tpu_torch.runtime import reg_trainer as PRT
from dregnerf_tpu_torch.runtime.checkpoint import load_checkpoint
from torch_reg_common import few_torch_threads  # noqa: F401 (an autouse fixture)
from torch_reg_common import (LOSS_KEYS, R, SMALL, _flat, fixed_item, jax_params, jbatch,
                              pair_root, port_trainer, restore, snapshot)

# ------------------------------------------------------------ compute_losses

# The attention key biases have a zero true gradient (they shift a softmax
# row by a constant), so both packages return rounding noise there: each
# must stay under NOISE times the largest |g| of any leaf (measured: 4e-9
# in f32, 3e-4 in bf16).
ZERO_GRAD = ("key/bias", "k_proj/bias")
NOISE = {"float32": 1e-7, "bfloat16": 1e-3}
# f32: each loss within 1e-5 relative; every other flax leaf's gradient
# within 1e-5 of its max |g| (measured: 2.5e-6); the global norm within
# 1e-5 relative.
# bf16 (bf16 operands on both sides): each loss within 0.02 relative; every
# leaf's gradient at a cosine of at least 0.97 to JAX's (JAX's own bf16
# gradients sit at cosines of 0.99 to its f32 ones, and up to 0.46 of a
# leaf's max away from them: the rounding of every layer's backward); the
# global norm within 2 %.
LOSS_TOL = {"float32": 1e-5, "bfloat16": 0.02}
NORM_TOL = {"float32": 1e-5, "bfloat16": 0.02}
F32_LEAF_TOL, BF16_COSINE = 1e-5, 0.97


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compute_losses_and_gradients_match_jax(pair_root, tmp_path, dtype):
    """Every loss term, feature_matches, the level, and the gradient of
    every flax leaf and of infonce_W, on one pair."""
    port = port_trainer(pair_root, str(tmp_path), shape=SMALL)
    model = NeRFRegTr(dtype=getattr(torch, dtype), **SMALL)
    model.load_state_dict(port.model.state_dict())
    params = jax_params(port)
    jmodel = jregtr.NeRFRegTr(dtype=getattr(jnp, dtype), **SMALL)
    item = fixed_item(pair_root)
    aabb = jnp.asarray(port.config.aabb, jnp.float32)

    def loss_fn(p):
        total, losses, pred = JRT.compute_losses(jmodel, p, jbatch(item), aabb, R, True)
        return total, (losses, pred["ds_level"])

    (want_total, (want_losses, want_level)), want_g = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)

    batch = PRT.to_device(item, torch.device("cpu"))
    total, losses, pred = PRT.compute_losses(model, port.infonce_W, batch, port.aabb, R, True)
    grads = torch.autograd.grad(total, [*model.parameters(), port.infonce_W])
    got_g = {"model": params_to_jax(model, dict(zip(port.param_keys, grads[:-1]))),
             "infonce_W": grads[-1].numpy()}

    assert int(pred["ds_level"]) == int(want_level)
    assert float(losses["feature_matches"]) == float(want_losses["feature_matches"]) > 0
    for k in ("overlap", "nerf_cont", "feature", "corr"):
        w = float(want_losses[k])
        assert abs(float(losses[k]) - w) <= LOSS_TOL[dtype] * max(abs(w), 1e-3), k
    w = float(want_total)
    assert abs(float(total) - w) <= LOSS_TOL[dtype] * abs(w)
    got, want = _flat(got_g), _flat(jax.tree_util.tree_map(np.asarray, want_g))
    assert got.keys() == want.keys() and len(want) == 1 + len(port.param_keys)
    largest = max(np.abs(v).max() for v in want.values())
    noise = rel = 0.0
    cosine = 1.0
    for k, wv in want.items():
        g = got[k].astype(np.float64)
        err = np.abs(g - wv).max() / np.abs(wv).max()
        if k.endswith(ZERO_GRAD):
            noise = max(noise, np.abs(g).max() / largest, np.abs(wv).max() / largest)
            assert noise <= NOISE[dtype], k
            continue
        rel = max(rel, err)
        if dtype == "float32":
            assert err <= F32_LEAF_TOL, k
        else:
            cos = (g * wv).sum() / np.sqrt((g * g).sum() * (wv * wv).sum())
            cosine = min(cosine, cos)
            assert cos >= BF16_COSINE, (k, cos)
    norm = lambda d: math.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in d.values()))
    norm_err = abs(norm(got) - norm(want)) / norm(want)
    print(f"[{dtype}] max leaf error / leaf max {rel:.3e}, min cosine {cosine:.4f}, key-bias "
          f"noise / largest {noise:.3e}, global norm rel err {norm_err:.3e}")
    assert norm_err <= NORM_TOL[dtype]


# ------------------------------------------------------------------ optimizer

def _optax_chain(lr):
    sched = optax.piecewise_constant_schedule(lr, {34000 * (i + 1): 0.5 for i in range(4)})
    return optax.chain(optax.clip_by_global_norm(0.1), optax.adamw(sched, weight_decay=1e-4))


@pytest.mark.parametrize("count,grad_scale", [(0, 1.0), (0, 1e-3), (33999, 1.0),
                                              (136001, 1.0)])
def test_update_matches_optax(count, grad_scale):
    """Two updates from a state at `count` (33999: the rate halves at the
    second, 34000; 136001: past the last halving, lr / 16) with the clip
    binding (grad_scale 1) and not (1e-3): parameters, mu and nu within
    1e-6 relative to their max, both counts exact."""
    rng = np.random.default_rng(count)
    shapes = {"a": (3, 4, 5), "b": (7,), "c": (16, 16)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * grad_scale).astype(np.float32) for k, s in shapes.items()}
             for _ in range(2)]
    mu0 = {k: rng.normal(size=s).astype(np.float32) * 0.01 for k, s in shapes.items()}
    nu0 = {k: rng.uniform(size=s).astype(np.float32) * 1e-4 for k, s in shapes.items()}

    chain = _optax_chain(1e-4)
    state = chain.init(params)
    adam = state[1][0]._replace(count=jnp.int32(count), mu=mu0, nu=nu0)
    state = (state[0], (adam, state[1][1], state[1][2]._replace(count=jnp.int32(count))))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    for g in grads:
        upd, state = chain.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)

    leaves = [torch.tensor(params[k], requires_grad=True) for k in shapes]
    opt = reg_optim.GuardedAdamW(leaves, 1e-4)
    opt.mu.copy_(torch.cat([torch.tensor(mu0[k]).reshape(-1) for k in shapes]))
    opt.nu.copy_(torch.cat([torch.tensor(nu0[k]).reshape(-1) for k in shapes]))
    opt.count.fill_(count)
    opt.schedule_count.fill_(count)
    for g in grads:
        finite = opt.step(opt.flat_grad([torch.tensor(g[k]) for k in shapes]), torch.tensor(1.0))
        assert bool(finite)
    adam, sched = state[1][0], state[1][2]
    assert int(opt.count) == int(adam.count) == count + 2
    assert int(opt.schedule_count) == int(sched.count) == count + 2
    for got, want in ((leaves, jp), (opt.split(opt.mu), adam.mu), (opt.split(opt.nu), adam.nu)):
        for t, k in zip(got, shapes):
            w = np.asarray(want[k])
            np.testing.assert_allclose(t.detach().numpy(), w, rtol=0,
                                       atol=1e-6 * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("count", [0, 33999, 34000, 67999, 68000, 135999, 136000, 10 ** 6])
def test_learning_rate_is_optax_piecewise_constant(count):
    sched = optax.piecewise_constant_schedule(1e-4, {34000 * (i + 1): 0.5 for i in range(4)})
    got = reg_optim.learning_rate(1e-4, torch.tensor(count, dtype=torch.int32))
    assert got.dtype == torch.float32
    assert float(got) == float(np.float32(sched(count)))
    assert float(got) == float(np.float32(1e-4) * 0.5 ** min(4, count // 34000))


def test_clip_norm_is_accurate_on_a_large_buffer():
    """The global norm over 2^24 gradient elements within 1e-6 of the f64
    norm (torch's f32 vector_norm on the CPU is 9.5e-4 off here, printed): one
    step from zero state with the clip binding moves mu by 0.1 g / |g|."""
    g = torch.randn(1 << 24, generator=torch.Generator().manual_seed(0))
    g = g * torch.rand(1 << 24, generator=torch.Generator().manual_seed(1)) ** 4
    leaf = torch.zeros(1 << 24, requires_grad=True)
    opt = reg_optim.GuardedAdamW([leaf], 1e-4)
    assert bool(opt.step(g.clone(), torch.tensor(1.0)))
    norm64 = torch.linalg.vector_norm(g.double())
    want = (1 - reg_optim.B1) * g.double() / norm64 * reg_optim.MAX_GRAD_NORM
    err = ((opt.mu.double() - want).abs().max() / want.abs().max()).item()
    print(f"mu rel err {err:.3e}; torch's f32 vector_norm rel err "
          f"{(torch.linalg.vector_norm(g).double() / norm64 - 1).abs().item():.3e}")
    assert err < 1e-6


def test_bf16_conv3d_weight_gradient_on_an_input_smaller_than_the_kernel():
    """The deepest FPN blocks at R = 16 see 1^3 inputs: on the CPU the
    port's bf16 Conv3d gives the weight gradient of the f32 sum of its bf16
    operands (within 1e-6 relative), where oneDNN's own bf16 kernel returns
    garbage that varies from call to call (printed)."""
    import torch.nn.functional as F

    from dregnerf_tpu_torch.models.layers import Conv3d

    gen = torch.Generator().manual_seed(0)
    conv = Conv3d(64, 32, 3, stride=2, padding=1, bias=False, compute_dtype=torch.bfloat16)
    x = torch.randn(1, 64, 1, 1, 1, generator=gen)
    got, = torch.autograd.grad(conv(x).float().sum(), [conv.weight])
    w = conv.weight.detach().bfloat16().float().requires_grad_(True)
    want, = torch.autograd.grad(F.conv3d(x.bfloat16().float(), w, None, 2, 1).sum(), [w])
    assert ((got - want).abs().max() / want.abs().max()).item() < 1e-6
    onednn = []
    for _ in range(5):
        wb = conv.weight.detach().bfloat16().requires_grad_(True)
        g, = torch.autograd.grad(F.conv3d(x.bfloat16(), wb, None, 2, 1).float().sum(), [wb])
        onednn.append(g.float().abs().max().item())
    print(f"|weight gradient| max: port {got.abs().max().item():.4g}, oneDNN bf16 {onednn}")


@pytest.mark.parametrize("bad", ["nan_grad", "inf_grad", "nan_loss"])
def test_guard_keeps_every_state_bit_for_bit(bad):
    rng = np.random.default_rng(9)
    leaves = [torch.tensor(rng.normal(size=(5, 6)).astype(np.float32), requires_grad=True),
              torch.tensor(rng.normal(size=(9,)).astype(np.float32), requires_grad=True)]
    opt = reg_optim.GuardedAdamW(leaves, 1e-4)
    g = torch.tensor(rng.normal(size=39).astype(np.float32))
    assert bool(opt.step(g, torch.tensor(2.0)))  # a good step first: moments and counts at 1
    before = [x.clone() for x in (opt.flat, opt.mu, opt.nu, opt.count, opt.schedule_count)]
    loss = torch.tensor(float("nan") if bad == "nan_loss" else 1.0)
    if bad != "nan_loss":
        g[3] = float("nan") if bad == "nan_grad" else float("inf")
    assert not bool(opt.step(g, loss))
    for x, b in zip((opt.flat, opt.mu, opt.nu, opt.count, opt.schedule_count), before):
        assert torch.equal(x, b)
    assert int(opt.count) == 1 and torch.equal(leaves[0].detach().reshape(-1), opt.flat[:30])


# ------------------------------------------------------------------- the loop

@pytest.fixture(scope="module")
def trainer(pair_root, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("loop"))
    yield port_trainer(pair_root, out, ["--reg_device_cache", "8"])
    shutil.rmtree(out)  # checkpoints of 0.4 GB a file at this width


def test_six_finite_iterations_with_every_metric(trainer):
    first = None
    for _ in range(6):
        m = trainer.train_iteration(trainer.train_dataset[0])
        total = float(m["total"])
        assert math.isfinite(total) and float(m["skipped_nonfinite"]) == 0.0
        first = total if first is None else first
    for k in (*LOSS_KEYS, "total", "R_error", "t_error", "skipped_nonfinite"):
        assert k in m and m[k].shape == ()
    assert total < first * 1.5  # a noisy single pair; no explosion
    assert int(trainer.optimizer.count) >= 6


def test_device_cached_step_equals_the_host_step(trainer):
    """On an unaugmented pair (test split: identity transforms, no jitter)
    the device-cached path builds the same grids, so the same metrics and
    the same updated parameters, bit for bit."""
    ds = trainer.val_dataset
    ds.rng = np.random.default_rng(0)
    item_h = ds[0]
    ds.rng = np.random.default_rng(0)
    item_d = ds.get_raw(0)
    assert item_d["aug"]["jitter"] is False
    np.testing.assert_array_equal(item_h["pose"], item_d["pose"])
    snap = snapshot(trainer)
    m_h = trainer._step([PRT.to_device(item_h, trainer.device)])
    after_h = trainer.optimizer.flat.clone()
    restore(trainer, snap)
    uploads = trainer._dev_uploads
    m_d = trainer.train_iteration(item_d)
    assert len(trainer._dev_cache) == 2 and trainer._dev_uploads == uploads + 2
    for k in m_h:
        assert torch.equal(m_h[k], m_d[k]), k
    assert torch.equal(after_h, trainer.optimizer.flat)
    trainer.train_iteration(item_d)  # both blocks cached now: no upload
    assert trainer._dev_uploads == uploads + 2


def test_augmented_device_step_trains(trainer):
    item = trainer.train_dataset.get_raw(0)
    assert item["aug"]["jitter"] is True
    m = trainer.train_iteration(item)
    assert math.isfinite(float(m["total"])) and float(m["skipped_nonfinite"]) == 0.0


def test_validate_checkpoint_and_resume(trainer):
    score = trainer.validate(fraction=1.0)
    assert math.isfinite(score) and score <= 0.0
    with open(os.path.join(trainer.output_dir, "log.txt")) as f:
        assert "over 2 pairs" in f.read()  # both block orders of the one val scene
    trainer.iteration = 6
    trainer.save_checkpoint(score)
    model_dir = os.path.join(trainer.output_dir, "model")
    for name in ("model.ckpt", "model_000006.ckpt", "model_best.ckpt", "checkpoints.txt"):
        assert os.path.exists(os.path.join(model_dir, name)), name
    flat, meta = load_checkpoint(os.path.join(model_dir, "model.ckpt"))
    assert meta["step"] == 6 and meta["_score"] == score
    for key in ("params::infonce_W", "optimizer::1/0/count", "optimizer::1/2/count",
                "optimizer::1/0/mu/infonce_W", "optimizer::1/0/nu/model/decoder/q_proj/kernel",
                "params::model/decoder/q_proj/kernel"):
        assert key in flat, key
    assert flat["optimizer::1/0/count"].dtype == np.int32
    before = trainer.optimizer.flat.clone()
    trainer.train_iteration(trainer.train_dataset[0])
    trainer.load_checkpoint()
    assert trainer.iteration == 6 and torch.equal(trainer.optimizer.flat, before)
    trainer.iteration, trainer.config.ckpt_path = 6, ""
    trainer.log_scalars({"total": torch.tensor(1.5)}, 2.0)
    with open(trainer.log_path) as f:
        assert json.loads(f.read().splitlines()[-1]) == {"iter": 6, "total": 1.5, "elapsed": 2.0}


def test_train_deadline_stops_before_the_first_iteration(trainer):
    import time

    it0 = trainer.iteration
    trainer.train_deadline = time.time() - 1.0
    try:
        trainer.train()
    finally:
        trainer.train_deadline = None
    assert trainer.iteration == it0
    assert os.path.exists(os.path.join(trainer.output_dir, "model", "model.ckpt"))


def test_train_runs_its_epochs_with_validation(pair_root, tmp_path):
    """train(): epochs x pairs iterations on the device-cached path, the
    on_validate callback at every validation, checkpoints, log lines."""
    tr = port_trainer(pair_root, str(tmp_path), ["--epochs", "3", "--n_tensorboard", "1",
                                                 "--n_validation", "2", "--n_checkpoint", "2"])
    seen = []
    tr.on_validate = lambda it, score: seen.append((it, score))
    try:
        tr.train()
        assert tr.iteration == 3 and [it for it, _ in seen] == [2]
        assert int(tr.optimizer.count) == 3
        assert len(tr._dev_cache) == 2  # the get_raw path
        with open(tr.log_path) as f:
            assert [json.loads(line)["iter"] for line in f] == [1, 2, 3]
        model_dir = os.path.join(tr.output_dir, "model")
        assert sorted(os.listdir(model_dir)) == ["checkpoints.txt", "model.ckpt",
                                                 "model_000002.ckpt", "model_000003.ckpt",
                                                 "model_best.ckpt"]
        _, meta = load_checkpoint(os.path.join(model_dir, "model.ckpt"))
        assert meta["step"] == 3 and meta["_score"] == seen[0][1]
    finally:
        shutil.rmtree(tr.output_dir)

