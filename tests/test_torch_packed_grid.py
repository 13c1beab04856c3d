"""Port parity: the packed-grid encoder (forward, and the table gradient
under grad_accum "pallas" through K1's plain version on the CPU) against
the JAX package, plus the config meta round trip."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dregnerf_tpu.models import ngp as jngp
from dregnerf_tpu.ops import packed_grid as JPG
from dregnerf_tpu_torch.models import ngp as tngp
from dregnerf_tpu_torch.ops import packed_grid as TPG

CONFIGS = {
    # two dense levels (tests/test_ray_march.py's bf16/pallas accumulator size)
    "dense": dict(n_levels=2, log2_table_size=10, base_resolution=4, per_level_scale=2.0),
    # a dense level then two levels wrapped into 2^10 rows
    "wrapped": dict(n_levels=3, log2_table_size=10, base_resolution=4, per_level_scale=4.0),
}


def _inputs(cfg_kw, seed=0):
    rng = np.random.default_rng(seed)
    cfg = JPG.PackedGridConfig(**cfg_kw)
    table = rng.uniform(-0.1, 0.1, (cfg.total_rows, cfg.n_features)).astype(np.float32)
    x = rng.uniform(-0.05, 1.05, (512, 3)).astype(np.float32)  # some outside [0, 1]
    return table, x


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_encode_forward_matches_jax(name):
    kw = CONFIGS[name]
    table, x = _inputs(kw)
    jcfg, tcfg = JPG.PackedGridConfig(**kw), TPG.PackedGridConfig(**kw)
    want = JPG.packed_encode(JPG.pack_table(jnp.asarray(table), jcfg), jnp.asarray(x), jcfg)
    got = TPG.packed_encode(TPG.pack_table(torch.as_tensor(table), tcfg),
                            torch.as_tensor(x), tcfg)
    assert got.shape == (512, tcfg.out_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("accum", ["pallas", "f32"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_table_gradient_matches_jax(name, accum):
    """dV of sum(encode^2), the port against jax.grad with the same
    accumulator (pallas: K1 against the Pallas kernel in interpret mode)."""
    kw = dict(CONFIGS[name], grad_accum=accum)
    table, x = _inputs(kw, seed=1)
    jcfg, tcfg = JPG.PackedGridConfig(**kw), TPG.PackedGridConfig(**kw)

    def jloss(v):
        return jnp.sum(JPG.packed_encode(JPG.pack_table(v, jcfg), jnp.asarray(x), jcfg) ** 2)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(table)))
    v = torch.as_tensor(table).requires_grad_(True)
    (TPG.packed_encode(TPG.pack_table(v, tcfg), torch.as_tensor(x), tcfg) ** 2).sum().backward()
    assert v.grad.dtype == torch.float32
    np.testing.assert_allclose(v.grad.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_config_meta_round_trips_between_packages():
    tcfg = tngp.NGPConfig(grid=TPG.PackedGridConfig(grad_accum="pallas"),
                          compute_dtype=torch.float32)
    meta = json.loads(json.dumps(tngp.config_to_meta(tcfg)))
    assert tngp.config_from_meta(meta) == tcfg
    jcfg = jngp.config_from_meta(meta)  # the JAX package accepts the port's meta
    assert dataclasses.asdict(jcfg.grid) == dataclasses.asdict(tcfg.grid)
    assert jcfg.compute_dtype == jnp.float32
    assert json.loads(json.dumps(jngp.config_to_meta(jcfg))) == meta
    # and the reverse: a JAX default config (bf16 accumulator, RLE step)
    jdef = jngp.NGPConfig(grid=JPG.PackedGridConfig(grad_accum="bf16", rle_step_u=0.003))
    back = tngp.config_from_meta(json.loads(json.dumps(jngp.config_to_meta(jdef))))
    assert dataclasses.asdict(back.grid) == dataclasses.asdict(jdef.grid)
    assert back.compute_dtype == torch.bfloat16


@pytest.mark.parametrize("kw", [dict(grad_accum="bf16"), dict(grad_accum="sorted"),
                                dict(grad_accum="sorted_bf16"),
                                dict(grad_accum="pallas", rle_step_u=0.003)])
def test_unported_backwards_raise_but_forward_works(kw):
    cfg = TPG.PackedGridConfig(**dict(CONFIGS["dense"], **kw))
    table, x = _inputs(CONFIGS["dense"])
    v = torch.as_tensor(table)
    with torch.no_grad():  # inference of a JAX-trained block needs no backward
        TPG.packed_encode(TPG.pack_table(v, cfg), torch.as_tensor(x), cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TPG.packed_encode(TPG.pack_table(v.requires_grad_(True), cfg),
                          torch.as_tensor(x), cfg)
