"""Kernel K1p (ops/scatter_add.py::scatter_add_bf16): the plain version
against the Pallas kernel of scripts/perf/probe_pallas_scatter.py in
interpret mode and against JAX's bf16 scatter, bit for bit; the CPU
dispatch, the row count and the input checks. The kernel itself is tested in
test_torch_kernels_cuda.py."""
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dregnerf_tpu_torch.ops import rle as trle
from dregnerf_tpu_torch.ops.scatter_add import scatter_add_bf16, scatter_add_bf16_plain

PROBE = Path(__file__).resolve().parent.parent / "scripts/perf/probe_pallas_scatter.py"
# process-wide settings that the probe sets when it is loaded
CACHE_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")


def _cache_settings():
    return {key: getattr(jax.config, key) for key in CACHE_KEYS}


def _load_probe():
    """The probe module, loaded by path. Loading it points JAX's persistent
    compilation cache at a fixed directory for the whole process; the
    settings are put back before anything compiles, so no later test
    writes a cache."""
    saved = _cache_settings()
    spec = importlib.util.spec_from_file_location("probe_pallas_scatter", PROBE)
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        for key, value in saved.items():
            jax.config.update(key, value)
    return module


@pytest.fixture(scope="module")
def probe():
    return _load_probe()


def test_loading_the_probe_keeps_jax_cache_settings():
    before = _cache_settings()
    _load_probe()
    assert _cache_settings() == before


def _case(kind, n=1024, table_rows=2048, width=32, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "random":
        idx = rng.integers(0, table_rows, n)
    elif kind.startswith("runs"):  # runs of equal slots, as marched samples give
        run = int(kind[4:])
        idx = np.repeat(rng.integers(0, 64, n // run + 1), run)[:n]
    else:  # out of range: negative and past the end, skipped
        idx = rng.integers(-200, table_rows + 200, n)
    src = (3.0 * rng.normal(size=(n, width))).astype(np.float32)
    return idx.astype(np.int32), src


@pytest.mark.parametrize("kind", ["random", "runs37", "runs7"])
def test_plain_matches_pallas_probe_bitwise(probe, kind):
    idx, src = _case(kind)
    want = probe.pallas_scatter_add(jnp.asarray(idx), jnp.asarray(src), table_rows=2048,
                                    shard_rows=512, chunk=256, interpret=True)
    got = scatter_add_bf16_plain(torch.as_tensor(idx), torch.as_tensor(src), 2048)
    assert got.dtype == torch.bfloat16 and got.shape == (2048, 32)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("kind", ["random", "runs37", "runs7", "out_of_range"])
def test_plain_matches_jax_bf16_scatter_bitwise(probe, kind):
    """The port skips rows whose slot is out of range (negative or past the
    end): the same as JAX's scatter of the other rows, in their order."""
    idx, src = _case(kind, seed=1)
    keep = (idx >= 0) & (idx < 2048)
    assert keep.all() == (kind != "out_of_range")
    want = probe.xla_scatter_add(jnp.asarray(idx[keep]), jnp.asarray(src[keep]), 2048)
    got = scatter_add_bf16_plain(torch.as_tensor(idx), torch.as_tensor(src), 2048)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_bf16_index_add_is_not_the_function():
    """torch's bf16 index_add_ sums in f32 and rounds once: a different
    function from the serial bf16 scatter, which is why the plain version
    does not use it."""
    idx, src = _case("runs37", seed=2, width=64)
    serial = scatter_add_bf16_plain(torch.as_tensor(idx), torch.as_tensor(src), 2048)
    once = torch.zeros(2048, 64, dtype=torch.bfloat16).index_add_(
        0, torch.as_tensor(idx).long(), torch.as_tensor(src).bfloat16())
    assert not torch.equal(serial, once)


def test_cpu_wrapper_takes_plain_version_and_counts_no_launch():
    idx, src = _case("random", seed=3)
    before = scatter_add_bf16.launches
    out = scatter_add_bf16(torch.as_tensor(idx), torch.as_tensor(src), 2048)
    assert scatter_add_bf16.launches == before
    assert torch.equal(out, scatter_add_bf16_plain(torch.as_tensor(idx),
                                                   torch.as_tensor(src), 2048))


@pytest.mark.parametrize("idx,src,rows,err", [
    (torch.zeros(4, dtype=torch.int64), torch.zeros(4, 8), 8, TypeError),
    (torch.zeros(4, dtype=torch.int32), torch.zeros(4, 8, dtype=torch.bfloat16), 8, TypeError),
    (torch.zeros(4, dtype=torch.int32), torch.zeros(5, 8), 8, ValueError),
    (torch.zeros(4, dtype=torch.int32), torch.zeros(4, 5), 8, ValueError),
    (torch.zeros(4, dtype=torch.int32), torch.zeros(4, 6), 8, ValueError),  # width % 8
    (torch.zeros(4, dtype=torch.int32), torch.zeros(8, 4).t(), 8, ValueError),
    (torch.zeros(4, dtype=torch.int32), torch.zeros(4, 8), 0, ValueError),
])
def test_wrapper_rejects_bad_inputs(idx, src, rows, err):
    with pytest.raises(err):
        scatter_add_bf16(idx, src, rows)


@pytest.mark.parametrize("take_alt", [False, True])
def test_cpu_wrapper_scatters_the_rows_its_flag_picks(take_alt):
    """With `alt`, the serial bf16 scatter of the rows the flag picks, bit
    for bit; out-of-range slots (the run-length padding) are skipped."""
    idx, src = _case("out_of_range", n=64, seed=4)
    alt_idx, alt_src = _case("runs7", seed=5)
    idx, src, alt_idx, alt_src = map(torch.as_tensor, (idx, src, alt_idx, alt_src))
    out = scatter_add_bf16(idx, src, 2048, alt=(torch.tensor([take_alt]), alt_idx, alt_src))
    want = scatter_add_bf16_plain(*((alt_idx, alt_src) if take_alt else (idx, src)), 2048)
    assert torch.equal(out, want)


@pytest.mark.parametrize("take_alt", [None, False, True])
@pytest.mark.parametrize("count", [0, 300, 1024, 5000, -3])
def test_cpu_wrapper_with_a_row_count_scatters_the_first_rows(probe, count, take_alt):
    """With `count`, JAX's bf16 scatter of the first `count` rows (clamped
    to [0, N]) bit for bit; the count bounds (idx, src), not the
    alternative rows that the flag picks."""
    idx, src = _case("runs7", seed=6)
    alt_idx, alt_src = _case("random", n=200, seed=7)
    alt = None if take_alt is None else (torch.tensor([take_alt]), torch.as_tensor(alt_idx),
                                         torch.as_tensor(alt_src))
    out = scatter_add_bf16(torch.as_tensor(idx), torch.as_tensor(src), 2048, alt=alt,
                           count=torch.tensor(count))
    n = min(max(count, 0), len(idx))
    rows = (alt_idx, alt_src) if take_alt else (idx[:n], src[:n])
    want = probe.xla_scatter_add(jnp.asarray(rows[0]), jnp.asarray(rows[1]), 2048)
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("count,err", [
    (torch.tensor(3, dtype=torch.int32), TypeError),
    (torch.tensor([3, 4]), TypeError),
    (torch.tensor(3, device="meta"), ValueError),
])
def test_wrapper_rejects_a_bad_row_count(count, err):
    with pytest.raises(err):
        scatter_add_bf16(torch.zeros(4, dtype=torch.int32), torch.zeros(4, 8), 8, count=count)


@pytest.mark.parametrize("case", ["fits", "overflow"])
def test_rle_safe_bf16_equals_its_run_sums_scattered_serially(case):
    """`rle_scatter_add_safe(accum="bf16")`, which hands K1p its run count:
    the serial bf16 scatter of its f32 run sums when they fit, else of the
    direct rows, bit for bit."""
    rng = np.random.default_rng(8)
    idx = torch.as_tensor(np.repeat(rng.integers(0, 64, 400), rng.integers(1, 9, 400))[:1024]
                          .astype(np.int32))
    vals = torch.as_tensor(rng.normal(size=(1024, 16)).astype(np.float32))
    n_runs = 1 + int((idx[1:] != idx[:-1]).sum())
    max_runs = n_runs + 7 if case == "fits" else n_runs // 2
    got = trle.rle_scatter_add_safe(idx, vals, max_runs, 64, "bf16")
    if case == "fits":
        run_idx, run_sum, _ = trle.run_length_segment_sum(idx, vals, max_runs)
        want = scatter_add_bf16_plain(run_idx[:n_runs], run_sum[:n_runs], 64)
    else:
        want = scatter_add_bf16_plain(idx, vals, 64)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def _serial_bf16_sum(rows):
    """The serial bf16 scatter of rows [k, n] into one slot, per column."""
    return scatter_add_bf16_plain(torch.zeros(rows.shape[0], dtype=torch.int32),
                                  rows.contiguous(), 1)[0].float()


def test_slot_bound_holds_for_every_order_of_the_adds():
    """The per-slot tolerance that holds K1p to its plain version on the
    card, 2 ((1 + 2^-8)^(k-1) - 1) sum|src|: the kernel adds a slot's k
    rows in another order than the serial scatter, and every order of the
    k - 1 rounded bf16 adds ends within it of every other. The tighter
    2^-8 k sum|src| does not hold: three bf16 values whose serial sums in
    two orders differ by more."""
    import itertools

    rng = np.random.default_rng(9)
    for k in (1, 2, 3, 4, 5):
        rows = torch.as_tensor(rng.normal(size=(k, 20000)).astype(np.float32))
        sums = torch.stack([_serial_bf16_sum(rows[list(p)])
                            for p in itertools.permutations(range(k))])
        spread = (sums.max(0).values - sums.min(0).values)
        abs_sum = rows.bfloat16().float().abs().sum(0)
        assert bool((spread <= 2.0 * math.expm1((k - 1) * math.log1p(2.0**-8)) * abs_sum).all())
    rows = torch.tensor([[0.15234375], [0.9921875], [0.01953125]])  # bf16 values
    spread = abs(float(_serial_bf16_sum(rows) - _serial_bf16_sum(rows.flip(0))))
    assert spread == 2.0**-6 > 2.0**-8 * 3 * float(rows.abs().sum())
