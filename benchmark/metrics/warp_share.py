"""Share of the points through the D-NeRF field's canonical trunk that
were warped first, in %: the counter `mlp.warp_rows` over `mlp.rows` of the
program's store (dregnerf_tpu_torch/runtime/profiling.py), over the traced
window. Every training sample is warped at its ray's time and the
occupancy updates' points are not (they query the canonical field at no
time), so at 2^18 samples a step and 2^18 points an update every 16 steps
it reads 16/17, about 94 %. None without a trace or units, or where the
program counts no trunk row (a program without the counters)."""


def read(record, trace):
    if trace is None or not record.get("units"):
        return None
    try:
        from dregnerf_tpu_torch.runtime.profiling import snapshot
    except ImportError:
        return None
    counters = snapshot()["counters"]
    rows = counters.get("mlp.rows")
    if not rows:
        return None
    return 100.0 * counters.get("mlp.warp_rows", 0) / rows
