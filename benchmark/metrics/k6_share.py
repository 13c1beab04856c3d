"""Share of the hash encoder's calls that launched K6's forward, in %: the
counter `hash.kernel_calls` over `hash.encode_calls` of the program's store
(dregnerf_tpu_torch/runtime/profiling.py), over the traced window. It
shows that the main path went through the kernel. None without a trace or
units, or where the program counts no hash-encoder call."""


def read(record, trace):
    if trace is None or not record.get("units"):
        return None
    try:
        from dregnerf_tpu_torch.runtime.profiling import snapshot
    except ImportError:
        return None
    counters = snapshot()["counters"]
    calls = counters.get("hash.encode_calls")
    if not calls:
        return None
    return 100.0 * counters.get("hash.kernel_calls", 0) / calls
