"""Share of the packed encoder's calls that launched K2's forward, in %: the
counter `packed.kernel_calls` over `packed.encode_calls` of the program's
store (dregnerf_tpu_torch/runtime/profiling.py), over the traced window. It
shows that the main path read the vertex table in place through the kernel.
None without a trace or units, off the card (a CPU rehearsal's trace holds
host operations only, and no kernel launches there), or where the program
counts no packed-encoder call (a program without these counters)."""


def read(record, trace):
    if trace is None or not record.get("units"):
        return None
    if all(name.startswith("aten::") for name in trace.kernel_s):
        return None
    try:
        from dregnerf_tpu_torch.runtime.profiling import snapshot
    except ImportError:
        return None
    counters = snapshot()["counters"]
    calls = counters.get("packed.encode_calls")
    if not calls:
        return None
    return 100.0 * counters.get("packed.kernel_calls", 0) / calls
