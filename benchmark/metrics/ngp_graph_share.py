"""Share of the traced units that ran as a replay of the NGP trainer's CUDA
graph, in %: the counter `ngp.graph_replays` of the program's store
(dregnerf_tpu_torch/runtime/profiling.py) over the traced units. The
counters are on only while a torch.profiler records, so with
`--trace 1` the store holds the traced window's units alone. None without
a trace or units, or where the program counts no replay (a program
without the graph)."""


def read(record, trace):
    if trace is None or not record.get("units"):
        return None
    try:
        from dregnerf_tpu_torch.runtime.profiling import snapshot
    except ImportError:
        return None
    replays = snapshot()["counters"].get("ngp.graph_replays")
    if replays is None:
        return None
    return 100.0 * replays / record["units"]
