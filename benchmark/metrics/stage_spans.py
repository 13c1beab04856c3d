"""What the per-stage readers share: the device-timeline milliseconds of
the program's stage spans, from its span store
(dregnerf_tpu_torch/runtime/profiling.py). The spans are on only while a
torch.profiler session records, so with `--trace 1` the store holds the
traced window's units and nothing else: set-up and the check run no
profiler."""


def stage_ms(record, trace, stage: str):
    """The device ms a traced unit of the spans named `<part>.<stage>`, or
    None without a trace, units or device times (off the card, or a
    program without the store)."""
    if trace is None or not record.get("units"):
        return None
    try:
        from dregnerf_tpu_torch.runtime.profiling import snapshot
    except ImportError:
        return None
    spans = snapshot()["spans"]
    times = [s["device_ms"] for name, s in spans.items()
             if name.endswith(f".{stage}") and s["device_ms"] is not None]
    if not times:
        return None
    return sum(times) / record["units"]
