"""The traced window's share of the card's bf16 peak, in %: the FLOPs its
units need (benchmark/harness/counts.py) over its wall seconds."""
from benchmark.harness.counts import PEAK_BF16_FLOPS


def read(record, trace):
    if trace is None or trace.window_s <= 0 or not record.get("flops"):
        return None
    return 100.0 * record["flops"] / trace.window_s / PEAK_BF16_FLOPS
