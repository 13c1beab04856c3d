"""K6 forward's share of its roofline, in %: the least time its bytes need
at the card's HBM bandwidth (benchmark/harness/hash_counts.py) over the
device time of its kernel (`hash_grid_fwd`,
dregnerf_tpu_torch/csrc/hash_grid.cu)."""
from benchmark.harness.counts import HBM_BYTES_PER_S

KERNEL = "hash_grid_fwd"


def read(record, trace):
    nbytes = record.get("bytes", {}).get("k6f")
    if trace is None or not nbytes:
        return None
    seconds = trace.kernel_seconds(KERNEL)
    if seconds <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds
