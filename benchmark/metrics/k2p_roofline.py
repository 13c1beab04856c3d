"""K2p's share of its roofline, in %: the least time its bytes need at the
card's HBM bandwidth over the device time of its kernel
(`gather_rows_f32x4`, dregnerf_tpu_torch/csrc/gather_rows.cu)."""
from benchmark.harness.counts import HBM_BYTES_PER_S

KERNEL = "gather_rows_f32x4"


def read(record, trace):
    nbytes = record.get("bytes", {}).get("k2p")
    if trace is None or not nbytes:
        return None
    seconds = trace.kernel_seconds(KERNEL)
    if seconds <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds
