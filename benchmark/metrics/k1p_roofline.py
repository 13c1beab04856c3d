"""K1p's share of its roofline, in %: the least time its bytes need at the
card's HBM bandwidth over the device time of its kernel
(`scatter_add_rows_bf16x8`, dregnerf_tpu_torch/csrc/scatter_add_bf16.cu)."""
from benchmark.harness.counts import HBM_BYTES_PER_S

KERNEL = "scatter_add_rows_bf16x8"


def read(record, trace):
    nbytes = record.get("bytes", {}).get("k1p")
    if trace is None or not nbytes:
        return None
    seconds = trace.kernel_seconds(KERNEL)
    if seconds <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds
