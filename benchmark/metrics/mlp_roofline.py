"""The MLP products' share of their roofline, in %: the FLOPs the traced
steps' MLPs need (`mlp_flops` of the driver's record,
benchmark/harness/mlp_counts.py) at the card's bf16 peak, which the
configuration's bf16 operands allow, over the device seconds of every
operation whose name holds `gemm` (the matrix products of cuBLAS and
CUTLASS that run the dense layers today). A change that computes the
products in kernels of other names needs a `benchmark` change to point
this reader at them."""
from benchmark.harness.counts import PEAK_BF16_FLOPS

KERNEL = "gemm"


def read(record, trace):
    flops = record.get("mlp_flops")
    if trace is None or not flops:
        return None
    seconds = trace.kernel_seconds(KERNEL)
    if seconds <= 0:
        return None
    return 100.0 * flops / PEAK_BF16_FLOPS / seconds
