"""The benchmark of the PyTorch and CUDA port (dregnerf_tpu_torch).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout, on a machine with the cards the cell
asks for (BENCHMARK.json); see benchmark/README.md.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# one process, few threads: the program's host work is a single Python thread
# launching kernels, and idle worker threads only compete with it
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root, where the benchmark and the program are packages
sys.path[0] = ROOT

if __name__ == "__main__":
    from benchmark.harness.cli import run

    sys.exit(run(sys.argv[1:], T0, ROOT))
