"""What the drivers share: seeds, norms and the comparisons of readings."""
from __future__ import annotations

import gc
import statistics
import sys
import time

import numpy as np
import torch


def log(msg: str) -> None:
    """A line of progress on standard error, stamped with the host clock."""
    print(f"[{time.perf_counter():.2f}] {msg}", file=sys.stderr, flush=True)


def sub_seed(seed: int, purpose: int) -> int:
    """A 63-bit seed for one use (`purpose`) of the run's seed."""
    state = np.random.SeedSequence([seed % (1 << 63), purpose]).generate_state(2, np.uint64)
    return int(state[0] >> np.uint64(1))


def generator(seed: int, purpose: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, purpose))


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def free(device) -> None:
    """Give back what the program's state held, before the reference runs."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def worst_leaf_gap(program: dict, reference: dict, only=None) -> float:
    """max over leaves of |program norm - reference norm| over the larger
    of the reference's norm of that leaf and of the median leaf."""
    keys = [k for k in reference if only is None or k in only]
    med = statistics.median(reference[k] for k in reference)
    return max(abs(program[k] - reference[k]) / max(reference[k], med, 1e-30) for k in keys)


def moving_leaves(first_grad_norms: dict, share: float = 1e-3) -> set:
    """Leaves whose reference gradient is at least `share` of the median
    leaf's: the others move under Adam by round-off alone."""
    med = statistics.median(first_grad_norms.values())
    return {k for k, v in first_grad_norms.items() if v >= share * med}


def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)
