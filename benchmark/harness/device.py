"""The card a run measures on, and what it may not have loaded."""
from __future__ import annotations

import subprocess
import sys

# JAX and the JAX package may not be in the measuring process; whole
# top-level names (the port's own name begins with the JAX package's)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "dregnerf_tpu")


def forbidden_loaded() -> list[str]:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(m for m in FORBIDDEN_MODULES if m in tops)


def require_cards(chips: int) -> str | None:
    """None when CUDA has `chips` cards, else why not."""
    import torch

    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is False"
    if torch.cuda.device_count() < chips:
        return f"{torch.cuda.device_count()} CUDA devices, the cell needs {chips}"
    return None


def power_limit_w() -> float | None:
    """The card's power limit from nvidia-smi (None where it cannot say)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=20, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def device_info(device, chips: int, peak_bytes: int) -> dict:
    import torch

    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": chips, "memory_peak_bytes": int(peak_bytes),
                "power_limit_w": power_limit_w()}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": int(peak_bytes)}
