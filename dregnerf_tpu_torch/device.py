"""Device policy of the port.

Entry points (`NGPTrainer`, `render_rays`, the CLI) and the public
constructors (`init_ngp`, `params_from_jax`, `init_packed_grid`,
`init_grid`, `occupancy_from_numpy`) take a ``device`` argument. With
none given they run on ``cuda``, and without CUDA they raise: the port
never continues on the CPU unless the caller asks for it
(``device="cpu"``, as the tests do).
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless one is given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "dregnerf_tpu_torch runs on CUDA and none is available; "
                "pass device='cpu' to run on the CPU explicitly")
        return torch.device("cuda")
    return torch.device(device)
