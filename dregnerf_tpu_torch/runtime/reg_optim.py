"""The registration trainer's optimizer with its nonfinite-step guard (port
of the optax chain of dregnerf_tpu/runtime/reg_trainer.py::setup_optimizer
and of the guard in its step).

The chain, as optax computes it:
  1. clip_by_global_norm(0.1) over every parameter (infonce_W included):
     g stays if |g| < 0.1, else g / |g| * 0.1 (no epsilon; torch's
     clip_grad_norm_ divides by |g| + 1e-6);
  2. Adam moments mu = 0.1 g + 0.9 mu, nu = 0.001 g^2 + 0.999 nu, bias
     corrected at the incremented count, u = mu_hat / (sqrt(nu_hat) + 1e-8);
  3. u + 1e-4 * param on every leaf (AdamW's decoupled decay);
  4. times -lr * 0.5^min(4, c // 34000) at the update of 0-based count c
     (optax.piecewise_constant_schedule with a halving at 34000 k,
     k = 1..4: the rate floors at lr / 16, unlike StepLR);
  5. param + u.
The guard: with a nonfinite loss or gradient the parameters, both moments
and both counts stay bit for bit as they were (JAX zeroes the gradient,
updates, then selects the old state), decided on the device from one flag,
with no host read.

Every parameter lives in one flat f32 buffer (the leaves become views of
it), so the whole update is a few elementwise kernels over the buffer.
The state mirrors optax's: `count` (adam's, optax key `1/0/count`), `mu`,
`nu` and `schedule_count` (`1/2/count`).
"""
from __future__ import annotations

from typing import Sequence

import torch

MAX_GRAD_NORM = 0.1
B1, B2, EPS = 0.9, 0.999, 1e-8
WEIGHT_DECAY = 1e-4
LR_BOUNDARIES = tuple(34000 * (k + 1) for k in range(4))
LR_SCALE = 0.5


def learning_rate(lr: float, count: torch.Tensor) -> torch.Tensor:
    """optax.piecewise_constant_schedule(lr, {34000 k: 0.5}) at `count`,
    in f32 on count's device."""
    v = torch.full((), lr, dtype=torch.float32, device=count.device)
    for threshold in LR_BOUNDARIES:
        v = torch.where(count >= threshold, v * LR_SCALE, v)
    return v


class GuardedAdamW:
    """clip_by_global_norm(0.1) + AdamW(lr schedule, wd 1e-4) over `leaves`
    (tensors that require grad), which become views of one flat buffer."""

    def __init__(self, leaves: Sequence[torch.Tensor], lr: float):
        self.lr = float(lr)
        self.leaves = list(leaves)
        self.numels = [t.numel() for t in self.leaves]
        with torch.no_grad():
            self.flat = torch.cat([t.detach().reshape(-1).float() for t in self.leaves])
        for t, view in zip(self.leaves, self.split(self.flat)):
            t.data = view
        dev = self.flat.device
        self.mu = torch.zeros_like(self.flat)
        self.nu = torch.zeros_like(self.flat)
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self.schedule_count = torch.zeros((), dtype=torch.int32, device=dev)

    def split(self, flat: torch.Tensor) -> list[torch.Tensor]:
        """Views of a flat tensor in the leaves' shapes."""
        return [v.view(t.shape) for v, t in zip(flat.split(self.numels), self.leaves)]

    @staticmethod
    def flat_grad(grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """One flat gradient from the leaves' gradients, in their order."""
        return torch.cat([g.reshape(-1).float() for g in grads])

    @torch.no_grad()
    def step(self, grad: torch.Tensor, loss: torch.Tensor) -> torch.Tensor:
        """One guarded update from the flat gradient of `loss`; returns the
        0-dim bool `finite` (False: nothing changed)."""
        finite = torch.isfinite(loss) & torch.isfinite(grad).all()
        g = torch.where(finite, grad, 0.0)
        # a sum of squares: the CPU's f32 vector_norm does not cascade its
        # sum (9.5e-4 off at 2^24 elements, test_clip_norm_is_accurate_on_a_
        # large_buffer); the cascaded sum is within 1e-6 there
        norm = torch.sqrt((g * g).sum())
        g = torch.where(norm < MAX_GRAD_NORM, g, g / norm * MAX_GRAD_NORM)

        mu = (1 - B1) * g + B1 * self.mu
        nu = (1 - B2) * (g * g) + B2 * self.nu
        count = self.count + 1
        c = count.to(torch.float32)
        one = torch.ones((), device=c.device)
        mu_hat = mu / (1 - torch.pow(B1 * one, c))
        nu_hat = nu / (1 - torch.pow(B2 * one, c))
        u = mu_hat / (torch.sqrt(nu_hat) + EPS)
        u = u + WEIGHT_DECAY * self.flat
        u = -learning_rate(self.lr, self.schedule_count) * u
        params = self.flat + u

        self.flat.copy_(torch.where(finite, params, self.flat))
        self.mu.copy_(torch.where(finite, mu, self.mu))
        self.nu.copy_(torch.where(finite, nu, self.nu))
        self.count.copy_(torch.where(finite, count, self.count))
        self.schedule_count.copy_(torch.where(finite, self.schedule_count + 1,
                                              self.schedule_count))
        return finite
