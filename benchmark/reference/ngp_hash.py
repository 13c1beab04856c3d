"""Plain PyTorch reference of the NGP block with Instant-NGP's xor-hash
grid: `benchmark/reference/ngp.py` (the marcher, the compositor, the MLPs,
the occupancy update, the training step with Adam), whose `Field` this
module subclasses with the hash grid's encoder.

The encoder reads each corner of the [L*T, F] vertex table by plain
indexing, so its table gradient is autograd's exact f32 scatter. Level l
scales a position u in [0, 1]^3 by s_l = base * scale^l - 1, takes
pos = u * s_l + 0.5 (the product, then the sum, each rounded to f32), and
blends the 8 corners of the cell of floor(pos) with trilinear weights. A
level whose res_l^3 vertices (res_l = ceil(s_l) + 1) fit in T rows indexes
them densely, x + y*res + z*res^2; the others hash x*1 xor y*2654435761
xor z*805459861 in uint32 and keep the low log2(T) bits. Level l's rows
start at l*T.

Departures from tiny-cuda-nn's HashGrid, which the source trains with
(each the program's too):
  * every level owns T rows of the table, so the table holds L*T rows;
    tcnn gives a dense level only its res^3 rows (rounded up to a multiple
    of 8);
  * corners are clamped to [0, res - 1]; tcnn takes a dense index past the
    grid modulo the level's rows;
  * pos = u * s + 0.5 is rounded twice; tcnn fuses the multiply-add;
  * the table and the interpolation are f32; tcnn stores and encodes in
    half precision.

It imports nothing of the program and nothing of JAX.
"""
from __future__ import annotations

import torch

from benchmark.reference.ngp import CORNERS
from benchmark.reference.ngp import Field as PackedField
# the rest of the block's reference, read from here by the cell's driver
from benchmark.reference.ngp import leaves, train_steps, warmup_grid  # noqa: F401

PRIMES = (1, 2654435761, 805459861)
MASK32 = (1 << 32) - 1


class Field(PackedField):
    """The configuration's field with the xor-hash grid over the [L*T, F]
    vertex table."""

    def __init__(self, cfg: dict, precision: str = "bf16"):
        super().__init__(cfg, precision)
        self.table_size = 1 << cfg["grid"]["log2_table_size"]
        self.dense = self.res**3 <= self.table_size

    def encode(self, table: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """[..., 3] positions (corners outside the grid are clamped to it)
        -> [..., levels * features]."""
        shape = u.shape[:-1]
        x = u.reshape(-1, 3).float()
        outs = []
        for l in range(self.levels):
            pos = x * float(self.scales[l])
            pos = pos + 0.5
            fl = torch.floor(pos)
            frac = pos - fl
            cell = fl.long()
            r = int(self.res[l])
            acc = 0.0
            for dx, dy, dz in CORNERS:
                c = (cell + torch.tensor([int(dx), int(dy), int(dz)], device=x.device)).clamp(
                    0, r - 1)
                if self.dense[l]:
                    idx = c[:, 0] + c[:, 1] * r + c[:, 2] * (r * r)
                else:
                    idx = ((c[:, 0] * PRIMES[0]) & MASK32) ^ ((c[:, 1] * PRIMES[1]) & MASK32) \
                        ^ ((c[:, 2] * PRIMES[2]) & MASK32)
                    idx = idx & (self.table_size - 1)
                w = ((frac[:, 0] if dx else 1 - frac[:, 0])
                     * (frac[:, 1] if dy else 1 - frac[:, 1])
                     * (frac[:, 2] if dz else 1 - frac[:, 2]))
                acc = acc + w[:, None] * table[idx + l * self.table_size]
            outs.append(acc)
        return torch.cat(outs, dim=-1).reshape(*shape, -1)
