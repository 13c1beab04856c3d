"""The port's mesh: the ranks of a torch.distributed process group (port of
dregnerf_tpu/parallel/mesh.py).

The JAX package's parallelism is one program over a device mesh: data
parallel over rays (`ngp_dp`) and over scene pairs (`regtr_dp`), ray
sharding in extraction (`extract_sharded`), query sharding in attention
(`sp_attention`), and the zero-collective block fleet (`fleet`). Here a
mesh is one process per rank: rank r of a run under
`torchrun --nproc_per_node N` uses `cuda:{LOCAL_RANK}` (or the CPU, when
the caller asks for it), and every array lives whole on each rank, so a
JAX `P("data")` sharding becomes a rank's slice of the rows (`Mesh.rows`,
`Mesh.shard`) and JAX's global views are rebuilt with `all_gather_rows`.
`replicated` and `row_sharded` name XLA shardings and have no torch
counterpart; those two helpers take their place.

The backend follows the device when this module starts the process group:
NCCL for CUDA, gloo for the CPU. A group started by the caller is used as
it is; gloo on CUDA tensors reads them through a host copy. gloo has no
`ReduceOp.AVG`, so every mean is a SUM and a divide by the world size. A
failed init or collective raises; nothing carries on as one rank.

A mesh of one rank with no process group is a valid mesh whose
collectives are identities.
"""
from __future__ import annotations

import dataclasses
import math
import os
import torch
import torch.distributed as dist

from dregnerf_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """`size` ranks along the `data` axis; this process is rank `rank` on
    `device`. `group` is the process group (None: the default group)."""

    size: int
    rank: int
    device: torch.device
    group: object = None

    def _live(self) -> bool:
        return dist.is_initialized()

    def rows(self, n: int) -> slice:
        """This rank's rows of an axis of n (n must divide by the size, as
        a `P("data")` shard_map input must)."""
        if n % self.size:
            raise ValueError(f"{n} rows do not split evenly over {self.size} ranks")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def shard(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's rows of x along `dim`."""
        return x.narrow(dim, self.rows(x.shape[dim]).start, x.shape[dim] // self.size)

    def _host(self, t: torch.Tensor) -> bool:
        return t.is_cuda and dist.get_backend(self.group) == "gloo"

    def all_reduce_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum t over the ranks, in place; returns t."""
        if self._live():
            if self._host(t):
                host = t.cpu()
                dist.all_reduce(host, group=self.group)
                t.copy_(host)
            else:
                dist.all_reduce(t, group=self.group)
        return t

    def all_gather_rows(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's t, concatenated along `dim` in rank order."""
        if not self._live():
            return t
        src = t.detach().contiguous()
        host = self._host(src)
        if host:
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        out = torch.cat(parts, dim)
        return out.to(t.device) if host else out

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank `src`'s t on every rank, in place; returns t."""
        if self._live():
            if self._host(t):
                host = t.cpu()
                dist.broadcast(host, src, group=self.group)
                t.copy_(host)
            else:
                dist.broadcast(t, src, group=self.group)
        return t


def _rank_device(device) -> torch.device:
    """`device`, with a bare "cuda" (or none) meaning cuda:{LOCAL_RANK}."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def make_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """The mesh of this process's group: n_devices ranks (default: the
    world size), which must be the world size. Without a process group,
    one is started from torchrun's environment (WORLD_SIZE, RANK,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT), with NCCL on CUDA and gloo on
    the CPU; with neither, the world is this one process."""
    dev = _rank_device(device)
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", 1)) > 1:
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method="env://")
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    n = n_devices or world
    if n != world:
        raise ValueError(f"a mesh of {n} ranks needs a world of {n} processes, this run has "
                         f"{world} (torchrun --nproc_per_node {n})")
    return Mesh(size=n, rank=rank, device=dev)


def mesh_ranks(config) -> int:
    """The number of ranks --mesh_shape asks for: 1 for '' or a product of
    1; 'N' -> N; 'N,1' -> N (JAX's (data, model) axes). A model axis over
    1 raises: the JAX package shards nothing over it (its shard_maps name
    `data` only, so a model axis would repeat every rank's work)."""
    spec = (getattr(config, "mesh_shape", "") or "").strip()
    dims = [int(x) for x in spec.split(",") if x.strip()]
    if len(dims) > 2:
        raise ValueError(f"--mesh_shape {spec}: at most two axes (data, model)")
    if len(dims) == 2 and dims[1] > 1:
        raise ValueError(f"--mesh_shape {spec}: a model axis of {dims[1]}; nothing is "
                         f"sharded over it, use --mesh_shape {dims[0]}")
    return math.prod(dims)


def make_mesh_from_config(config, device=None) -> Mesh | None:
    """The --mesh_shape mesh (mesh_ranks), or None for one rank."""
    n = mesh_ranks(config)
    if n <= 1:
        return None
    if device is None:
        device = getattr(config, "device", None)
    return make_mesh(n, device)


def mesh_and_device(config, device=None) -> tuple[Mesh | None, torch.device]:
    """An entry point's (mesh, device): the --mesh_shape mesh and its rank's
    device, or no mesh and `device` (else the config's --device, else
    cuda)."""
    if device is None:
        device = getattr(config, "device", None)
    mesh = make_mesh_from_config(config, device)
    return mesh, (mesh.device if mesh is not None else resolve_device(device))


def is_main(mesh: Mesh | None) -> bool:
    """Whether this process logs and writes: rank 0, or no mesh."""
    return mesh is None or mesh.rank == 0


def barrier(mesh: Mesh | None) -> None:
    """Every rank of `mesh` waits here (no mesh, or no group: a no-op)."""
    if mesh is not None and mesh._live():
        dist.barrier(group=mesh.group)
