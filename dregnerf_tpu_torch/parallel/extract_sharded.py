"""Ray-sharded surface pass of voxel extraction (port of
dregnerf_tpu/parallel/extract_sharded.py).

The cameras x points pass is the extraction's hot loop, and every ray in
it is independent: each rank marches, queries and reduces its own slice
of a chunk's rays, with the rows marcher and `samples_per_ray` survivors a
ray as on one device (extract/sample_grid.py). The per-ray scores stay on
their rank until `compute_surface_mask(mesh=)` gathers them, once per
chunk (JAX needs no collective there: its device-to-host read of the
sharded output is the gather). No packed buffer is involved, so JAX's
`buffer_per_device` has no counterpart.
"""
from __future__ import annotations

from typing import Any

from dregnerf_tpu_torch.extract.sample_grid import make_surface_chunk_fn
from dregnerf_tpu_torch.parallel.mesh import Mesh


def make_sharded_surface_fn(mesh: Mesh, params: Any, model_cfg, grid, aabb, rcfg,
                            samples_per_ray: int = 64):
    """(origins, viewdirs, t_max) of a whole chunk, whose ray count divides
    by the mesh size -> this rank's per-ray S, its rows of the chunk."""
    fn = make_surface_chunk_fn(params, model_cfg, grid, aabb, rcfg, samples_per_ray)

    def call(origins, viewdirs, t_max):
        return fn(mesh.shard(origins), mesh.shard(viewdirs), mesh.shard(t_max))

    return call
