"""Radiance-field registry, one interface over the field families (port of
dregnerf_tpu/models/fields.py).

The renderer and the trainer drive any field through
  init(cfg, generator, device) / query_density(params, x, aabb, cfg,
  return_feat) / query_rgb(params, dirs, feat, cfg) / forward(params, pos,
  dirs, aabb, cfg) / prepare_params(params, cfg),
with `t=` (a time per point, [..., 1]) on query_density and forward of the
MLP fields, and `params_from_jax` for weights in the JAX package's layout.

Families:
  * "ngp"     - Instant-NGP, packed or xor-hash grid (models/ngp.py);
  * "vanilla" - the 8x256 frequency-encoded MLP (models/mlp_nerf.py);
  * "dnerf"   - vanilla with the time-conditioned warp.
"""
from __future__ import annotations

from dregnerf_tpu_torch.models import mlp_nerf, ngp


class _NGPField:
    init = staticmethod(ngp.init_ngp)
    query_density = staticmethod(ngp.query_density)
    query_rgb = staticmethod(ngp.query_rgb)
    forward = staticmethod(ngp.forward)
    prepare_params = staticmethod(ngp.prepare_params)
    params_from_jax = staticmethod(ngp.params_from_jax)


class _VanillaField:
    """The aabb only selects the density: a point not strictly inside it
    (before any warp) has sigma 0; the MLP itself is unbounded."""

    init = staticmethod(mlp_nerf.init_vanilla_nerf)
    query_rgb = staticmethod(mlp_nerf.query_rgb)
    params_from_jax = staticmethod(mlp_nerf.params_from_jax)

    @staticmethod
    def query_density(params, x, aabb, cfg, return_feat: bool = False, t=None):
        selector = ((x > aabb[:3]) & (x < aabb[3:])).all(dim=-1)[..., None]
        out = mlp_nerf.query_density(params, x, cfg, t=t, return_feat=return_feat)
        if return_feat:
            sigma, feat = out
            return sigma * selector, feat
        return out * selector

    @staticmethod
    def forward(params, positions, viewdirs, aabb, cfg, t=None):
        sigma, feat = _VanillaField.query_density(params, positions, aabb, cfg,
                                                  return_feat=True, t=t)
        return mlp_nerf.query_rgb(params, viewdirs, feat, cfg), sigma

    @staticmethod
    def prepare_params(params, cfg):
        return params


FIELD_REGISTRY = {
    "ngp": _NGPField,
    "vanilla": _VanillaField,
    "dnerf": _VanillaField,  # under a config with warp=True
}


def get_field(name: str):
    if name not in FIELD_REGISTRY:
        raise ValueError(f"unknown field family {name!r}; have {list(FIELD_REGISTRY)}")
    return FIELD_REGISTRY[name]
