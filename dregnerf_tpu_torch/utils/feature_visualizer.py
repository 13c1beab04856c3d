"""Feature-embedding visualization (port of
dregnerf_tpu/utils/feature_visualizer.py): high-dimensional point features
projected to RGB by PCA, and a coloured point cloud of them."""
from __future__ import annotations

import numpy as np

from dregnerf_tpu_torch.io.ply import write_ply


def features_to_rgb(feats: np.ndarray) -> np.ndarray:
    """[N, D] features -> [N, 3] colours: the top 3 principal components,
    min-max normalized."""
    feats = np.asarray(feats, np.float64)
    mu = feats.mean(axis=0, keepdims=True)
    x = feats - mu
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    proj = x @ vt[:3].T  # [N, 3]
    lo = proj.min(axis=0, keepdims=True)
    hi = proj.max(axis=0, keepdims=True)
    return ((proj - lo) / np.maximum(hi - lo, 1e-9)).astype(np.float32)


def save_feature_cloud(path: str, xyz: np.ndarray, feats: np.ndarray) -> None:
    """A PLY whose colours encode the PCA-projected features."""
    write_ply(path, np.asarray(xyz), features_to_rgb(feats))
