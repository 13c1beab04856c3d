"""ctypes binding of the classical registration baseline: FGR, RANSAC and
FPFH features (port of dregnerf_tpu/registration/fgr.py).

The C++ source is the port's own copy, `csrc/fgr.cpp`, built with the
system g++ at first use into `dregnerf_tpu_torch/_build/` by
`ops/native.py`. A failed build raises RuntimeError with the compiler's
output: it is not a failed registration. Everything here runs on the host.
"""
from __future__ import annotations

import ctypes
import time
from typing import Optional, Tuple

import numpy as np

from dregnerf_tpu_torch.ops.native import entry_point

_DOUBLES = ctypes.POINTER(ctypes.c_double)


def _doubles(points: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(points, np.float64).reshape(-1, 3))


def _fgr_once(src: np.ndarray, tgt: np.ndarray, voxel_size: float
              ) -> Tuple[Optional[np.ndarray], int]:
    out = np.zeros(16, np.float64)
    rc = entry_point("fgr", "fgr_register")(
        src.ctypes.data_as(_DOUBLES), len(src), tgt.ctypes.data_as(_DOUBLES), len(tgt),
        voxel_size, out.ctypes.data_as(_DOUBLES))
    return (out.reshape(4, 4) if rc == 0 else None), rc


def run_registration(src_points: np.ndarray, tgt_points: np.ndarray, voxel_size: float = 0.05,
                     retry: bool = True) -> Tuple[Optional[np.ndarray], float]:
    """FGR src->tgt. Returns (4x4 float64 or None, seconds).

    fgr.cpp fails with too few points after the voxel downsample (rc -1/-2)
    or too few reciprocal FPFH correspondences (-3). With `retry`, the voxel
    halves twice (a denser downsample keeps small clouds above the
    10-point floors), then RANSAC, which needs 3 correspondences where
    FGR's solver wants 10, tries at v/2 and v/4."""
    src, tgt = _doubles(src_points), _doubles(tgt_points)
    t0 = time.time()
    ladder = [voxel_size, voxel_size / 2, voxel_size / 4] if retry else [voxel_size]
    rc = 0
    for vox in ladder:
        T, rc = _fgr_once(src, tgt, vox)
        if T is not None:
            return T, time.time() - t0
    if retry:
        for vox in (voxel_size / 2, voxel_size / 4):
            T, _ = run_ransac_registration(src, tgt, voxel_size=vox)
            if T is not None:
                return T, time.time() - t0
    print(f"[fgr] failed (rc={rc}, n_src={len(src)}, n_tgt={len(tgt)}, "
          f"voxels tried {ladder})", flush=True)
    return None, time.time() - t0


def run_ransac_registration(src_points: np.ndarray, tgt_points: np.ndarray,
                            voxel_size: float = 0.05, max_iters: int = 100000
                            ) -> Tuple[Optional[np.ndarray], float]:
    """RANSAC on FPFH matches, then the FGR objective from its pose (Open3D's
    `registration_ransac_based_on_feature_matching`). Returns (4x4 float64
    or None, seconds)."""
    src, tgt = _doubles(src_points), _doubles(tgt_points)
    out = np.zeros(16, np.float64)
    t0 = time.time()
    rc = entry_point("fgr", "ransac_register")(
        src.ctypes.data_as(_DOUBLES), len(src), tgt.ctypes.data_as(_DOUBLES), len(tgt),
        voxel_size, max_iters, out.ctypes.data_as(_DOUBLES))
    dt = time.time() - t0
    return (out.reshape(4, 4) if rc == 0 else None), dt


def fpfh(points: np.ndarray, voxel_size: float = 0.05) -> Optional[np.ndarray]:
    """[n, 33] FPFH features of the voxel-downsampled cloud, or None."""
    pts = _doubles(points)
    out = np.zeros((len(pts), 33), np.float32)
    n = entry_point("fgr", "fpfh_features")(
        pts.ctypes.data_as(_DOUBLES), len(pts), voxel_size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if n <= 0:
        return None
    return out[: min(n, len(pts))]
