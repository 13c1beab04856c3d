"""Visualization and geometry-export utilities (port of
dregnerf_tpu/utils/visualization.py).

Colormapped scalar images with optional colorbars (`colorize_np`), depth
visualization, total-variation loss, camera plots and SDF-volume -> PLY
mesh export by marching tetrahedra.

The card's machine has no matplotlib, so the jet colormap, which the
novel-view renders colour their depth with, is a 256-entry table built
here from matplotlib's `_jet_data` segments the way
`LinearSegmentedColormap(N=256)` builds its own, and indexed as matplotlib
indexes it. Any other colormap name, the colorbar and the camera plot
import matplotlib inside the function.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# matplotlib's _jet_data: (x, y_left, y_right) breakpoints of each channel
_JET_SEGMENTS = (
    ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1), (1.0, 0.5, 0.5)),
    ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1), (0.91, 0, 0), (1.0, 0, 0)),
    ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0), (1.0, 0, 0)),
)
_N = 256


def _segment_lut(data, n: int) -> np.ndarray:
    """One channel of a LinearSegmentedColormap's lookup table (matplotlib's
    _create_lookup_table at gamma 1)."""
    a = np.array(data, np.float64)
    x, y0, y1 = a[:, 0] * (n - 1), a[:, 1], a[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1], [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


JET_LUT = np.stack([_segment_lut(s, _N) for s in _JET_SEGMENTS], axis=-1)  # [256, 3] f64


def _jet(norm: np.ndarray) -> np.ndarray:
    """matplotlib's Colormap.__call__ on float input: x * N (in the input's
    dtype), N mapped to N - 1, truncated to int and clipped to the table; NaN
    takes the "bad" colour (0, 0, 0)."""
    xa = np.array(norm, copy=True)
    xa *= _N
    xa[xa == _N] = _N - 1
    bad = np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = xa.astype(int)
    idx = np.clip(idx, 0, _N - 1)  # under and over take the end colours
    rgb = JET_LUT.take(idx, axis=0)
    rgb[bad] = 0.0
    return rgb


def colorize_np(
    x: np.ndarray,
    cmap_name: str = "jet",
    mask: Optional[np.ndarray] = None,
    value_range: Optional[tuple] = None,
) -> np.ndarray:
    """Scalar [H, W] -> float RGB [H, W, 3] through a colormap."""
    x = np.asarray(x, np.float32)
    if value_range is not None:
        vmin, vmax = value_range
    elif mask is not None and mask.any():
        vmin, vmax = float(x[mask].min()), float(x[mask].max())
    else:
        vmin, vmax = float(x.min()), float(x.max())
    norm = np.clip((x - vmin) / max(vmax - vmin, 1e-9), 0.0, 1.0)
    if cmap_name == "jet":
        rgb = _jet(norm).astype(np.float32)
    else:
        import matplotlib

        rgb = matplotlib.colormaps[cmap_name](norm)[..., :3].astype(np.float32)
    if mask is not None:
        rgb = rgb * mask[..., None]
    return rgb


def get_vertical_colorbar(
    height: int, vmin: float, vmax: float, cmap_name: str = "jet",
    label: str | None = None, precision: int = 2,
) -> np.ndarray:
    """A vertical colorbar strip as an RGB uint8 array (needs matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import colors as mcolors

    fig, ax = plt.subplots(figsize=(1.2, height / 100), dpi=100)
    norm = mcolors.Normalize(vmin=vmin, vmax=vmax)
    cb = matplotlib.colorbar.ColorbarBase(ax, cmap=matplotlib.colormaps[cmap_name], norm=norm)
    cb.set_ticks([vmin, (vmin + vmax) / 2, vmax])
    cb.set_ticklabels([f"{v:.{precision}f}" for v in (vmin, (vmin + vmax) / 2, vmax)])
    if label:
        cb.set_label(label)
    fig.tight_layout()
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return buf


def colorize_with_colorbar(
    x: np.ndarray, cmap_name: str = "jet", label: str | None = None
) -> np.ndarray:
    """colorize_np with a vertical colorbar appended on the right."""
    rgb = (colorize_np(x, cmap_name) * 255).astype(np.uint8)
    cbar = get_vertical_colorbar(rgb.shape[0], float(np.min(x)), float(np.max(x)), cmap_name,
                                 label)
    if cbar.shape[0] != rgb.shape[0]:  # resize the strip to the image's height
        idx = (np.arange(rgb.shape[0]) * cbar.shape[0] // rgb.shape[0]).clip(
            0, cbar.shape[0] - 1)
        cbar = cbar[idx]
    return np.concatenate([rgb, cbar], axis=1)


def visualize_depth_numpy(
    depth: np.ndarray, minmax: Optional[tuple] = None
) -> tuple[np.ndarray, tuple]:
    """Depth map -> uint8 jet RGB, and the (min, max) it was scaled by."""
    x = np.nan_to_num(depth)
    mi = np.min(x[x > 0]) if (x > 0).any() else 0.0
    ma = np.max(x)
    if minmax is not None:
        mi, ma = minmax
    x = (x - mi) / (ma - mi + 1e-8)
    rgb = (colorize_np(x, "jet") * 255).astype(np.uint8)
    return rgb, (mi, ma)


def tv_loss(x: torch.Tensor, weight: float = 1.0) -> torch.Tensor:
    """Total variation over the last two axes ([B, C, H, W]-style)."""
    h_tv = torch.mean((x[..., 1:, :] - x[..., :-1, :]) ** 2)
    w_tv = torch.mean((x[..., :, 1:] - x[..., :, :-1]) ** 2)
    return weight * 2.0 * (h_tv + w_tv)


def plot_cameras(camtoworlds: np.ndarray, path: str, labels=None, scale: float = 0.1):
    """Save a 3D scatter and quiver of camera poses (needs matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(projection="3d")
    centers = camtoworlds[:, :3, 3]
    fwd = -camtoworlds[:, :3, 2]
    c = labels if labels is not None else "b"
    ax.scatter(centers[:, 0], centers[:, 1], centers[:, 2], c=c, s=10)
    ax.quiver(centers[:, 0], centers[:, 1], centers[:, 2], fwd[:, 0], fwd[:, 1], fwd[:, 2],
              length=scale, color="r")
    fig.savefig(path, dpi=100)
    plt.close(fig)


# ------------------------- marching tetrahedra (SDF volume -> mesh) ---------
# Each cube splits into 6 tetrahedra; each tet contributes 0-2 triangles.
_TETS = np.array(
    [[0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6], [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6]]
)
_CUBE = np.array(
    [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
     [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]]
)


def _crossing(p, v, i, o):
    """The point where the SDF crosses zero on the edge from corner i to o."""
    a, b = v[i], v[o]
    t = a / (a - b) if abs(a - b) > 1e-12 else 0.5
    return p[i] + t * (p[o] - p[i])


def sdf_to_mesh(
    sdf: np.ndarray, level: float = 0.0, origin=(0.0, 0.0, 0.0), spacing=(1.0, 1.0, 1.0)
) -> tuple[np.ndarray, np.ndarray]:
    """The `level` isosurface of an [X, Y, Z] SDF volume by marching
    tetrahedra: (vertices [V, 3], faces [F, 3])."""
    sx, sy, sz = sdf.shape
    cells = np.stack(
        np.meshgrid(np.arange(sx - 1), np.arange(sy - 1), np.arange(sz - 1), indexing="ij"), -1,
    ).reshape(-1, 3)
    corner_pos = cells[:, None, :] + _CUBE[None]  # [C, 8, 3]
    corner_val = sdf[corner_pos[..., 0], corner_pos[..., 1], corner_pos[..., 2]]
    verts_out, faces_out = [], []
    vcount = 0
    for tet in _TETS:
        vals = corner_val[:, tet] - level  # [C, 4]
        pos = corner_pos[:, tet].astype(np.float64)  # [C, 4, 3]
        inside = vals < 0
        n_in = inside.sum(-1)
        for n, flip in [(1, False), (3, True)]:  # one corner apart: a triangle
            m = n_in == n
            if not m.any():
                continue
            v, p, s = vals[m], pos[m], inside[m]
            if flip:
                s = ~s
            one = np.argmax(s, axis=-1)
            tri = np.asarray([[_crossing(p[row], v[row], one[row], r)
                               for r in range(4) if r != one[row]]
                              for row in range(v.shape[0])])  # [M, 3, 3]
            verts_out.append(tri.reshape(-1, 3))
            faces_out.append(np.arange(tri.shape[0] * 3).reshape(-1, 3) + vcount)
            vcount += tri.shape[0] * 3
        m = n_in == 2  # two inside: a quad, as 2 triangles
        if m.any():
            v, p, s = vals[m], pos[m], inside[m]
            quads = []
            for row in range(v.shape[0]):
                ins, outs = np.where(s[row])[0], np.where(~s[row])[0]
                pts = [_crossing(p[row], v[row], i, o) for i in ins for o in outs]
                # order: (i0,o0),(i0,o1),(i1,o1),(i1,o0)
                quads.append([pts[0], pts[1], pts[3], pts[2]])
            quads = np.asarray(quads)
            tris = np.concatenate([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]], axis=0)
            verts_out.append(tris.reshape(-1, 3))
            faces_out.append(np.arange(tris.shape[0] * 3).reshape(-1, 3) + vcount)
            vcount += tris.shape[0] * 3
    if not verts_out:
        return np.zeros((0, 3)), np.zeros((0, 3), int)
    verts = np.concatenate(verts_out)
    faces = np.concatenate(faces_out)
    verts = verts * np.asarray(spacing)[None] + np.asarray(origin)[None]
    return verts, faces


def save_mesh_ply(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    """Binary little-endian PLY mesh (vertex and face elements)."""
    header = [
        "ply", "format binary_little_endian 1.0",
        f"element vertex {len(verts)}",
        "property double x", "property double y", "property double z",
        f"element face {len(faces)}",
        "property list uchar int vertex_indices", "end_header",
    ]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        f.write(np.asarray(verts, "<f8").tobytes())
        rec = np.zeros(len(faces), dtype=[("n", "u1"), ("idx", "<i4", 3)])
        rec["n"] = 3
        rec["idx"] = faces
        f.write(rec.tobytes())
