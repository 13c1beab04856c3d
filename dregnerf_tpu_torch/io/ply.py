"""PLY point-cloud IO (copy of dregnerf_tpu/io/ply.py: the port imports
nothing of the JAX package).

Writes and reads binary-little-endian PLY with xyz (+ rgb) vertices, the
files Open3D emits for `voxel_point_cloud.ply`; both packages write the
same bytes for the same arrays.
"""
from __future__ import annotations

import struct

import numpy as np


def write_ply(
    path: str, points: np.ndarray, colors: np.ndarray | None = None
) -> None:
    """points [N, 3] float; colors [N, 3] float in [0,1] or uint8."""
    points = np.asarray(points, np.float64)
    n = points.shape[0]
    has_color = colors is not None
    if has_color:
        colors = np.asarray(colors)
        if colors.dtype != np.uint8:
            colors = (np.clip(colors, 0.0, 1.0) * 255).astype(np.uint8)

    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property double {ax}" for ax in "xyz"]
    if has_color:
        header += [f"property uchar {c}" for c in ("red", "green", "blue")]
    header += ["end_header"]

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if has_color:
            rec = np.zeros(
                n, dtype=[("xyz", "<f8", 3), ("rgb", "u1", 3)]
            )
            rec["xyz"] = points
            rec["rgb"] = colors
            f.write(rec.tobytes())
        else:
            f.write(points.astype("<f8").tobytes())


def read_ply(path: str) -> tuple[np.ndarray, np.ndarray | None]:
    """Returns (points [N,3] f64, colors [N,3] u8 or None). Handles the
    binary-little-endian and ascii files this module + Open3D write."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        n = 0
        props: list[tuple[str, str]] = []
        while True:
            line = f.readline().strip()
            if line == b"end_header":
                break
            parts = line.decode("ascii").split()
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element" and parts[1] == "vertex":
                n = int(parts[2])
            elif parts[0] == "property" and len(parts) == 3:
                props.append((parts[1], parts[2]))

        type_map = {
            "float": ("<f4", 4), "float32": ("<f4", 4),
            "double": ("<f8", 8), "float64": ("<f8", 8),
            "uchar": ("u1", 1), "uint8": ("u1", 1),
            "char": ("i1", 1), "int": ("<i4", 4), "uint": ("<u4", 4),
        }
        if fmt == "ascii":
            rows = np.loadtxt(f, max_rows=n, ndmin=2)
            names = [name for _, name in props]
            xyz_idx = [names.index(a) for a in "xyz"]
            pts = rows[:, xyz_idx]
            if all(c in names for c in ("red", "green", "blue")):
                cols = rows[:, [names.index(c) for c in ("red", "green", "blue")]]
                return pts, cols.astype(np.uint8)
            return pts, None

        dtype = np.dtype(
            [(name, type_map[t][0]) for t, name in props]
        )
        rec = np.frombuffer(f.read(dtype.itemsize * n), dtype=dtype, count=n)
        pts = np.stack([rec[a].astype(np.float64) for a in "xyz"], -1)
        if all(c in rec.dtype.names for c in ("red", "green", "blue")):
            cols = np.stack([rec[c] for c in ("red", "green", "blue")], -1)
            return pts, cols
        return pts, None
