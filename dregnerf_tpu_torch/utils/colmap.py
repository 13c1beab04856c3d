"""COLMAP sparse-model reader (binary + text), writers and database (copy
of dregnerf_tpu/utils/colmap.py: stdlib struct and sqlite3, and numpy).

Equivalent of the reference's conerf/utils/colmap_reader.py:85-272 /
sfm_reader.py:53-331 and the vendored pycolmap SceneManager
(conerf/pycolmap/pycolmap/scene_manager.py) for the read paths the
pipeline uses: cameras / images / points3D parsing, pose matrices, and
AABB estimation from point percentiles (scripts/preprocess/
compute_bbox.py:29-59: 2-98% percentiles scaled by 1.4).
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


@dataclass
class Camera:
    model: str
    width: int
    height: int
    params: np.ndarray

    @property
    def K(self) -> np.ndarray:
        p = self.params
        if self.model == "SIMPLE_PINHOLE" or self.model.startswith("SIMPLE_RADIAL"):
            f, cx, cy = p[0], p[1], p[2]
            fx = fy = f
        elif self.model == "RADIAL":
            fx = fy = p[0]
            cx, cy = p[1], p[2]
        else:  # PINHOLE / OPENCV family: fx fy cx cy ...
            fx, fy, cx, cy = p[0], p[1], p[2], p[3]
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)


@dataclass
class Image:
    qvec: np.ndarray  # (w, x, y, z)
    tvec: np.ndarray
    camera_id: int
    name: str

    def rotation(self) -> np.ndarray:
        w, x, y, z = self.qvec / np.linalg.norm(self.qvec)
        return np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ]
        )

    def world_to_cam(self) -> np.ndarray:
        m = np.eye(4)
        m[:3, :3] = self.rotation()
        m[:3, 3] = self.tvec
        return m

    def cam_to_world(self) -> np.ndarray:
        return np.linalg.inv(self.world_to_cam())


@dataclass
class SparseModel:
    cameras: Dict[int, Camera] = field(default_factory=dict)
    images: Dict[int, Image] = field(default_factory=dict)
    points: Optional[np.ndarray] = None  # [N, 3]
    point_colors: Optional[np.ndarray] = None  # [N, 3] uint8


def _read(f, fmt):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_bin(path: str) -> Dict[int, Camera]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, w, h = _read(f, "<iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{n_params}d"))
            out[cam_id] = Camera(name, int(w), int(h), params)
    return out


def read_images_bin(path: str) -> Dict[int, Image]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            img_id = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<4d"))
            tvec = np.array(_read(f, "<3d"))
            cam_id = _read(f, "<i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read(f, "<Q")
            f.read(24 * n_pts)  # xys + point3D ids, unused
            out[img_id] = Image(qvec, tvec, cam_id, name.decode())
    return out


def read_points3d_bin(path: str):
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        xyz = np.zeros((n, 3))
        rgb = np.zeros((n, 3), np.uint8)
        for i in range(n):
            _read(f, "<Q")  # id
            xyz[i] = _read(f, "<3d")
            rgb[i] = _read(f, "<3B")
            _read(f, "<d")  # error
            (track_len,) = _read(f, "<Q")
            f.read(8 * track_len)
    return xyz, rgb


def read_cameras_txt(path: str) -> Dict[int, Camera]:
    out = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.split()
            cam_id, model = int(parts[0]), parts[1]
            w, h = int(parts[2]), int(parts[3])
            out[cam_id] = Camera(model, w, h, np.array([float(p) for p in parts[4:]]))
    return out


def read_images_txt(path: str) -> Dict[int, Image]:
    out = {}
    with open(path) as f:
        lines = [l for l in f if not l.startswith("#") and l.strip()]
    for i in range(0, len(lines), 2):  # every other line is 2D points
        parts = lines[i].split()
        out[int(parts[0])] = Image(
            np.array([float(p) for p in parts[1:5]]),
            np.array([float(p) for p in parts[5:8]]),
            int(parts[8]), parts[9],
        )
    return out


def read_model(sparse_dir: str) -> SparseModel:
    """Auto-detect binary vs text model in a COLMAP sparse dir."""
    m = SparseModel()
    if os.path.exists(os.path.join(sparse_dir, "cameras.bin")):
        m.cameras = read_cameras_bin(os.path.join(sparse_dir, "cameras.bin"))
        m.images = read_images_bin(os.path.join(sparse_dir, "images.bin"))
        p3d = os.path.join(sparse_dir, "points3D.bin")
        if os.path.exists(p3d):
            m.points, m.point_colors = read_points3d_bin(p3d)
    elif os.path.exists(os.path.join(sparse_dir, "cameras.txt")):
        m.cameras = read_cameras_txt(os.path.join(sparse_dir, "cameras.txt"))
        m.images = read_images_txt(os.path.join(sparse_dir, "images.txt"))
    else:
        raise FileNotFoundError(f"no COLMAP model in {sparse_dir}")
    return m


def compute_aabb_from_points(
    points: np.ndarray, lo_pct: float = 2.0, hi_pct: float = 98.0, scale: float = 1.4
) -> np.ndarray:
    """AABB from point percentiles x scale (compute_bbox.py:29-59)."""
    lo = np.percentile(points, lo_pct, axis=0)
    hi = np.percentile(points, hi_pct, axis=0)
    center = (lo + hi) / 2
    half = (hi - lo) / 2 * scale
    return np.concatenate([center - half, center + half]).astype(np.float32)


def write_cameras_txt(path: str, cameras: Dict[int, Camera]) -> None:
    with open(path, "w") as f:
        f.write("# Camera list: CAMERA_ID MODEL WIDTH HEIGHT PARAMS[]\n")
        for cid, c in sorted(cameras.items()):
            params = " ".join(str(p) for p in c.params)
            f.write(f"{cid} {c.model} {c.width} {c.height} {params}\n")


def write_images_txt(path: str, images: Dict[int, Image]) -> None:
    with open(path, "w") as f:
        f.write("# Image list: IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID NAME\n")
        for iid, im in sorted(images.items()):
            q = " ".join(str(v) for v in im.qvec)
            t = " ".join(str(v) for v in im.tvec)
            f.write(f"{iid} {q} {t} {im.camera_id} {im.name}\n\n")


# --------------------------------------------------------------------------
# Write paths (pycolmap SceneManager.save_* + database tooling parity —
# reference conerf/pycolmap/pycolmap/scene_manager.py:21-700 and
# conerf/pycolmap/pycolmap/database.py). Binary writers mirror COLMAP's
# on-disk format exactly so models written here round-trip through the
# readers above (and through COLMAP itself).
# --------------------------------------------------------------------------

_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


def write_cameras_bin(path: str, cameras: Dict[int, Camera]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cid, c in sorted(cameras.items()):
            mid = _MODEL_IDS[c.model]
            n_params = CAMERA_MODELS[mid][1]
            params = np.asarray(c.params, np.float64)
            assert len(params) == n_params, (c.model, len(params))
            f.write(struct.pack("<iiQQ", cid, mid, c.width, c.height))
            f.write(struct.pack(f"<{n_params}d", *params))


def write_images_bin(
    path: str,
    images: Dict[int, Image],
    points2d: Optional[Dict[int, np.ndarray]] = None,
    point3d_ids: Optional[Dict[int, np.ndarray]] = None,
) -> None:
    """points2d[iid]: [N, 2] keypoint xys; point3d_ids[iid]: [N] int64
    (-1 = untracked). Both optional (empty tracks written otherwise)."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for iid, im in sorted(images.items()):
            f.write(struct.pack("<i", iid))
            f.write(struct.pack("<4d", *np.asarray(im.qvec, np.float64)))
            f.write(struct.pack("<3d", *np.asarray(im.tvec, np.float64)))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode() + b"\x00")
            xys = None if points2d is None else points2d.get(iid)
            if xys is None:
                f.write(struct.pack("<Q", 0))
                continue
            ids = None if point3d_ids is None else point3d_ids.get(iid)
            if ids is None:
                ids = np.full(len(xys), -1, np.int64)
            f.write(struct.pack("<Q", len(xys)))
            rec = np.zeros(len(xys), dtype=[("xy", "<f8", 2), ("pid", "<i8")])
            rec["xy"] = np.asarray(xys, np.float64)
            rec["pid"] = np.asarray(ids, np.int64)
            f.write(rec.tobytes())


def write_points3d_bin(
    path: str,
    xyz: np.ndarray,
    rgb: Optional[np.ndarray] = None,
    errors: Optional[np.ndarray] = None,
    tracks: Optional[list] = None,
) -> None:
    """xyz [N, 3]; rgb [N, 3] uint8; tracks: list of [(image_id,
    point2d_idx), ...] per point (empty tracks written otherwise)."""
    xyz = np.asarray(xyz, np.float64)
    n = len(xyz)
    rgb = (np.full((n, 3), 128, np.uint8) if rgb is None
           else np.asarray(rgb, np.uint8))
    errors = (np.full(n, -1.0) if errors is None
              else np.asarray(errors, np.float64))
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", n))
        for i in range(n):
            f.write(struct.pack("<Q", i + 1))
            f.write(struct.pack("<3d", *xyz[i]))
            f.write(struct.pack("<3B", *rgb[i]))
            f.write(struct.pack("<d", float(errors[i])))
            track = [] if tracks is None else tracks[i]
            f.write(struct.pack("<Q", len(track)))
            for img_id, p2d_idx in track:
                f.write(struct.pack("<ii", int(img_id), int(p2d_idx)))


def write_model(sparse_dir: str, model: SparseModel, binary: bool = True) -> None:
    """SceneManager.save parity: write cameras/images/points3D (bin or txt)."""
    os.makedirs(sparse_dir, exist_ok=True)
    if binary:
        write_cameras_bin(os.path.join(sparse_dir, "cameras.bin"), model.cameras)
        write_images_bin(os.path.join(sparse_dir, "images.bin"), model.images)
        write_points3d_bin(
            os.path.join(sparse_dir, "points3D.bin"),
            model.points if model.points is not None else np.zeros((0, 3)),
            model.point_colors,
        )
    else:
        write_cameras_txt(os.path.join(sparse_dir, "cameras.txt"), model.cameras)
        write_images_txt(os.path.join(sparse_dir, "images.txt"), model.images)


# ---------------------------------------------------------------- database
_MAX_IMAGE_ID = 2**31 - 1

_DB_SCHEMA = """
CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model INTEGER NOT NULL, width INTEGER NOT NULL, height INTEGER NOT NULL,
    params BLOB, prior_focal_length INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS images (
    image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name TEXT NOT NULL UNIQUE, camera_id INTEGER NOT NULL,
    prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
    prior_tx REAL, prior_ty REAL, prior_tz REAL,
    CONSTRAINT image_id_check CHECK(image_id >= 0 and image_id < 2147483647),
    FOREIGN KEY(camera_id) REFERENCES cameras(camera_id));
CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    config INTEGER NOT NULL, F BLOB, E BLOB, H BLOB,
    qvec BLOB, tvec BLOB);
"""


def image_ids_to_pair_id(image_id1: int, image_id2: int) -> int:
    """COLMAP's canonical pair key (database.py parity)."""
    if image_id1 > image_id2:
        image_id1, image_id2 = image_id2, image_id1
    return image_id1 * _MAX_IMAGE_ID + image_id2


def pair_id_to_image_ids(pair_id: int) -> tuple:
    image_id2 = pair_id % _MAX_IMAGE_ID
    return (pair_id - image_id2) // _MAX_IMAGE_ID, image_id2


class COLMAPDatabase:
    """COLMAP-schema SQLite database writer/reader.

    Capability parity with the vendored pycolmap database tooling: create
    the schema, add cameras/images/keypoints/descriptors/matches/two-view
    geometries, and read them back — enough to seed a COLMAP mapper run
    (scripts/preprocess/colmap_mapping.sh) from external features or known
    poses. Pure stdlib (sqlite3 + struct + numpy blobs)."""

    def __init__(self, path: str):
        import sqlite3

        self.conn = sqlite3.connect(path)
        self.conn.executescript(_DB_SCHEMA)

    def close(self):
        self.conn.commit()
        self.conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @staticmethod
    def _blob(arr, dtype):
        return np.ascontiguousarray(arr, dtype).tobytes()

    def add_camera(self, model: str, width: int, height: int,
                   params: np.ndarray, prior_focal_length: bool = False,
                   camera_id: Optional[int] = None) -> int:
        cur = self.conn.execute(
            "INSERT INTO cameras VALUES (?, ?, ?, ?, ?, ?)",
            (camera_id, _MODEL_IDS[model], int(width), int(height),
             self._blob(params, np.float64), int(prior_focal_length)),
        )
        return cur.lastrowid

    def add_image(self, name: str, camera_id: int,
                  prior_q: Optional[np.ndarray] = None,
                  prior_t: Optional[np.ndarray] = None,
                  image_id: Optional[int] = None) -> int:
        q = [None] * 4 if prior_q is None else [float(v) for v in prior_q]
        t = [None] * 3 if prior_t is None else [float(v) for v in prior_t]
        cur = self.conn.execute(
            "INSERT INTO images VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (image_id, name, camera_id, *q, *t),
        )
        return cur.lastrowid

    def add_keypoints(self, image_id: int, keypoints: np.ndarray) -> None:
        kp = np.asarray(keypoints, np.float32)
        assert kp.ndim == 2 and kp.shape[1] in (2, 4, 6)
        self.conn.execute(
            "INSERT INTO keypoints VALUES (?, ?, ?, ?)",
            (image_id, kp.shape[0], kp.shape[1], self._blob(kp, np.float32)),
        )

    def add_descriptors(self, image_id: int, descriptors: np.ndarray) -> None:
        d = np.asarray(descriptors, np.uint8)
        self.conn.execute(
            "INSERT INTO descriptors VALUES (?, ?, ?, ?)",
            (image_id, d.shape[0], d.shape[1], self._blob(d, np.uint8)),
        )

    def add_matches(self, image_id1: int, image_id2: int,
                    matches: np.ndarray) -> None:
        m = np.asarray(matches, np.uint32)
        if image_id1 > image_id2:  # canonical order flips match columns
            m = m[:, ::-1]
        self.conn.execute(
            "INSERT INTO matches VALUES (?, ?, ?, ?)",
            (image_ids_to_pair_id(image_id1, image_id2),
             m.shape[0], m.shape[1], self._blob(m, np.uint32)),
        )

    def add_two_view_geometry(self, image_id1: int, image_id2: int,
                              matches: np.ndarray, F=None, E=None, H=None,
                              config: int = 2) -> None:
        m = np.asarray(matches, np.uint32)
        if image_id1 > image_id2:
            m = m[:, ::-1]
        eye = np.eye(3)
        self.conn.execute(
            "INSERT INTO two_view_geometries VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (image_ids_to_pair_id(image_id1, image_id2),
             m.shape[0], m.shape[1], self._blob(m, np.uint32), config,
             self._blob(eye if F is None else F, np.float64),
             self._blob(eye if E is None else E, np.float64),
             self._blob(eye if H is None else H, np.float64),
             self._blob(np.array([1.0, 0, 0, 0]), np.float64),
             self._blob(np.zeros(3), np.float64)),
        )

    # ---- read-back (parity checks + reuse of prior databases) ----
    def read_keypoints(self, image_id: int) -> np.ndarray:
        row = self.conn.execute(
            "SELECT rows, cols, data FROM keypoints WHERE image_id=?",
            (image_id,),
        ).fetchone()
        r, c, data = row
        return np.frombuffer(data, np.float32).reshape(r, c)

    def read_matches(self, image_id1: int, image_id2: int) -> np.ndarray:
        row = self.conn.execute(
            "SELECT rows, cols, data FROM matches WHERE pair_id=?",
            (image_ids_to_pair_id(image_id1, image_id2),),
        ).fetchone()
        r, c, data = row
        m = np.frombuffer(data, np.uint32).reshape(r, c)
        return m[:, ::-1] if image_id1 > image_id2 else m

    def read_cameras(self) -> Dict[int, Camera]:
        out = {}
        for cid, mid, w, h, params, _ in self.conn.execute(
            "SELECT * FROM cameras"
        ):
            name, n_params = CAMERA_MODELS[mid]
            out[cid] = Camera(
                name, int(w), int(h), np.frombuffer(params, np.float64).copy()
            )
        return out
