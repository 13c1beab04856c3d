"""8-bit RGB PNG files without an image library (the card's machine has no
imageio): a writer on zlib, struct and crc32, and a reader of what it
writes (non-interlaced 8-bit RGB, every scanline unfiltered)."""
from __future__ import annotations

import binascii
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", binascii.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray) -> None:
    """Write an [H, W, 3] uint8 image (every row with filter 0)."""
    img = np.ascontiguousarray(image)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_png takes [H, W, 3] uint8, got {img.shape} {img.dtype}")
    h, w, _ = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """An unfiltered 8-bit RGB PNG (what write_png writes) as [H, W, 3] uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype != 2 or interlace:
        raise ValueError(f"{path}: only non-interlaced 8-bit RGB is read (bit depth "
                         f"{depth}, colour type {ctype}, interlace {interlace})")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * 3)
    if raw[:, 0].any():
        raise ValueError(f"{path}: scanline filters other than 0 are not read")
    return raw[:, 1:].reshape(h, w, 3).copy()
