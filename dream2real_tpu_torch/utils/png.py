"""A PNG writer (and a reader of what it writes) from the standard library.

The grid scorer saves ``cb_render/cb_rgb_%04d.png`` and
``best_render.png`` with it, so the port needs no imaging package on the GPU
machine. 8-bit RGB, no interlace, filter type 0 on every row; zlib releases
the interpreter lock while it deflates, so a writer thread overlaps the
device's work.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Fast deflate: the renders are artifacts, and the writer has to keep up
# with the device.
_ZLIB_LEVEL = 1


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> the bytes of a PNG file."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_png takes (H, W, 3) uint8, got {img.shape} {img.dtype}")
    h, w, _ = img.shape
    rows = np.empty((h, 1 + 3 * w), np.uint8)
    rows[:, 0] = 0  # filter type None
    rows[:, 1:] = img.reshape(h, 3 * w)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit truecolour
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), _ZLIB_LEVEL)) + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit RGB, non-interlaced PNG whose rows use filter type 0
    (what ``write_png`` writes) -> (H, W, 3) uint8. Any other PNG raises."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, shape = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        tag, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n : pos + 12 + n])
        if crc != zlib.crc32(tag + body) & 0xFFFFFFFF:
            raise ValueError(f"{path}: bad CRC in chunk {tag!r}")
        if tag == b"IHDR":
            w, h, depth, colour, _, _, interlace = struct.unpack(">IIBBBBB", body)
            if (depth, colour, interlace) != (8, 2, 0):
                raise NotImplementedError(f"{path}: only 8-bit RGB without interlace is read")
            shape = (h, w)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    if shape is None:
        raise ValueError(f"{path}: no IHDR chunk")
    h, w = shape
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise NotImplementedError(f"{path}: only filter type 0 rows are read")
    return rows[:, 1:].reshape(h, w, 3).copy()
