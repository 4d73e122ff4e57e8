"""A PNG codec from the standard library (zlib, struct) and numpy.

The port has no imaging package on the GPU machine, so every image file it
reads or writes goes through here: the scan (``images/``, ``depth/``,
``masks/``), the task fields' RGBA training images, the cached masks and the
grid scorer's renders.

- Decoding reads what PIL (and libpng) write: 8-bit grey, grey + alpha, RGB
  and RGBA, 16-bit grey and RGB(A), every filter type (None, Sub, Up,
  Average, Paeth), no interlace. None and Up run a row at a time, Sub as a
  per-channel running sum mod 256; Average and Paeth depend on the pixel to
  the left as well as the row above, so a batch of same-shaped files is
  decoded together along anti-diagonals of the image (``h + w - 1`` steps,
  each over every frame of the batch at once).
- Encoding writes 8-bit RGB, RGBA and grey and 16-bit grey, with filter
  type 0 on every row unless another is asked for. The pixels read back
  equal PIL's; the bytes are not PIL's (PIL chooses filters row by row).
  zlib releases the interpreter lock while it deflates, so a writer thread
  overlaps the device's work.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Fast deflate: the renders are artifacts, and the writer has to keep up
# with the device.
_ZLIB_LEVEL = 1
# Colour type -> channels (grey, RGB, grey + alpha, RGBA).
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _filter_rows(flat: np.ndarray, bpp: int, ftype: int) -> np.ndarray:
    """Apply one PNG filter type to every row of (h, w * bpp) bytes."""
    x = flat.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]   # left
    b = np.zeros_like(x)
    b[1:] = x[:-1]             # up
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]  # up-left
    pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[ftype]
    return ((x - pred) & 0xFF).astype(np.uint8)


def encode_png(img: np.ndarray, filter_type: int = 0) -> bytes:
    """(H, W, 3) or (H, W, 4) uint8, (H, W) uint8 or (H, W) uint16 -> the
    bytes of a PNG file (RGB, RGBA, grey, 16-bit grey); every row takes
    ``filter_type`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    img = np.ascontiguousarray(img)
    if img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] in (3, 4):
        colour, depth = (2 if img.shape[2] == 3 else 6), 8
        data = img
    elif img.dtype == np.uint8 and img.ndim == 2:
        colour, depth, data = 0, 8, img
    elif img.dtype == np.uint16 and img.ndim == 2:
        colour, depth, data = 0, 16, img.astype(">u2")
    else:
        raise ValueError("encode_png takes (H, W, 3 | 4) uint8, (H, W) uint8 or (H, W) "
                         f"uint16, got {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    flat = data.view(np.uint8).reshape(h, -1)
    rows = np.empty((h, 1 + flat.shape[1]), np.uint8)
    rows[:, 0] = filter_type
    rows[:, 1:] = flat if filter_type == 0 else _filter_rows(
        flat, flat.shape[1] // w, filter_type)
    header = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), _ZLIB_LEVEL)) + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray, filter_type: int = 0) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img, filter_type))


def _parse(data: bytes, name: str):
    """-> ((h, w, channels, bytes per sample), the filtered rows (h, 1 + w * bpp))."""
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos, idat, head = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        tag, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n : pos + 12 + n])
        if crc != zlib.crc32(tag + body) & 0xFFFFFFFF:
            raise ValueError(f"{name}: bad CRC in chunk {tag!r}")
        if tag == b"IHDR":
            w, h, depth, colour, _, _, interlace = struct.unpack(">IIBBBBB", body)
            if colour not in _CHANNELS or depth not in (8, 16) or interlace:
                raise NotImplementedError(
                    f"{name}: colour type {colour}, bit depth {depth}, interlace {interlace}: "
                    "only 8- and 16-bit grey, grey + alpha, RGB and RGBA without interlace "
                    "are read")
            head = (h, w, _CHANNELS[colour], depth // 8)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if head is None:
        raise ValueError(f"{name}: no IHDR chunk")
    h, w, ch, bps = head
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if rows.size != h * (1 + w * ch * bps):
        raise ValueError(f"{name}: {rows.size} bytes of image data for {h} x {w} x {ch * bps}")
    return head, rows.reshape(h, 1 + w * ch * bps)


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor on int16 arrays (left a, up b, up-left c)."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(rows: np.ndarray, w: int, bpp: int) -> np.ndarray:
    """Undo the filters of a batch of images. rows: (F, h, 1 + w * bpp) uint8
    -> (F, h, w, bpp) uint8."""
    f, h = rows.shape[:2]
    ftype = rows[:, :, 0]
    if int(ftype.max(initial=0)) > 4:
        raise ValueError(f"unknown PNG filter type {int(ftype.max())}")
    raw = rows[:, :, 1:].reshape(f, h, w, bpp)
    out = np.empty((f, h, w, bpp), np.uint8)
    if not np.isin(ftype, (3, 4)).any():
        # None, Sub and Up: a row at a time, whole rows at once.
        prev = np.zeros((f, w, bpp), np.uint8)
        for r in range(h):
            t = ftype[:, r, None, None]
            row = raw[:, r]
            sub = np.cumsum(row, axis=1, dtype=np.uint8)  # wraps mod 256
            cur = np.where(t == 1, sub, np.where(t == 2, row + prev, row))
            out[:, r] = cur
            prev = cur
        return out
    # Average and Paeth: along anti-diagonals, where every pixel's left, up
    # and up-left neighbours are already decoded.
    dec = np.zeros((f, h + 1, w + 1, bpp), np.int16)  # a zero row and column in front
    raw16 = raw.astype(np.int16)
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        x = d - r
        t = ftype[:, r][..., None]
        cur = raw16[:, r, x]
        a = dec[:, r + 1, x]       # left
        b = dec[:, r, x + 1]       # up
        c = dec[:, r, x]           # up-left
        pred = np.where(t == 1, a, np.where(t == 2, b, np.where(
            t == 3, (a + b) >> 1, np.where(t == 4, _paeth(a, b, c), 0))))
        dec[:, r + 1, x + 1] = (cur + pred) & 0xFF
    out[:] = dec[:, 1:, 1:]
    return out


def _samples(px: np.ndarray, head) -> np.ndarray:
    """(F, h, w, bpp) bytes -> (F, h, w) or (F, h, w, C) samples."""
    f = px.shape[0]
    h, w, ch, bps = head
    if bps == 2:
        px = px.reshape(f, h, w * ch * 2).view(">u2").astype(np.uint16)
    px = px.reshape(f, h, w, ch)
    return px[..., 0] if ch == 1 else px


def decode_pngs(blobs: list[bytes], names: list[str] | None = None) -> np.ndarray:
    """Decode PNG files of one shape and format together -> (F, H, W) or
    (F, H, W, C), uint8 or uint16 as the files hold them."""
    names = names or [f"<png {i}>" for i in range(len(blobs))]
    parsed = [_parse(b, n) for b, n in zip(blobs, names)]
    head = parsed[0][0]
    for (hd, _), n in zip(parsed, names):
        if hd != head:
            raise ValueError(f"{n}: {hd} differs from {names[0]}: {head}")
    h, w, ch, bps = head
    rows = np.stack([r for _, r in parsed])
    return _samples(_unfilter(rows, w, ch * bps), head)


def read_pngs(paths, group: int = 16) -> np.ndarray:
    """Read PNG files of one shape and format as one batch (see decode_pngs),
    decoded ``group`` files at a time to bound the decoder's scratch."""
    paths = [str(p) for p in paths]
    parts = []
    for s in range(0, len(paths), group):
        blobs = []
        for p in paths[s : s + group]:
            with open(p, "rb") as f:
                blobs.append(f.read())
        parts.append(decode_pngs(blobs, paths[s : s + group]))
    return np.concatenate(parts)


def read_png(path: str) -> np.ndarray:
    """Read one PNG file -> (H, W) grey or (H, W, C), uint8 or uint16."""
    return read_pngs([path])[0]


def to_rgb(img: np.ndarray) -> np.ndarray:
    """A decoded 8-bit image as (H, W, 3), as PIL's ``convert("RGB")`` makes
    it: grey repeated, the alpha channel dropped."""
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    if img.shape[-1] == 2:
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])
