"""ctypes bindings of the native runtime (``d2r_native.cpp``, the port's
copy of the JAX package's): the PNG codec and the RGB-D dataset ingest.

The library is built at first use (``build.load_native``); a build that
fails raises. The functions return None (``png_write`` False) for a file the
native codec does not take: a palette or interlaced PNG, a frame of another
size or channel count; the caller then decodes with ``utils/png.py`` and
says so.
"""

from __future__ import annotations

import ctypes

import numpy as np

from dream2real_tpu_torch import build

_c_int_p = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "d2r_png_info_file": ([ctypes.c_char_p, _c_int_p, _c_int_p, _c_int_p, _c_int_p],
                          ctypes.c_int),
    "d2r_png_decode_file": ([ctypes.c_char_p, ctypes.c_void_p, ctypes.c_long], ctypes.c_int),
    "d2r_png_encode_file": ([ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int, ctypes.c_int], ctypes.c_long),
    "d2r_load_rgbd_dataset": ([ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int),
}


_TYPED: list[ctypes.CDLL] = []


def get_lib() -> ctypes.CDLL:
    """The native library with its argument types set, built if needed."""
    if not _TYPED:
        lib = build.load_native()
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        _TYPED.append(lib)
    return _TYPED[0]


def _buf(arr: np.ndarray) -> ctypes.c_void_p:
    return arr.ctypes.data_as(ctypes.c_void_p)


def png_read(path: str) -> np.ndarray | None:
    """Decode a PNG: 8-bit -> uint8 (H, W[, C]); 16-bit grey -> uint16 (H,
    W). None for a file the native codec does not take."""
    lib = get_lib()
    w, h, ch, bd = (ctypes.c_int() for _ in range(4))
    if lib.d2r_png_info_file(path.encode(), w, h, ch, bd) != 0:
        return None
    dtype = np.uint16 if bd.value == 16 else np.uint8
    shape = (h.value, w.value) if ch.value == 1 else (h.value, w.value, ch.value)
    out = np.empty(shape, dtype)
    rc = lib.d2r_png_decode_file(path.encode(), _buf(out), out.nbytes)
    return out if rc == 0 else None


def png_write(path: str, arr: np.ndarray) -> bool:
    """Encode (H, W) uint8 / uint16 or (H, W, 3 | 4) uint8 with filter 0 on
    every row. False for another dtype or shape."""
    lib = get_lib()
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint16:
        bd, ch = 16, 1
        if arr.ndim != 2:
            return False
    elif arr.dtype == np.uint8:
        bd = 8
        ch = 1 if arr.ndim == 2 else arr.shape[2]
    else:
        return False
    rc = lib.d2r_png_encode_file(path.encode(), _buf(arr), arr.shape[1], arr.shape[0], ch, bd)
    return rc > 0


def load_rgbd_dataset(dir_path: str, n: int, height: int, width: int):
    """Decode ``dir/images/rgb_%04d.png`` (8-bit RGB) and
    ``dir/depth/depth_%04d.png`` (16-bit millimetres) for n frames in one
    call. -> (rgb uint8 (N, H, W, 3), depth f32 metres (N, H, W)), or None
    when a frame is not of that format and size."""
    lib = get_lib()
    rgb = np.empty((n, height, width, 3), np.uint8)
    depth = np.empty((n, height, width), np.float32)
    if lib.d2r_load_rgbd_dataset(dir_path.encode(), n, height, width, _buf(rgb), _buf(depth)):
        return None
    return rgb, depth
