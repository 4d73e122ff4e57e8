"""The legacy 2D image compositor (port of dream2real_tpu/compositor2d.py):
object crops pasted onto a background crop at normalised 2D positions, the
pre-NeRF baseline path. Host numpy, as in the JAX package.
"""

from __future__ import annotations

import numpy as np


def _ensure_rgba(img: np.ndarray) -> np.ndarray:
    if img.shape[-1] == 4:
        return img.copy()
    a = np.full(img.shape[:2] + (1,), 255, img.dtype)
    return np.concatenate([img, a], axis=-1)


def composite_images(objs, bground_idx: int) -> np.ndarray:
    """objs: ObjectModel2D's (obj_crop (H, W, 3 | 4) uint8, pos (x, y) in
    [-1, 1]); objs[bground_idx] is the background. -> the composite, (H, W,
    4) uint8 RGBA (HWC, not the reference's CHW)."""
    bground = objs[bground_idx]
    others = [o for i, o in enumerate(objs) if i != bground_idx]
    comp = _ensure_rgba(np.asarray(bground.obj_crop))
    bh, bw = comp.shape[:2]

    for obj in others:
        crop = _ensure_rgba(np.asarray(obj.obj_crop))
        ch, cw = crop.shape[:2]
        # Centred, then offset by the normalised position: +x right, +y up,
        # so the row offset is negated.
        tx = int(obj.pos[0] * bw // 2) + (bw // 2 - cw // 2)
        ty = int(-1 * obj.pos[1] * bh // 2) + (bh // 2 - ch // 2)
        x0, y0 = max(tx, 0), max(ty, 0)
        x1, y1 = min(tx + cw, bw), min(ty + ch, bh)
        if x0 >= x1 or y0 >= y1:
            continue
        src = crop[y0 - ty:y1 - ty, x0 - tx:x1 - tx]
        dst = comp[y0:y1, x0:x1]
        opaque = src[..., 3] > 229  # alpha above 0.9 * 255
        dst[..., :3][opaque] = src[..., :3][opaque]
    return comp


def normalise_tensor(x: np.ndarray) -> np.ndarray:
    """Min-max normalisation to [0, 1], in f64."""
    x = np.asarray(x, np.float64).copy()
    x -= x.min()
    x /= max(x.max(), 1e-12)
    return x
