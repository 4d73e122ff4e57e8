"""Small vis helpers (port of dream2real_tpu/vis/utils.py): the pastel
palette, an instance-mask overlay and ``visimg``, which writes through the
port's PNG codec (utils/png.py): the same pixels as PIL's file, other
bytes."""

from __future__ import annotations

import numpy as np

from dream2real_tpu_torch.utils.png import write_png

# The reference's object palette (vis_utils.py:15-26).
pastel_colors = np.array(
    [
        [255, 179, 186],
        [255, 223, 186],
        [255, 255, 186],
        [186, 255, 201],
        [186, 225, 255],
        [201, 186, 255],
        [255, 186, 255],
        [255, 186, 201],
        [186, 255, 255],
        [222, 186, 255],
    ]
)


def visimg(img, path: str | None = None):
    """Save (or return) an array as an 8-bit image: floats in [0, 1] are
    scaled to 0-255, other values cast."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        scaled = arr.max() <= 1.0
        arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8) if scaled else arr.astype(np.uint8)
    if path is not None:
        write_png(path, arr)
    return arr


def seg_overlay(rgb: np.ndarray, mask: np.ndarray, alpha: float = 0.5) -> np.ndarray:
    """Colour an instance mask over an RGB image (ids 0 and 255 left bare)."""
    out = rgb.astype(np.float32).copy()
    for idx in np.unique(mask):
        if idx in (0, 255):
            continue
        col = pastel_colors[idx % len(pastel_colors)]
        sel = mask == idx
        out[sel] = (1 - alpha) * out[sel] + alpha * col
    return out.astype(np.uint8)
