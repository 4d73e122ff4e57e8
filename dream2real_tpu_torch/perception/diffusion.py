"""Hole inpainting (port of dream2real_tpu/perception/diffusion.py).

The reference inpaints scan holes with Stable Diffusion 2 when a local
checkpoint exists, and with ``cv2.inpaint(..., INPAINT_TELEA)`` otherwise.
No SD-2 weights are in the repository, so the port runs Telea's method
directly (``perception/imgproc.py::inpaint_telea``, OpenCV's arithmetic in
numpy): the reference's result whenever it has no checkpoint. The diffusion
pipeline itself (``txt2img``, ``inpaint`` given a pipeline) raises until
such weights are in the repository, as the segmentor does for SAM.
"""

from __future__ import annotations

import numpy as np

from dream2real_tpu_torch.perception.imgproc import inpaint_telea

_NO_SD2 = ("the Stable Diffusion 2 pipeline is not ported: no SD-2 weights are in the "
           "repository; inpaint() with no pipeline fills holes with Telea's method")


def _auto_mask(img: np.ndarray) -> np.ndarray:
    """White pixels (all channels > 200) are the holes (diffusion.py:24-27)."""
    return np.all(img > 200, axis=-1).astype(np.uint8) * 255


def txt2img(prompt: str):
    raise NotImplementedError(_NO_SD2)


def inpaint(img: np.ndarray, mask: np.ndarray | None = None, pipeline=None, prompt: str = ""):
    """Inpaint holes. img: (H, W, 3) uint8. mask: (H, W), nonzero = inpaint
    (None: the white pixels). -> (H, W, 3) uint8, Telea's fill at radius 3."""
    if pipeline is not None:
        raise NotImplementedError(_NO_SD2)
    img = np.asarray(img)
    if mask is None:
        mask = _auto_mask(img)
    mask = np.asarray(mask).astype(np.uint8)
    return inpaint_telea(img, (mask > 0).astype(np.uint8), 3)
