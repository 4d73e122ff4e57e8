"""Hole inpainting against OpenCV and the JAX package, on the CPU.

``perception/imgproc.py::inpaint_telea`` against ``cv2.inpaint(img, mask,
radius, cv2.INPAINT_TELEA)`` on blocks, scattered single pixels, holes on
the image border and thin bands, one and three channels, radii 1-5: every
pixel identical, inside the holes as outside (the bound measured is 0
levels). ``inpaint_ns`` against ``cv2.inpaint(..., cv2.INPAINT_NS)`` on the
same mask families and radii 1-5: uint8 with one and three channels
identical (no tie was met: OpenCV's mean is an f64 division of f32 sums,
which the port repeats in the same order, and both round half to even), and
float32 single-channel images (what ``grasp.patch_up_depth`` passes, at
depth, 8-bit and wide value ranges) identical too, tolerance 0, NaN samples
included: OpenCV reads the column to the right of a sample in the first
column for its isophote, a hole pixel there spreads its NaN, and the port
reads the same pixel. ``perception/diffusion.py::inpaint`` against the JAX package's
``inpaint`` with no checkpoint, which falls back on cv2's Telea; the
engine's ``inpaint_images`` under ``inpaint_holes``.
"""

import zlib

import cv2
import numpy as np
import pytest
import torch

from dream2real_tpu.perception import diffusion as jdiff
from dream2real_tpu_torch.perception import diffusion as tdiff
from dream2real_tpu_torch.perception.imgproc import inpaint_ns, inpaint_telea

torch.set_num_threads(2)


def _image(rng, h, w, c):
    img = (rng.random((h, w, c)) * 255).astype(np.uint8)
    return cv2.GaussianBlur(img, (7, 7), 0).reshape(h, w, c)


def _mask(rng, h, w, kind):
    m = np.zeros((h, w), np.uint8)
    if kind == "blocks":
        for _ in range(4):
            y, x = rng.integers(0, h), rng.integers(0, w)
            m[max(y - 4, 0):y + 5, max(x - 6, 0):x + 4] = 255
    elif kind == "scatter":
        m[rng.random((h, w)) < 0.05] = 1
    elif kind == "border":
        m[:3, rng.integers(0, w - 8):][:, :8] = 7
        m[-4:, :5] = 1
        m[rng.integers(0, h - 6):][:6, -2:] = 1
    elif kind == "band":
        m[h // 2:h // 2 + 3, :] = 1
        m[rng.random((h, w)) < 0.01] = 1
    return m


@pytest.mark.parametrize("kind", ["blocks", "scatter", "border", "band"])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("radius", [1, 3, 5])
def test_inpaint_telea_matches_opencv(kind, channels, radius):
    rng = np.random.default_rng(zlib.crc32(f"{kind}{channels}{radius}".encode()))
    h, w = 36, 48
    img = _image(rng, h, w, channels)
    mask = _mask(rng, h, w, kind)
    src = img[..., 0] if channels == 1 else img
    want = cv2.inpaint(src, mask, radius, cv2.INPAINT_TELEA)
    got = inpaint_telea(src, mask, radius)
    assert got.shape == want.shape and got.dtype == np.uint8
    hole = mask != 0
    np.testing.assert_array_equal(got[~hole], src[~hole])  # outside: untouched
    np.testing.assert_array_equal(got[hole], want[hole])   # inside: OpenCV's fill
    assert hole.sum() > 0


@pytest.mark.parametrize("kind", ["blocks", "scatter", "border", "band"])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("radius", [1, 2, 3, 4, 5])
def test_inpaint_ns_matches_opencv(kind, channels, radius):
    rng = np.random.default_rng(zlib.crc32(f"ns{kind}{channels}{radius}".encode()))
    h, w = 36, 48
    img = _image(rng, h, w, channels)
    mask = _mask(rng, h, w, kind)
    src = img[..., 0] if channels == 1 else img
    want = cv2.inpaint(src, mask, radius, cv2.INPAINT_NS)
    got = inpaint_ns(src, mask, radius)
    assert got.shape == want.shape and got.dtype == np.uint8
    hole = mask != 0
    np.testing.assert_array_equal(got[~hole], src[~hole])
    np.testing.assert_array_equal(got[hole], want[hole])
    assert hole.sum() > 0


@pytest.mark.parametrize("kind", ["blocks", "scatter", "border", "band"])
@pytest.mark.parametrize("scale", ["depth", "u8", "wide", "nan"])
@pytest.mark.parametrize("radius", [1, 3, 5])
def test_inpaint_ns_matches_opencv_f32(kind, scale, radius):
    rng = np.random.default_rng(zlib.crc32(f"ns32{kind}{scale}{radius}".encode()))
    h, w = 36, 48
    img = _image(rng, h, w, 1)[..., 0].astype(np.float32)
    img = {"depth": 0.4 + img / 255 * 1.2, "u8": img, "wide": (img - 100) * 37.3,
           "nan": 0.4 + img / 255 * 1.2}[scale].astype(np.float32)
    mask = _mask(rng, h, w, kind)
    if scale == "nan":
        img[mask != 0] = np.nan
    want = cv2.inpaint(img, mask, radius, cv2.INPAINT_NS)
    got = inpaint_ns(img, mask, radius)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)  # NaN where OpenCV's is NaN
    assert np.isfinite(got[mask == 0]).all()


def test_inpaint_matches_jax_without_a_checkpoint():
    rng = np.random.default_rng(7)
    img = _image(rng, 40, 56, 3)
    img[10:16, 20:30] = 255  # white holes: the auto mask
    img[30, 5:40] = 250
    np.testing.assert_array_equal(tdiff._auto_mask(img), jdiff._auto_mask(img))
    np.testing.assert_array_equal(tdiff.inpaint(img), jdiff.inpaint(img))
    mask = _mask(rng, 40, 56, "blocks").astype(np.int64) * 3  # nonzero = inpaint
    np.testing.assert_array_equal(tdiff.inpaint(img, mask), jdiff.inpaint(img, mask))


def test_diffusion_pipeline_is_not_ported():
    with pytest.raises(NotImplementedError, match="SD-2"):
        tdiff.txt2img("a red box")
    with pytest.raises(NotImplementedError, match="SD-2"):
        tdiff.inpaint(np.zeros((4, 4, 3), np.uint8), pipeline=object())


def test_engine_inpaints_the_frames(tmp_path):
    """inpaint_images under the flag, and no change without it."""
    import json
    import os

    from dream2real_tpu_torch.cfg import Config
    from dream2real_tpu_torch.engine import ImaginationEngine

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    raw = json.load(open(os.path.join(root, "configs", "synth_demo.json")))
    raw["engine"]["inpaint_holes"] = True
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(raw))
    rng = np.random.default_rng(8)
    frames = np.stack([_image(rng, 24, 32, 3) for _ in range(2)])
    frames[:, 5:9, 10:14] = 255
    eng = ImaginationEngine(Config(str(path), str(tmp_path)), device="cpu")
    out = eng.inpaint_images(frames)
    for f, o in zip(frames, out):
        np.testing.assert_array_equal(o, jdiff.inpaint(f))
    assert "inpaint_holes" in eng.stage_timer.stages
    eng.inpaint_holes = False
    np.testing.assert_array_equal(eng.inpaint_images(frames), frames)
