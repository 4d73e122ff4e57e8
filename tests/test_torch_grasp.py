"""The 2D compositor and the grasp math of the port against the JAX
package's on the CPU: ``compositor2d.composite_images`` identical, with
crops that fall off every edge of the background (and wholly outside it),
RGB and RGBA, alpha around the 0.9 cut; ``normalise_tensor`` identical; the
grasp functions to 1e-9 (the same f64 numpy); ``patch_up_depth`` (the
port's Navier-Stokes inpainting, ``perception/imgproc.py::inpaint_ns``)
against the JAX function, which calls cv2.inpaint(..., INPAINT_NS), on depth
maps with zero and NaN holes: identical (tolerance 0; the port repeats
OpenCV's f32 arithmetic, see tests/test_torch_inpaint.py)."""

import zlib

import numpy as np
import pytest

from dream2real_tpu import compositor2d as jcomp
from dream2real_tpu import grasp as jgrasp
from dream2real_tpu.scene_model import ObjectModel2D as JObject
from dream2real_tpu_torch import compositor2d as tcomp
from dream2real_tpu_torch import grasp as tgrasp
from dream2real_tpu_torch.scene_model import ObjectModel2D as TObject


def test_composite_images_mirror():
    """tests/test_perception_misc.py::test_composite_images on the port."""
    bg = np.full((40, 40, 3), 100, np.uint8)
    obj = np.zeros((10, 10, 4), np.uint8)
    obj[..., 0] = 200
    obj[..., 3] = 255
    out = tcomp.composite_images([TObject("bg", bg, None, (0, 0), None),
                                  TObject("o", obj, None, (0.0, 0.0), None)], 0)
    assert out.shape == (40, 40, 4)
    assert out[20, 20, 0] == 200 and out[2, 2, 0] == 100
    out2 = tcomp.composite_images([TObject("bg", bg, None, (0, 0), None),
                                   TObject("o", obj, None, (0.5, 0.5), None)], 0)
    assert out2[10, 30, 0] == 200
    np.testing.assert_allclose(tcomp.normalise_tensor(np.array([2.0, 4.0, 6.0])), [0, 0.5, 1.0])


@pytest.mark.parametrize("seed", range(4))
def test_composite_images_matches_jax(seed):
    rng = np.random.default_rng(seed)
    bh, bw = rng.integers(20, 48, 2)
    bg = rng.integers(0, 256, (bh, bw, 3 + seed % 2), dtype=np.uint8)
    # Positions that push a crop off the left, right, top and bottom edges,
    # past a corner, wholly outside, and inside.
    positions = [(-1.3, 0.0), (1.3, 0.0), (0.0, 1.3), (0.0, -1.3), (1.1, 1.2), (-1.2, -1.1),
                 (3.0, 0.0), (0.0, -3.0), tuple(rng.uniform(-1, 1, 2))]
    objs_t, objs_j = [TObject("bg", bg, None, (0, 0), None)], [JObject("bg", bg, None, (0, 0), None)]
    for k, pos in enumerate(positions):
        ch, cw = rng.integers(3, 30, 2)
        crop = rng.integers(0, 256, (ch, cw, 4 if k % 3 else 3), dtype=np.uint8)
        if crop.shape[-1] == 4:
            crop[..., 3] = rng.choice([0, 229, 230, 255], (ch, cw))
        objs_t.append(TObject(f"o{k}", crop, None, pos, None))
        objs_j.append(JObject(f"o{k}", crop, None, pos, None))
    for bg_idx in (0, 3):
        got = tcomp.composite_images(objs_t, bg_idx)
        want = jcomp.composite_images(objs_j, bg_idx)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    x = rng.normal(size=(7, 5)) * 3
    np.testing.assert_array_equal(tcomp.normalise_tensor(x), jcomp.normalise_tensor(x))
    np.testing.assert_array_equal(tcomp.normalise_tensor(np.ones(4)), jcomp.normalise_tensor(np.ones(4)))


def test_grasp_math_mirror():
    """tests/test_perception_misc.py::test_grasp_math on the port."""
    T = tgrasp.get_grasp_pose(np.array([0.1, 0.2, 0.3]), np.array([0, 0, 1.0]))
    np.testing.assert_allclose(T[:3, 2], [0, 0, -1], atol=1e-9)
    np.testing.assert_allclose(T[:3, 3], [0.1, 0.2, 0.3])
    np.testing.assert_allclose(T[:3, :3] @ T[:3, :3].T, np.eye(3), atol=1e-9)
    T2 = tgrasp.rotate_grasp_about_normal(T, np.array([0, 0, 1.0]), 90)
    np.testing.assert_allclose(T2[:3, 3], T[:3, 3])
    assert abs(tgrasp.normalise_angle(270) - (-90)) < 1e-9
    depth = np.full((20, 20), 0.8, np.float32)
    depth[5, 5] = 0
    assert tgrasp.patch_up_depth(depth)[5, 5] > 0.5
    K = np.array([[20.0, 0, 10], [0, 20.0, 10], [0, 0, 1.0]])
    pose, normal = tgrasp.get_grasp_pose_from_pix(10, 10, np.full((20, 20), 0.5, np.float32), K,
                                                  np.eye(4))
    np.testing.assert_allclose(pose[:3, 3], [0, 0, 0.5], atol=1e-6)
    np.testing.assert_allclose(normal, [0, 0, 1])
    with pytest.raises(ValueError, match="zero depth"):
        tgrasp.get_grasp_pose_from_pix(5, 5, depth, K, np.eye(4))


def test_grasp_functions_match_jax(rng):
    tol = dict(atol=1e-9, rtol=0)
    normals = rng.normal(size=(16, 3))
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    normals[0] = [0, 1.0, 0]  # the pseudo-up switch
    normals[1] = [0, -0.995, 0.0998]
    for n in normals:
        pos = rng.normal(size=3)
        T = tgrasp.get_grasp_pose(pos, n)
        np.testing.assert_allclose(T, jgrasp.get_grasp_pose(pos, n), **tol)
        ang = rng.uniform(-400, 400)
        np.testing.assert_allclose(tgrasp.rotate_grasp_about_normal(T, n, ang),
                                   jgrasp.rotate_grasp_about_normal(T, n, ang), **tol)
    angles = rng.uniform(-1000, 1000, 50)
    np.testing.assert_allclose(tgrasp.normalise_angle(angles), jgrasp.normalise_angle(angles), **tol)
    depth = rng.uniform(0.3, 1.5, (24, 32)).astype(np.float32)
    K = np.array([[30.0, 0, 16], [0, 31.0, 12], [0, 0, 1.0]])
    cam = np.eye(4)
    cam[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    cam[:3, 3] = rng.normal(size=3)
    for row, col in ((0, 0), (12, 16), (23, 31), (7, 3)):
        got, got_n = tgrasp.get_grasp_pose_from_pix(row, col, depth, K, cam)
        want, want_n = jgrasp.get_grasp_pose_from_pix(row, col, depth, K, cam)
        np.testing.assert_allclose(got, want, **tol)
        np.testing.assert_array_equal(got_n, want_n)


def _depth_with_holes(rng, h, w, kind):
    yy, xx = np.mgrid[:h, :w]
    depth = (0.6 + 0.3 * np.sin(xx / 7.0) * np.cos(yy / 5.0) + 0.01 * rng.normal(size=(h, w)))
    depth = depth.astype(np.float32)
    holes = rng.random((h, w)) < 0.04
    for _ in range(3):
        y, x = rng.integers(0, h), rng.integers(0, w)
        holes[max(y - 3, 0):y + 4, max(x - 5, 0):x + 2] = True
    holes[0, :6] = holes[-2:, -3:] = True  # on the border
    if kind == "zero":
        depth[holes] = 0
    elif kind == "nan":
        depth[holes] = np.nan
    else:
        depth[holes] = np.where(rng.random(holes.sum()) < 0.5, 0.0, np.nan)
    return depth


@pytest.mark.parametrize("kind", ["zero", "nan", "both"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_patch_up_depth_matches_jax(kind, dtype):
    rng = np.random.default_rng(zlib.crc32(f"{kind}{np.dtype(dtype).name}".encode()))
    depth = _depth_with_holes(rng, 30, 44, kind).astype(dtype)
    got = tgrasp.patch_up_depth(depth)
    want = jgrasp.patch_up_depth(depth)
    assert got.dtype == want.dtype == dtype
    hole = np.isnan(depth) | (depth == 0)
    assert hole.sum() > 40 and np.isfinite(got).all()
    # A NaN sample next to a hole spreads through OpenCV's clamped border
    # reads in both packages, and the NaN left is set to 0; zero holes fill.
    assert kind != "zero" or (got[hole] > 0).all()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[~hole], depth[~hole])
