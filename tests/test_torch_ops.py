"""Geometry, camera, image, sampling and smoothing ops of the port against
the JAX package on the same seeded inputs (f32, tolerance 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dream2real_tpu import sampling as jsampling
from dream2real_tpu import smoothing as jsmoothing
from dream2real_tpu.nerf import render as jrender
from dream2real_tpu.ops import cameras as jcam
from dream2real_tpu.ops import image as jimg
from dream2real_tpu.ops import se3 as jse3
from dream2real_tpu_torch import sampling as tsampling
from dream2real_tpu_torch import smoothing as tsmoothing
from dream2real_tpu_torch.nerf import render as trender
from dream2real_tpu_torch.ops import cameras as tcam
from dream2real_tpu_torch.ops import image as timg
from dream2real_tpu_torch.ops import se3 as tse3

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _poses(rng, n):
    eul = rng.uniform(-np.pi, np.pi, size=(n, 3)).astype(np.float32)
    R = np.asarray(jse3.euler_angles_to_matrix(jnp.asarray(eul)))
    T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    T[:, :3, :3] = R
    T[:, :3, 3] = rng.normal(size=(n, 3)).astype(np.float32)
    return eul, T


def test_se3_parity():
    rng = np.random.default_rng(0)
    eul, T = _poses(rng, 16)
    np.testing.assert_allclose(
        tse3.euler_angles_to_matrix(torch.from_numpy(eul)).numpy(),
        np.asarray(jse3.euler_angles_to_matrix(jnp.asarray(eul))), **TOL)
    np.testing.assert_allclose(tse3.pose_inverse(torch.from_numpy(T)).numpy(),
                               np.asarray(jse3.pose_inverse(jnp.asarray(T))), **TOL)
    _, T1 = _poses(rng, 1)
    _, C1 = _poses(rng, 1)
    ref = jse3.convert_virtual_pose(jnp.asarray(T1[0]), jnp.asarray(T), jnp.asarray(C1[0]))
    out = tse3.convert_virtual_pose(torch.from_numpy(T1[0]), torch.from_numpy(T),
                                    torch.from_numpy(C1[0]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("distortion", [None, (-0.12, 0.03, 0.0008, -0.0006, 0.0, 0.0)])
def test_pixel_dirs_parity(distortion):
    K = np.array([[52.0, 0, 31.5], [0, 51.0, 24.0], [0, 0, 1.0]])
    ref = jcam.pixel_dirs(48, 64, jnp.asarray(K),
                          None if distortion is None else jnp.asarray(distortion, jnp.float32))
    out = tcam.pixel_dirs(48, 64, K, distortion, device="cpu")
    assert out.shape == (48, 64, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_image_ops_parity():
    rng = np.random.default_rng(1)
    x = rng.uniform(-0.1, 1.2, size=(3, 20, 24)).astype(np.float32)
    np.testing.assert_allclose(timg.linear_to_srgb(torch.from_numpy(x)).numpy(),
                               np.asarray(jimg.linear_to_srgb(jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(timg.gaussian_blur(torch.from_numpy(x), 3, 0.7).numpy(),
                               np.asarray(jimg.gaussian_blur(jnp.asarray(x), 3, 0.7)), **TOL)
    im = rng.uniform(size=(30, 40, 3)).astype(np.float32)
    sq = timg.center_crop_square(torch.from_numpy(im))
    np.testing.assert_array_equal(sq.numpy(), np.asarray(jimg.center_crop_square(jnp.asarray(im))))
    np.testing.assert_allclose(
        timg.resize_image(sq, (16, 16)).numpy(),
        np.asarray(jimg.resize_image(jimg.center_crop_square(jnp.asarray(im)), (16, 16))), **TOL)


def test_rot90_orientation():
    """The renders reach CLIP rotated like np.rot90(k=1) over (H, W)."""
    x = np.arange(2 * 5 * 7 * 3, dtype=np.uint8).reshape(2, 5, 7, 3)
    np.testing.assert_array_equal(
        torch.rot90(torch.from_numpy(x), k=1, dims=(1, 2)).numpy(),
        np.asarray(jnp.rot90(jnp.asarray(x), k=1, axes=(1, 2))))


@pytest.mark.parametrize("scene_type,res", [(0, (5, 4, 3, 1, 1, 1)), (1, (3, 2, 2, 2, 3, 2)),
                                            (3, (16, 32, 1, 1, 1, 1))])
def test_sample_poses_grid_bit_equal(scene_type, res):
    centre = (0.5, 0.0, 0.05)
    np.testing.assert_array_equal(
        tsampling.sample_poses_grid(centre, res, scene_type=scene_type),
        np.asarray(jsampling.sample_poses_grid(centre, res, scene_type=scene_type)))


def test_smoothing_parity():
    rng = np.random.default_rng(2)
    res = (6, 5, 2, 1, 1, 1)
    s = rng.uniform(0.5, 1.5, size=int(np.prod(res))).astype(np.float32)
    s[rng.random(s.shape) < 0.2] = 0.0  # invalid poses stay zero
    ref = np.asarray(jsmoothing.spatially_smooth_heatmap(jnp.asarray(s), res))
    out = tsmoothing.spatially_smooth_heatmap(torch.from_numpy(s), res).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    assert (out[s == 0] == 0).all()
    assert int(out.argmax()) == int(ref.argmax())


def test_sample_pdf_and_composite_parity():
    rng = np.random.default_rng(3)
    ts = np.sort(rng.uniform(0.1, 2.0, size=(64, 16)), axis=-1).astype(np.float32)
    w = rng.exponential(size=(64, 16)).astype(np.float32)
    np.testing.assert_allclose(
        trender.sample_pdf(torch.from_numpy(ts), torch.from_numpy(w), 12).numpy(),
        np.asarray(jrender.sample_pdf(jnp.asarray(ts), jnp.asarray(w), 12)), **TOL)
    sigma = rng.exponential(size=(64, 16)).astype(np.float32) * 5
    rgb = rng.uniform(size=(64, 16, 3)).astype(np.float32)
    dn = rng.uniform(1.0, 1.5, size=64).astype(np.float32)
    ref = jrender._composite(jnp.asarray(sigma), jnp.asarray(rgb), jnp.asarray(ts),
                             jnp.asarray(dn), 1e-4)
    out = trender._composite(torch.from_numpy(sigma), torch.from_numpy(rgb),
                             torch.from_numpy(ts), torch.from_numpy(dn), 1e-4)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)


def test_rectify_depth_and_mask_parity():
    rng = np.random.default_rng(4)
    depth = rng.uniform(0.2, 2.0, size=(36, 64)).astype(np.float32)
    mask = (rng.random((36, 64)) > 0.3)
    np.testing.assert_allclose(timg.rectify_depth(torch.from_numpy(depth), 24).numpy(),
                               np.asarray(jimg.rectify_depth(jnp.asarray(depth), 24)), **TOL)
    out = timg.rectify_mask(torch.from_numpy(mask), 24).numpy()
    ref = np.asarray(jimg.rectify_mask(jnp.asarray(mask), 24))
    assert out.shape == (24, 24)
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_array_equal(out == 0, ref == 0)


def test_rays_project_and_cartesian_parity():
    rng = np.random.default_rng(5)
    _, T = _poses(rng, 3)
    K = np.array([[52.0, 0, 31.5], [0, 51.0, 24.0], [0, 0, 1.0]], np.float32)
    jdirs = jcam.pixel_dirs(6, 8, jnp.asarray(K))
    tdirs = tcam.pixel_dirs(6, 8, K, device="cpu")
    jo, jd = jcam.rays_from_pose(jnp.asarray(T), jdirs)
    to, td = tcam.rays_from_pose(torch.from_numpy(T), tdirs)
    assert to.shape == (3, 1, 1, 3) and td.shape == (3, 6, 8, 3)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
    pts = rng.normal(size=(5, 7, 3)).astype(np.float32)
    juv, jz = jcam.project_points(jnp.asarray(pts), jnp.asarray(T[0]), jnp.asarray(K))
    tuv, tz = tcam.project_points(torch.from_numpy(pts), torch.from_numpy(T[0]),
                                  torch.from_numpy(K))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tuv.numpy(), np.asarray(juv), atol=1e-3, rtol=1e-4)
    axes = [rng.normal(size=n).astype(np.float32) for n in (2, 3, 1, 2, 1, 3)]
    np.testing.assert_array_equal(
        tse3.cartesian_prod_6([torch.from_numpy(a) for a in axes]).numpy(),
        np.asarray(jse3.cartesian_prod_6([jnp.asarray(a) for a in axes])))
    np.testing.assert_array_equal(
        tse3.cartesian_prod_6([torch.from_numpy(a) for a in axes]).numpy(),
        torch.cartesian_prod(*[torch.from_numpy(a) for a in axes]).numpy())
    cams = [np.eye(4) * i for i in range(4)]
    np.testing.assert_array_equal(tsampling.get_virtual_cam_poses(cams, [2, 0]),
                                  jsampling.get_virtual_cam_poses(cams, [2, 0]))
