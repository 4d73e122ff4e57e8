"""The port's quaternion and camera-convention helpers
(``ops/se3.py::matrix_to_quaternion``, ``quaternion_to_matrix``,
``accio_to_ngp``) against the JAX package's on the same seeded inputs, f32,
to 1e-6; the round trips of tests/test_se3.py; and the four branches of
``matrix_to_quaternion``, near trace -1 included (rotations by up to
pi - 1e-3, where the w candidate is the worst and an x, y or z candidate is
taken)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

from dream2real_tpu.ops import se3 as jse3
from dream2real_tpu_torch.ops import se3 as tse3

torch.set_num_threads(1)
TOL = dict(atol=1e-6, rtol=0)


def _quat_t(m: np.ndarray) -> np.ndarray:
    return tse3.matrix_to_quaternion(torch.from_numpy(m)).numpy()


def _quat_j(m: np.ndarray) -> np.ndarray:
    return np.asarray(jse3.matrix_to_quaternion(jnp.asarray(m)))


def test_matrix_to_quaternion_roundtrip_and_jax(rng):
    eulers = rng.uniform(-np.pi, np.pi, size=(128, 3)).astype(np.float32)
    mats = tse3.euler_angles_to_matrix(torch.from_numpy(eulers), "XYZ").numpy()
    q = _quat_t(mats)
    ref = R.from_matrix(mats.astype(np.float64)).as_quat()  # xyzw
    ref_wxyz = np.concatenate([ref[:, 3:4], ref[:, :3]], axis=1)
    ref_wxyz *= np.where(ref_wxyz[:, :1] < 0, -1.0, 1.0)
    np.testing.assert_allclose(q, ref_wxyz, atol=1e-4)
    np.testing.assert_allclose(q, _quat_j(mats), **TOL)


@pytest.mark.parametrize("axis", [0, 1, 2, None])
def test_matrix_to_quaternion_near_trace_minus_one(rng, axis):
    """Rotations by pi - [1e-3, 0.05] about an axis near x, y or z (or any
    axis): trace near -1, so the x, y or z candidate is taken; the result
    equals the JAX package's to 1e-6 and the canonical sign is w >= 0."""
    n = 64
    if axis is None:
        axes = rng.normal(size=(n, 3))
    else:
        axes = rng.normal(scale=0.05, size=(n, 3))
        axes[:, axis] = 1.0
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    ang = np.pi - rng.uniform(1e-3, 0.05, size=(n, 1))
    mats = R.from_rotvec(axes * ang).as_matrix().astype(np.float32)
    assert np.all(np.trace(mats, axis1=1, axis2=2) < -0.99)
    q = _quat_t(mats)
    best = np.argmax(np.sqrt(np.maximum(np.stack([
        1 + mats[:, 0, 0] + mats[:, 1, 1] + mats[:, 2, 2],
        1 + mats[:, 0, 0] - mats[:, 1, 1] - mats[:, 2, 2],
        1 - mats[:, 0, 0] + mats[:, 1, 1] - mats[:, 2, 2],
        1 - mats[:, 0, 0] - mats[:, 1, 1] + mats[:, 2, 2]], -1), 0)), -1)
    assert 0 not in best and (axis is None or np.all(best == axis + 1))
    np.testing.assert_allclose(q, _quat_j(mats), **TOL)
    assert np.all(q[:, 0] >= 0)
    np.testing.assert_allclose(tse3.quaternion_to_matrix(torch.from_numpy(q)).numpy(), mats,
                               atol=1e-5)


def test_quaternion_to_matrix_inverse_and_jax(rng):
    q = rng.normal(size=(32, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    m = tse3.quaternion_to_matrix(torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(m, np.asarray(jse3.quaternion_to_matrix(jnp.asarray(q))), **TOL)
    q2 = _quat_t(m)
    qc = q * np.where(q[:, :1] < 0, -1.0, 1.0)
    np.testing.assert_allclose(q2, qc, atol=1e-4)
    # Unnormalised input: normalised first, as the reference does.
    np.testing.assert_allclose(tse3.quaternion_to_matrix(torch.from_numpy(3 * q)).numpy(), m,
                               atol=1e-6)


def test_accio_to_ngp_is_column_flip_and_involutive(rng):
    T = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    T[:, :3, :3] = R.from_euler("xyz", rng.uniform(-1, 1, (5, 3))).as_matrix()
    T[:, :3, 3] = rng.normal(size=(5, 3))
    out = tse3.accio_to_ngp(torch.from_numpy(T)).numpy()
    ref = T.copy()
    ref[:, :3, 1] *= -1
    ref[:, :3, 2] *= -1
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, np.asarray(jse3.accio_to_ngp(jnp.asarray(T))))
    np.testing.assert_array_equal(tse3.ngp_to_accio(torch.from_numpy(out)).numpy(), T)
    np.testing.assert_array_equal(out[:, 3], np.tile([0, 0, 0, 1], (5, 1)))
