"""The port's ICP and multiway pose graph (``registration.py``) against the
JAX package's on the same clouds: the transforms, fitness and rmse to 1e-9
(both are host numpy and scipy), and the recoveries of
tests/test_registration.py."""

import numpy as np
import pytest
from scipy.spatial.transform import Rotation as R

from dream2real_tpu import registration as jreg
from dream2real_tpu_torch import registration as treg

TOL = dict(atol=1e-9, rtol=0)


def _plane_cloud(rng, n=2000):
    """Two perpendicular planes and a bump: well constrained for ICP."""
    a = np.stack([rng.uniform(0, 1, n), rng.uniform(0, 1, n), np.zeros(n)], -1)
    b = np.stack([rng.uniform(0, 1, n // 2), np.zeros(n // 2), rng.uniform(0, 0.5, n // 2)], -1)
    c = np.stack([rng.uniform(0.4, 0.6, n // 4), rng.uniform(0.4, 0.6, n // 4),
                  rng.uniform(0, 0.2, n // 4)], -1)
    return np.concatenate([a, b, c]).astype(np.float64)


def _moved(rng, src, euler, t):
    T = np.eye(4)
    T[:3, :3] = R.from_euler("xyz", euler).as_matrix()
    T[:3, 3] = t
    return T, src @ T[:3, :3].T + T[:3, 3] + rng.normal(scale=1e-4, size=src.shape)


@pytest.mark.parametrize("seed", range(3))
def test_icp_matches_jax(seed):
    rng = np.random.default_rng(seed)
    src = _plane_cloud(rng)
    T_true, target = _moved(rng, src, rng.uniform(-0.03, 0.03, 3), rng.uniform(-0.01, 0.01, 3))
    init = np.eye(4) if seed else np.linalg.inv(np.eye(4))
    got = treg.point_to_plane_icp(src, target, max_correspondence_distance=0.05, init=init)
    want = jreg.point_to_plane_icp(src, target, max_correspondence_distance=0.05, init=init)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got[1:], want[1:], **TOL)
    np.testing.assert_allclose(got[0], T_true, atol=2e-3)  # the recovery
    assert got[1] > 0.9 and got[2] < 0.01
    # Given normals and too few correspondences (an early stop).
    tn = treg.estimate_normals(target)
    np.testing.assert_allclose(tn, jreg.estimate_normals(target), **TOL)
    far = treg.point_to_plane_icp(src + 5.0, target, tn, max_correspondence_distance=0.01)
    assert far[1] == 0.0 and np.isinf(far[2])
    np.testing.assert_array_equal(far[0], np.eye(4))


def test_pairwise_registration_matches_jax(rng):
    src = _plane_cloud(rng, 1500)
    _, target = _moved(rng, src, [0.01, -0.02, 0.015], [0.004, 0.002, -0.003])
    T, info = treg.pairwise_registration(src, target, voxel_size=0.005)
    Tj, infoj = jreg.pairwise_registration(src, target, voxel_size=0.005)
    np.testing.assert_allclose(T, Tj, **TOL)
    np.testing.assert_allclose(info, infoj, **TOL)


def test_multiway_pose_graph_matches_jax(rng):
    """tests/test_registration.py::test_multiway_pose_graph on the port, and
    the graph and the optimised poses against the JAX package's."""
    base = _plane_cloud(rng, n=1200)
    steps = [np.eye(4)]
    for k in range(2):
        T = np.eye(4)
        T[:3, :3] = R.from_euler("z", 0.02 * (k + 1)).as_matrix()
        T[:3, 3] = [0.02 * (k + 1), 0.01, 0]
        steps.append(T)
    pcds = [base @ np.linalg.inv(T)[:3, :3].T + np.linalg.inv(T)[:3, 3] for T in steps]
    graph = treg.full_registration(pcds, voxel_size=0.01)
    jgraph = jreg.full_registration(pcds, voxel_size=0.01)
    assert len(graph.nodes) == 3 and any(e[4] for e in graph.edges)
    for a, b in zip(graph.nodes, jgraph.nodes):
        np.testing.assert_allclose(a, b, **TOL)
    assert [e[:2] + e[4:] for e in graph.edges] == [e[:2] + e[4:] for e in jgraph.edges]
    for e, ej in zip(graph.edges, jgraph.edges):
        np.testing.assert_allclose(e[2], ej[2], **TOL)
        np.testing.assert_allclose(e[3], ej[3], **TOL)
    opt = treg.optimize_pose_graph(graph)
    for a, b in zip(opt, jreg.optimize_pose_graph(jgraph)):
        np.testing.assert_allclose(a, b, **TOL)
    rel = np.linalg.inv(opt[0]) @ opt[1]
    np.testing.assert_allclose(rel[:3, 3], steps[1][:3, 3], atol=5e-3)
    # Every pair an edge at stride 2, and another fixed node.
    g2 = treg.full_registration(pcds, voxel_size=0.01, loop_closure_stride=2)
    for a, b in zip(treg.optimize_pose_graph(g2, fixed_node=1),
                    jreg.optimize_pose_graph(jreg.full_registration(pcds, 0.01, 2), fixed_node=1)):
        np.testing.assert_allclose(a, b, **TOL)
