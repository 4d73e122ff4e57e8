"""Point-cloud registration tools (port of dream2real_tpu/registration.py):
local-PCA normals (which the physics models use), point-to-plane ICP and the
multiway pose graph, the offline scan-alignment tools run before the
pipeline when poses.txt needs refining. Host numpy and scipy, as in the JAX
package: ICP solves the linearised point-to-plane 6 x 6 system by least
squares, and the pose graph is optimised over se(3) by scipy's
Levenberg-Marquardt."""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy.spatial import cKDTree
from scipy.spatial.transform import Rotation as R


def estimate_normals(points: np.ndarray, k: int = 30, camera_location=None) -> np.ndarray:
    """Local-PCA normals (the smallest eigenvector of each point's k-nearest
    covariance); optionally flipped to face a camera location."""
    tree = cKDTree(points)
    _, idx = tree.query(points, k=min(k, len(points)))
    nbrs = points[idx]  # (N, k, 3)
    centered = nbrs - nbrs.mean(axis=1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", centered, centered)
    _, vecs = np.linalg.eigh(cov)
    normals = vecs[:, :, 0]  # smallest eigenvalue
    if camera_location is not None:
        to_cam = np.asarray(camera_location) - points
        flip = np.sign(np.einsum("ni,ni->n", normals, to_cam))
        flip[flip == 0] = 1
        normals = normals * flip[:, None]
    return normals


def _transform(T, pts):
    return pts @ T[:3, :3].T + T[:3, 3]


def point_to_plane_icp(
    source: np.ndarray,
    target: np.ndarray,
    target_normals: np.ndarray | None = None,
    max_correspondence_distance: float = 0.02,
    init: np.ndarray | None = None,
    max_iters: int = 30,
    tol: float = 1e-8,
):
    """Point-to-plane ICP. Returns (T 4x4 source->target, fitness, rmse)."""
    if target_normals is None:
        target_normals = estimate_normals(target)
    T = np.eye(4) if init is None else np.asarray(init, np.float64).copy()
    tree = cKDTree(target)
    prev_err = np.inf
    fitness, rmse = 0.0, np.inf
    for _ in range(max_iters):
        src = _transform(T, source)
        dist, idx = tree.query(src, k=1)
        mask = dist < max_correspondence_distance
        if mask.sum() < 6:
            break
        p = src[mask]
        q = target[idx[mask]]
        n = target_normals[idx[mask]]
        # Linearised point-to-plane: minimize ((p + w x p + t - q) . n)^2.
        b = -np.einsum("ni,ni->n", p - q, n)
        A = np.concatenate([np.cross(p, n), n], axis=1)  # (M, 6)
        x, *_ = np.linalg.lstsq(A, b, rcond=None)
        dT = np.eye(4)
        dT[:3, :3] = R.from_rotvec(x[:3]).as_matrix()
        dT[:3, 3] = x[3:]
        T = dT @ T
        err = float(np.mean(b**2))
        fitness = float(mask.mean())
        rmse = float(np.sqrt(np.mean(dist[mask] ** 2)))
        if abs(prev_err - err) < tol:
            break
        prev_err = err
    return T, fitness, rmse


def pairwise_registration(
    source: np.ndarray,
    target: np.ndarray,
    voxel_size: float = 0.001,
):
    """Coarse->fine point-to-plane ICP + information matrix.

    Parity: mutiway_registration.py:33-46 (coarse at 15*voxel, fine at
    1.5*voxel). Information matrix approximated as (#inliers) * I6 (Open3D's
    exact GTSAM-style information is correspondence-dependent; the pose-graph
    optimiser only needs relative edge confidence).
    """
    tn = estimate_normals(target)
    T_coarse, _, _ = point_to_plane_icp(
        source, target, tn, max_correspondence_distance=voxel_size * 15
    )
    T_fine, fitness, rmse = point_to_plane_icp(
        source, target, tn, max_correspondence_distance=voxel_size * 1.5,
        init=T_coarse,
    )
    info = np.eye(6) * max(fitness * len(source), 1.0)
    return T_fine, info


@dataclasses.dataclass
class PoseGraph:
    nodes: list  # list of 4x4 absolute poses
    edges: list  # list of (i, j, T_ij, info, uncertain)


def full_registration(
    pcds: list[np.ndarray],
    voxel_size: float = 0.001,
    loop_closure_stride: int = 1,
) -> PoseGraph:
    """Multiway registration pose graph (mutiway_registration.py:49-78):
    consecutive pairs become odometry edges (and accumulate node poses);
    non-consecutive pairs become uncertain loop-closure edges."""
    graph = PoseGraph(nodes=[np.eye(4)], edges=[])
    odometry = np.eye(4)
    n = len(pcds)
    for src in range(n):
        for dst in range(src + 1, n):
            if dst != src + 1 and (dst - src) % max(loop_closure_stride, 1) != 0:
                continue
            T_icp, info = pairwise_registration(pcds[src], pcds[dst], voxel_size)
            if dst == src + 1:  # odometry edge
                odometry = T_icp @ odometry
                graph.nodes.append(np.linalg.inv(odometry))
                graph.edges.append((src, dst, T_icp, info, False))
            else:  # loop closure
                graph.edges.append((src, dst, T_icp, info, True))
    return graph


def optimize_pose_graph(graph: PoseGraph, fixed_node: int = 0) -> list[np.ndarray]:
    """Global Gauss-Newton over se(3) (replaces Open3D's LM global
    optimisation, mutiway_registration.py:160-171). Returns optimised
    absolute node poses."""
    from scipy.optimize import least_squares

    n = len(graph.nodes)
    x0 = np.zeros((n, 6))
    for i, T in enumerate(graph.nodes):
        x0[i, :3] = R.from_matrix(T[:3, :3]).as_rotvec()
        x0[i, 3:] = T[:3, 3]

    def unpack(x):
        x = x.reshape(n, 6)
        Ts = []
        for i in range(n):
            T = np.eye(4)
            T[:3, :3] = R.from_rotvec(x[i, :3]).as_matrix()
            T[:3, 3] = x[i, 3:]
            Ts.append(T)
        return Ts

    def residuals(x):
        Ts = unpack(x)
        res = []
        # Edge residual: T_icp maps src -> dst frames; with absolute node
        # poses T_i (world_from_i), consistency is T_j^-1 @ T_i ~ T_icp.
        for i, j, T_ij, info, _ in graph.edges:
            E = np.linalg.inv(T_ij) @ np.linalg.inv(Ts[j]) @ Ts[i]
            w = np.sqrt(max(info[0, 0], 1e-9))
            res.append(w * R.from_matrix(E[:3, :3]).as_rotvec())
            res.append(w * E[:3, 3])
        # Anchor the fixed node.
        res.append(1e6 * x.reshape(n, 6)[fixed_node])
        return np.concatenate(res)

    sol = least_squares(residuals, x0.ravel(), method="lm", max_nfev=200)
    return unpack(sol.x)
