"""Mesh extraction from TSDF grids (marching tetrahedra) + export.

Replaces the reference's Open3D `extract_triangle_mesh` + cluster pruning +
OBJ export used for the physics models (vision_3d/physics_utils.py:99-119,
172-194). The meshes feed visualisation and file-format compat
(`phys_mod/mesh_concave_*.obj`, `init_pose_*.txt`); the collision checks
themselves run on the TSDF occupancy directly (physics/collision.py), so mesh
quality only affects export/visuals.

Marching *tetrahedra* (6 tets per cell) instead of marching cubes: the case
table is derivable in code (no 256-entry magic table), fully vectorized in
numpy, and produces watertight surfaces with slightly more triangles.
VHACD convex decomposition (physics_utils.py:193) has no equivalent here by
design — Bullet needed convex parts; the SDF overlap test does not.
"""

from __future__ import annotations

import numpy as np

from dream2real_tpu_torch.device import to_numpy
from dream2real_tpu_torch.physics.tsdf import TSDFGrid

# Cube corners in binary (x, y, z) order; tet decomposition of the cube.
_CORNER_OFFSETS = np.array(
    [[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0], [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]]
)
# 6 tetrahedra sharing the main diagonal 0-7.
_TETS = np.array(
    [[0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7], [0, 6, 4, 7], [0, 4, 5, 7], [0, 5, 1, 7]]
)


def _tet_triangles(p, v, level):
    """Triangulate one batch of tetrahedra.

    p: (N, 4, 3) vertex positions; v: (N, 4) sdf values.
    Returns (M, 3, 3) triangle vertex positions.
    """
    inside = v < level  # (N, 4)
    code = (
        inside[:, 0].astype(int)
        + 2 * inside[:, 1].astype(int)
        + 4 * inside[:, 2].astype(int)
        + 8 * inside[:, 3].astype(int)
    )

    def interp(a_idx, b_idx, sel):
        va = v[sel, a_idx]
        vb = v[sel, b_idx]
        tt = (level - va) / np.where(np.abs(vb - va) < 1e-12, 1e-12, vb - va)
        tt = np.clip(tt, 0.0, 1.0)[:, None]
        return p[sel, a_idx] * (1 - tt) + p[sel, b_idx] * tt

    tris = []
    # One vertex inside (or its complement): single triangle on the three
    # edges from that vertex.
    singles = {1: 0, 2: 1, 4: 2, 8: 3, 14: 0, 13: 1, 11: 2, 7: 3}
    for c, vi in singles.items():
        sel = np.nonzero(code == c)[0]
        if len(sel) == 0:
            continue
        others = [i for i in range(4) if i != vi]
        e = [interp(vi, o, sel) for o in others]
        if c in (1, 2, 4, 8):
            tris.append(np.stack([e[0], e[1], e[2]], axis=1))
        else:  # flipped orientation for the complement cases
            tris.append(np.stack([e[0], e[2], e[1]], axis=1))
    # Two vertices inside: quad on the four crossing edges -> two triangles.
    pairs = {3: (0, 1), 5: (0, 2), 9: (0, 3), 6: (1, 2), 10: (1, 3), 12: (2, 3)}
    for c, (a, b) in pairs.items():
        sel = np.nonzero(code == c)[0]
        if len(sel) == 0:
            continue
        others = [i for i in range(4) if i not in (a, b)]
        ao0 = interp(a, others[0], sel)
        ao1 = interp(a, others[1], sel)
        bo0 = interp(b, others[0], sel)
        bo1 = interp(b, others[1], sel)
        tris.append(np.stack([ao0, bo0, bo1], axis=1))
        tris.append(np.stack([ao0, bo1, ao1], axis=1))
    if not tris:
        return np.zeros((0, 3, 3), np.float32)
    return np.concatenate(tris, axis=0).astype(np.float32)


def extract_mesh(grid: TSDFGrid, level: float = 0.0):
    """TSDF -> (vertices (V, 3), triangles (T, 3) int) via marching tets.

    Only cells where all 8 corners are observed (weight > 0) are meshed,
    mirroring VoxelBlockGrid's behaviour of meshing integrated blocks only.
    """
    tsdf = to_numpy(grid.tsdf)
    weight = to_numpy(grid.weight)
    X, Y, Z = tsdf.shape
    if min(X, Y, Z) < 2:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    # Corner values per cell: (X-1, Y-1, Z-1, 8).
    def corners(a):
        return np.stack(
            [
                a[o[0] : X - 1 + o[0], o[1] : Y - 1 + o[1], o[2] : Z - 1 + o[2]]
                for o in _CORNER_OFFSETS
            ],
            axis=-1,
        )

    cv = corners(tsdf)
    cw = corners(weight)
    observed = (cw > 0).all(axis=-1)
    crossing = (cv < level).any(axis=-1) & (cv >= level).any(axis=-1)
    active = np.argwhere(observed & crossing)  # (Nc, 3)
    if active.shape[0] == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    origin = to_numpy(grid.origin)
    vs = grid.voxel_size
    cell_corner_pos = (
        origin
        + (active[:, None, :] + _CORNER_OFFSETS[None, :, :]) * vs
    ).astype(np.float32)  # (Nc, 8, 3)
    cell_vals = cv[active[:, 0], active[:, 1], active[:, 2]]  # (Nc, 8)

    all_tris = []
    for tet in _TETS:
        p = cell_corner_pos[:, tet]  # (Nc, 4, 3)
        v = cell_vals[:, tet]
        all_tris.append(_tet_triangles(p, v, level))
    tris = np.concatenate(all_tris, axis=0)  # (M, 3, 3)

    # Weld vertices on a voxel/1024 lattice.
    flat = tris.reshape(-1, 3)
    key = np.round(flat / (vs / 1024)).astype(np.int64)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    verts = np.zeros((uniq.shape[0], 3), np.float64)
    np.add.at(verts, inv, flat)
    counts = np.bincount(inv, minlength=uniq.shape[0])[:, None]
    verts = (verts / counts).astype(np.float32)
    faces = inv.reshape(-1, 3).astype(np.int32)
    # Drop degenerate faces.
    keep = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return verts, faces[keep]


def remove_small_clusters(verts, faces, keep_ratio: float = 0.02):
    """Drop connected components with < keep_ratio * max cluster triangles.

    Parity: physics_utils.py:106-109 (cluster_connected_triangles + 2% rule).
    """
    if faces.shape[0] == 0:
        return verts, faces
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    n = verts.shape[0]
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    adj = sp.coo_matrix(
        (np.ones(len(e)), (e[:, 0], e[:, 1])), shape=(n, n)
    )
    _, labels = connected_components(adj, directed=False)
    face_label = labels[faces[:, 0]]
    counts = np.bincount(face_label)
    thresh = keep_ratio * counts.max()
    keep = counts[face_label] >= thresh
    return verts, faces[keep]


def largest_cluster(verts, faces):
    """Keep only the largest connected component (create_mesh parity,
    physics_utils.py:398-400)."""
    if faces.shape[0] == 0:
        return verts, faces
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    n = verts.shape[0]
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    adj = sp.coo_matrix((np.ones(len(e)), (e[:, 0], e[:, 1])), shape=(n, n))
    _, labels = connected_components(adj, directed=False)
    face_label = labels[faces[:, 0]]
    counts = np.bincount(face_label)
    return verts, faces[face_label == counts.argmax()]


def crop_mesh(verts, faces, bounds):
    """Drop faces with any vertex outside bounds (mesh.crop parity,
    physics_utils.py:102-103)."""
    lo = np.asarray(bounds[0])
    hi = np.asarray(bounds[1])
    inside = ((verts >= lo) & (verts <= hi)).all(axis=1)
    keep = inside[faces].all(axis=1)
    return verts, faces[keep]


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray):
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for t in faces:
            f.write(f"f {t[0]+1} {t[1]+1} {t[2]+1}\n")


def load_obj(path: str):
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                faces.append([int(x.split("/")[0]) - 1 for x in line.split()[1:4]])
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


def mesh_center(verts: np.ndarray) -> np.ndarray:
    """Open3D get_center == vertex mean (used for init_pose,
    physics_utils.py:113-114)."""
    if len(verts) == 0:
        return np.zeros(3)
    return verts.mean(axis=0)
