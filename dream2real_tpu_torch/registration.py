"""Point-cloud tools (the part of dream2real_tpu/registration.py that the
physics models need): local-PCA normals. Host numpy and scipy, as in the
JAX package; ICP and the multiway pose graph are not ported yet."""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


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
