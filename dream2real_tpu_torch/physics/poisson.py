"""Point-cloud physics models: statistical outlier removal + regular-grid
Poisson surface reconstruction.

Parity target — the ``use_phys_tsdf=False`` branch of the reference:
- vision_3d/physics_utils.py:121-167: per-object point clouds from masked
  depth (15 px erosion), scene-bounds crop, 2 mm voxel downsample,
  ``remove_statistical_outlier(nb_neighbors=30, std_ratio=1.05)``;
- vision_3d/physics_utils.py:381-401 (``create_mesh``): normal estimation +
  orientation, Poisson reconstruction at depth=5, crop to the pcd AABB,
  keep the largest connected component.

The reference runs Open3D's octree screened-Poisson solver on the CPU. Here
the indicator solve is a REGULAR-GRID spectral Poisson solve (host numpy
FFTs: scene preprocessing, where the reference spends it too; a copy of the
JAX package's module): the oriented normal field is trilinearly splatted
into a padded grid V, the indicator chi solves lap(chi) = div(V) by FFT
diagonalization of the (central-difference) Laplacian, and the iso level
is the mean indicator at the input samples (Kazhdan's isovalue choice).
A 96-cell regular grid meets or exceeds the reference's Poisson depth=5
(= 32^3 octree leaf resolution). The indicator doubles as the collision
SDF (a TSDFGrid, placed on the device), which is the role Bullet gave the
Poisson meshes.
"""

from __future__ import annotations

import numpy as np
import torch

from dream2real_tpu_torch.device import resolve_device
from dream2real_tpu_torch.physics.tsdf import TSDFGrid


def remove_statistical_outliers(
    points: np.ndarray, nb_neighbors: int = 30, std_ratio: float = 1.05
) -> np.ndarray:
    """Inlier mask with Open3D ``remove_statistical_outlier`` semantics:
    keep points whose mean distance to their nb_neighbors nearest
    neighbours is below mean + std_ratio * std over the cloud
    (physics_utils.py:127-128, 150-151)."""
    n = len(points)
    if n == 0:
        return np.zeros((0,), bool)
    from scipy.spatial import cKDTree

    k = min(nb_neighbors + 1, n)  # +1: query includes the point itself
    d, _ = cKDTree(points).query(points, k=k)
    mean_d = d[:, 1:].mean(axis=1) if k > 1 else np.zeros(n)
    return mean_d <= mean_d.mean() + std_ratio * mean_d.std()


def oriented_normals(
    points: np.ndarray, view_origins: np.ndarray, k: int = 30
) -> np.ndarray:
    """Local-PCA normals flipped to face the camera that observed each point
    — a stronger orientation signal than the reference's
    orient_normals_consistent_tangent_plane (create_mesh:383) since the
    per-point view origin is known from back-projection."""
    from dream2real_tpu_torch.registration import estimate_normals

    normals = estimate_normals(points, k=k)
    to_cam = np.asarray(view_origins) - points
    flip = np.sign(np.einsum("ni,ni->n", normals, to_cam))
    flip[flip == 0] = 1.0
    return (normals * flip[:, None]).astype(np.float32)


def poisson_indicator(
    points: np.ndarray,
    normals: np.ndarray,
    max_dim: int = 96,
    pad_ratio: float = 0.25,
    min_voxel: float = 0.004,
    smooth_voxels: float = 1.5,
    device=None,
) -> TSDFGrid:
    """Solve the Poisson indicator problem on a regular grid and return it
    packaged as a TSDFGrid (tsdf in [-1, 1], negative inside, 0 at the
    reconstructed surface) so physics/collision.py consumes it unchanged.

    points (N, 3), normals (N, 3) outward-oriented unit vectors. The solve
    runs on the host; the grid goes to ``device`` (CUDA unless the caller
    names another).
    """
    dev = resolve_device(device)
    pts = np.asarray(points, np.float32)
    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    extent = hi - lo
    pad = np.maximum(extent * pad_ratio, 4 * min_voxel)
    lo_p, hi_p = lo - pad, hi + pad
    voxel = float(max(np.max(hi_p - lo_p) / (max_dim - 1), min_voxel))
    dims = np.maximum(np.ceil((hi_p - lo_p) / voxel).astype(int) + 1, 8)
    X, Y, Z = (int(d) for d in dims)
    origin = lo_p.astype(np.float32)

    # --- Trilinear splat of -normals (grad(chi) points inward) into V.
    g = (pts - origin) / voxel  # grid coords
    i0 = np.clip(np.floor(g).astype(np.int64), 0, np.array([X, Y, Z]) - 2)
    f = np.clip(g - i0, 0.0, 1.0)
    V = np.zeros((3, X, Y, Z), np.float32)
    vec = -np.asarray(normals, np.float32)
    for dx in (0, 1):
        wx = f[:, 0] if dx else 1 - f[:, 0]
        for dy in (0, 1):
            wy = f[:, 1] if dy else 1 - f[:, 1]
            for dz in (0, 1):
                wz = f[:, 2] if dz else 1 - f[:, 2]
                w = (wx * wy * wz)[:, None] * vec  # (N, 3)
                flat_idx = (
                    (i0[:, 0] + dx) * Y * Z + (i0[:, 1] + dy) * Z + (i0[:, 2] + dz)
                )
                for a in range(3):
                    np.add.at(V[a].ravel(), flat_idx, w[:, a])

    # --- Spectral solve: chi_hat = div_hat / lap_sym, smoothed. Host numpy
    # FFTs: this is once-per-object scene preprocessing (the reference runs
    # its octree Poisson on the CPU too).
    kx = np.fft.fftfreq(X)[:, None, None]  # cycles/sample
    ky = np.fft.fftfreq(Y)[None, :, None]
    kz = np.fft.rfftfreq(Z)[None, None, :]
    # Central-difference derivative symbol i*sin(2*pi*k)/h per axis; the
    # Laplacian symbol is its square summed -> div/grad stay adjoint.
    sx = np.sin(2 * np.pi * kx) / voxel
    sy = np.sin(2 * np.pi * ky) / voxel
    sz = np.sin(2 * np.pi * kz) / voxel
    div_hat = 1j * (
        sx * np.fft.rfftn(V[0])
        + sy * np.fft.rfftn(V[1])
        + sz * np.fft.rfftn(V[2])
    )
    # Gaussian pre-smoothing of the splatted field (B-spline kernel stand-in).
    sig = smooth_voxels * voxel
    kap2 = (2 * np.pi) ** 2 * (
        (kx / voxel) ** 2 + (ky / voxel) ** 2 + (kz / voxel) ** 2
    )
    div_hat = div_hat * np.exp(-0.5 * sig * sig * kap2)
    lap = -(sx * sx + sy * sy + sz * sz)
    chi_hat = np.where(
        np.abs(lap) > 1e-12, div_hat / np.where(lap == 0, 1.0, lap), 0.0
    )
    chi = np.fft.irfftn(chi_hat, s=(X, Y, Z), axes=(0, 1, 2)).astype(np.float32)

    # --- Iso level: mean indicator at the samples (trilinear).
    def trilinear(vol, g, i0, f):
        acc = np.zeros(len(g), np.float32)
        for dx in (0, 1):
            wx = f[:, 0] if dx else 1 - f[:, 0]
            for dy in (0, 1):
                wy = f[:, 1] if dy else 1 - f[:, 1]
                for dz in (0, 1):
                    wz = f[:, 2] if dz else 1 - f[:, 2]
                    acc += wx * wy * wz * vol[
                        i0[:, 0] + dx, i0[:, 1] + dy, i0[:, 2] + dz
                    ]
        return acc

    iso = float(trilinear(chi, g, i0, f).mean())
    scale = max(0.5 * (float(chi.max()) - iso), 1e-9)
    tsdf = np.clip((iso - chi) / scale, -1.0, 1.0)
    return TSDFGrid(
        tsdf=torch.as_tensor(tsdf, device=dev),
        weight=torch.ones((X, Y, Z), dtype=torch.float32, device=dev),
        origin=torch.as_tensor(origin, device=dev),
        voxel_size=voxel,
    )


def poisson_mesh(grid: TSDFGrid, pcd_points: np.ndarray):
    """Extract the reconstructed surface from the indicator grid, crop to
    the point cloud's AABB and keep the largest connected component
    (create_mesh parity, physics_utils.py:381-401)."""
    from dream2real_tpu_torch.physics import mesh as mesh_ops

    verts, faces = mesh_ops.extract_mesh(grid)
    if len(pcd_points):
        verts, faces = mesh_ops.crop_mesh(
            verts, faces, (pcd_points.min(axis=0), pcd_points.max(axis=0))
        )
    verts, faces = mesh_ops.largest_cluster(verts, faces)
    return verts, faces


def write_pcd(path: str, points: np.ndarray):
    """Minimal ASCII .pcd writer (the reference saves obj_{i}.pcd via
    o3d.io.write_point_cloud, physics_utils.py:161-163)."""
    pts = np.asarray(points, np.float32)
    with open(path, "w") as fh:
        fh.write(
            "# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
            "FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
            f"WIDTH {len(pts)}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
            f"POINTS {len(pts)}\nDATA ascii\n"
        )
        for p in pts:
            fh.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
