"""Dense TSDF fusion on the device (port of dream2real_tpu/physics/tsdf.py).

A per-object TSDF is fused from masked depth frames over ``scene_phys_bounds``
(the reference's Open3D VoxelBlockGrid at 2 mm on the CPU; here a dense grid,
4 mm by default). Each frame is one pass over the grid: voxel centres to the
camera, a gather from the depth image at the rounded pixel, an elementwise
update. The JAX package scans the frames; here a plain loop runs them.

Numerics follow the JAX package operation for operation (f32, the same
order), so that a voxel's decisions (frustum, rounding to a pixel, the
truncation band) match it except at ties: the division by the truncation is
a multiplication by its f32 reciprocal, as XLA compiles the JAX package's
division by a constant. The inverses of the camera poses are taken on the
host, so that the card's grid equals the CPU path's bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dream2real_tpu_torch.device import F32, resolve_device, to_numpy
from dream2real_tpu_torch.ops.cameras import distort_coords, normalize_distortion
from dream2real_tpu_torch.ops.image import erode


class TSDFGrid(NamedTuple):
    tsdf: torch.Tensor  # (X, Y, Z) float32 in [-1, 1] (truncated, normalized)
    weight: torch.Tensor  # (X, Y, Z) float32
    origin: torch.Tensor  # (3,) world coords of voxel (0,0,0) CENTER
    voxel_size: float

    @property
    def shape(self):
        return tuple(self.tsdf.shape)

    def occupancy(self, thresh: float = 0.0) -> torch.Tensor:
        """Occupied = observed and at/behind the surface."""
        return (self.weight > 0) & (self.tsdf <= thresh)

    def to(self, device) -> "TSDFGrid":
        """The same grid on another device."""
        return TSDFGrid(self.tsdf.to(device), self.weight.to(device),
                        self.origin.to(device), self.voxel_size)


def grid_coords(bounds, voxel_size: float):
    """World-space voxel-center coordinates covering bounds.

    bounds: ((x0,y0,z0), (x1,y1,z1)). Returns (origin (3,) f32 numpy, dims).
    """
    lo = np.asarray(bounds[0], np.float32)
    hi = np.asarray(bounds[1], np.float32)
    dims = np.maximum(np.ceil((hi - lo) / voxel_size).astype(int), 1)
    origin = lo + voxel_size / 2
    return origin, tuple(int(d) for d in dims)


def fuse_tsdf(
    depths,  # (N, H, W) float32 metres, 0 = invalid
    masks,  # (N, H, W) bool: True where this object
    cam_poses,  # (N, 4, 4) camera-to-world, accio
    intrinsics,  # (3, 3)
    bounds,
    voxel_size: float = 0.004,
    trunc: float | None = None,
    erosion_kernel: int = 8,
    depth_max: float = 3.0,
    distortion=None,
    device=None,
) -> TSDFGrid:
    """Fuse masked depth frames into a dense TSDF on ``device`` (CUDA unless
    the caller names another).

    erosion_kernel: mask erosion in pixels (20 for the background object, 8
    for foreground objects in the reference). trunc defaults to 3 voxels.
    distortion: optional Brown-Conrady coefficients; the voxel -> pixel
    projection then applies the forward lens model, and voxels past the
    radial model's monotonic range are masked (they can fold back into the
    image and fuse depth from the wrong pixel).
    """
    dev = resolve_device(device)
    trunc = trunc if trunc is not None else 3.0 * voxel_size
    origin, dims = grid_coords(bounds, voxel_size)
    X, Y, Z = dims

    def on_dev(a, dtype=None):
        return torch.as_tensor(a if torch.is_tensor(a) else to_numpy(a), dtype=dtype, device=dev)

    depths = on_dev(depths, F32)
    K = on_dev(intrinsics, F32)
    masks = on_dev(masks) != 0
    T_CWs = torch.linalg.inv(torch.as_tensor(to_numpy(cam_poses), dtype=F32)).to(dev)
    h, w = depths.shape[1:3]

    xs = (torch.arange(X, device=dev, dtype=F32) * voxel_size + float(origin[0]))
    ys = (torch.arange(Y, device=dev, dtype=F32) * voxel_size + float(origin[1]))
    zs = (torch.arange(Z, device=dev, dtype=F32) * voxel_size + float(origin[2]))
    px, py, pz = xs[:, None, None], ys[None, :, None], zs[None, None, :]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    inv_trunc = torch.tensor(np.float32(1.0) / np.float32(trunc), device=dev)
    dist = normalize_distortion(distortion)
    if dist is not None:
        dist = torch.as_tensor(dist, device=dev)

    if erosion_kernel > 1:
        masks = erode(masks.to(F32), erosion_kernel) > 0.5

    tsdf = torch.zeros((X, Y, Z), dtype=F32, device=dev)
    weight = torch.zeros((X, Y, Z), dtype=F32, device=dev)
    for i in range(depths.shape[0]):
        depth = torch.where(masks[i], depths[i], 0.0).reshape(-1)
        R, t = T_CWs[i, :3, :3], T_CWs[i, :3, 3]
        # Voxel centers -> camera frame, separably: cam = R @ [x, y, z] + t.
        cam_x = R[0, 0] * px + R[0, 1] * py + R[0, 2] * pz + t[0]
        cam_y = R[1, 0] * px + R[1, 1] * py + R[1, 2] * pz + t[1]
        cam_z = R[2, 0] * px + R[2, 1] * py + R[2, 2] * pz + t[2]
        xn = cam_x / cam_z
        yn = cam_y / cam_z
        del cam_x, cam_y
        in_frustum = cam_z > 1e-3
        if dist is not None:
            r2 = xn * xn + yn * yn
            k1, k2, k3 = dist[0], dist[1], dist[4]
            dmono = 1.0 + r2 * (3.0 * k1 + r2 * (5.0 * k2 + r2 * 7.0 * k3))
            in_frustum = in_frustum & (dmono > 0.0)
            del r2, dmono
            xn, yn = distort_coords(xn, yn, dist)
        u = xn * fx + cx
        v = yn * fy + cy
        del xn, yn
        in_frustum = in_frustum & (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1)
        # torch.round, like jnp.round, rounds half to even.
        ui = torch.clamp(torch.round(u).to(torch.int64), 0, w - 1)
        vi = torch.clamp(torch.round(v).to(torch.int64), 0, h - 1)
        del u, v
        d = depth[vi * w + ui]
        del ui, vi
        valid = in_frustum & (d > 0) & (d < depth_max)
        sdf = (d - cam_z) * inv_trunc
        del d, cam_z
        valid = valid & (sdf > -1.0)
        sdf = torch.clamp(sdf, -1.0, 1.0)
        weight_next = weight + torch.where(valid, 1.0, 0.0)
        tsdf = torch.where(
            valid, (tsdf * weight + sdf) / torch.clamp(weight_next, min=1e-9), tsdf)
        weight = weight_next
    return TSDFGrid(tsdf=tsdf, weight=weight, origin=torch.as_tensor(origin, device=dev),
                    voxel_size=voxel_size)


def occupied_points(
    grid: TSDFGrid,
    max_points: int,
    thresh: float = 0.0,
    mode: str = "solid",
    bounds=None,
) -> np.ndarray:
    """World coords of occupied voxel centers, deterministically downsampled /
    zero-padded to exactly (max_points, 4): [x, y, z, valid] (host numpy).

    mode="solid": everything at/behind the surface (tsdf <= thresh).
    mode="shell": the surface shell only (|tsdf| < 0.5, observed): the
    movable object's points, since fusion marks up to a truncation band
    behind every visible surface as inside, which for an object resting on
    a table includes phantom voxels below table level. ``bounds``
    additionally crops.
    """
    if mode == "shell":
        occ = to_numpy((grid.weight > 0) & (grid.tsdf.abs() < 0.5))
    else:
        occ = to_numpy(grid.occupancy(thresh))
    idx = np.argwhere(occ)
    origin = to_numpy(grid.origin)
    if bounds is not None and idx.shape[0] > 0:
        pts_w = origin + idx * grid.voxel_size
        inb = (
            (pts_w >= np.asarray(bounds[0])) & (pts_w <= np.asarray(bounds[1]))
        ).all(axis=1)
        idx = idx[inb]
    n = idx.shape[0]
    pts = np.zeros((max_points, 4), np.float32)
    if n == 0:
        return pts
    if n > max_points:
        stride = n / max_points
        sel = (np.arange(max_points) * stride).astype(int)
        idx = idx[sel]
        n = max_points
    pts[:n, :3] = origin + idx * grid.voxel_size
    pts[:n, 3] = 1.0
    return pts


def grid_centroid(grid: TSDFGrid, thresh: float = 0.0) -> np.ndarray:
    """Centroid of occupied voxels (host numpy, f64)."""
    occ = to_numpy(grid.occupancy(thresh)).astype(np.float64)
    total = occ.sum()
    if total == 0:
        return np.zeros(3)
    X, Y, Z = occ.shape
    origin = to_numpy(grid.origin).astype(np.float64)
    cx = (occ.sum(axis=(1, 2)) * (origin[0] + grid.voxel_size * np.arange(X))).sum()
    cy = (occ.sum(axis=(0, 2)) * (origin[1] + grid.voxel_size * np.arange(Y))).sum()
    cz = (occ.sum(axis=(0, 1)) * (origin[2] + grid.voxel_size * np.arange(Z))).sum()
    return np.array([cx, cy, cz]) / total
