"""Camera models (port of dream2real_tpu/ops/cameras.py): intrinsics
constants, per-pixel ray directions with Brown-Conrady undistortion, world
rays of a pose and point projection."""

from __future__ import annotations

import numpy as np
import torch

from dream2real_tpu_torch.device import resolve_device

# Derived 336x336 "CLIP view" intrinsics (reference vision_3d/camera_info.py).
INTRINSICS_CLIP_VIEW = np.array(
    [
        [436.01158022, 0.0, 168.0],
        [0.0, 435.90814372, 168.0],
        [0.0, 0.0, 1.0],
    ]
)


def pixel_dirs(
    h: int,
    w: int,
    intrinsics,
    distortion=None,
    snap_to_pixel_centers: bool = True,
    device=None,
) -> torch.Tensor:
    """(h, w, 3) camera-frame ray directions, OpenCV convention (+x right,
    +y down, +z forward), z-normalized so that t along the ray is z-depth.

    ``distortion`` (k1, k2, p1, p2, k3, k4) applies four fixed-point
    undistortion steps, like instant-ngp's render_with_lens_distortion.
    Computed in f32 like the reference, on CUDA unless ``device`` says
    otherwise.
    """
    device = resolve_device(device)
    K = torch.as_tensor(np.asarray(intrinsics), dtype=torch.float32, device=device)
    off = 0.5 if snap_to_pixel_centers else 0.0
    ys = torch.arange(h, dtype=torch.float32, device=device) + off
    xs = torch.arange(w, dtype=torch.float32, device=device) + off
    grid_y, grid_x = torch.meshgrid(ys, xs, indexing="ij")
    x = (grid_x - K[0, 2]) / K[0, 0]
    y = (grid_y - K[1, 2]) / K[1, 1]

    if distortion is not None:
        dist = torch.as_tensor(
            np.asarray(distortion, np.float32), dtype=torch.float32, device=device
        )
        k1, k2, p1, p2, k3 = (dist[i] for i in range(5))
        xd, yd = x, y
        for _ in range(4):
            r2 = xd * xd + yd * yd
            radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
            dx = 2.0 * p1 * xd * yd + p2 * (r2 + 2.0 * xd * xd)
            dy = p1 * (r2 + 2.0 * yd * yd) + 2.0 * p2 * xd * yd
            xd, yd = (x - dx) / radial, (y - dy) / radial
        x, y = xd, yd

    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def rays_from_pose(T_WC: torch.Tensor, dirs_cam: torch.Tensor):
    """World-frame ray origins and directions of a camera-to-world pose
    T_WC (..., 4, 4) (OpenCV convention) and dirs_cam (h, w, 3) from
    ``pixel_dirs``. -> origins (..., 1, 1, 3), broadcastable, and dirs
    (..., h, w, 3), z-normalized so that t is z-depth."""
    dirs = torch.einsum("...ij,hwj->...hwi", T_WC[..., :3, :3], dirs_cam)
    return T_WC[..., None, None, :3, 3], dirs


def project_points(points_w: torch.Tensor, T_CW: torch.Tensor, intrinsics: torch.Tensor):
    """World points (..., 3) through the world-to-camera pose T_CW (4, 4) ->
    ((..., 2) [col, row] pixel coordinates, (...,) camera-frame z)."""
    cam = points_w @ T_CW[:3, :3].T + T_CW[:3, 3]
    z = cam[..., 2]
    zc = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    u = cam[..., 0] / zc * intrinsics[0, 0] + intrinsics[0, 2]
    v = cam[..., 1] / zc * intrinsics[1, 1] + intrinsics[1, 2]
    return torch.stack([u, v], dim=-1), z
