"""Camera models (port of dream2real_tpu/ops/cameras.py): intrinsics
constants, Brown-Conrady coefficients and the forward lens model, per-pixel
ray directions with undistortion, world rays of a pose and point
projection."""

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


def normalize_distortion(distortion):
    """None for absent or all-zero coefficient arrays, so that pinhole code
    paths stay numerically identical when a config carries k1..p2 = 0 (every
    synth config does); else the coefficients as f32 numpy."""
    if distortion is None:
        return None
    d = np.asarray(distortion, np.float32)
    if not np.any(d):
        return None
    return d


def distort_coords(x, y, distortion):
    """Forward Brown-Conrady: normalized pinhole coords -> distorted coords
    (the model whose inverse ``pixel_dirs`` iterates; coefficient order k1,
    k2, p1, p2, k3, k4). x, y: tensors; distortion: indexable by 0..5."""
    k1, k2, p1, p2, k3, _k4 = [distortion[i] for i in range(6)]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return xd, yd


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


def pix_to_world(row, col, img_height: int, depth, cam_pose, intrinsics) -> torch.Tensor:
    """Pixel + depth -> world point, f32, with the reference's u = height -
    row convention (vision_3d/geometry_utils.py:127-135). Runs on the device
    of ``cam_pose`` when it is a tensor, else on the CPU."""
    dev = cam_pose.device if torch.is_tensor(cam_pose) else torch.device("cpu")

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    u = t(img_height) - t(row)
    v = t(col)
    K_inv = torch.linalg.inv(t(intrinsics))
    cam = K_inv @ (t(depth) * torch.stack([u, v, torch.ones_like(u)]))
    world = t(cam_pose) @ torch.cat([cam, torch.ones_like(cam[:1])])
    return (world / world[3])[:3]


def clip_view_intrinsics_like(intrinsics: np.ndarray, src_hw: tuple[int, int],
                              res: int = 336) -> np.ndarray:
    """CLIP-view intrinsics of a source camera: center-crop to a square, then
    resize to res (how INTRINSICS_CLIP_VIEW relates to the reference's
    1280 x 720 RealSense intrinsics). Host numpy, f64."""
    h, w = src_hw
    side = min(h, w)
    scale = res / side
    crop_x = (w - side) / 2
    crop_y = (h - side) / 2
    out = intrinsics.copy().astype(np.float64)
    out[0, 0] *= scale
    out[1, 1] *= scale
    out[0, 2] = (intrinsics[0, 2] - crop_x) * scale
    out[1, 2] = (intrinsics[1, 2] - crop_y) * scale
    return out
