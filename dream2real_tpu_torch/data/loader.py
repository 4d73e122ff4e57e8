"""RGB-D scan loader and the dynamic (out-of-scene-bounds) masks (port of
dream2real_tpu/data/loader.py).

- ``load_rgbds``: poses.txt (stacked 4 x 4) + images/rgb_%04d.png +
  depth/depth_%04d.png (mm uint16 -> metres f32), all frames of a directory
  as one batch, by the native ingest (``native/``) as the JAX loader does
  first; a scan it does not take (grey or RGBA frames, another size) is
  decoded by the numpy codec (``utils/png.py``) with a warning.
  ``decoder`` records which of the two ("native" or "numpy") decoded the
  frames. Host numpy arrays, as the engine consumes them.
- ``remove_background``: each frame's depth back-projected to the world on
  the device, pixels outside scene_phys_bounds marked (world z > -0.40 guard,
  the bounds' z_min forced to -100), then a 50 px dilate-then-erode closing;
  cached as images/dynamic_mask_rgb_%04d.png.

The sums of the back-projection are written in the JAX package's order, one
rounding per operation and no fused multiply-add, so the card and the CPU
give the same masks; the JAX package's XLA program may contract them, and a
pixel on a bounds face can then fall the other way (a tie).
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from dream2real_tpu_torch import native
from dream2real_tpu_torch.device import F32, resolve_device, to_numpy
from dream2real_tpu_torch.ops import cameras
from dream2real_tpu_torch.ops.image import dilate, erode
from dream2real_tpu_torch.utils.png import read_pngs, write_png


class D2RDataLoader:
    """Loads a Dream2Real scan directory. rgb output is (N, H, W, 3) uint8."""

    def __init__(self, cfg, device=None):
        self.device = resolve_device(device)
        self.root_dir = cfg.data_dir
        self.rgb_dir = os.path.join(self.root_dir, "images")
        self.depth_dir = os.path.join(self.root_dir, "depth")
        self.traj_file = os.path.join(self.root_dir, "poses.txt")
        self.width = cfg.width
        self.height = cfg.height
        self.size = None
        self.rgb_data = None
        self.depth_data = None
        self.T_WC_data = None
        self.dynamic_masks = None
        self.decoder = None  # "native" or "numpy", once load_rgbds has run

    def load_rgbds(self):
        """-> (rgbs (N, H, W, 3) uint8, depths (N, H, W) f32 metres, T_WC
        (N, 4, 4) f32), host numpy."""
        T_WC = np.loadtxt(self.traj_file).reshape([-1, 4, 4])
        size = len(T_WC)
        self.size = size
        loaded = native.load_rgbd_dataset(self.root_dir, size, self.height, self.width)
        if loaded is not None:
            self.decoder = "native"
            self.rgb_data, self.depth_data = loaded
        else:
            self.decoder = "numpy"
            warnings.warn(f"{self.root_dir}: a frame is not 8-bit RGB + 16-bit depth of "
                          f"{self.height} x {self.width}; the frames are decoded by the numpy "
                          "codec (utils/png.py)", stacklevel=2)
            rgbs = read_pngs([os.path.join(self.rgb_dir, f"rgb_{i:04d}.png")
                              for i in range(size)])
            depths = read_pngs([os.path.join(self.depth_dir, f"depth_{i:04d}.png")
                                for i in range(size)])
            if rgbs.ndim == 3:  # a grey scan
                rgbs = np.repeat(rgbs[..., None], 3, axis=-1)
            self.rgb_data = np.ascontiguousarray(rgbs[..., :3])
            self.depth_data = depths.astype(np.float32) / 1000.0  # mm -> metres
        self.T_WC_data = T_WC.astype(np.float32)
        return self.rgb_data, self.depth_data, self.T_WC_data

    def remove_background(self, intrinsics, scene_phys_bounds, use_cache: bool = False,
                          distortion=None):
        """Dynamic masks (N, H, W) uint8 host numpy: 255 where a valid-depth
        pixel back-projects outside the scene's physical bounds, after a 50
        px dilate-then-erode; 0 inside the scene. ``distortion``: optional
        Brown-Conrady coefficients (k1, k2, p1, p2, k3, k4)."""
        out_path = os.path.join(self.root_dir, "images")
        if use_cache:
            self.dynamic_masks = read_pngs(
                [os.path.join(out_path, f"dynamic_mask_rgb_{i:04d}.png")
                 for i in range(self.size)])
            return self.dynamic_masks

        bounds = np.asarray(scene_phys_bounds, np.float64).copy()
        bounds[0][2] = -100.0  # the floor is never out of bounds
        masks = to_numpy(compute_dynamic_masks(
            self.depth_data, self.T_WC_data, np.asarray(intrinsics, np.float32), bounds,
            distortion=distortion, device=self.device,
        ))
        for idx in range(self.size):
            write_png(os.path.join(out_path, f"dynamic_mask_rgb_{idx:04d}.png"), masks[idx])
        self.dynamic_masks = masks
        return masks


def compute_dynamic_masks(depths, T_WC, intrinsics, scene_phys_bounds, distortion=None,
                          device=None) -> torch.Tensor:
    """(N, H, W) depths -> (N, H, W) uint8 dynamic masks on the device: the
    world-z > -0.40 pre-filter, the bounds test and the 50 px closing, all
    frames at once. With ``distortion`` the per-pixel rays are undistorted as
    the training rays are."""
    dev = resolve_device(device)
    depths = torch.as_tensor(np.asarray(to_numpy(depths), np.float32), device=dev)
    T = torch.as_tensor(np.asarray(to_numpy(T_WC), np.float32), device=dev)
    K = torch.as_tensor(np.asarray(intrinsics, np.float32), device=dev)
    lo = torch.as_tensor(np.asarray(scene_phys_bounds[0], np.float32), device=dev)
    hi = torch.as_tensor(np.asarray(scene_phys_bounds[1], np.float32), device=dev)
    h, w = depths.shape[1:3]
    distortion = cameras.normalize_distortion(distortion)
    if distortion is not None:
        dirs = cameras.pixel_dirs(h, w, K.cpu().numpy(), distortion,
                                  snap_to_pixel_centers=False, device=dev)
        us_map, vs_map = dirs[..., 0], dirs[..., 1]
    else:
        us = (torch.arange(w, dtype=F32, device=dev) - K[0, 2]) / K[0, 0]
        vs = (torch.arange(h, dtype=F32, device=dev) - K[1, 2]) / K[1, 1]
        us_map = us[None, :].expand(h, w)
        vs_map = vs[:, None].expand(h, w)

    x_cam = depths * us_map
    y_cam = depths * vs_map
    z_cam = depths
    R = T[:, None, None, :3, :3]
    t = T[:, None, None, :3, 3]
    # The reference hands Open3D extrinsic = inv(T_WC): the points land in
    # the world frame.
    px = R[..., 0, 0] * x_cam + R[..., 0, 1] * y_cam + R[..., 0, 2] * z_cam + t[..., 0]
    py = R[..., 1, 0] * x_cam + R[..., 1, 1] * y_cam + R[..., 1, 2] * z_cam + t[..., 1]
    pz = R[..., 2, 0] * x_cam + R[..., 2, 1] * y_cam + R[..., 2, 2] * z_cam + t[..., 2]
    above_floor = pz > -0.40
    outside = ((px < lo[0]) | (px > hi[0]) | (py < lo[1]) | (py > hi[1])
               | (pz < lo[2]) | (pz > hi[2]))
    m = (above_floor & outside & (depths != 0)).to(F32) * 255.0
    return erode(dilate(m, 50), 50).to(torch.uint8)
