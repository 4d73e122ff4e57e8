"""Coloured per-object point clouds from masked RGB-D (port of
dream2real_tpu/pcd/visual_model.py).

Per object: back-project the masked RGB-D (the mask eroded by a 15 x 15
square, cv2's placement, perception/imgproc.py), crop to the scene bounds,
one view (``pcds_type`` 0) or the union of every view with a 2 mm voxel
downsample (``pcds_type`` 1); cached as ``obj_vis_{i}.npz`` in save_dir, a
file either package reads. Host numpy in the reference's order: the
renderer's tie order depends on the point order.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from dream2real_tpu_torch.perception.imgproc import erode


@dataclasses.dataclass
class PointCloud:
    points: np.ndarray  # (N, 3) float32 world
    colors: np.ndarray  # (N, 3) uint8

    def transformed(self, T: np.ndarray) -> "PointCloud":
        pts = self.points @ np.asarray(T[:3, :3]).T + np.asarray(T[:3, 3])
        return PointCloud(pts.astype(np.float32), self.colors)


def _backproject(rgb, depth, mask, T_WC, K):
    vs, us = np.nonzero(mask & (depth > 0))
    z = depth[vs, us]
    x = (us - K[0, 2]) / K[0, 0] * z
    y = (vs - K[1, 2]) / K[1, 1] * z
    cam = np.stack([x, y, z], axis=-1)
    pts = cam @ np.asarray(T_WC[:3, :3]).T + np.asarray(T_WC[:3, 3])
    return pts.astype(np.float32), rgb[vs, us].astype(np.uint8)


def voxel_downsample(pts: np.ndarray, cols: np.ndarray, voxel: float):
    """The first point (in order) of every occupied voxel, voxels in
    lexicographic order of their integer keys."""
    if len(pts) == 0:
        return pts, cols
    key = np.floor(pts / voxel).astype(np.int64)
    _, idx = np.unique(key, axis=0, return_index=True)
    return pts[idx], cols[idx]


def get_vis_pcds(
    rgbs, depths, cam_poses, intrinsics, masks, num_objs, scene_bounds,
    save_dir=None, vis=False, use_cache=True, pcds_type=1, single_view_idx=0,
) -> list[PointCloud]:
    """One PointCloud per object id 0..num_objs-1 of ``masks``."""
    if use_cache and save_dir is not None:
        print("Using cached visual point cloud models")
        out = []
        for obj_id in range(num_objs):
            z = np.load(os.path.join(save_dir, f"obj_vis_{obj_id}.npz"))
            out.append(PointCloud(z["points"], z["colors"]))
        return out

    print("Creating visual point cloud models...")
    if save_dir is not None:
        os.makedirs(save_dir, exist_ok=True)
    rgbs = np.asarray(rgbs)
    depths = np.asarray(depths)
    masks = np.asarray(masks)
    K = np.asarray(intrinsics)
    lo = np.asarray(scene_bounds[0])
    hi = np.asarray(scene_bounds[1])

    out = []
    view_range = range(len(depths)) if pcds_type == 1 else [single_view_idx]
    for obj_id in range(num_objs):
        all_pts, all_cols = [], []
        for frame_id in view_range:
            mask = erode((masks[frame_id] == obj_id).astype(np.uint8), 15).astype(bool)
            pts, cols = _backproject(
                rgbs[frame_id], depths[frame_id], mask,
                np.asarray(cam_poses[frame_id]), K,
            )
            inb = ((pts >= lo) & (pts <= hi)).all(axis=1)
            pts, cols = pts[inb], cols[inb]
            if pcds_type == 1:
                pts, cols = voxel_downsample(pts, cols, 0.002)
            all_pts.append(pts)
            all_cols.append(cols)
        pcd = PointCloud(
            np.concatenate(all_pts) if all_pts else np.zeros((0, 3), np.float32),
            np.concatenate(all_cols) if all_cols else np.zeros((0, 3), np.uint8),
        )
        out.append(pcd)
        if save_dir is not None:
            np.savez(
                os.path.join(save_dir, f"obj_vis_{obj_id}.npz"),
                points=pcd.points, colors=pcd.colors,
            )
    print("Visual point cloud models created.")
    return out
