"""Grasp-pose math from depth and normals, the robot-facing API (port of
dream2real_tpu/grasp.py): a gripper orientation from a surface normal with
a pseudo-up vector to fix the roll, rotation about the normal, hole patching
of a depth image, and pixel -> grasp pose. Host numpy, as in the JAX
package; the holes are filled by ``perception/imgproc.py::inpaint_ns``
(OpenCV's INPAINT_NS, which the reference calls).
"""

from __future__ import annotations

import numpy as np

from dream2real_tpu_torch.perception.imgproc import inpaint_ns


def get_grasp_pose(pos: np.ndarray, normal: np.ndarray) -> np.ndarray:
    """Gripper pose (4, 4) at ``pos`` with z pointing into the surface."""
    pseudo_up = np.array([0.0, 1.0, 0.0])
    if abs(np.dot(normal, pseudo_up)) > 0.99:
        pseudo_up = np.array([0.0, 0.0, 1.0])
    z_axis = -1 * np.asarray(normal, np.float64)
    x_axis = pseudo_up
    y_axis = np.cross(z_axis, x_axis)
    x_axis = -1 * np.cross(z_axis, y_axis)
    T = np.eye(4)
    T[:3, 0] = x_axis / np.linalg.norm(x_axis)
    T[:3, 1] = y_axis / np.linalg.norm(y_axis)
    T[:3, 2] = z_axis / np.linalg.norm(z_axis)
    T[:3, 3] = pos
    return T


def rotate_grasp_about_normal(grasp_pose, normal_axis, angle_deg: float) -> np.ndarray:
    """The grasp rotated by ``angle_deg`` about ``normal_axis`` (its position
    kept)."""
    from scipy.spatial.transform import Rotation as R

    rot = R.from_rotvec(np.asarray(normal_axis, np.float64) * np.deg2rad(angle_deg)).as_matrix()
    out = np.eye(4)
    out[:3, :3] = rot @ np.asarray(grasp_pose)[:3, :3]
    out[:3, 3] = np.asarray(grasp_pose)[:3, 3]
    return out


def normalise_angle(angle_deg):
    """Wrap degrees to (-180, 180]."""
    return np.rad2deg(np.arctan2(np.sin(np.deg2rad(angle_deg)), np.cos(np.deg2rad(angle_deg))))


def patch_up_depth(depth_img: np.ndarray) -> np.ndarray:
    """Zero and NaN depth holes filled by Navier-Stokes inpainting (radius 3,
    on the f32 image); a NaN left anywhere becomes 0."""
    depth_img = depth_img.copy()
    hole = (np.isnan(depth_img) | (depth_img == 0)).astype(np.uint8)
    patched = inpaint_ns(depth_img.astype(np.float32), hole, 3)
    depth_img[hole == 1] = patched[hole == 1]
    depth_img[np.isnan(depth_img)] = 0
    return depth_img


def get_grasp_pose_from_pix(
    row: int, col: int, depth_img: np.ndarray, intrinsics: np.ndarray,
    cam_pose: np.ndarray,
):
    """Pixel + depth image -> (world grasp pose (4, 4), normal). As in the
    reference the normal is straight down the world's +z; no local normal is
    estimated."""
    if depth_img[row, col] == 0:
        raise ValueError("Attempted grasp at pixel with zero depth value.")
    K = np.asarray(intrinsics, np.float64)
    z = float(depth_img[row, col])
    x = (col - K[0, 2]) / K[0, 0] * z
    y = (row - K[1, 2]) / K[1, 1] * z
    cam = np.array([x, y, z, 1.0])
    world = np.asarray(cam_pose, np.float64) @ cam
    pos = world[:3] / world[3]
    normal = np.array([0.0, 0.0, 1.0])
    return get_grasp_pose(pos, normal), normal
