"""SE(3) candidate-pose grid sampling (port of dream2real_tpu/sampling.py).

The flattened order is a bit-compat artifact (pose_batch.txt, smoothing
reshapes by sample_res): torch.cartesian_prod order, last axis fastest.
Host numpy, as in the reference: this is set-up work.
"""

from __future__ import annotations

import math

import numpy as np

# Per-scene-type bounds relative to scene_centre: ((x), (y), (z), 3 x
# orientation ranges). Values from the reference's vision_3d/obj_pose_opt.py.
SCENE_TYPE_BOUNDS = {
    0: (  # Pool table
        (-0.12, 0.04), (-0.10, 0.06), (0.00, 0.085),
        (0.0, 0.0), (0.0, 0.0), (0.0, 0.0),
    ),
    1: (  # Shelf
        (-0.15, 0.20), (0.40, 0.44), (0.04, 0.41),
        (-math.pi, math.pi / 2), (-math.pi, math.pi / 2), (-math.pi, math.pi / 2),
    ),
    3: (  # Shopping
        (-0.19, 0.15), (-0.25, 0.10), (0.00, 0.14),
        (0.0, 0.0), (0.0, 0.0), (0.0, 0.0),
    ),
}


def sample_poses_grid(
    scene_centre,
    sample_res=(40, 40, 1, 1, 1, 1),
    scene_type: int = 0,
    bounds_override=None,
) -> np.ndarray:
    """6-DoF grid of absolute world-frame candidate poses.

    Returns (prod(sample_res), 16) float32 flattened homogeneous matrices.
    """
    if bounds_override is not None:
        b = bounds_override
    else:
        if scene_type not in SCENE_TYPE_BOUNDS:
            raise NotImplementedError(f"scene_type {scene_type} not implemented")
        b = SCENE_TYPE_BOUNDS[scene_type]
    x_rng, y_rng, z_rng = b[0], b[1], b[2]
    ori_rngs = b[3:6]

    cx, cy, cz = (float(scene_centre[i]) for i in range(3))
    axes = [
        np.linspace(x_rng[0] + cx, x_rng[1] + cx, int(sample_res[0])),
        np.linspace(y_rng[0] + cy, y_rng[1] + cy, int(sample_res[1])),
        np.linspace(z_rng[0] + cz, z_rng[1] + cz, int(sample_res[2])),
        np.linspace(ori_rngs[0][0], ori_rngs[0][1], int(sample_res[3])),
        np.linspace(ori_rngs[1][0], ori_rngs[1][1], int(sample_res[4])),
        np.linspace(ori_rngs[2][0], ori_rngs[2][1], int(sample_res[5])),
    ]
    grids = np.meshgrid(*axes, indexing="ij")
    combos = np.stack([g.reshape(-1) for g in grids], axis=-1)
    n = combos.shape[0]
    rot = _np_euler_xyz_to_matrix(combos[:, 3], combos[:, 4], combos[:, 5])
    poses = np.tile(np.eye(4, dtype=np.float32)[None], (n, 1, 1))
    poses[:, :3, :3] = rot.astype(np.float32)
    poses[:, :3, 3] = combos[:, :3].astype(np.float32)
    return poses.reshape(-1, 16)


def _np_euler_xyz_to_matrix(a, b, c):
    """Batched R = Rx(a) @ Ry(b) @ Rz(c) (pytorch3d "XYZ"), closed form."""
    ca, sa = np.cos(a), np.sin(a)
    cb, sb = np.cos(b), np.sin(b)
    cc, sc = np.cos(c), np.sin(c)
    rot = np.empty(a.shape + (3, 3), dtype=np.float64)
    rot[..., 0, 0] = cb * cc
    rot[..., 0, 1] = -cb * sc
    rot[..., 0, 2] = sb
    rot[..., 1, 0] = sa * sb * cc + ca * sc
    rot[..., 1, 1] = -sa * sb * sc + ca * cc
    rot[..., 1, 2] = -sa * cb
    rot[..., 2, 0] = -ca * sb * cc + sa * sc
    rot[..., 2, 1] = ca * sb * sc + sa * cc
    rot[..., 2, 2] = ca * cb
    return rot


def get_virtual_cam_poses(opt_cam_poses, render_cam_pose_idx) -> np.ndarray:
    """The render views' camera poses picked from the (optimised) training
    views: a sequence of (4, 4) arrays -> (L, 4, 4)."""
    return np.stack([np.asarray(opt_cam_poses[i]) for i in render_cam_pose_idx], axis=0)
