"""SE(3) / SO(3) utilities (port of dream2real_tpu/ops/se3.py).

Pose-chain math is full f32: the package turns TF32 off on import, so every
4x4 product here is an exact-input f32 matmul, like the reference's
``Precision.HIGHEST``. All functions batch over leading axes.
"""

from __future__ import annotations

import torch


def _axis_rotation(axis: str, angle: torch.Tensor) -> torch.Tensor:
    """Rotation matrix about a named axis. angle: (...,) -> (..., 3, 3)."""
    c = torch.cos(angle)
    s = torch.sin(angle)
    o = torch.ones_like(angle)
    z = torch.zeros_like(angle)
    if axis == "X":
        rows = [o, z, z, z, c, -s, z, s, c]
    elif axis == "Y":
        rows = [c, z, s, z, o, z, -s, z, c]
    elif axis == "Z":
        rows = [c, -s, z, s, c, z, z, z, o]
    else:
        raise ValueError(axis)
    return torch.stack(rows, dim=-1).reshape(angle.shape + (3, 3))


def euler_angles_to_matrix(euler: torch.Tensor, convention: str = "XYZ") -> torch.Tensor:
    """Euler angles -> rotation matrices, pytorch3d semantics.

    For "XYZ": R = Rx(a) @ Ry(b) @ Rz(c). euler: (..., 3) -> (..., 3, 3).
    """
    if len(convention) != 3:
        raise ValueError(convention)
    mats = [_axis_rotation(axis, euler[..., i]) for i, axis in enumerate(convention)]
    return (mats[0] @ mats[1]) @ mats[2]


def make_pose(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble (..., 4, 4) homogeneous transforms from (..., 3, 3), (..., 3)."""
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def pose_inverse(T: torch.Tensor) -> torch.Tensor:
    """Analytic inverse of rigid transforms. T: (..., 4, 4)."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    ti = -(Rt @ T[..., :3, 3:4])[..., 0]
    return make_pose(Rt, ti)


def convert_virtual_pose(
    T_WO_1: torch.Tensor, T_WO_2: torch.Tensor, T_WC_1: torch.Tensor
) -> torch.Tensor:
    """Virtual-camera pose trick: T_WC_2 such that T_C1_O2 == T_C2_O1.

    Rendering the object at its original pose from T_WC_2 equals rendering
    it moved to T_WO_2 from T_WC_1. All arguments broadcast; T_WO_2 is
    typically a (K, 4, 4) batch.
    """
    T_O2_O1 = pose_inverse(T_WO_2) @ T_WO_1
    T_O1_C1 = pose_inverse(T_WO_1) @ T_WC_1
    return (T_WO_1 @ T_O2_O1) @ T_O1_C1
