"""Foreground/background compositing for the imagine loop (port of the
functions of dream2real_tpu/nerf/combined.py on the imagine-and-score path).

Per candidate pose: virtual-camera trick, fg march inside the object's
projected crop window (K1, all poses of a group in one launch), per-pixel
depth test against the background (< 0.05 -> 100 guard), unpremultiply,
linear -> sRGB, u8, alpha < 130 -> black, pasted into the precomputed
background frame. The whole group stays on the device: crop windows are
gathered and scattered by index, with no host round trip.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dream2real_tpu_torch.device import F32
from dream2real_tpu_torch.nerf.march_kernel import march_rays_fused, pack_params, supports
from dream2real_tpu_torch.nerf.model import NGPField
from dream2real_tpu_torch.nerf.render import RenderSettings, render_rays
from dream2real_tpu_torch.ops.image import linear_to_srgb
from dream2real_tpu_torch.ops.se3 import convert_virtual_pose, pose_inverse

CLIP_RES = 336


class BackgroundView(NamedTuple):
    """Per-render-view background, amortised over all poses."""

    rgb: torch.Tensor    # (res, res, 3) premultiplied linear
    alpha: torch.Tensor  # (res, res)
    depth: torch.Tensor  # (res, res) z-depth, movable object pushed far


def composite_one(fg_rgb, fg_alpha, fg_depth, bg: BackgroundView) -> torch.Tensor:
    """Depth-composite fg renders over the background -> u8 RGB. Broadcasts
    over leading batch dims."""
    fg_d = torch.where(fg_depth < 0.05, torch.full_like(fg_depth, 100.0), fg_depth)
    bg_d = torch.where(bg.depth < 0.05, torch.full_like(bg.depth, 100.0), bg.depth)
    near = fg_d < bg_d
    rgb = torch.where(near[..., None], fg_rgb, bg.rgb)
    alpha = torch.where(near, fg_alpha, bg.alpha)
    safe_a = torch.where(alpha == 0, torch.ones_like(alpha), alpha)
    rgb = torch.where(alpha[..., None] == 0, torch.zeros_like(rgb), rgb / safe_a[..., None])
    img = torch.clamp(linear_to_srgb(rgb), 0.0, 1.0)
    img_u8 = (img * 255.0 + 0.5).to(torch.uint8)
    alpha_u8 = (torch.clamp(alpha, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
    return torch.where(alpha_u8[..., None] < 130, torch.zeros_like(img_u8), img_u8)


def _corners(obj_aabb, device) -> torch.Tensor:
    lo = torch.as_tensor(obj_aabb[0], dtype=F32, device=device)
    hi = torch.as_tensor(obj_aabb[1], dtype=F32, device=device)
    return torch.stack([
        torch.stack([hi[0] if i & 1 else lo[0], hi[1] if i & 2 else lo[1],
                     hi[2] if i & 4 else lo[2]])
        for i in range(8)
    ])  # (8, 3)


def crop_window(T_WC_2: torch.Tensor, obj_aabb, intrinsics, res: int, crop: int):
    """Pixel windows (v0, u0) of crop x crop boxes centred on the projected
    object AABB; batched over the leading dims of T_WC_2 (..., 4, 4)."""
    K = torch.as_tensor(np.asarray(intrinsics), dtype=F32, device=T_WC_2.device)
    T_CW = pose_inverse(T_WC_2)
    corners = _corners(obj_aabb, T_WC_2.device)
    cam = corners @ T_CW[..., :3, :3].transpose(-1, -2) + T_CW[..., None, :3, 3]
    z = torch.clamp(cam[..., 2], min=1e-2)
    u = cam[..., 0] / z * K[0, 0] + K[0, 2]
    v = cam[..., 1] / z * K[1, 1] + K[1, 2]
    uc = (u.amin(dim=-1) + u.amax(dim=-1)) * 0.5
    vc = (v.amin(dim=-1) + v.amax(dim=-1)) * 0.5
    u0 = torch.clamp(torch.round(uc - crop / 2).to(torch.int64), 0, res - crop)
    v0 = torch.clamp(torch.round(vc - crop / 2).to(torch.int64), 0, res - crop)
    return v0, u0


def crop_extents(obj_aabb, intrinsics, res: int, T_WO_1, T_WC_1, poses):
    """Per-candidate in-frame pixel extent (ext_u, ext_v), each (K,), of the
    projected movable AABB under the virtual-camera trick (host numpy)."""
    lo = np.asarray(obj_aabb[0], np.float64)
    hi = np.asarray(obj_aabb[1], np.float64)
    corners = np.stack(
        [[hi[0] if i & 1 else lo[0], hi[1] if i & 2 else lo[1], hi[2] if i & 4 else lo[2]]
         for i in range(8)]
    )
    poses = np.asarray(poses, np.float64).reshape(-1, 4, 4)
    T_WO_1 = np.asarray(T_WO_1, np.float64)
    T_WC_1 = np.asarray(T_WC_1, np.float64)

    def _inv(T):
        Rt = np.swapaxes(T[..., :3, :3], -1, -2)
        out = np.zeros_like(T)
        out[..., :3, :3] = Rt
        out[..., :3, 3] = -np.einsum("...ij,...j->...i", Rt, T[..., :3, 3])
        out[..., 3, 3] = 1.0
        return out

    # T_WC_2 = T_WO_1 @ inv(T_WO_2) @ T_WC_1 (convert_virtual_pose, simplified).
    T_WC_2 = np.einsum("ij,kjl,lm->kim", T_WO_1, _inv(poses), T_WC_1)
    T_CW = _inv(T_WC_2)
    cam = np.einsum("kij,cj->kci", T_CW[:, :3, :3], corners) + T_CW[:, None, :3, 3]
    z = np.maximum(cam[..., 2], 1e-2)
    K = np.asarray(intrinsics, np.float64)
    u = np.clip(cam[..., 0] / z * K[0, 0] + K[0, 2], 0.0, res)
    v = np.clip(cam[..., 1] / z * K[1, 1] + K[1, 2], 0.0, res)
    return (u.max(axis=1) - u.min(axis=1)), (v.max(axis=1) - v.min(axis=1))


def required_crop(obj_aabb, intrinsics, res: int, T_WO_1, render_poses, poses) -> int:
    """Smallest crop window (px, multiple of 16) covering the movable
    object's in-frame projection for every candidate from every view."""
    need = 0.0
    for T_WC_1 in np.asarray(render_poses).reshape(-1, 4, 4):
        ext_u, ext_v = crop_extents(obj_aabb, intrinsics, res, T_WO_1, T_WC_1, poses)
        need = max(need, float(ext_u.max()), float(ext_v.max()))
    return min(int(-(-(int(np.ceil(need)) + 2) // 16) * 16), res)


def background_only_image(bg: BackgroundView) -> torch.Tensor:
    """Full-frame postprocessed background (composite with an empty fg)."""
    res = bg.rgb.shape[0]
    empty = torch.zeros(res, res, dtype=F32, device=bg.rgb.device)
    return composite_one(torch.zeros_like(bg.rgb), empty, empty, bg)


def _window_index(v0, u0, crop: int):
    """Row/column index grids (P, crop, 1), (P, 1, crop) of each window."""
    ar = torch.arange(crop, device=v0.device)
    return (v0[:, None] + ar)[:, :, None], (u0[:, None] + ar)[:, None, :]


def crop_rays(dirs_cam, intrinsics, obj_aabb, crop: int, T_WO_1, T_WC_1, T_WO_2):
    """World rays of each pose's crop window. -> (T_WC_2 (P, 4, 4), rows
    (P, crop, 1), cols (P, 1, crop), dirs (P, crop * crop, 3))."""
    P = T_WO_2.shape[0]
    T_WC_2 = convert_virtual_pose(T_WO_1, T_WO_2, T_WC_1)
    v0, u0 = crop_window(T_WC_2, obj_aabb, intrinsics, dirs_cam.shape[0], crop)
    rows, cols = _window_index(v0, u0, crop)
    dirs = torch.einsum("pij,phwj->phwi", T_WC_2[:, :3, :3], dirs_cam[rows, cols])
    return T_WC_2, rows, cols, dirs.reshape(P, crop * crop, 3)


def render_pose_cropped(
    fg: NGPField,
    settings: RenderSettings,
    dirs_cam: torch.Tensor,
    intrinsics,
    obj_aabb,
    crop: int,
    T_WO_1: torch.Tensor,
    T_WC_1: torch.Tensor,
    bg: BackgroundView,
    bg_only_u8: torch.Tensor,
    T_WO_2: torch.Tensor,
    packed=None,
) -> torch.Tensor:
    """Render a batch of poses T_WO_2 (P, 4, 4): the fg marched only inside
    each pose's crop window with a tight t-range, composited into the
    background frame. -> (P, res, res, 3) u8.

    The flagship field goes through K1, all P poses in one launch
    (``packed`` = march_kernel.pack_params(fg), computed here if absent);
    any other field through the plain render_rays."""
    P = T_WO_2.shape[0]
    res = dirs_cam.shape[0]
    T_WC_2, rows, cols, dirs = crop_rays(dirs_cam, intrinsics, obj_aabb, crop, T_WO_1, T_WC_1,
                                         T_WO_2)
    if supports(fg.cfg, settings):
        out = march_rays_fused(
            packed or pack_params(fg), fg.cfg, T_WC_2[:, :3, 3], dirs, obj_aabb, settings
        )
    else:
        origins = T_WC_2[:, None, :3, 3].expand(dirs.shape)
        out = render_rays(fg, origins, dirs, settings, march_aabb=obj_aabb)
    bg_crop = BackgroundView(rgb=bg.rgb[rows, cols], alpha=bg.alpha[rows, cols],
                             depth=bg.depth[rows, cols])
    img_crop = composite_one(
        out["rgb"].reshape(P, crop, crop, 3), out["alpha"].reshape(P, crop, crop),
        out["depth"].reshape(P, crop, crop), bg_crop,
    )
    frames = bg_only_u8.expand(P, res, res, 3).clone()
    pidx = torch.arange(P, device=frames.device)[:, None, None]
    frames[pidx, rows, cols] = img_crop
    return frames
