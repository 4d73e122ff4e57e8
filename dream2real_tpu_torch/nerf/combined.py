"""Foreground/background compositing for the imagine loop and the combined
renderer (port of dream2real_tpu/nerf/combined.py).

Per candidate pose: virtual-camera trick, fg march inside the object's
projected crop window (K1 for the flagship field, H2 for an instant-ngp
hash-grid field on the card; all poses of a group in one launch), per-pixel
depth test against the background (< 0.05 -> 100 guard), unpremultiply,
linear -> sRGB, u8, alpha < 130 -> black, pasted into the precomputed
background frame. The whole group stays on the device: crop windows are
gathered and scattered by index, with no host round trip.
"""

from __future__ import annotations

import os
import shutil
from typing import NamedTuple, Optional

import numpy as np
import torch

from dream2real_tpu_torch.device import F32, resolve_device
from dream2real_tpu_torch.nerf import hash_march
from dream2real_tpu_torch.nerf.march_kernel import march_rays_fused, pack_params, supports
from dream2real_tpu_torch.nerf.model import NGPField
from dream2real_tpu_torch.nerf.render import RenderSettings, render_image, render_rays
from dream2real_tpu_torch.ops import cameras
from dream2real_tpu_torch.ops.image import linear_to_srgb, rectify_depth, rectify_mask
from dream2real_tpu_torch.ops.se3 import convert_virtual_pose, pose_inverse
from dream2real_tpu_torch.utils.png import write_png

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
    K = torch.as_tensor(intrinsics, dtype=F32, device=T_WC_2.device)
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


def pack_crop(fg: NGPField, crop_settings: RenderSettings, device):
    """The fg field laid out once for its crop kernel, the one place that
    chooses it: K1's pack for the flagship field, H2's for a hash-grid field
    on the card; None where the crop render is the plain ``render_rays``
    (any other field, and a hash-grid field on the CPU). A hash-grid field
    on the card that H2 does not cover raises: its plain render would cost
    several times H2's, unseen."""
    if supports(fg.cfg, crop_settings):
        return pack_params(fg)
    if fg.cfg.field_type != "hashgrid" or torch.device(device).type != "cuda":
        return None
    if not hash_march.supports(fg.cfg, crop_settings):
        g = fg.cfg.grid
        raise ValueError(
            f"pack_crop: H2 covers hash-grid fields of {hash_march.IN} encoded features as "
            f"(levels, features) {hash_march.LAYOUTS}, hidden {hash_march.HIDDEN}, degree-4 SH, "
            f"at crop settings without fine samples; got {g.n_levels} x {g.n_features}, hidden "
            f"{fg.cfg.hidden_dim}, SH {fg.cfg.sh_degree}, n_fine {crop_settings.n_fine}")
    return hash_march.pack(fg)


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

    The kernel follows ``packed`` (``pack_crop``'s, computed here if
    absent): K1 for the flagship field, H2 for a hash-grid field on the
    card, all P poses in one launch; without one, the plain render_rays.
    With ``intrinsics`` and ``obj_aabb`` on the device and ``packed`` given,
    the K1 and H2 paths issue their work without waiting for the device."""
    P = T_WO_2.shape[0]
    res = dirs_cam.shape[0]
    T_WC_2, rows, cols, dirs = crop_rays(dirs_cam, intrinsics, obj_aabb, crop, T_WO_1, T_WC_1,
                                         T_WO_2)
    if packed is None:
        packed = pack_crop(fg, settings, dirs.device)
    if isinstance(packed, hash_march.HashMarchParams):
        out = hash_march.march_rays_hash(packed, T_WC_2[:, :3, 3], dirs, obj_aabb, settings)
    elif packed is not None:
        out = march_rays_fused(packed, T_WC_2[:, :3, 3], dirs, obj_aabb, settings)
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


def render_pose_batch(
    fg: NGPField,
    settings: RenderSettings,
    crop_settings: RenderSettings,
    dirs_cam: torch.Tensor,
    intrinsics,
    obj_aabb,
    crop: int,
    row_chunk: int,
    T_WO_1: torch.Tensor,
    T_WC_1: torch.Tensor,
    bg: BackgroundView,
    bg_only_u8,
    T_WO_2: torch.Tensor,
    packed=None,
) -> torch.Tensor:
    """Composites of a batch of candidate poses T_WO_2 (P, 4, 4) ->
    (P, res, res, 3) u8: the crop path (``render_pose_cropped``) when a crop
    and an object box are set, else a full-frame fg render of each pose
    composited over the background. The imagine loop and
    ``CombinedRenderer.render`` share it."""
    if crop and obj_aabb is not None:
        return render_pose_cropped(fg, crop_settings, dirs_cam, intrinsics, obj_aabb, crop,
                                   T_WO_1, T_WC_1, bg, bg_only_u8, T_WO_2, packed=packed)
    T_WC_2 = convert_virtual_pose(T_WO_1, T_WO_2, T_WC_1)
    outs = [render_image(fg, T, dirs_cam, settings, row_chunk=row_chunk) for T in T_WC_2]
    return torch.stack([composite_one(o["rgb"], o["alpha"], o["depth"], bg) for o in outs])


class CombinedRenderer:
    """Foreground/background NeRF combined renderer.

    fg / bg are the task's movable-object and task-background fields. All
    camera poses are in the OpenCV ("accio") convention. ``device`` None
    means CUDA; both fields must lie on the renderer's device.
    """

    def __init__(
        self,
        fg: NGPField,
        bg: NGPField,
        settings: RenderSettings = RenderSettings(),
        res: int = CLIP_RES,
        intrinsics: Optional[np.ndarray] = None,
        out_render_path: Optional[str] = None,
        poses_per_dispatch: int = 64,
        row_chunk: int = 56,
        obj_aabb=None,
        fg_crop: int = 0,
        crop_settings: Optional[RenderSettings] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        for name, field in (("fg", fg), ("bg", bg)):
            got = next(field.parameters()).device
            if got.type != self.device.type:
                raise ValueError(f"CombinedRenderer on {self.device}: the {name} field is on {got}")
        self.fg, self.bg = fg, bg
        self.settings = settings
        self.res = res
        if intrinsics is None:
            intrinsics = cameras.INTRINSICS_CLIP_VIEW
        self.intrinsics = np.asarray(intrinsics)
        self.dirs_cam = cameras.pixel_dirs(res, res, self.intrinsics, device=self.device)
        self.out_render_path = out_render_path
        self.poses_per_dispatch = poses_per_dispatch
        self.row_chunk = row_chunk if res % max(row_chunk, 1) == 0 else 0
        # Fast path: march the fg only inside the object's projected crop
        # window with a tight t-range (obj_aabb = the movable object's world
        # bounds at its initial pose, static for every candidate thanks to
        # the virtual-camera trick).
        self.obj_aabb = obj_aabb
        self.fg_crop = min(fg_crop, res) if fg_crop else 0
        # Uniform samples over the tight object box; D2R_CROP_SAMPLES sets
        # their count (default 20, as the reference).
        self.crop_settings = crop_settings or settings._replace(
            n_coarse=int(os.environ.get("D2R_CROP_SAMPLES", "20")), n_fine=0
        )

    # ------------------------------------------------------------ crop guard

    def crop_required(self, T_WO_1, render_poses, poses) -> int:
        """See ``required_crop``; 0 when no crop is configured."""
        if not self.fg_crop or self.obj_aabb is None:
            return 0
        return required_crop(self.obj_aabb, self.intrinsics, self.res, T_WO_1, render_poses,
                             poses)

    def bump_crop(self, crop: int) -> None:
        """Grow the crop window (the guard found candidates that would
        clip). Nothing is compiled for a crop size here, so that is all."""
        self.fg_crop = min(int(crop), self.res)

    # ---------------------------------------------------------------- bg

    def _f32(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x).to(
            device=self.device, dtype=F32)

    def render_background(self, T_WC, gt_depth=None, movable_mask=None) -> BackgroundView:
        """Render the task background once for a view.

        gt_depth (H, W) metres; movable_mask (H, W) nonzero outside the
        movable object. Opaque black background: alpha -> 1, premultiplied
        rgb unchanged. With a scan's depth the composite tests against it,
        the movable object's pixels pushed to 100."""
        with torch.inference_mode():
            out = render_image(self.bg, self._f32(T_WC), self.dirs_cam, self.settings,
                               row_chunk=self.row_chunk)
            alpha = torch.ones_like(out["alpha"])
            if gt_depth is not None:
                depth = rectify_depth(self._f32(gt_depth), self.res)
                if movable_mask is not None:
                    m = rectify_mask(self._f32(movable_mask), self.res)
                    depth = torch.where(m == 0, torch.full_like(depth, 100.0), depth)
            else:
                depth = out["depth"]
            return BackgroundView(rgb=out["rgb"], alpha=alpha, depth=depth)

    # ---------------------------------------------------------------- fg

    def render(
        self,
        valid_poses,          # (K, 4, 4) or (K, 16) candidate world poses
        render_poses,         # (L, 4, 4) camera poses of the render views
        render_cam_pose_idx,  # view indices (kept for the reference's signature)
        depths_gt=None,       # (L, H, W) GT depths of the render views
        movable_masks=None,   # (L, H, W) nonzero outside the movable object
        T_WO_1=None,          # the movable object's current pose (4, 4)
        save: bool = False,
    ) -> np.ndarray:
        """Render every candidate pose from every render view. ->
        (K * L, res, res, 3) uint8 RGB, view-major like the reference. Each
        dispatch takes ``poses_per_dispatch`` poses, the last one padded
        with identity poses whose renders are dropped. Writes
        cb_render/cb_rgb_%04d.png for view 0 when save=True."""
        valid_poses = self._f32(valid_poses).reshape(-1, 4, 4)
        render_poses = self._f32(render_poses).reshape(-1, 4, 4)
        if T_WO_1 is None:
            raise ValueError("T_WO_1 (movable object pose) is required")
        T_WO_1 = self._f32(T_WO_1).reshape(4, 4)
        use_crop = bool(self.fg_crop) and self.obj_aabb is not None
        packed = pack_crop(self.fg, self.crop_settings, self.device) if use_crop else None

        k = valid_poses.shape[0]
        p = min(self.poses_per_dispatch, max(k, 1))
        all_imgs = []
        with torch.inference_mode():
            for view_i in range(render_poses.shape[0]):
                bg = self.render_background(
                    render_poses[view_i],
                    None if depths_gt is None else depths_gt[view_i],
                    None if movable_masks is None else movable_masks[view_i],
                )
                bg_only = background_only_image(bg) if use_crop else None
                for start in range(0, k, p):
                    chunk = valid_poses[start : start + p]
                    pad = p - chunk.shape[0]
                    if pad:
                        eye = torch.eye(4, dtype=F32, device=self.device)
                        chunk = torch.cat([chunk, eye.expand(pad, 4, 4)])
                    imgs = render_pose_batch(
                        self.fg, self.settings, self.crop_settings, self.dirs_cam,
                        self.intrinsics, self.obj_aabb, self.fg_crop, self.row_chunk, T_WO_1,
                        render_poses[view_i], bg, bg_only, chunk, packed=packed)
                    all_imgs.append(imgs[: p - pad].cpu().numpy())
        renders = np.concatenate(all_imgs, axis=0)

        if save and self.out_render_path:
            if os.path.exists(self.out_render_path):
                shutil.rmtree(self.out_render_path)
            os.makedirs(self.out_render_path)
            # Only view 0's renders are saved, as the reference does.
            for i in range(min(k, renders.shape[0])):
                write_png(os.path.join(self.out_render_path, f"cb_rgb_{i:04d}.png"), renders[i])
        return renders

