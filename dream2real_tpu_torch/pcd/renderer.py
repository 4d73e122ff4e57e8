"""Point-splat renderer of the pcd ablation path (port of
dream2real_tpu/pcd/renderer.py).

336 x 336 CLIP-view renders of the task background's cloud plus the movable
cloud moved to each candidate pose, with every pixel whose channels all
exceed 220 blacked out afterwards.

The reference splats one pose at a time on the host: f64 projection,
``np.round``, points sorted far to near, then a 3 x 3 footprint written
offset by offset in (dy, dx) order, each a fancy assignment in which the
last write wins. ``splat_batch`` does the same for a chunk of poses at once
on the renderer's device:

- the movable points move by ``pose @ inv(old_pose)`` in f64 and round to
  f32, as ``PointCloud.transformed`` does; every coordinate is an explicit
  ``x*r0 + y*r1 + z*r2 + t`` in that order (no matmul, whose summation order
  is the library's), rounded half to even by ``torch.round`` as by
  ``np.round``;
- each pose's points are ranked by a stable sort of -z (the reference's
  quicksort leaves equal depths in no set order);
- a write is keyed ``offset_index * N + rank`` (int64) and reduced with
  ``scatter_reduce(..., "amax")`` into a (P, 336^2) buffer: the reference's
  last write, as a deterministic rule (``index_put_`` with repeated indices
  keeps an arbitrary writer on CUDA).

``splat`` and ``render_plain`` are the reference's per-pose loop on the
host, kept as the plain version the tests and the card check hold the
batched splat against; ``shown_ties`` tells which of the pixels where the
two differ are ties.
"""

from __future__ import annotations

import numpy as np
import torch

from dream2real_tpu_torch.device import resolve_device
from dream2real_tpu_torch.ops.cameras import INTRINSICS_CLIP_VIEW

CLIP_RES = 336
POINT_PX = 3
# Bytes of device memory splat_batch holds for each pose: per point, the
# f64 coordinates and their temporaries, the sort, the keys and indices of
# one offset; per pixel, the int64 write buffer, its rank, index and
# temporaries, the colour gather and the u8 frames. A chunk of poses takes
# at most CHUNK_BYTES on the device.
BYTES_PER_POINT = 160
BYTES_PER_PIXEL = 48
CHUNK_BYTES = {"cuda": 2 << 30, "cpu": 256 << 20}
# A projection within this many pixels of a half pixel rounds either way
# (shown_ties).
TIE_PX = 1e-9


def splat(points, colors, T_WC, K, res=CLIP_RES, point_px: int = POINT_PX, bg=255):
    """z-buffer splat of one point cloud on the host. -> (res, res, 3) u8,
    zbuf."""
    T_CW = np.linalg.inv(T_WC)
    cam = points @ T_CW[:3, :3].T + T_CW[:3, 3]
    z = cam[:, 2]
    front = z > 1e-6
    cam, z, cols = cam[front], z[front], colors[front]
    u = np.round(cam[:, 0] / z * K[0, 0] + K[0, 2]).astype(np.int64)
    v = np.round(cam[:, 1] / z * K[1, 1] + K[1, 2]).astype(np.int64)
    img = np.full((res, res, 3), bg, np.uint8)
    zbuf = np.full((res, res), np.inf, np.float64)
    half = point_px // 2
    order = np.argsort(-z)  # far to near: nearest written last
    u, v, z, cols = u[order], v[order], z[order], cols[order]
    for dy in range(-half, half + 1):
        for dx in range(-half, half + 1):
            uu = u + dx
            vv = v + dy
            ok = (uu >= 0) & (uu < res) & (vv >= 0) & (vv < res)
            img[vv[ok], uu[ok]] = cols[ok]
            zbuf[vv[ok], uu[ok]] = z[ok]
    return img, zbuf


def _affine(T: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """T (P, 4, 4) f64 applied to points x (P | 1, N, 3) f64, each output
    coordinate summed as x*r0 + y*r1 + z*r2 + t."""
    cols = [x[..., k] for k in range(3)]
    out = []
    for i in range(3):
        acc = cols[0] * T[:, i, 0, None]
        acc = acc + cols[1] * T[:, i, 1, None]
        acc = acc + cols[2] * T[:, i, 2, None]
        out.append(acc + T[:, i, 3, None])
    return torch.stack(out, dim=-1)


def splat_batch(bg_points, bg_colors, mv_points, mv_colors, tfs, T_WC, K,
                res: int = CLIP_RES, point_px: int = POINT_PX, bg: int = 255,
                return_winner: bool = False):
    """Splat the background cloud plus the movable cloud moved by each of
    ``tfs`` (P, 4, 4) f64, from camera pose ``T_WC``, on the device of
    ``bg_points``. Points: (N, 3) f32 tensors, colours (N, 3) u8 tensors.
    -> (P, res, res, 3) u8, white pixels not yet blacked out; with
    ``return_winner`` also (P, res, res) int64, the index into
    ``cat(bg, moved)`` of each pixel's writer (-1 for none)."""
    dev = bg_points.device
    P = tfs.shape[0]
    n_bg = bg_points.shape[0]
    n = n_bg + mv_points.shape[0]
    T_CW = torch.as_tensor(np.linalg.inv(np.asarray(T_WC, np.float64)), device=dev)[None]
    moved = _affine(tfs, mv_points.to(torch.float64)[None]).to(torch.float32)
    pts = torch.cat([bg_points[None].expand(P, n_bg, 3), moved], dim=1).to(torch.float64)
    cam = _affine(T_CW.expand(P, 4, 4), pts)
    z = cam[..., 2]
    front = z > 1e-6
    fx, fy, cx, cy = (float(K[0][0]), float(K[1][1]), float(K[0][2]), float(K[1][2]))
    u = torch.round(cam[..., 0] / z * fx + cx).to(torch.int64)
    v = torch.round(cam[..., 1] / z * fy + cy).to(torch.int64)
    del cam, pts, moved
    # Far to near, equal depths in point order; points behind the camera
    # sort after every point in front of it.
    perm = torch.sort(-z, dim=1, stable=True).indices
    u, v, front = u.gather(1, perm), v.gather(1, perm), front.gather(1, perm)
    rank = torch.arange(n, device=dev, dtype=torch.int64)[None]
    dump = res * res  # the slot of writes that fall off the image
    best = torch.full((P, dump + 1), -1, dtype=torch.int64, device=dev)
    half = point_px // 2
    offset = 0
    for dy in range(-half, half + 1):
        for dx in range(-half, half + 1):
            uu, vv = u + dx, v + dy
            ok = front & (uu >= 0) & (uu < res) & (vv >= 0) & (vv < res)
            pix = torch.where(ok, vv * res + uu, torch.full_like(uu, dump))
            best.scatter_reduce_(1, pix, (offset * n + rank).expand(P, n), "amax")
            offset += 1
    best = best[:, :dump]
    hit = best >= 0
    r = torch.where(hit, best % n, torch.zeros_like(best))
    idx = perm.gather(1, r)
    colors = torch.cat([bg_colors, mv_colors])
    img = torch.where(hit[..., None], colors[idx], torch.full_like(colors[idx], bg))
    img = img.reshape(P, res, res, 3)
    if return_winner:
        return img, torch.where(hit, idx, torch.full_like(idx, -1)).reshape(P, res, res)
    return img


def _black_out_white(img: torch.Tensor) -> torch.Tensor:
    """Pixels whose channels all exceed 220 -> 0, in place."""
    img[(img > 220).all(-1)] = 0
    return img


class PointCloudRenderer:
    """Renders of the task's point clouds at candidate movable poses, on
    ``device`` (CUDA unless named), as many poses at a time as the device's
    budget (CHUNK_BYTES) holds at the cloud's size."""

    def __init__(self, task_model=None, intrinsics=None, device=None):
        self.K = np.asarray(intrinsics if intrinsics is not None else INTRINSICS_CLIP_VIEW)
        self.device = resolve_device(device)

    def _chunk(self, n_points: int, res: int = CLIP_RES) -> int:
        budget = CHUNK_BYTES.get(self.device.type, CHUNK_BYTES["cpu"])
        return max(1, budget // (n_points * BYTES_PER_POINT + res * res * BYTES_PER_PIXEL))

    def _cloud(self, pcd):
        dev = self.device
        return (torch.as_tensor(np.asarray(pcd.points, np.float32), device=dev),
                torch.as_tensor(np.asarray(pcd.colors, np.uint8), device=dev))

    def render(self, render_pose, pose_batch, task_model, hide_movable: bool = False):
        """One render per movable pose: a list of (336, 336, 3) u8 RGB.

        hide_movable renders the task background without the movable
        object, one identical frame per requested pose (the reference
        declares the parameter and raises in its branch; this is the
        declared intent, as the JAX package has it).
        """
        bg_pcd = task_model.task_bground_obj.vis_model
        pose_batch = np.asarray(pose_batch, np.float64).reshape(-1, 4, 4)
        T_WC = np.asarray(render_pose, np.float64)
        bg_pts, bg_cols = self._cloud(bg_pcd)
        if hide_movable:
            empty_pts = torch.zeros((0, 3), dtype=torch.float32, device=self.device)
            empty_cols = torch.zeros((0, 3), dtype=torch.uint8, device=self.device)
            eye = torch.eye(4, dtype=torch.float64, device=self.device)[None]
            img = splat_batch(bg_pts, bg_cols, empty_pts, empty_cols, eye, T_WC, self.K)[0]
            img = _black_out_white(img).cpu().numpy()
            return [img.copy() for _ in range(len(pose_batch))]
        mv_pcd = task_model.movable_obj.vis_model
        old_pose = np.asarray(task_model.movable_obj.pose, np.float64).reshape(4, 4)
        mv_pts, mv_cols = self._cloud(mv_pcd)
        inv_old = np.linalg.inv(old_pose)
        tfs = np.stack([pose @ inv_old for pose in pose_batch])
        chunk = self._chunk(bg_pts.shape[0] + mv_pts.shape[0])
        out = []
        for s in range(0, len(tfs), chunk):
            tf = torch.as_tensor(tfs[s:s + chunk], device=self.device)
            imgs = _black_out_white(splat_batch(bg_pts, bg_cols, mv_pts, mv_cols, tf, T_WC, self.K))
            out.extend(imgs.cpu().numpy())
        return out

    def render_plain(self, render_pose, pose_batch, task_model, hide_movable: bool = False):
        """The reference's per-pose loop on the host (the plain version)."""
        bg_pcd = task_model.task_bground_obj.vis_model
        pose_batch = np.asarray(pose_batch).reshape(-1, 4, 4)
        if hide_movable:
            img, _ = splat(bg_pcd.points, bg_pcd.colors, np.asarray(render_pose, np.float64),
                           self.K)
            img[np.all(img > 220, axis=-1)] = 0
            return [img.copy() for _ in range(len(pose_batch))]
        mv_pcd = task_model.movable_obj.vis_model
        old_pose = np.asarray(task_model.movable_obj.pose, np.float64).reshape(4, 4)
        out = []
        for pose in pose_batch:
            tf = pose @ np.linalg.inv(old_pose)
            moved = mv_pcd.transformed(tf)
            pts = np.concatenate([bg_pcd.points, moved.points])
            cols = np.concatenate([bg_pcd.colors, moved.colors])
            img, _ = splat(pts, cols, np.asarray(render_pose, np.float64), self.K)
            img[np.all(img > 220, axis=-1)] = 0
            out.append(img)
        return out


def shown_ties(got, want, winner, pts, cols, T_WC, K, tie_px: float = TIE_PX):
    """One frame of the batched splat (``got``) against the per-pose loop's
    (``want``), with ``winner`` the batched splat's writer of each pixel
    (``splat_batch(..., return_winner=True)``) and ``pts`` / ``cols`` the
    frame's whole cloud: -> (pixels that differ, ties among them).

    A differing pixel is a tie when a point of the loop frame's colour
    (white-ish points also under black, which the black-out makes them)
    projects in front of the camera to the batched writer's pixel at the
    same depth (the reference's quicksort leaves equal depths in no set
    order), or when the writer's or such a point's projection lies within
    ``tie_px`` of a half pixel."""
    diff = np.argwhere(np.any(got != want, axis=-1))
    T_CW = np.linalg.inv(T_WC)
    cam = pts.astype(np.float64) @ T_CW[:3, :3].T + T_CW[:3, 3]
    z = cam[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        u = cam[:, 0] / z * K[0, 0] + K[0, 2]
        v = cam[:, 1] / z * K[1, 1] + K[1, 2]
    ambiguous = (np.abs(np.abs(u - np.floor(u)) - 0.5) < tie_px) | (
        np.abs(np.abs(v - np.floor(v)) - 0.5) < tie_px)
    ur, vr = np.round(u), np.round(v)
    code = cols.astype(np.int64) @ [1 << 16, 1 << 8, 1]
    order = np.argsort(code, kind="stable")
    white = np.flatnonzero(np.all(cols > 220, axis=-1))
    ties = 0
    for py, px in diff:
        w = winner[py, px]
        if w < 0:
            continue
        key = int(want[py, px].astype(np.int64) @ [1 << 16, 1 << 8, 1])
        lo, hi = np.searchsorted(code[order], [key, key + 1])
        cand = np.concatenate([order[lo:hi], white if key == 0 else []]).astype(np.int64)
        same = (vr[cand] == vr[w]) & (ur[cand] == ur[w]) & (z[cand] > 1e-6) & (z[cand] == z[w])
        if same.any() or ambiguous[w] or ambiguous[cand].any():
            ties += 1
    return len(diff), ties
