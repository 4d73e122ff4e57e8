"""Synthetic tabletop (the part of dream2real_tpu/data/synth.py the
imagine-and-score drive needs): the default scene, an orbit of look-at
camera poses and the analytic renderer that gives a view's ground-truth
depth and instance ids. Host numpy."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Box:
    lo: tuple[float, float, float]
    hi: tuple[float, float, float]
    color: tuple[float, float, float]


@dataclasses.dataclass
class SynthScene:
    boxes: list[Box]
    plane_z: float = 0.0
    plane_color: tuple[float, float, float] = (0.75, 0.7, 0.65)
    sky_color: tuple[float, float, float] = (0.0, 0.0, 0.0)
    centre: tuple[float, float, float] = (0.5, 0.0, 0.0)


def default_scene() -> SynthScene:
    """Table plane + three boxes around the centre; box 0 (red) is the
    movable object, box 1 (green) a target, box 2 (blue) a distractor."""
    return SynthScene(
        boxes=[
            Box((0.42, -0.12, 0.0), (0.50, -0.04, 0.10), (0.85, 0.15, 0.10)),
            Box((0.55, 0.05, 0.0), (0.68, 0.18, 0.06), (0.10, 0.75, 0.20)),
            Box((0.36, 0.08, 0.0), (0.44, 0.16, 0.08), (0.15, 0.20, 0.85)),
        ],
        plane_z=0.0,
        centre=(0.5, 0.0, 0.05),
    )


def look_at_pose(eye: np.ndarray, target: np.ndarray, up=(0, 0, 1)) -> np.ndarray:
    """Camera-to-world pose, OpenCV convention (+z forward, +y down)."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    T = np.eye(4)
    T[:3, 0] = right
    T[:3, 1] = down
    T[:3, 2] = fwd
    T[:3, 3] = eye
    return T


def orbit_poses(centre, n: int, radius: float = 0.55, height: float = 0.45,
                sweep=2 * np.pi) -> np.ndarray:
    """n camera poses on an arc orbiting the scene centre, looking at it."""
    centre = np.asarray(centre, np.float64)
    poses = []
    for i in range(n):
        ang = sweep * i / max(n, 1)
        eye = centre + np.array([radius * np.cos(ang), radius * np.sin(ang), height])
        poses.append(look_at_pose(eye, centre))
    return np.stack(poses)


def render_scene(scene: SynthScene, T_WC: np.ndarray, intrinsics: np.ndarray, h: int, w: int):
    """Analytic pinhole render: exact ray-plane / ray-box hits with Lambert
    shading. Returns (rgb u8 (h, w, 3), z-depth f32 (h, w), instance ids u8
    (h, w): 0 plane, 1..K boxes, 255 sky)."""
    K = np.asarray(intrinsics, np.float64)
    ys, xs = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5, indexing="ij")
    dirs_cam = np.stack([(xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1],
                         np.ones_like(xs)], axis=-1).astype(np.float32)
    R, t = T_WC[:3, :3], T_WC[:3, 3]
    dirs = dirs_cam @ R.T
    o = t[None, None, :]

    t_best = np.full((h, w), np.inf, np.float64)
    color = np.tile(np.asarray(scene.sky_color), (h, w, 1))
    inst = np.full((h, w), 255, np.uint8)
    normal = np.zeros((h, w, 3))

    dz = dirs[..., 2]
    t_plane = (scene.plane_z - t[2]) / np.where(np.abs(dz) < 1e-9, 1e-9, dz)
    upd = (t_plane > 1e-4) & (t_plane < t_best)
    t_best = np.where(upd, t_plane, t_best)
    color[upd] = scene.plane_color
    inst[upd] = 0
    normal[upd] = [0, 0, 1]

    for k, box in enumerate(scene.boxes):
        safe = np.where(np.abs(dirs) < 1e-9, 1e-9, dirs)
        t_lo = (np.asarray(box.lo) - o) / safe
        t_hi = (np.asarray(box.hi) - o) / safe
        t0 = np.minimum(t_lo, t_hi)
        t_near = t0.max(axis=-1)
        t_far = np.maximum(t_lo, t_hi).min(axis=-1)
        upd = (t_far > t_near) & (t_near > 1e-4) & (t_near < t_best)
        t_best = np.where(upd, t_near, t_best)
        face_axis = np.argmax(t0, axis=-1)
        n_sign = -np.sign(np.take_along_axis(dirs, face_axis[..., None], axis=-1)[..., 0])
        face_n = np.zeros((h, w, 3))
        np.put_along_axis(face_n, face_axis[..., None], n_sign[..., None], axis=-1)
        color[upd] = np.asarray(box.color)
        inst[upd] = k + 1
        normal[upd] = face_n[upd]

    light = np.array([0.3, 0.2, 0.9])
    light = light / np.linalg.norm(light)
    lam = np.clip((normal * light).sum(-1), 0.0, 1.0) * 0.5 + 0.5
    shaded = np.clip(color * lam[..., None], 0, 1)
    depth = np.where(np.isfinite(t_best), t_best, 0.0).astype(np.float32)
    return (shaded * 255 + 0.5).astype(np.uint8), depth, inst
