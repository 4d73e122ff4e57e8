"""Synthetic RGB-D scenes with analytic ground truth (port of
dream2real_tpu/data/synth.py): the default and rectangular-box tabletops, an
orbit of look-at camera poses, the analytic renderer (exact ray-plane /
ray-box hits, Lambert shading, optional Brown-Conrady lens) and
``write_dataset``, which writes a Dream2Real-format scan directory
(``images/rgb_%04d.png``, ``depth/depth_%04d.png`` in mm, ``masks/``,
``poses.txt``, ``transforms.json``, ``synth_meta.json``, ``captions.json``)
through the port's PNG codec. Host numpy.

    python -m dream2real_tpu_torch.data.synth OUT_DIR [N_VIEWS] [--distort] [--noise]
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from dream2real_tpu_torch.ops.cameras import normalize_distortion, pixel_dirs
from dream2real_tpu_torch.utils.png import write_png


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


def rect_scene() -> SynthScene:
    """The default scene with a rectangular-footprint movable box (0.14 x
    0.06), so that a 90-degree yaw changes its silhouette; the green
    target's top face (0.18 x 0.18) fits it at either yaw."""
    return SynthScene(
        boxes=[
            Box((0.40, -0.13, 0.0), (0.54, -0.07, 0.08), (0.85, 0.15, 0.10)),
            Box((0.52, 0.02, 0.0), (0.70, 0.20, 0.06), (0.10, 0.75, 0.20)),
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


def render_scene(scene: SynthScene, T_WC: np.ndarray, intrinsics: np.ndarray, h: int, w: int,
                 distortion=None):
    """Analytic render: exact ray-plane / ray-box hits with Lambert shading,
    through the lens a distorted camera would have when ``distortion`` is
    given (depth stays z-depth along each pixel's ray). Returns (rgb u8 (h,
    w, 3), z-depth f32 (h, w), instance ids u8 (h, w): 0 plane, 1..K boxes,
    255 sky)."""
    dirs_cam = pixel_dirs(h, w, intrinsics, normalize_distortion(distortion),
                          device="cpu").numpy()
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


#: A RealSense-like Brown-Conrady coefficient set for the distorted scan
#: variant (k1, k2, p1, p2, k3, k4).
DEFAULT_DISTORTION = (-0.12, 0.03, 0.0008, -0.0006, 0.0, 0.0)

#: Real-scan corruption preset (``write_dataset(noise=...)``): RGB shot noise,
#: depth error growing with the square of range, depth holes and per-view
#: SE(3) jitter of the written poses (the images stay rendered from the true
#: poses).
DEFAULT_NOISE = {
    "rgb_sigma": 3.0,        # u8 units
    "depth_quad": 0.003,     # metres^-1 (sigma(z) = depth_quad * z^2)
    "depth_dropout": 0.02,   # fraction of pixels zeroed (sensor holes)
    "pose_rot_deg": 0.4,     # per-view rotation jitter (std per axis)
    "pose_trans_mm": 4.0,    # per-view translation jitter (std per axis)
}


def _jitter_pose(T: np.ndarray, rot_deg: float, trans_mm: float, rng) -> np.ndarray:
    """Right-multiply camera-frame SE(3) noise: T @ [R(w) | t]."""
    w = np.deg2rad(rot_deg) * rng.standard_normal(3)
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    R = np.eye(3) if th < 1e-12 else (
        np.eye(3) + np.sin(th) / th * K + (1 - np.cos(th)) / th**2 * (K @ K)
    )
    J = np.eye(4)
    J[:3, :3] = R
    J[:3, 3] = trans_mm * 1e-3 * rng.standard_normal(3)
    return T @ J


def write_dataset(
    out_dir: str,
    scene: SynthScene | None = None,
    n_views: int = 24,
    h: int = 180,
    w: int = 320,
    intrinsics: np.ndarray | None = None,
    distortion=None,
    noise: dict | None = None,
    seed: int = 0,
) -> dict:
    """Write a Dream2Real-format scan directory of an analytic scene:
    images/rgb_%04d.png, depth/depth_%04d.png (mm, uint16), masks/mask_%04d.png
    (instance ids), poses.txt (stacked 4 x 4), transforms.json (NGP
    convention), synth_meta.json and captions.json (the ground-truth
    captions that key the packaged LLM cache). ``noise`` (see DEFAULT_NOISE)
    adds sensor noise and depth holes to the images and SE(3) jitter to the
    written poses; poses_true.txt then records the true ones. -> the
    metadata dict."""
    scene = scene or default_scene()
    if intrinsics is None:
        f = 0.9 * w
        intrinsics = np.array([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1.0]])
    os.makedirs(out_dir, exist_ok=True)
    for sub in ("images", "depth", "masks"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)

    distortion = normalize_distortion(distortion)
    poses = orbit_poses(scene.centre, n_views)
    rng = np.random.default_rng(seed)
    file_poses = poses
    if noise is not None:
        nz = {**DEFAULT_NOISE, **noise}
        file_poses = np.stack([
            _jitter_pose(poses[i], nz["pose_rot_deg"], nz["pose_trans_mm"], rng)
            for i in range(n_views)
        ])
    frames = []
    for i in range(n_views):
        rgb, depth, inst = render_scene(scene, poses[i], intrinsics, h, w, distortion=distortion)
        if noise is not None:
            rgb = np.clip(
                rgb.astype(np.float32) + nz["rgb_sigma"] * rng.standard_normal(rgb.shape),
                0, 255,
            ).astype(np.uint8)
            valid = depth > 0
            depth = np.where(
                valid,
                depth + nz["depth_quad"] * depth**2
                * rng.standard_normal(depth.shape).astype(np.float32),
                depth,
            )
            holes = rng.random(depth.shape) < nz["depth_dropout"]
            depth = np.where(holes, 0.0, depth)  # 0 = invalid
        write_png(os.path.join(out_dir, "images", f"rgb_{i:04d}.png"), rgb)
        depth_mm = np.clip(depth * 1000.0, 0, 65535).astype(np.uint16)
        write_png(os.path.join(out_dir, "depth", f"depth_{i:04d}.png"), depth_mm)
        write_png(os.path.join(out_dir, "masks", f"mask_{i:04d}.png"), inst)
        c2w = file_poses[i].copy()  # NGP convention: y / z columns flipped
        c2w[:3, 1] *= -1
        c2w[:3, 2] *= -1
        frames.append({"file_path": f"./images/rgb_{i:04d}.png", "transform_matrix": c2w.tolist()})

    np.savetxt(os.path.join(out_dir, "poses.txt"), file_poses.reshape(-1, 4))
    if noise is not None:
        np.savetxt(os.path.join(out_dir, "poses_true.txt"), poses.reshape(-1, 4))

    # Coefficient order k1, k2, p1, p2, k3, k4 (cfg.distortion_array).
    d = [0.0] * 6 if distortion is None else [float(v) for v in np.asarray(distortion)]
    transforms = {
        "fl_x": intrinsics[0, 0],
        "fl_y": intrinsics[1, 1],
        "k1": d[0], "k2": d[1], "k3": d[4], "k4": d[5], "p1": d[2], "p2": d[3],
        "is_fisheye": False,
        "cx": intrinsics[0, 2],
        "cy": intrinsics[1, 2],
        "w": w, "h": h,
        "aabb_scale": 2,
        "scale": 1,
        "offset": [0.0, 0.0, 0.0],
        "frames": frames,
    }
    with open(os.path.join(out_dir, "transforms.json"), "w") as f:
        json.dump(transforms, f, indent=2)

    meta = {
        "scene_centre": list(scene.centre),
        "scene_phys_bounds": [[0.1, -0.5, -0.05], [0.9, 0.5, 0.6]],
        "n_objects": len(scene.boxes),
        "distortion": d,
        "noise": None if noise is None else {**DEFAULT_NOISE, **noise},
        "intrinsics": intrinsics.tolist(),
        "h": h,
        "w": w,
        "boxes": [dataclasses.asdict(b) for b in scene.boxes],
        "plane_z": scene.plane_z,
    }
    with open(os.path.join(out_dir, "synth_meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    with open(os.path.join(out_dir, "captions.json"), "w") as f:
        json.dump(["__background__", "a red box", "a green box", "a blue box"], f)
    return meta


if __name__ == "__main__":
    import sys

    args = [a for a in sys.argv[1:] if not a.startswith("-")]
    out = args[0] if args else "./synth_dataset"
    n = int(args[1]) if len(args) > 1 else 24
    dist = DEFAULT_DISTORTION if "--distort" in sys.argv else None
    nz = DEFAULT_NOISE if "--noise" in sys.argv else None
    write_dataset(out, n_views=n, distortion=dist, noise=nz)
    print(
        f"Wrote synthetic dataset to {out}"
        + (f" (Brown-Conrady distortion {dist})" if dist else "")
        + (f" (sensor/SLAM noise {nz})" if nz else "")
    )
