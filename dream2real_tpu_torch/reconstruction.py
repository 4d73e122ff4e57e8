"""NeRF reconstruction driver (port of dream2real_tpu/reconstruction.py):
dataset IO and training orchestration on one device.

- ``build_vis_model``: transforms.json (written from poses.txt when the
  extrinsics are optimised) -> trained field under the convergence
  governor -> snapshot (npz + JSON header with the RenderSettings, readable
  by either package) and the optimised-pose exports (opt_cam_poses.npy,
  fg/bg transforms.json);
- ``get_vis_ngps``: masked RGBA images (mask as alpha) -> fg / task-bg field.

``NGPModel`` bundles (field, NGPConfig, RenderSettings), the handle the
engine and renderer pass around. Image files go through the port's PNG
codec (``utils/png.py``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from dream2real_tpu_torch.bridge import field_from_jax
from dream2real_tpu_torch.device import F32, resolve_device
from dream2real_tpu_torch.nerf.model import NGPConfig, NGPField
from dream2real_tpu_torch.nerf.render import RenderSettings
from dream2real_tpu_torch.nerf.snapshot import (
    load_snapshot, save_snapshot, settings_from_extra, snapshot_path,
)
from dream2real_tpu_torch.nerf.trainer import (
    TrainConfig, init_train_state, make_train_chunk, optimized_poses, train_with_governor,
)
from dream2real_tpu_torch.ops import cameras
from dream2real_tpu_torch.parallel import mesh as pmesh
from dream2real_tpu_torch.utils.png import read_pngs, to_rgb, write_png


#: One entry a build_vis_model call, appended when its training ends: the
#: transforms file it read, the steps the convergence governor ran and the
#: final loss.
TRAIN_LOG: list = []

#: The sharding decision of the most recent build_vis_model run:
#: "mesh_devices" and the global "batch_rays".
LAST_TRAIN_INFO: dict = {}


@dataclasses.dataclass
class NGPModel:
    """The vis_model handle: a trained field, its config and the
    RenderSettings it was trained with."""

    field: NGPField
    cfg: NGPConfig
    settings: RenderSettings

    @classmethod
    def load(cls, path: str, settings: Optional[RenderSettings] = None,
             device=None) -> "NGPModel":
        """Load a snapshot of either package; the RenderSettings its
        training run persisted are restored unless given."""
        params, cfg, extra = load_snapshot(snapshot_path(path))
        field = field_from_jax(params, cfg, device)
        return cls(field=field, cfg=cfg,
                   settings=settings or settings_from_extra(extra) or RenderSettings())


def raw_poses_convert(cfg, out_path: str):
    """poses.txt -> transforms.json with full intrinsics / distortion; frames
    carry NGP-convention matrices (y / z columns flipped)."""
    out = {
        "fl_x": cfg.fx,
        "fl_y": cfg.fy,
        "k1": getattr(cfg, "k1", 0.0),
        "k2": getattr(cfg, "k2", 0.0),
        "k3": getattr(cfg, "k3", 0.0),
        "k4": getattr(cfg, "k4", 0.0),
        "p1": getattr(cfg, "p1", 0.0),
        "p2": getattr(cfg, "p2", 0.0),
        "is_fisheye": getattr(cfg, "is_fisheye", False),
        "cx": cfg.cx,
        "cy": cfg.cy,
        "w": cfg.W,
        "h": cfg.H,
        "aabb_scale": 2,
        "scale": cfg.scale,
        "offset": cfg.offset,
        "frames": [],
    }
    if cfg.camera_angle_x is not None:
        out["camera_angle_x"] = cfg.camera_angle_x
        out["camera_angle_y"] = cfg.camera_angle_y
    traj = np.loadtxt(os.path.join(cfg.data_dir, "poses.txt")).reshape(-1, 4, 4)
    for i, c2w in enumerate(traj):
        m = c2w.copy()
        m[:3, 1] *= -1
        m[:3, 2] *= -1
        out["frames"].append(
            {"file_path": f"./images/rgb_{i:04d}.png", "transform_matrix": m.tolist()}
        )
    with open(out_path, "w") as f:
        json.dump(out, f, indent=2)


def load_transforms_dataset(transforms_path: str, data_dir: str):
    """Read a transforms.json: images (RGBA uint8), accio poses, intrinsics,
    distortion. The frames' NGP-convention matrices are flipped back to accio."""
    with open(transforms_path) as f:
        meta = json.load(f)
    K = np.array([[meta["fl_x"], 0, meta["cx"]], [0, meta["fl_y"], meta["cy"]], [0, 0, 1.0]])
    dist = None
    if any(meta.get(k) for k in ("k1", "k2", "p1", "p2", "k3", "k4")):
        dist = np.array([meta.get(k, 0.0) for k in ("k1", "k2", "p1", "p2", "k3", "k4")])
    imgs = read_pngs([os.path.join(data_dir, fr["file_path"].lstrip("./"))
                      for fr in meta["frames"]])
    if imgs.shape[-1] != 4:
        rgb = np.stack([to_rgb(im) for im in imgs])
        imgs = np.concatenate([rgb, np.full(rgb.shape[:3] + (1,), 255, np.uint8)], axis=-1)
    poses = []
    for fr in meta["frames"]:
        m = np.asarray(fr["transform_matrix"], np.float32)
        m[:3, 1] *= -1  # NGP -> accio
        m[:3, 2] *= -1
        poses.append(m)
    return imgs, np.stack(poses), K, dist


def _aabb_from_cfg(cfg, poses: Optional[np.ndarray], pad: float = 0.15):
    """Field AABB: scene_phys_bounds padded when the config has them, else
    the camera positions' bounding box grown by 1 m."""
    b = getattr(cfg, "scene_phys_bounds", None)
    if b is not None:
        lo = np.asarray(b[0], np.float64) - pad
        hi = np.asarray(b[1], np.float64) + pad
        return tuple(lo.tolist()), tuple(hi.tolist())
    t = poses[:, :3, 3]
    return tuple((t.min(axis=0) - 1.0).tolist()), tuple((t.max(axis=0) + 1.0).tolist())


def field_spec(cfg, poses: Optional[np.ndarray] = None,
               field_overrides: Optional[dict] = None):
    """(NGPConfig, RenderSettings) a build_vis_model run with this config
    uses; D2R_TRAIN_SAMPLING="nc,nf" overrides the 32 + 32 sampling."""
    aabb_min, aabb_max = _aabb_from_cfg(cfg, poses)
    field_kw = dict(aabb_min=aabb_min, aabb_max=aabb_max)
    if field_overrides:
        field_kw.update(field_overrides)
    nc, nf = (int(v) for v in os.environ.get("D2R_TRAIN_SAMPLING", "32,32").split(","))
    settings = RenderSettings(n_coarse=nc, n_fine=nf, near=cfg.near_distance, far=cfg.max_depth)
    return NGPConfig(**field_kw), settings


def build_vis_model(
    cfg,
    dynamic_time_extension: bool = True,
    render_distract: bool = False,
    images_override: Optional[np.ndarray] = None,
    depths: Optional[np.ndarray] = None,
    field_overrides: Optional[dict] = None,
    train_overrides: Optional[dict] = None,
    log_fn=None,
    warm_start: bool = True,
    device=None,
):
    """Train a NeRF per config; returns (NGPModel, opt_cam_poses or None).

    opt_cam_poses are exported in the accio convention to
    data_dir/opt_cam_poses.npy, and fg/bg transforms.json stubs are written
    for the task-field stage (full-scene builds only)."""
    dev = resolve_device(device)
    transforms_path = cfg.files
    if cfg.optimize_extrinsics:
        raw_poses_convert(cfg, transforms_path)

    imgs, poses, K, dist = load_transforms_dataset(transforms_path, cfg.data_dir)
    if images_override is not None:
        imgs = np.asarray(images_override)
    ngp_cfg, settings = field_spec(cfg, poses, field_overrides)

    steps_scale = float(os.environ.get("D2R_TRAIN_STEPS_SCALE", "1.0"))
    tc_kw = dict(
        n_steps=max(1, int(cfg.n_steps * steps_scale)),
        optimize_extrinsics=bool(cfg.optimize_extrinsics),
        dynamic_time_extension=dynamic_time_extension and not render_distract,
        # The governor's hard cap scales with the step scale, so quick runs
        # cannot be extended back to 40k steps.
        max_infinity_steps=max(1000, int(40000 * steps_scale)),
    )
    if train_overrides:
        tc_kw.update(train_overrides)
    tc = TrainConfig(**tc_kw)

    h, w = imgs.shape[1:3]
    dirs_cam = cameras.pixel_dirs(h, w, K, dist, device=dev)
    state = init_train_state(ngp_cfg, tc, n_images=len(imgs), device=dev)

    if warm_start and cfg.load_snapshot and os.path.exists(snapshot_path(cfg.load_snapshot_path)):
        params_loaded, cfg_loaded, _ = load_snapshot(snapshot_path(cfg.load_snapshot_path))
        if cfg_loaded == ngp_cfg:
            warm = field_from_jax(params_loaded, ngp_cfg, dev)
            with torch.no_grad():
                for k, p in state["field"].named_parameters():
                    p.copy_(getattr(warm, k))

    # Alpha-masked training set (fg / bg task fields): importance-sample the
    # opaque pixels, else the mostly transparent supervision starves the
    # object and the field collapses to empty.
    fg_pixels = None
    alpha = imgs[..., 3]
    if float((alpha > 127).mean()) < 0.5:
        coords = np.argwhere(alpha > 127)
        if len(coords):
            if len(coords) > (1 << 20):
                coords = coords[np.linspace(0, len(coords) - 1, 1 << 20).astype(int)]
            fg_pixels = torch.as_tensor(coords, dtype=torch.int64, device=dev)

    # Several devices: the ray batch shards over the mesh, every device
    # taking part in every step. D2R_TRAIN_BATCH_SCALE_MESH=1 also scales
    # the global batch by the mesh size (constant work a device); by default
    # sharded and single-device runs train with the same batch.
    mesh = pmesh.leads(pmesh.auto_mesh(), dev)
    ray_sharding = None
    if mesh is not None:
        if os.environ.get("D2R_TRAIN_BATCH_SCALE_MESH") == "1":
            tc = dataclasses.replace(tc, batch_rays=tc.batch_rays * mesh.size)
        if tc.batch_rays % mesh.size == 0:
            ray_sharding = pmesh.pose_sharding(mesh)
    LAST_TRAIN_INFO.clear()
    LAST_TRAIN_INFO.update(mesh_devices=1 if ray_sharding is None else mesh.size,
                           batch_rays=tc.batch_rays)

    poses_t = torch.as_tensor(poses, dtype=F32, device=dev)
    chunk = make_train_chunk(
        ngp_cfg, tc, settings,
        torch.as_tensor(imgs, device=dev), poses_t, dirs_cam,
        depths=None if depths is None else torch.as_tensor(np.asarray(depths), dtype=F32,
                                                           device=dev),
        fg_pixels=fg_pixels, ray_sharding=ray_sharding,
    )
    state, losses = train_with_governor(chunk, state, tc, log_fn=log_fn)
    TRAIN_LOG.append({"files": os.path.basename(transforms_path), "steps": int(state["step"]),
                      "final_loss": losses[-1]})

    opt_cam_poses = None
    if cfg.optimize_extrinsics:
        with torch.no_grad():
            opt_cam_poses = optimized_poses(state["ext_rot"], state["ext_trans"],
                                            poses_t).cpu().numpy()
    if images_override is None:
        # The task-field stage always loads its poses from
        # {fg,bg}_transforms.json / opt_cam_poses.npy: export them even when
        # the extrinsics are not optimised (raw poses then).
        exported = opt_cam_poses if opt_cam_poses is not None else np.asarray(poses)
        np.save(os.path.join(cfg.data_dir, "opt_cam_poses.npy"), exported)
        export_task_transforms(cfg, exported)

    model = NGPModel(field=state["field"], cfg=ngp_cfg, settings=settings)
    if cfg.save_snapshot:
        save_snapshot(
            cfg.save_snapshot_path,
            model.field,
            ngp_cfg,
            extra={
                "losses_tail": [float(x) for x in losses[-5:]],
                # The RenderSettings travel with the snapshot, so a replay
                # renders exactly like the run that trained the model.
                "settings": {
                    "n_coarse": settings.n_coarse,
                    "n_fine": settings.n_fine,
                    "near": settings.near,
                    "far": settings.far,
                    "min_transmittance": settings.min_transmittance,
                    "compute_dtype": settings.compute_dtype,
                },
            },
        )
    return model, opt_cam_poses


def export_task_transforms(cfg, opt_cam_poses_accio: np.ndarray):
    """Write fg_transforms.json / bg_transforms.json with the optimised poses
    (NGP convention in the file, images under images_fg/ and images_bg/)."""
    base = {
        "fl_x": cfg.fx,
        "fl_y": cfg.fy,
        "k1": getattr(cfg, "k1", 0.0),
        "k2": getattr(cfg, "k2", 0.0),
        "k3": getattr(cfg, "k3", 0.0),
        "k4": getattr(cfg, "k4", 0.0),
        "p1": getattr(cfg, "p1", 0.0),
        "p2": getattr(cfg, "p2", 0.0),
        "is_fisheye": getattr(cfg, "is_fisheye", False),
        "cx": cfg.cx,
        "cy": cfg.cy,
        "w": cfg.W,
        "h": cfg.H,
        "aabb_scale": 1,
        "scale": cfg.scale,
        "offset": cfg.offset,
    }
    if cfg.camera_angle_x is not None:
        base["camera_angle_x"] = cfg.camera_angle_x
        base["camera_angle_y"] = cfg.camera_angle_y
    for tag in ("fg", "bg"):
        out = dict(base)
        out["frames"] = []
        for i, m_accio in enumerate(opt_cam_poses_accio):
            m = np.asarray(m_accio).copy()
            m[:3, 1] *= -1  # accio -> NGP for the file format
            m[:3, 2] *= -1
            out["frames"].append(
                {"file_path": f"./images_{tag}/rgb_{i:04d}.png", "transform_matrix": m.tolist()}
            )
        with open(os.path.join(cfg.data_dir, f"{tag}_transforms.json"), "w") as f:
            json.dump(out, f, indent=2)


def get_vis_ngps(
    rgbs,
    movable_masks,
    scene_type,
    use_cache: bool = False,
    data_dir: Optional[str] = None,
    fg: bool = True,
    render_distract: bool = False,
    cfg_dir: Optional[str] = None,
    depths=None,
    scene_phys_bounds=None,
    field_overrides: Optional[dict] = None,
    train_overrides: Optional[dict] = None,
    warm_start: bool = False,
    device=None,
) -> NGPModel:
    """Build (or load) the fg / task-bg field. movable_masks: True = pixels
    to make transparent (the mask as inverted alpha). Cold start by default:
    the MLP field fine-tunes worse from the full-scene snapshot than it
    trains from scratch."""
    from dream2real_tpu_torch.cfg import Config

    snap = os.path.join(data_dir, "fg_base.ingp" if fg else "bg_base.ingp")
    if use_cache:
        print(f'Using cached {"fg" if fg else "bg"} model')
        return NGPModel.load(snap, device=device)

    tag = "fg" if fg else "bg"
    out_path = os.path.join(data_dir, f"images_{tag}")
    os.makedirs(out_path, exist_ok=True)
    rgbs = np.asarray(rgbs)
    alphas = (1 - np.asarray(movable_masks).astype(np.uint8)) * 255
    rgba = np.concatenate([rgbs, alphas[..., None]], axis=-1).astype(np.uint8)
    for i in range(rgba.shape[0]):
        write_png(os.path.join(out_path, f"rgb_{i:04d}.png"), rgba[i])

    cfg_dir = cfg_dir or os.path.join(os.path.dirname(__file__), "..", "configs")
    cfg = Config(os.path.join(cfg_dir, f"{tag}_scene.json"), data_dir)
    if scene_phys_bounds is not None:
        cfg.scene_phys_bounds = scene_phys_bounds
    model, _ = build_vis_model(
        cfg,
        render_distract=render_distract,
        images_override=rgba,
        depths=depths,
        field_overrides=field_overrides,
        train_overrides=train_overrides,
        warm_start=warm_start,
        device=device,
    )
    return model
