"""Config system (numpy-only copy of dream2real_tpu/cfg.py's ``Config`` and
``validate_cache_flags``):
flat JSON -> attribute object, with the reference's schema (sections
``dataset`` / ``engine`` / ``trainer`` / ``render`` / ``camera`` / ``vis`` /
``robot``), so the repo's configs and cached artifact directories work
unchanged. Device fields (``train_device`` / ``data_device``) are read and
ignored: the port places work by its ``device`` arguments.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np


def _load_json(path: str) -> dict:
    """Load JSON, tolerating // and /* */ comments (reference uses commentjson
    for NGP scene configs, reconstruction/train_ngp.py:15)."""
    with open(path) as f:
        text = f.read()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        import re

        text = re.sub(r"//[^\n]*", "", text)
        text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
        return json.loads(text)


class Config:
    """Attribute-style view over a Dream2Real JSON config.

    Mirrors the reference's Config attribute for attribute.
    """

    def __init__(self, config_file: str, data_dir: str):
        config = _load_json(config_file)
        self.raw = config

        # dataset (cfg.py:15-16)
        self.data_dir = data_dir
        self.files = os.path.join(data_dir, config["dataset"]["files"])

        # engine (cfg.py:19-53)
        if "engine" in config:
            eng = config["engine"]
            self.inpaint_holes = eng["inpaint_holes"]
            self.caption = eng["caption"]
            self.visseg = eng["visseg"]
            self.render_distractors = eng["render_distractors"]
            self.spatial_smoothing = eng["spatial_smoothing"]
            self.physics_only = eng["physics_only"]
            self.use_vis_pcds = eng["use_vis_pcds"]
            # 0: single view, 1: multi view (cfg.py:27-31)
            self.pcds_type = eng["pcds_type"] if self.use_vis_pcds else None
            self.single_view_idx = eng.get("single_view_idx", 0)
            self.use_cache_dynamic_masks = eng["use_cache_dynamic_masks"]
            self.use_cache_segs = eng["use_cache_segs"]
            self.use_cache_cam_poses = eng["use_cache_cam_poses"]
            self.use_cache_captions = eng["use_cache_captions"]
            self.use_cache_phys = eng["use_cache_phys"]
            self.use_cache_vis = eng["use_cache_vis"]
            self.use_cache_llm = eng["use_cache_llm"]
            self.use_cache_renders = eng["use_cache_renders"]
            self.use_cache_goal_pose = eng["use_cache_goal_pose"]
            self.use_phys = eng["use_phys"]
            self.use_phys_tsdf = eng["use_phys_tsdf"]
            self.lazy_phys_mods = eng["lazy_phys_mods"]
            self.multi_view_captions = eng["multi_view_captions"]
            self.scene_type = eng["scene_type"]
            self.sample_res = eng["sample_res"]
            self.scene_centre = eng["scene_centre"]
            self.scene_phys_bounds = eng["scene_phys_bounds"]
            self.render_cam_pose_idx = eng["render_cam_pose_idx"]
            # Extensions of the upstream schema: explicit sampling bounds
            # override and render resolution (upstream hardcodes 336).
            self.sample_bounds = eng.get("sample_bounds", None)
            self.render_res = eng.get("render_res", 336)
            # False -> fused on-device render+score (no cb_render artifacts).
            self.save_renders = eng.get("save_renders", True)
            # CLIP 9-template score averaging (upstream hardcodes False at
            # the call site; here it is a config knob).
            self.use_templates = eng.get("use_templates", False)
            # CLIP image batch per device (upstream picks 128 vs 32 by VRAM);
            # the fused score program caps it at 32.
            self.clip_batch = eng.get("clip_batch", 256)

        # trainer (cfg.py:56-68)
        tr = config["trainer"]
        self.train = tr["train"]
        self.depth_scale = 1 / tr["scale"]
        self.training_device = tr["train_device"]
        self.data_device = tr["data_device"]
        self.load_snapshot = tr["load_snapshot"]
        if self.load_snapshot:
            self.load_snapshot_path = os.path.join(data_dir, tr["load_snapshot_path"])
        self.save_snapshot = tr["save_snapshot"]
        if self.save_snapshot:
            self.save_snapshot_path = os.path.join(data_dir, tr["save_snapshot_path"])
        self.n_steps = tr["n_steps"]
        self.near_distance = tr["near_distance"]
        self.optimize_extrinsics = tr["optimize_extrinsics"]

        # render (cfg.py:71-72)
        self.min_depth = config["render"]["depth_range"][0]
        self.max_depth = config["render"]["depth_range"][1]

        # camera (cfg.py:75-115)
        if "camera" in config:
            cam = config["camera"]
            self.mh = cam["mh"]
            self.mw = cam["mw"]
            self.height = cam["h"]
            self.width = cam["w"]
            self.H = self.height - 2 * self.mh
            self.W = self.width - 2 * self.mw
            self.camera_angle_x = cam.get("camera_angle_x")
            self.camera_angle_y = cam.get("camera_angle_y")
            if "is_fisheye" in cam:
                self.is_fisheye = cam["is_fisheye"]
            if "fx" in cam:
                self.fx = cam["fx"]
                self.fy = cam["fy"]
                self.cx = cam["cx"] - self.mw
                self.cy = cam["cy"] - self.mh
            else:  # scannet-style external intrinsics file (cfg.py:95-100)
                intrinsic = np.loadtxt(
                    os.path.join(data_dir, "intrinsic/intrinsic_depth.txt")
                )
                self.fx = intrinsic[0, 0]
                self.fy = intrinsic[1, 1]
                self.cx = intrinsic[0, 2] - self.mw
                self.cy = intrinsic[1, 2] - self.mh
            if "distortion" in cam:
                self.distortion_array = np.array(cam["distortion"])
            elif "k1" in cam:
                self.k1 = cam["k1"]
                self.k2 = cam["k2"]
                self.k3 = cam["k3"]
                self.k4 = cam["k4"]
                self.p1 = cam["p1"]
                self.p2 = cam["p2"]
                self.distortion_array = np.array(
                    [self.k1, self.k2, self.p1, self.p2, self.k3, self.k4]
                )
            else:
                self.distortion_array = None
            self.aabb_scale = cam["aabb_scale"]
            self.scale = cam["scale"]
            self.offset = cam["offset"]

        # vis (cfg.py:118)
        self.gui = config["vis"]["gui"] if "vis" in config else False

        # robot (cfg.py:120-121)
        if "robot" in config:
            self.robot_cfg = config["robot"]

    def intrinsics_matrix(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]]
        )

    def get(self, key: str, default: Any = None) -> Any:
        return getattr(self, key, default)


def validate_cache_flags(cfg: Config) -> None:
    """Cache-flag consistency checks (reference demo.py:27-29): cached
    physics or visual models need the cached camera poses they were built
    from, and cached captions need the cached segmentations."""
    if (not cfg.use_cache_cam_poses) and cfg.use_cache_phys:
        raise AssertionError("Cannot use new camera poses with old cached physics models. "
                             "Disable use_cache_phys.")
    if (not cfg.use_cache_cam_poses) and cfg.use_cache_vis:
        raise AssertionError("Cannot use new camera poses with old cached visual models. "
                             "Disable use_cache_vis.")
    if (not cfg.use_cache_segs) and cfg.use_cache_captions:
        raise AssertionError("Cannot use new segmentations with old cached captions. "
                             "Disable use_cache_captions.")
