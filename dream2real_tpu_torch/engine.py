"""ImaginationEngine, the pipeline orchestrator (port of
dream2real_tpu/engine.py).

The same three calls that ``cli/demo.py`` makes: ``build_scene_model()`` ->
``interpret_user_instr(instr)`` -> ``dream_best_pose(task_model)``, the same
cache flags and the same artifacts (goal_pose.txt, pose_batch.txt,
pose_scores.txt, best_render.png, cb_render/, cost_volume.png,
multiverse.png, and viewer.html under ``vis.gui``). Every stage runs on the
engine's ``device``: CUDA unless the caller names another, and no GPU is an
error unless the CPU was asked for.

Every engine option of the repo's configs runs: hole inpainting
(``inpaint_holes``, perception/diffusion.py), the point-cloud visual models
and their splat renderer (``use_vis_pcds``, pcd/) and the viewer export
(``vis.gui``, vis/viewer.py). A config with no ``engine`` section (the task
fields' trainer blocks ``fg_scene.json`` / ``bg_scene.json``, which the
engine reads itself) is refused with a ValueError.
"""

from __future__ import annotations

import json
import os
import pathlib
import threading
from typing import Optional

import numpy as np
import torch

from dream2real_tpu_torch.cfg import Config
from dream2real_tpu_torch.data.loader import D2RDataLoader
from dream2real_tpu_torch.device import resolve_device
from dream2real_tpu_torch.lang.llm import LangModel
from dream2real_tpu_torch.nerf.combined import CombinedRenderer
from dream2real_tpu_torch.ops.cameras import clip_view_intrinsics_like, normalize_distortion
from dream2real_tpu_torch.perception.captioner import Captioner
from dream2real_tpu_torch.perception.segmentation import Segmentor
from dream2real_tpu_torch.physics.collision import make_unsupcol_check
from dream2real_tpu_torch.reconstruction import build_vis_model
from dream2real_tpu_torch.sampling import get_virtual_cam_poses
from dream2real_tpu_torch.scene_model import ObjectModel, SceneModel, TaskModel
from dream2real_tpu_torch.scoring import optimise_pose_grid
from dream2real_tpu_torch.utils.profiling import StageTimer, trace

_CURR_DIR = pathlib.Path(__file__).parent.absolute()


def _aabb_equal(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return bool(np.allclose(np.asarray(a[0]), np.asarray(b[0]))
                and np.allclose(np.asarray(a[1]), np.asarray(b[1])))


class ImaginationEngine:
    """Imagination engine: task models from user instructions."""

    def __init__(
        self,
        cfg: Config,
        embodied: bool = False,
        llm_backend=None,
        caption_backend=None,
        clip_loader=None,
        ngp_overrides: Optional[dict] = None,
        mask_generator=None,
        propagator=None,
        device=None,
    ):
        if "engine" not in cfg.raw:
            raise ValueError(
                f"{cfg.files}: the config has no engine section; fg_scene.json and "
                "bg_scene.json are the task fields' trainer blocks, which the engine reads "
                "itself; give the engine a scene config (configs/*_demo.json, "
                "configs/<scene>/*.json)")
        self.device = resolve_device(device)
        self.embodied = embodied
        self.cfg = cfg
        self.data_dir = cfg.data_dir
        self.use_phys = cfg.use_phys
        self.use_phys_tsdf = cfg.use_phys_tsdf
        self.lazy_phys_mods = cfg.lazy_phys_mods
        self.multi_view_captions = cfg.multi_view_captions
        self.use_cache_dynamic_masks = cfg.use_cache_dynamic_masks
        self.use_cache_segs = cfg.use_cache_segs
        self.use_cache_captions = cfg.use_cache_captions
        self.use_cache_phys = cfg.use_cache_phys
        self.use_cache_cam_poses = cfg.use_cache_cam_poses
        self.use_cache_renders = cfg.use_cache_renders
        self.use_cache_goal_pose = cfg.use_cache_goal_pose
        self.render_distractors = cfg.render_distractors
        self.spatial_smoothing = cfg.spatial_smoothing
        self.use_cache_vis = cfg.use_cache_vis
        self.use_vis_pcds = cfg.use_vis_pcds
        self.pcds_type = cfg.pcds_type
        self.render_cam_pose_idx = cfg.render_cam_pose_idx
        self.scene_type = cfg.scene_type
        self.topdown = cfg.scene_type in [0, 3]
        self.physics_only = cfg.physics_only
        self.single_view_idx = cfg.single_view_idx
        self.sample_bounds = getattr(cfg, "sample_bounds", None)
        self.use_templates = getattr(cfg, "use_templates", False)
        self.clip_batch = getattr(cfg, "clip_batch", 256)
        # Brown-Conrady lens of the scan camera; None for pinhole configs.
        self.distortion = normalize_distortion(getattr(cfg, "distortion_array", None))
        self.ngp_overrides = ngp_overrides or {}

        self.depths_gt = None
        self.scene_model = None
        self.frame_decoder = None  # which codec decoded the scan's frames (data/loader.py)
        # Wall-clock seconds per stage; cli/demo.py prints the report.
        self.stage_timer = StageTimer()
        self.segmentor = Segmentor(mask_generator=mask_generator, propagator=propagator)
        self.caption = cfg.caption
        # Hole inpainting before segmentation and captioning (Telea's method;
        # perception/diffusion.py).
        self.inpaint_holes = bool(getattr(cfg, "inpaint_holes", False))
        if cfg.caption:
            self.captioner = Captioner(
                topdown=self.topdown,
                read_cache=self.use_cache_captions,
                cache_path=os.path.join(self.data_dir, "captions.json"),
                backend=caption_backend,
            )
        local_cache = os.path.join(self.data_dir, "lang_cache.json")
        self.lang_model = LangModel(
            cache_path=local_cache if os.path.exists(local_cache)
            else str(_CURR_DIR / "lang" / "cache.json"),
            read_cache=cfg.use_cache_llm,
            backend=llm_backend,
        )
        self.renderer = None
        self.clip_loader = clip_loader
        self._clip_scorer = None
        self._tokenizer = None
        # _get_clip may be entered by the prefetch thread and the main thread.
        self._clip_lock = threading.Lock()
        self._score_prefetch = None

        assert cfg.scene_centre is not None
        assert cfg.scene_phys_bounds is not None
        assert cfg.sample_res is not None
        self.scene_centre = cfg.scene_centre
        self.scene_phys_bounds = cfg.scene_phys_bounds
        self.sample_res = cfg.sample_res

    def _ngp_kwargs(self) -> dict:
        return dict(field_overrides=self.ngp_overrides.get("field"),
                    train_overrides=self.ngp_overrides.get("train"), device=self.device)

    # ------------------------------------------------------------------

    def build_scene_model(self, raw_data=None):
        """Load the scan, segment, reconstruct, caption -> SceneModel."""
        print("Building scene model...")
        intrinsics = self.cfg.intrinsics_matrix()
        with self.stage_timer.stage("data_load"):
            dataloader = D2RDataLoader(self.cfg, device=self.device)
            if raw_data is None:
                rgbs, depths, raw_cam_poses = dataloader.load_rgbds()
                self.frame_decoder = dataloader.decoder  # "native" or "numpy"
            else:
                rgbs, depths, raw_cam_poses = (np.asarray(x) for x in raw_data)
                dataloader.size = len(depths)
                dataloader.depth_data = np.asarray(depths, np.float32)
                dataloader.T_WC_data = np.asarray(raw_cam_poses, np.float32)
            self.out_scene_bound_masks = dataloader.remove_background(
                intrinsics, self.scene_phys_bounds,
                use_cache=self.use_cache_dynamic_masks, distortion=self.distortion,
            )
        if self.inpaint_holes:
            rgbs = self.inpaint_images(rgbs)
        self.depths_gt = np.stack([np.asarray(depths[i]) for i in self.render_cam_pose_idx])

        video_path = os.path.join(self.data_dir, "seg_images")
        with self.stage_timer.stage("segmentation"):
            if os.path.exists(video_path):
                masks = self.segmentor.segment_associate(
                    video_path, depths, dataloader.T_WC_data, intrinsics, self.data_dir,
                    self.out_scene_bound_masks, self.scene_centre,
                    show=self.cfg.visseg, use_cache=self.use_cache_segs,
                )
            else:
                masks = self.segmentor.segment(
                    np.asarray(rgbs), depths, self.data_dir,
                    show=self.cfg.visseg, use_cache=self.use_cache_segs,
                )
            self.segmentor.free()
        masks = np.asarray(masks)

        # Mask id 0 = background, 255 = outside the scene's bounds.
        uniq = np.unique(masks)
        num_objs = len(uniq) - 1 if 255 in uniq else len(uniq)

        if self.use_cache_cam_poses:
            print("Using cached optimised camera poses")
            opt_cam_poses = np.load(os.path.join(self.data_dir, "opt_cam_poses.npy"))
            self._full_model = None
        else:
            with self.stage_timer.stage("full_scene_nerf"):
                self._full_model, opt_cam_poses = build_vis_model(
                    self.cfg,
                    # The full-scene field is not under the convergence
                    # governor, as in the reference.
                    dynamic_time_extension=False,
                    render_distract=self.render_distractors,
                    depths=np.asarray(depths),
                    **self._ngp_kwargs(),
                )
            if opt_cam_poses is None:
                opt_cam_poses = np.asarray(raw_cam_poses)
        opt_cam_poses = [np.asarray(p, np.float32) for p in opt_cam_poses]

        if self.lazy_phys_mods:
            phys_models = [None] * num_objs
            init_poses = [None] * num_objs
        else:
            from dream2real_tpu_torch.physics.models import get_phys_models

            with self.stage_timer.stage("physics_models"):
                phys_models, init_poses = get_phys_models(
                    depths, opt_cam_poses, intrinsics, masks, num_objs,
                    self.scene_phys_bounds,
                    save_dir=os.path.join(self.data_dir, "phys_mods/"),
                    vis=False, use_cache=self.use_cache_phys,
                    use_phys_tsdf=self.use_phys_tsdf, distortion=self.distortion,
                    device=self.device,
                )

        if self.caption:
            with self.stage_timer.stage("captioning"):
                captions, thumbnails = self.captioner.caption_objs(
                    num_objs, rgbs, masks, self.lang_model, self.out_scene_bound_masks,
                    topdown=self.topdown, multi_view=self.multi_view_captions,
                    single_view_idx=self.single_view_idx,
                )
                self.captioner.free()
        else:
            cache_path = os.path.join(self.data_dir, "captions.json")
            if os.path.exists(cache_path):
                with open(cache_path) as f:
                    captions = json.load(f)
            else:
                captions = ["__background__"] + [f"object {i}" for i in range(1, num_objs)]
            thumbnails = [None] * num_objs

        vis_models = [None] * num_objs
        objs = [
            ObjectModel(captions[i], vis_models[i], phys_models[i], init_poses[i],
                        thumbnails[i] if i < len(thumbnails) else None, i)
            for i in range(num_objs)
        ]
        self.scene_model = SceneModel(
            self.scene_centre, objs, objs[0], np.asarray(rgbs), depths, opt_cam_poses,
            intrinsics, masks, self.scene_phys_bounds, self.scene_type,
            device=self.device, distortion=self.distortion,
        )

    # ------------------------------------------------------------------

    def inpaint_images(self, rgbs, masks=None):
        """Fill the scan's holes in the RGB frames when ``inpaint_holes`` is
        set. masks: optional per-frame (H, W) hole masks (nonzero = fill);
        None fills the white pixels. The frames feed segmentation,
        captioning and the task fields; the full-scene field trains on the
        frames it reads from disk, as in the JAX package."""
        rgbs = np.asarray(rgbs)
        if not self.inpaint_holes:
            return rgbs
        from dream2real_tpu_torch.perception.diffusion import inpaint

        with self.stage_timer.stage("inpaint_holes"):
            out = [inpaint(rgbs[i], None if masks is None else np.asarray(masks[i]))
                   for i in range(len(rgbs))]
        return np.stack(out)

    def determine_movable_obj(self, user_instr):
        obj_captions = [obj.name for obj in self.scene_model.objs]
        movable_idx = self.lang_model.get_movable_obj_idx(user_instr, obj_captions)
        return self.scene_model.objs[movable_idx], movable_idx

    def determine_relevant_objs(self, norm_caption, movable_obj_idx):
        obj_captions = [obj.name for obj in self.scene_model.objs]
        relevant_idxs = self.lang_model.get_relevant_obj_idxs(
            norm_caption, obj_captions, movable_obj_idx)
        if len(relevant_idxs) == 0:
            raise RuntimeError(
                "Error: None of the captioned objects were determined to be relevant.")
        return [self.scene_model.objs[idx] for idx in relevant_idxs]

    def interpret_user_instr(self, user_instr, goal_caption=None, norm_captions=None):
        """Instruction -> TaskModel: the LLM's reading, the two physics
        models and the task's fg / bg fields."""
        if self.scene_model is None:
            raise RuntimeError(
                "Must call build_scene_model() first before receiving user instructions")
        with self.stage_timer.stage("llm_interpret"):
            if goal_caption is None:
                goal_caption, norm_caption = self.lang_model.parse_instr(user_instr)
                print("Goal caption:", goal_caption)
                print("Normalised caption:", norm_caption)
                norm_captions = [norm_caption]
            movable_obj, movable_obj_idx = self.determine_movable_obj(user_instr)
            relevant_objs = self.determine_relevant_objs(goal_caption, movable_obj_idx)

        if self.lazy_phys_mods:
            with self.stage_timer.stage("task_phys_models"):
                (
                    [bground_phys, movable_phys],
                    [bground_init_pose, movable_init_pose],
                ) = TaskModel.create_lazy_phys_mods(
                    self.scene_model, movable_obj, self.scene_phys_bounds,
                    save_dir=os.path.join(self.data_dir, "phys_mod/"),
                    embodied=self.embodied, vis=False, use_cache=self.use_cache_phys,
                    use_phys_tsdf=self.use_phys_tsdf, use_vis_pcds=self.use_vis_pcds,
                    single_view_idx=self.single_view_idx, device=self.device,
                )

        # Scoring set-up prefetch: the physics check, the crop guard and the
        # CLIP towers' text side run beside task-field training (prefetch.py).
        self._score_prefetch = None
        fresh_run = not (self.use_cache_goal_pose or self.use_cache_renders)
        want_scoring = (
            fresh_run and not self.use_vis_pcds and not self.physics_only
            and len(self.render_cam_pose_idx) == 1 and self.depths_gt is not None
        )
        want_phys = (fresh_run and self.use_phys and self.lazy_phys_mods
                     and movable_init_pose is not None)
        if (want_scoring or want_phys) and os.environ.get("D2R_PREFETCH", "1") != "0":
            from dream2real_tpu_torch.prefetch import start_scoring_prefetch

            res = getattr(self.cfg, "render_res", 336)
            clip_K = clip_view_intrinsics_like(
                self.scene_model.intrinsics, (self.cfg.height, self.cfg.width), res=res)
            fg_phys_h = movable_phys if self.lazy_phys_mods else movable_obj.phys_model
            obj_aabb, fg_crop = self._movable_crop(fg_phys_h, res)
            phys_spec = None
            if want_phys:
                phys_spec = dict(
                    bg_phys=bground_phys, fg_phys=movable_phys,
                    init_pose=np.asarray(movable_init_pose),
                    scene_centre=self.scene_centre, sample_res=self.sample_res,
                    scene_type=self.scene_type, bounds_override=self.sample_bounds,
                    embodied=self.embodied,
                )
            self._score_prefetch = start_scoring_prefetch(
                self._get_clip, goal_caption, norm_captions,
                use_templates=self.use_templates, res=res, clip_K=clip_K,
                obj_aabb=obj_aabb, fg_crop=fg_crop,
                render_poses=get_virtual_cam_poses(self.scene_model.opt_cam_poses,
                                                   self.render_cam_pose_idx),
                phys=phys_spec, scoring=want_scoring, device=self.device,
            )

        depths_np = np.asarray(self.scene_model.depths)
        with self.stage_timer.stage("task_nerfs"):
            movable_obj.vis_model = TaskModel.create_movable_vis_model(
                self.scene_model, movable_obj, self.out_scene_bound_masks,
                os.path.join(self.data_dir, "movable_vis_mod/"),
                use_vis_pcds=self.use_vis_pcds, pcds_type=self.pcds_type,
                single_view_idx=self.single_view_idx, use_cache=self.use_cache_vis,
                data_dir=self.data_dir, depths=depths_np, **self._ngp_kwargs(),
            )
            task_bground_obj, task_bground_masks = TaskModel.create_task_bground_obj(
                self.scene_model, movable_obj, relevant_objs, self.out_scene_bound_masks,
                os.path.join(self.data_dir, "task_bground_vis_mod/"),
                use_vis_pcds=self.use_vis_pcds, pcds_type=self.pcds_type,
                single_view_idx=self.single_view_idx,
                render_distractors=self.render_distractors,
                use_cache=self.use_cache_vis, data_dir=self.data_dir, depths=depths_np,
                **self._ngp_kwargs(),
            )

        if self.lazy_phys_mods:
            movable_obj.phys_model = movable_phys
            movable_obj.pose = movable_init_pose
            task_bground_obj.phys_model = bground_phys

        return TaskModel(user_instr, goal_caption, norm_captions, self.scene_model,
                         movable_obj, task_bground_obj, task_bground_masks, self.topdown)

    # ------------------------------------------------------------------

    def _get_clip(self):
        with self._clip_lock:
            return self._get_clip_locked()

    def _get_clip_locked(self):
        if self._clip_scorer is None:
            from dream2real_tpu_torch.clip.scorer import ClipScorer
            from dream2real_tpu_torch.clip.tokenizer import ClipTokenizer

            if self.clip_loader is not None:
                model, ccfg = self.clip_loader()
            else:
                try:
                    from dream2real_tpu_torch.clip.convert import load_clip

                    model, ccfg = load_clip(device=self.device)
                    print("Loaded CLIP ViT-L/14-336 weights.")
                except (FileNotFoundError, ImportError):
                    # Random weights would still give a goal_pose.txt, with
                    # no meaning: only an explicit opt-in allows that.
                    if os.environ.get("D2R_ALLOW_RANDOM_CLIP") != "1":
                        raise RuntimeError(
                            "No local CLIP checkpoint found (reference scorer: "
                            "openai/clip-vit-large-patch14-336). Set D2R_CLIP_PATH to a "
                            "checkpoint for real scoring, or set D2R_ALLOW_RANDOM_CLIP=1 to "
                            "proceed with a small RANDOM CLIP whose scores are "
                            "self-consistent but not semantic (goal_pose.txt will be "
                            "meaningless)."
                        ) from None
                    from dream2real_tpu_torch.clip.model import CLIPConfig, init_clip_params

                    print("WARNING: no local CLIP checkpoint found — using a small RANDOM "
                          "CLIP (D2R_ALLOW_RANDOM_CLIP=1). Scores are self-consistent but "
                          "not semantic.")
                    ccfg = CLIPConfig(
                        image_size=336, patch_size=28, vision_width=128, vision_layers=4,
                        vision_heads=4, text_width=128, text_layers=2, text_heads=4,
                        projection_dim=64,
                    )
                    gen = torch.Generator(device=self.device).manual_seed(0)
                    model = init_clip_params(ccfg, gen, device=self.device)
            self._clip_scorer = ClipScorer(model, batch_size=self.clip_batch)
            self._tokenizer = ClipTokenizer(context_length=ccfg.context_length,
                                            vocab_size=ccfg.vocab_size)
        return self._clip_scorer, self._tokenizer

    def _movable_crop(self, fg_phys_h, res: int):
        """(obj_aabb, fg_crop) of the cropped fast path, from the movable's
        collision shell; deterministic from the physics handle and the
        config, so the prefetch computes the same values before training."""
        obj_aabb = None
        fg_crop = 0
        if fg_phys_h is not None and getattr(fg_phys_h, "points", None) is not None:
            pts = fg_phys_h.points
            pv = pts[pts[:, 3] > 0, :3]
            if len(pv):
                pad = 0.03
                obj_aabb = (tuple(pv.min(axis=0) - pad), tuple(pv.max(axis=0) + pad))
                # res // 2 covers the projected object on every demo scene;
                # the config's fg_crop overrides, D2R_FG_CROP overrides both.
                fg_crop = int(os.environ.get(
                    "D2R_FG_CROP", self.cfg.raw.get("engine", {}).get("fg_crop", res // 2)))
        return obj_aabb, fg_crop

    def dream_best_pose(self, task_model, vis_cost_vol: bool = True):
        """Imagine and score the candidate placements -> the goal pose (4, 4)."""
        movable_init_pose = np.asarray(task_model.movable_obj.pose)
        pf = self._score_prefetch.result() if self._score_prefetch else None

        phys_check = None
        if self.use_phys and not self.use_cache_renders:
            with self.stage_timer.stage("phys_check_build"):
                bg_phys = task_model.task_bground_obj.phys_model
                fg_phys = task_model.movable_obj.phys_model
                # Handles kept for motion planning in embodied runs.
                self.static_phys_handles = [bg_phys]
                self.movable_phys_handle = fg_phys
                if (
                    pf is not None
                    and pf.get("phys_check") is not None
                    and pf.get("phys_bg") is bg_phys
                    and pf.get("phys_fg") is fg_phys
                    and np.array_equal(pf.get("phys_init_pose"), movable_init_pose)
                ):
                    phys_check = pf["phys_check"]
                else:
                    if pf is not None:  # a stale physics prefetch: drop it
                        pf = dict(pf)
                        pf.pop("is_valid", None)
                    phys_check = make_unsupcol_check(
                        bg_phys.tsdf, fg_phys.points, movable_init_pose, self.scene_centre,
                        self.sample_res, disallow_regrasp=self.embodied, device=self.device,
                    )

        if self.use_vis_pcds and not self.use_cache_goal_pose:
            from dream2real_tpu_torch.pcd.renderer import PointCloudRenderer

            self.renderer = PointCloudRenderer(task_model, device=self.device)
        else:
            fg = task_model.movable_obj.vis_model
            bg = task_model.task_bground_obj.vis_model
            res = getattr(self.cfg, "render_res", 336)
            # The movable's collision shell bounds the cropped fast path (the
            # fg marched only in its projected window).
            clip_K = clip_view_intrinsics_like(
                self.scene_model.intrinsics, (self.cfg.height, self.cfg.width), res=res)
            obj_aabb, fg_crop = self._movable_crop(task_model.movable_obj.phys_model, res)
            # The prefetch's crop guard ran over the same physics-valid set
            # as optimise_pose_grid's, when its physics check was adopted.
            if (
                pf is not None
                and pf.get("fg_crop")
                and phys_check is not None
                and phys_check is pf.get("phys_check")
                and _aabb_equal(pf.get("obj_aabb"), obj_aabb)
            ):
                fg_crop = max(fg_crop, pf["fg_crop"])
            self.renderer = CombinedRenderer(
                fg.field, bg.field, settings=fg.settings, res=res, intrinsics=clip_K,
                out_render_path=os.path.join(self.data_dir, "cb_render"),
                obj_aabb=obj_aabb, fg_crop=fg_crop, device=self.device,
            )

        if self.use_cache_goal_pose:
            best_pose = np.loadtxt(os.path.join(self.data_dir, "goal_pose.txt"))
            pose_batch = np.loadtxt(os.path.join(self.data_dir, "pose_batch.txt"))
            pose_scores = np.loadtxt(os.path.join(self.data_dir, "pose_scores.txt"))
        else:
            clip_scorer, tokenizer = (None, None)
            if not self.physics_only:
                clip_scorer, tokenizer = self._get_clip()
            with self.stage_timer.stage("imagine_and_score"), trace("imagine-loop"):
                best_pose, pose_batch, pose_scores = optimise_pose_grid(
                    self.renderer, self.depths_gt, self.render_cam_pose_idx, task_model,
                    self.data_dir, sample_res=self.sample_res, phys_check=phys_check,
                    use_templates=self.use_templates, scene_type=self.scene_type,
                    use_vis_pcds=self.use_vis_pcds, use_cache_renders=self.use_cache_renders,
                    smoothing=self.spatial_smoothing, physics_only=self.physics_only,
                    clip_scorer=clip_scorer, tokenizer=tokenizer,
                    bounds_override=self.sample_bounds,
                    save_renders=getattr(self.cfg, "save_renders", True), prefetch=pf,
                )
            np.savetxt(os.path.join(self.data_dir, "goal_pose.txt"), best_pose)
            np.savetxt(os.path.join(self.data_dir, "pose_batch.txt"), pose_batch)
            np.savetxt(os.path.join(self.data_dir, "pose_scores.txt"), pose_scores)

        if vis_cost_vol:
            try:
                with self.stage_timer.stage("artifacts"):
                    from dream2real_tpu_torch.vis.cost_volume import (
                        export_cost_volume,
                        export_multiverse,
                    )

                    export_cost_volume(pose_scores, self.sample_res, pose_batch,
                                       os.path.join(self.data_dir, "cost_volume.png"))
                    fg_h = task_model.movable_obj.phys_model
                    bg_h = task_model.task_bground_obj.phys_model
                    if fg_h is not None and getattr(fg_h, "points", None) is not None:
                        export_multiverse(
                            pose_scores, pose_batch, fg_h.points, movable_init_pose,
                            os.path.join(self.data_dir, "multiverse.png"),
                            bground_points=None if bg_h is None else bg_h.points,
                        )
            except Exception as e:  # the exports are artifacts, best-effort as in the reference
                print("cost volume export skipped:", e)

        if getattr(self.cfg, "gui", False):
            # The reference's vis.gui pops Open3D windows and the NGP GUI; the
            # flag exports a self-contained HTML viewer of the same geometry.
            try:
                with self.stage_timer.stage("artifacts"):
                    self._export_viewer(task_model, best_pose)
            except Exception as e:
                print("viewer export skipped:", e)

        return np.asarray(best_pose).reshape(4, 4)

    def _export_viewer(self, task_model, best_pose) -> str:
        from dream2real_tpu_torch.physics.mesh import load_obj
        from dream2real_tpu_torch.vis.viewer import export_scene_html

        points, meshes, frames = [], [], []
        fg_h = task_model.movable_obj.phys_model
        bg_h = task_model.task_bground_obj.phys_model
        if fg_h is not None and getattr(fg_h, "points", None) is not None:
            pts = np.asarray(fg_h.points)
            pv = pts[pts[:, 3] > 0, :3]
            points.append((pv, np.tile([255, 80, 80], (len(pv), 1)), "movable"))
        if bg_h is not None and getattr(bg_h, "points", None) is not None:
            pts = np.asarray(bg_h.points)
            pv = pts[pts[:, 3] > 0, :3]
            points.append((pv, np.tile([120, 120, 140], (len(pv), 1)), "background"))
        mesh_dir = os.path.join(self.data_dir, "phys_mod")
        if os.path.isdir(mesh_dir):
            for fn in sorted(os.listdir(mesh_dir)):
                if fn.startswith("mesh_concave_") and fn.endswith(".obj"):
                    try:
                        v, f = load_obj(os.path.join(mesh_dir, fn))
                        meshes.append((v, f, "#44cc88", fn[:-4]))
                    except Exception:
                        pass
        for i in self.render_cam_pose_idx:
            frames.append((np.asarray(self.scene_model.opt_cam_poses[i]), f"cam{i}"))
        frames.append((np.asarray(best_pose).reshape(4, 4), "goal"))
        out = export_scene_html(
            os.path.join(self.data_dir, "viewer.html"),
            points=points, meshes=meshes, frames=frames,
            title="dream2real_tpu \u2014 imagined placement",
        )
        print(f"interactive viewer exported: {out}")
        return out
