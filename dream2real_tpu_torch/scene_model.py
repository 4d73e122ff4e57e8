"""Scene / object / task data model (port of dream2real_tpu/scene_model.py).

ObjectModel (name / vis_model / phys_model / pose / thumbnail / mask_idx),
SceneModel (objs incl. bground at idx 0, rgbs, depths, opt_cam_poses, masks,
bounds), TaskModel (task-specific fg / bg visual models built by masking,
the lazy two-body physics models, free_visual_models) and the legacy
ObjectModel2D.

vis_model handles are reconstruction.NGPModel, or pcd.visual_model's
PointCloud on the point-cloud ablation path (``use_vis_pcds``); phys_model
handles are the mesh .obj paths, with the collision state (TSDF grid on the
device, shell points) carried by the physics.models.PhysModel handles.
"""

from __future__ import annotations

import numpy as np


class ObjectModel:
    def __init__(self, name, vis_model, phys_model, init_pose, thumbnail, mask_idx):
        self.name = name
        self.vis_model = vis_model
        self.phys_model = phys_model  # mesh path (artifact compat)
        self.pose = init_pose  # T_world_obj (4, 4) numpy
        self.thumbnail = thumbnail
        self.mask_idx = mask_idx
        # Collision-state handles (set by the physics stage).
        self.tsdf = None
        self.collision_points = None

    def update_pose(self, new_pose):
        self.pose = new_pose


class SceneModel:
    """NOTE: bground is also included in objs (at index 0)."""

    def __init__(
        self, scene_centre, objs, bground_obj, rgbs, depths, opt_cam_poses,
        intrinsics, masks, scene_bounds, scene_type, device=None,
        distortion=None,
    ):
        self.objs = objs
        self.bground_obj = bground_obj
        self.scene_centre = scene_centre
        self.device = device
        self.rgbs = rgbs
        self.depths = depths
        self.opt_cam_poses = opt_cam_poses
        self.intrinsics = intrinsics
        self.masks = masks
        self.scene_bounds = scene_bounds
        self.scene_type = scene_type
        # Brown-Conrady coefficients of the scan camera (None = pinhole);
        # consumed by every depth back-/forward-projection site.
        self.distortion = distortion


class TaskModel:
    """task_bground_obj is a dummy ObjectModel holding the visual model of the
    scene background specific to this task (scene_model.py:45-47)."""

    def __init__(
        self, user_instr, goal_caption, norm_captions, scene_model,
        movable_obj, task_bground_obj, task_bground_masks, topdown,
    ):
        self.user_instr = user_instr
        self.goal_caption = goal_caption
        self.norm_captions = norm_captions
        self.scene_model = scene_model
        self.movable_obj = movable_obj
        self.task_bground_obj = task_bground_obj
        self.task_bground_masks = task_bground_masks
        # True for NON-movable pixels (scene_model.py:55).
        self.movable_masks = np.asarray(scene_model.masks) != movable_obj.mask_idx
        self.topdown = topdown

    @staticmethod
    def create_task_bground_obj(
        scene_model, movable_obj, relevant_objs, out_scene_bound_masks, save_dir,
        use_vis_pcds=False, pcds_type=None, single_view_idx=0,
        render_distractors=False, use_cache=False, data_dir=None,
        depths=None, **ngp_kwargs,
    ):
        """Mask out movable + distractors (+ optionally keep distractors) and
        train the task-background visual model (scene_model.py:60-96)."""
        masks = np.asarray(scene_model.masks)
        task_bground_masks = np.zeros_like(masks)
        for obj in scene_model.objs:
            if render_distractors:
                if obj is movable_obj:
                    task_bground_masks[masks == obj.mask_idx] = 1
            else:
                if (
                    obj is movable_obj
                    or obj is scene_model.bground_obj
                    or (obj not in relevant_objs)
                ):
                    task_bground_masks[masks == obj.mask_idx] = 1
        for i, m in enumerate(np.asarray(out_scene_bound_masks)):
            task_bground_masks[i] |= m.astype(bool)

        if use_vis_pcds:
            from dream2real_tpu_torch.pcd.visual_model import get_vis_pcds

            vis_model = get_vis_pcds(
                scene_model.rgbs, scene_model.depths, scene_model.opt_cam_poses,
                scene_model.intrinsics, task_bground_masks, 1,
                scene_model.scene_bounds, save_dir=save_dir, vis=False,
                use_cache=use_cache, pcds_type=pcds_type,
                single_view_idx=single_view_idx,
            )[0]
        else:
            from dream2real_tpu_torch.reconstruction import get_vis_ngps

            vis_model = get_vis_ngps(
                scene_model.rgbs, task_bground_masks, scene_model.scene_type,
                use_cache=use_cache, data_dir=data_dir, fg=False,
                render_distract=render_distractors, depths=depths,
                scene_phys_bounds=scene_model.scene_bounds, **ngp_kwargs,
            )

        task_bground_obj = ObjectModel(
            "__task_bground__", vis_model, None, np.eye(4), None, None
        )
        return task_bground_obj, task_bground_masks

    @staticmethod
    def create_movable_vis_model(
        scene_model, movable_obj, out_scene_bound_masks, save_dir,
        use_vis_pcds=False, pcds_type=None, single_view_idx=0,
        use_cache=False, data_dir=None, depths=None, **ngp_kwargs,
    ):
        """Train the movable-object visual model (scene_model.py:98-113)."""
        movable_masks = np.asarray(scene_model.masks) != movable_obj.mask_idx
        if use_vis_pcds:
            from dream2real_tpu_torch.pcd.visual_model import get_vis_pcds

            return get_vis_pcds(
                scene_model.rgbs, scene_model.depths, scene_model.opt_cam_poses,
                scene_model.intrinsics, movable_masks, 1,
                scene_model.scene_bounds, save_dir=save_dir, vis=False,
                use_cache=use_cache, pcds_type=pcds_type,
                single_view_idx=single_view_idx,
            )[0]
        from dream2real_tpu_torch.reconstruction import get_vis_ngps

        return get_vis_ngps(
            scene_model.rgbs, movable_masks, scene_model.scene_type,
            use_cache=use_cache, data_dir=data_dir, fg=True, depths=depths,
            scene_phys_bounds=scene_model.scene_bounds, **ngp_kwargs,
        )

    @staticmethod
    def create_lazy_phys_mods(
        scene_model, movable_obj, scene_bounds, save_dir, embodied=False,
        vis=False, use_cache=False, use_phys_tsdf=True, use_vis_pcds=False,
        single_view_idx=0, voxel_size=0.004, device=None,
    ):
        """Two physics models: movable obj vs everything else
        (scene_model.py:116-125), on ``device`` (CUDA unless named). Returns
        ([bg, fg] handles, [bg, fg] init poses); handles carry the TSDF grid
        and the collision points for the on-device checks plus mesh paths
        for artifact compat."""
        from dream2real_tpu_torch.physics.models import get_phys_models

        fg_bg_masks = np.where(
            np.asarray(scene_model.masks) == movable_obj.mask_idx, 1, 0
        )
        return get_phys_models(
            scene_model.depths, scene_model.opt_cam_poses, scene_model.intrinsics,
            fg_bg_masks, num_objs=2, scene_bounds=scene_bounds,
            embodied=embodied, save_dir=save_dir, vis=vis, use_cache=use_cache,
            use_phys_tsdf=use_phys_tsdf, use_vis_pcds=use_vis_pcds,
            single_view_idx=single_view_idx, voxel_size=voxel_size,
            distortion=getattr(scene_model, "distortion", None), device=device,
        )

    def free_visual_models(self):
        """Drop the bg field handle (scene_model.py:127-130): one H100 holds
        the fields and CLIP together, but the lifecycle stays the
        reference's."""
        self.task_bground_obj.vis_model = None


class ObjectModel2D:
    """Legacy 2D compositor object (scene_model.py:132-141)."""

    def __init__(self, name, obj_crop, thumbnail, pos, mask):
        self.name = name
        self.obj_crop = obj_crop
        self.thumbnail = thumbnail
        self.pos = pos
        self.mask = mask
