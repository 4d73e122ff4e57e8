"""Imagine-and-score (port of
dream2real_tpu/parallel/imagine.py::make_imagine_and_score).

Per group of ``clip_batch`` candidate poses: render every pose (crop path:
one K1 launch for the group, or one H2 launch for a hash-grid field on the
card), composite over the background, rot90 k=1,
CLIP-preprocess, encode with the image tower (K2 in 23 of 24 blocks),
logits against the precomputed text embeddings, and reduce to one score per
pose.

With a mesh the K poses split into ``mesh.size`` contiguous shards that fall
on clip-group boundaries; each shard runs the single-device body under its
device and on its own stream (``mesh.run_shards``), against replicas of the
fg field and the CLIP model made once for each distinct device, and the
scores (and renders) gather on the first device in shard order: the JAX
program's ``out_specs=P(DATA_AXIS)``. Every clip group is the same work as
on one device, so the scores are those of ``mesh=None`` bit for bit.
"""

from __future__ import annotations

import copy
import os
from typing import Optional

import torch

from dream2real_tpu_torch.clip.model import (
    CLIPConfig,
    CLIPModel,
    encode_image,
    logits_per_image,
    preprocess_images,
)
from dream2real_tpu_torch.clip.scorer import reduce_logits
from dream2real_tpu_torch.device import F32, resolve_device
from dream2real_tpu_torch.nerf.combined import (
    BackgroundView,
    background_only_image,
    pack_crop,
    render_pose_batch,
)
from dream2real_tpu_torch.nerf.model import NGPConfig, NGPField
from dream2real_tpu_torch.nerf.render import RenderSettings
from dream2real_tpu_torch.parallel.mesh import run_shards
from dream2real_tpu_torch.utils.profiling import span


def make_imagine_and_score(
    fg_cfg: NGPConfig,
    clip_cfg: CLIPConfig,
    settings: RenderSettings,
    dirs_cam: torch.Tensor,
    n_norm_captions: int,
    use_templates: bool = False,
    mesh=None,
    clip_batch: int = 8,
    row_chunk: int = 56,
    obj_aabb=None,
    fg_crop: int = 0,
    crop_settings: Optional[RenderSettings] = None,
    intrinsics=None,
    return_renders: bool = False,
    device=None,
):
    """Build score_fn(fg, clip_model, T_WO_1, T_WC_1, bg, txt_emb, poses
    (K, 4, 4)) -> (K,) scores, or (scores, (K, res, res, 3) u8 composites
    before the rot90) with return_renders=True. K must divide by clip_batch,
    and with a mesh by ``mesh.size * clip_batch``.
    """
    dev = resolve_device(device) if mesh is None else mesh.lead
    res = dirs_cam.shape[0]
    rc = row_chunk if res % max(row_chunk, 1) == 0 else 0
    use_crop = bool(fg_crop) and obj_aabb is not None
    if use_crop:
        # Uniform samples over the tight object box; D2R_CROP_SAMPLES sets
        # their count (default 20, as the reference).
        crop_settings = crop_settings or settings._replace(
            n_coarse=int(os.environ.get("D2R_CROP_SAMPLES", "20")), n_fine=0
        )
    # The constants on every device once, so that a clip group's render
    # copies nothing from the host (a copy from pageable memory waits for
    # the device).
    consts = {}
    for d in ((dev,) if mesh is None else mesh.distinct()):
        consts[d] = (
            dirs_cam.to(device=d, dtype=F32),
            None if intrinsics is None else torch.as_tensor(intrinsics, dtype=F32, device=d),
            None if obj_aabb is None else tuple(torch.as_tensor(v, dtype=F32, device=d)
                                               for v in obj_aabb),
        )
    # Replicas of the fg field and the CLIP model on the devices after the
    # first, made at first use and kept: (device, id) -> (original, replica).
    replicas: dict = {}

    def replica(module, d):
        if _module_device(module) == d:
            return module
        key = (d, id(module))
        if key not in replicas:
            with torch.inference_mode(False):
                replicas[key] = (module, copy.deepcopy(module).to(d))
        return replicas[key][1]

    def score_local(d, fg, clip_model, T_WO_1, T_WC_1, bg, bg_only, packed, txt_emb, poses,
                    renders):
        dirs_d, K_d, box_d = consts[d]
        scores = []
        for start in range(0, poses.shape[0], clip_batch):
            with span("score.render", device=True):
                imgs = render_pose_batch(
                    fg, settings, crop_settings, dirs_d, K_d, box_d,
                    fg_crop if use_crop else 0, rc, T_WO_1, T_WC_1, bg, bg_only,
                    poses[start : start + clip_batch], packed=packed,
                )
            with span("score.tower", device=True):
                pixels = preprocess_images(torch.rot90(imgs, k=1, dims=(1, 2)), clip_cfg)
                emb = encode_image(clip_model, pixels)
                lg = logits_per_image(clip_model, emb, txt_emb)
                scores.append(reduce_logits(lg, n_norm_captions, use_templates))
            if renders is not None:
                renders.append(imgs)
        return scores

    @torch.inference_mode()
    def score_fn(fg: NGPField, clip_model: CLIPModel, T_WO_1, T_WC_1, bg: BackgroundView,
                 txt_emb, poses):
        poses = torch.as_tensor(poses, dtype=F32, device=dev).reshape(-1, 4, 4)
        k = poses.shape[0]
        n_dev = 1 if mesh is None else mesh.size
        if k % (n_dev * clip_batch):
            raise ValueError(f"{k} poses do not divide into {n_dev} shards of clip batches "
                             f"of {clip_batch}")
        # What every shard of a device shares, made on its current stream
        # before the shards start.
        per_dev = {}
        for d in consts:
            fg_d = fg if mesh is None else replica(fg, d)
            bg_d = BackgroundView(*(t.to(d) for t in bg))
            bg_only = packed = None
            if use_crop:
                bg_only = background_only_image(bg_d)
                packed = pack_crop(fg_d, crop_settings, d)
            per_dev[d] = (
                fg_d, clip_model if mesh is None else replica(clip_model, d),
                torch.as_tensor(T_WO_1, dtype=F32, device=d),
                torch.as_tensor(T_WC_1, dtype=F32, device=d), bg_d, bg_only, packed,
                torch.as_tensor(txt_emb, dtype=F32, device=d),
            )
        if mesh is None:
            renders = [] if return_renders else None
            scores = score_local(dev, *per_dev[dev], poses, renders)
        else:
            k_local = k // n_dev

            def shard(i, d):
                part = poses[i * k_local : (i + 1) * k_local].to(d, non_blocking=True)
                rs = [] if return_renders else None
                return score_local(d, *per_dev[d], part, rs), rs

            gathered = run_shards(mesh, shard)
            scores = [s for out, _ in gathered for s in out]
            renders = [r for _, rs in gathered for r in rs] if return_renders else None
        if return_renders:
            return torch.cat(scores), torch.cat(renders)
        return torch.cat(scores)

    return score_fn


def _module_device(module: torch.nn.Module) -> torch.device:
    """The device of a module's first parameter."""
    return next(module.parameters()).device
