"""Imagine-and-score, single device (port of
dream2real_tpu/parallel/imagine.py::make_imagine_and_score).

Per group of ``clip_batch`` candidate poses: render every pose (crop path:
one K1 launch for the group), composite over the background, rot90 k=1,
CLIP-preprocess, encode with the image tower (K2 in 23 of 24 blocks),
logits against the precomputed text embeddings, and reduce to one score per
pose. Multi-GPU pose sharding belongs to a later slice.
"""

from __future__ import annotations

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
    render_pose_batch,
)
from dream2real_tpu_torch.nerf.march_kernel import pack_params, supports
from dream2real_tpu_torch.nerf.model import NGPConfig, NGPField
from dream2real_tpu_torch.nerf.render import RenderSettings


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
    before the rot90) with return_renders=True. K must divide by clip_batch.
    """
    if mesh is not None:
        raise NotImplementedError("multi-GPU pose sharding is not ported yet")
    dev = resolve_device(device)
    dirs_cam = dirs_cam.to(device=dev, dtype=F32)
    # On the device once, so that a clip group's render copies nothing from
    # the host (a copy from pageable memory waits for the device).
    if obj_aabb is not None:
        obj_aabb = tuple(torch.as_tensor(v, dtype=F32, device=dev) for v in obj_aabb)
    if intrinsics is not None:
        intrinsics = torch.as_tensor(intrinsics, dtype=F32, device=dev)
    res = dirs_cam.shape[0]
    rc = row_chunk if res % max(row_chunk, 1) == 0 else 0
    use_crop = bool(fg_crop) and obj_aabb is not None
    if use_crop:
        # Uniform samples over the tight object box; D2R_CROP_SAMPLES sets
        # their count (default 20, as the reference).
        crop_settings = crop_settings or settings._replace(
            n_coarse=int(os.environ.get("D2R_CROP_SAMPLES", "20")), n_fine=0
        )

    @torch.inference_mode()
    def score_fn(fg: NGPField, clip_model: CLIPModel, T_WO_1, T_WC_1, bg: BackgroundView,
                 txt_emb, poses):
        poses = torch.as_tensor(poses, dtype=F32, device=dev).reshape(-1, 4, 4)
        T_WO_1 = torch.as_tensor(T_WO_1, dtype=F32, device=dev)
        T_WC_1 = torch.as_tensor(T_WC_1, dtype=F32, device=dev)
        txt_emb = torch.as_tensor(txt_emb, dtype=F32, device=dev)
        k = poses.shape[0]
        if k % clip_batch:
            raise ValueError(f"{k} poses do not divide into clip batches of {clip_batch}")
        bg_only = packed = None
        if use_crop:
            bg_only = background_only_image(bg)
            packed = pack_params(fg) if supports(fg.cfg, crop_settings) else None
        scores, renders = [], []
        for start in range(0, k, clip_batch):
            imgs = render_pose_batch(
                fg, settings, crop_settings, dirs_cam, intrinsics, obj_aabb,
                fg_crop if use_crop else 0, rc, T_WO_1, T_WC_1, bg, bg_only,
                poses[start : start + clip_batch], packed=packed,
            )
            pixels = preprocess_images(torch.rot90(imgs, k=1, dims=(1, 2)), clip_cfg)
            emb = encode_image(clip_model, pixels)
            lg = logits_per_image(clip_model, emb, txt_emb)
            scores.append(reduce_logits(lg, n_norm_captions, use_templates))
            if return_renders:
                renders.append(imgs)
        if return_renders:
            return torch.cat(scores), torch.cat(renders)
        return torch.cat(scores)

    return score_fn
