"""Object captioning with the captions.json cache (port of
dream2real_tpu/perception/captioner.py).

The thumbnail pipeline of the reference: per-view masked thumbnails,
sideways early views rotated upright for non-topdown scenes, containers
found from the connected components of the inverted mask on frame 0, and
their surroundings filled with noise (a 201 x 201 Gaussian blur and a 60 x
60 dilation of the inverted mask) so that the captioner ignores what they
hold. The OpenCV calls go through ``perception.imgproc``. Backend: any
callable imgs -> captions; the default ``blip2_backend`` needs a local
BLIP-2 checkpoint, which the repository does not hold, so a run without
the cache needs an injected backend.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional, Sequence

import numpy as np

from dream2real_tpu_torch.device import resolve_device
from dream2real_tpu_torch.perception import imgproc
from dream2real_tpu_torch.perception.segmentation import get_thumbnail, mask_touches_edge


def blip2_backend(path: Optional[str] = None, device=None, batch_size: int = 200):
    """BLIP-2 captioning from a local checkpoint (D2R_BLIP2_PATH) on
    ``device`` (CUDA unless the caller names another; raises without a GPU
    before anything is loaded); the import raises where transformers is
    absent."""
    device = resolve_device(device)
    import torch
    from transformers import Blip2ForConditionalGeneration, Blip2Processor

    path = path or os.environ.get("D2R_BLIP2_PATH", "Salesforce/blip2-opt-2.7b-coco")
    processor = Blip2Processor.from_pretrained(path, local_files_only=True)
    model = Blip2ForConditionalGeneration.from_pretrained(path, local_files_only=True)
    model = model.to(device).eval()

    def caption(imgs: Sequence[np.ndarray]) -> list[str]:
        out = []
        with torch.no_grad():
            for start in range(0, len(imgs), batch_size):
                batch = list(imgs[start : start + batch_size])
                inputs = processor(images=batch, return_tensors="pt").to(device)
                ids = model.generate(**inputs)
                out.extend(c.strip() for c in processor.batch_decode(ids, skip_special_tokens=True))
        return out

    return caption


class Captioner:
    def __init__(
        self,
        topdown: bool,
        device=None,
        read_cache: bool = False,
        cache_path: Optional[str] = None,
        backend: Optional[Callable] = None,
        seed: int = 0,
    ):
        self.topdown = topdown
        self.device = device  # where the default backend loads BLIP-2 (None: CUDA)
        self.read_cache = read_cache
        self.cache_path = cache_path
        self.backend = backend
        self._rng = np.random.default_rng(seed)

    def caption(self, imgs: Sequence[np.ndarray]) -> list[str]:
        backend = self.backend
        if backend is None:
            backend = blip2_backend(device=self.device)  # raises without a local checkpoint
        return backend(imgs)

    def caption_objs(
        self,
        num_objs: int,
        rgbs,
        masks,
        lang_model,
        scene_masks,
        topdown: bool,
        multi_view: bool = True,
        single_view_idx: int = 0,
    ):
        """-> (captions with '__background__' at index 0, thumbnails)."""
        if self.read_cache:
            print("Using cached captions")
            with open(self.cache_path) as f:
                agg_captions = json.load(f)
            return agg_captions, [None] * len(agg_captions)

        rgbs = np.asarray(rgbs)
        masks = np.asarray(masks)
        scene_masks = np.asarray(scene_masks)
        noise = self._rng.uniform(0, 256, rgbs[0].shape).astype(np.uint8)

        all_thumbnails = []
        for obj_idx in range(1, num_objs):  # the background is not captioned
            obj_thumbnails = []
            frame_range = range(len(rgbs)) if multi_view else [single_view_idx]
            is_container = False
            for frame_idx in frame_range:
                frame_mask = masks[frame_idx].copy()
                rgb_frame = rgbs[frame_idx].copy()
                scene_mask = np.logical_not(scene_masks[frame_idx].astype(bool))
                # Sideways early views of 3D scenes are turned upright.
                if ((frame_idx in (0, 1)) and not topdown) or (
                    not multi_view and single_view_idx > 0
                ):
                    rgb_frame = np.flip(rgb_frame.swapaxes(0, 1), 0)
                    frame_mask = np.flip(frame_mask.swapaxes(0, 1), 0)
                    scene_mask = np.flip(scene_mask.swapaxes(0, 1), 0)

                obj_mask = (frame_mask == obj_idx) & scene_mask
                if obj_mask.sum() < 200:
                    continue
                if mask_touches_edge(obj_mask) and len(obj_thumbnails) >= 3 and not self.topdown:
                    continue

                # Container detection on frame 0.
                if frame_idx == 0:
                    n_comps, comp_img = imgproc.connected_components(
                        np.logical_not(obj_mask).astype(np.uint8)
                    )
                    for i in range(1, n_comps):
                        comp_mask = comp_img == i
                        black_pix = frame_mask == 0
                        inter = (comp_mask & black_pix).sum()
                        union = comp_mask.sum()
                        if union and inter / union > 0.7:
                            continue
                        if comp_mask.sum() < 400:
                            continue
                        if not mask_touches_edge(comp_mask):
                            is_container = True

                if is_container:
                    bg_mask = np.logical_not(obj_mask).astype(np.uint8)
                    bg_mask = imgproc.gaussian_blur(bg_mask, 201, 0)
                    bg_mask = imgproc.dilate(bg_mask, 60).astype(bool)
                    frame_noise = (
                        np.flip(noise.swapaxes(0, 1), 0)
                        if (frame_idx in (0, 1) and not topdown)
                        else noise
                    )
                    rgb_frame[bg_mask] = frame_noise[bg_mask]

                mask_for_thumb = np.ones_like(obj_mask) if is_container else obj_mask
                thumb = get_thumbnail(rgb_frame, mask_for_thumb)
                obj_thumbnails.append(thumb.astype(np.uint8))
            all_thumbnails.append(obj_thumbnails)

        flat_imgs, flat_idxs = [], []
        for oi, thumbs in enumerate(all_thumbnails):
            flat_imgs.extend(thumbs)
            flat_idxs.extend([oi] * len(thumbs))
        flat_captions = self.caption(flat_imgs)

        all_captions = [
            [c for c, fi in zip(flat_captions, flat_idxs) if fi == oi]
            for oi in range(len(all_thumbnails))
        ]

        debug_thumbnails = [t[0] if t else None for t in all_thumbnails]
        debug_thumbnails.insert(0, rgbs[0])

        if not multi_view:
            agg = [oc[0] if oc else "" for oc in all_captions]
        else:
            agg = [
                lang_model.aggregate_captions_for_obj(oc, silent=True) if oc else ""
                for oc in all_captions
            ]
        agg.insert(0, "__background__")
        if self.cache_path is not None:
            with open(self.cache_path, "w") as f:
                json.dump(agg, f)
        return agg, debug_thumbnails

    def free(self):
        self.backend = None
