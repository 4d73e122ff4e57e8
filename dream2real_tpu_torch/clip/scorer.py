"""CLIP render scoring (port of dream2real_tpu/clip/scorer.py): the caption
layout, batched logits and the goal / mean(norm) reduction.

Renders are rotated 90 degrees (rot90 k=1 over (H, W)) before CLIP, as the
reference feeds them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from dream2real_tpu_torch.clip.model import (
    CLIPModel,
    encode_image,
    encode_text,
    logits_per_image,
    preprocess_images,
)

# Reference clip_text_templates.py, verbatim.
CLIP_TEMPLATES = [
    "{}",
    "a photo of {}",
    "a bad photo of {}",
    "a good photo of {}",
    "a low resolution photo of {}",
    "a cropped photo of {}",
    "a bright photo of {}",
    "a dark photo of {}",
    "a painting of {}",
]


def build_captions(
    goal_caption: str,
    norm_captions: Optional[Sequence[str]],
    use_templates: bool = False,
) -> list[str]:
    """Goal caption first, then the normalising captions (optionally each
    expanded with the 9 templates)."""
    if use_templates:
        captions = [t.format(goal_caption) for t in CLIP_TEMPLATES]
        for nc in norm_captions or ():
            captions += [t.format(nc) for t in CLIP_TEMPLATES]
        return captions
    return [goal_caption] if norm_captions is None else [goal_caption] + list(norm_captions)


def reduce_logits(all_logits: torch.Tensor, n_norm: int, use_templates: bool) -> torch.Tensor:
    """(N, n_captions) -> (N,) scores: goal logit / mean(norm logits)."""
    if use_templates:
        n_t = len(CLIP_TEMPLATES)
        if n_norm == 0:
            return all_logits.mean(dim=1)
        return all_logits[:, :n_t].mean(dim=1) / all_logits[:, n_t:].mean(dim=1)
    if n_norm == 0:
        return all_logits[:, 0]
    return all_logits[:, 0] / all_logits[:, 1:].mean(dim=1)


class ClipScorer:
    """Scores u8 renders against captions in fixed-size batches on the
    model's device. ``params`` is the CLIPModel (the name the grid scorer
    looks for on a scorer that can run fused)."""

    def __init__(self, model: CLIPModel, batch_size: int = 256):
        self.params = model
        self.cfg = model.cfg
        self.batch_size = batch_size
        self.device = model.logit_scale.device

    @torch.inference_mode()
    def text_embeddings(self, ids) -> torch.Tensor:
        return encode_text(self.params, torch.as_tensor(np.asarray(ids), device=self.device))

    @torch.inference_mode()
    def logits(self, renders_u8, ids) -> np.ndarray:
        """renders_u8 (N, res, res, 3) -> (N, n_captions) logits_per_image.
        The last batch is zero-padded to ``batch_size``."""
        txt = self.text_embeddings(ids)
        renders_u8 = np.asarray(renders_u8)
        n, bs = renders_u8.shape[0], self.batch_size
        outs = []
        for start in range(0, n, bs):
            batch = torch.as_tensor(renders_u8[start : start + bs], device=self.device)
            pad = bs - batch.shape[0]
            if pad:
                batch = torch.cat([batch, batch.new_zeros((pad,) + tuple(batch.shape[1:]))])
            pixels = preprocess_images(torch.rot90(batch, k=1, dims=(1, 2)), self.cfg)
            lg = logits_per_image(self.params, encode_image(self.params, pixels), txt)
            outs.append(lg[: bs - pad].cpu().numpy())
        return np.concatenate(outs, axis=0)

    def score(self, renders_u8, goal_caption: str, norm_captions: Optional[Sequence[str]],
              tokenizer, use_templates: bool = False) -> np.ndarray:
        captions = build_captions(goal_caption, norm_captions, use_templates)
        all_logits = self.logits(renders_u8, tokenizer(captions))
        n_norm = 0 if norm_captions is None else len(norm_captions)
        return reduce_logits(torch.from_numpy(all_logits), n_norm, use_templates).numpy()
