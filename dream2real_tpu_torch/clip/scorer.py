"""CLIP caption layout and logit reduction (port of the functions of
dream2real_tpu/clip/scorer.py on the imagine-and-score path)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

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
