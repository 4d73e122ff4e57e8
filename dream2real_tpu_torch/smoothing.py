"""Spatial smoothing of the pose-score heatmap (port of
dream2real_tpu/smoothing.py; reference vision_3d/geometry_utils.py).

Scores are viewed as an (x, y) image per (z, orientation) slice, zero
(invalid) entries are filled with the minimum nonzero score, padded by one
pixel with that value, blurred 3x3 (sigma 0.7), unpadded, and re-zeroed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dream2real_tpu_torch.ops.image import gaussian_blur


def spatially_smooth_heatmap(
    pose_scores: torch.Tensor, sample_res, sigma: float = 0.7
) -> torch.Tensor:
    """pose_scores: (prod(sample_res),) -> smoothed scores, same shape."""
    res = [int(r) for r in sample_res]
    n_xy = res[0] * res[1]
    n_rest = res[2] * res[3] * res[4] * res[5]

    zero_mask = pose_scores == 0
    big = pose_scores.abs().max() + 1.0
    min_nonzero = torch.where(zero_mask, big, pose_scores).min()
    filled = torch.where(zero_mask, min_nonzero, pose_scores)

    imgs = filled.reshape(n_xy, n_rest).transpose(0, 1).reshape(n_rest, res[0], res[1])
    imgs = F.pad(imgs, (1, 1, 1, 1), value=0.0)
    border = torch.ones_like(imgs, dtype=torch.bool)
    border[:, 1:-1, 1:-1] = False
    imgs = torch.where(border, min_nonzero, imgs)

    smoothed = gaussian_blur(imgs, kernel_size=3, sigma=sigma)[:, 1:-1, 1:-1]
    out = smoothed.reshape(n_rest, n_xy).transpose(0, 1).reshape(-1)
    return torch.where(zero_mask, torch.zeros_like(out), out)
