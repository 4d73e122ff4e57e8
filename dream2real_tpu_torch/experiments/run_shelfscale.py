"""The shelf-shaped 2.2M-pose 6-DoF run on one GPU (port of the repo's
experiments/run_shelfscale.py).

The reference's largest workload is the shelf demo: sample_res 60 x 16 x 36
x 4 x 4 x 4 = 2,211,840 candidate poses with orientation dedup, regrasp
gating and per-pose physics, then CLIP scoring of the valid subset. Here:

- the full 2,211,840-pose grid (the shelf's orientation ranges, tabletop
  translation bounds for the synth scene);
- ``orientation_dedup_mask`` and ``regrasp_mask`` over the grid, and
  ``make_unsupcol_check`` (embodied: regrasps refused) over all poses, in
  chunks of D2R_PHYS_CHUNK survivors;
- the valid subset scored through ``optimise_pose_grid``, cut evenly to
  D2R_SHELF_SCORE_CAP (65,536) poses when larger: physics sees all 2.2M,
  scoring reports its wall-clock per pose either way.

The field is the flagship one trained 500 steps on 10 views of 336^2, the
physics models are fused from the same scan at 4 mm, and the scorer is a
random-weight ViT-L/14-336 at full size with hash-tokenized captions.

    python -m dream2real_tpu_torch.experiments.run_shelfscale [out.json]

Knobs: D2R_SHELF_GRID="60,16,36,4,4,4", D2R_PHYS_CHUNK, D2R_SHELF_SCORE_CAP.
Prints one JSON line: the JAX script's keys plus ``device`` (the card's name
and power limit) and ``models_s`` (the physics models' seconds).
"""

from __future__ import annotations

import json
import math
import os
import shutil
import sys
import tempfile
import time
from functools import partial

import numpy as np
import torch

from dream2real_tpu_torch import scoring
from dream2real_tpu_torch.cli.bench import device_line
from dream2real_tpu_torch.cli.selftest import SETTINGS
from dream2real_tpu_torch.clip.model import CLIPConfig, init_clip_params
from dream2real_tpu_torch.clip.scorer import ClipScorer
from dream2real_tpu_torch.clip.tokenizer import hash_tokenize
from dream2real_tpu_torch.device import resolve_device
from dream2real_tpu_torch.experiments.run_refscale import (
    RES, synth_scan, task_model, train_field,
)
from dream2real_tpu_torch.nerf.combined import CombinedRenderer
from dream2real_tpu_torch.physics.collision import (
    make_unsupcol_check, orientation_dedup_mask, regrasp_mask,
)
from dream2real_tpu_torch.physics.models import get_phys_models
from dream2real_tpu_torch.sampling import sample_poses_grid
from dream2real_tpu_torch.utils.health import wait_cuda_healthy

GRID = (60, 16, 36, 4, 4, 4)
# The shelf's orientation ranges, tabletop translation bounds for the synth
# scene.
BOUNDS = ((-0.19, 0.15), (-0.25, 0.10), (0.0, 0.35),
          (-math.pi, math.pi / 2), (-math.pi, math.pi / 2), (-math.pi, math.pi / 2))
SCENE_BOUNDS = ((0.0, -0.45, -0.06), (1.0, 0.45, 0.45))


def shelf_grid(scene_centre, grid_res=GRID, device=None):
    """-> (pose_batch (N, 16) f32 host, orientations a position, dedup keep
    mask (N,) host bool, regrasp keep mask (N,) host bool); the masks
    computed on ``device``."""
    pose_batch = sample_poses_grid(scene_centre, grid_res, bounds_override=BOUNDS)
    oris = int(grid_res[3] * grid_res[4] * grid_res[5])
    poses44 = torch.as_tensor(pose_batch.reshape(-1, 4, 4), device=resolve_device(device))
    dedup = orientation_dedup_mask(poses44, oris).cpu().numpy()
    regrasp = regrasp_mask(poses44, oris).cpu().numpy()
    return pose_batch, oris, dedup, regrasp


def score_subset(is_valid: np.ndarray, cap: int) -> np.ndarray:
    """The valid poses, cut evenly to ``cap`` when there are more."""
    n_valid = int(is_valid.sum())
    if n_valid <= cap:
        return is_valid
    vidx = np.flatnonzero(is_valid)
    sel = vidx[(np.arange(cap) * (n_valid / cap)).astype(int)]
    out = np.zeros(len(is_valid), bool)
    out[sel] = True
    return out


def run(grid_res=GRID, score_cap: int = 65536, train_steps: int = 500, n_views: int = 10,
        voxel: float = 0.004, device=None, res: int = RES, clip_cfg: CLIPConfig = CLIPConfig(),
        log=lambda m: print(m, file=sys.stderr, flush=True)) -> dict:
    """Train, build the physics models, check every pose, score the valid
    subset. -> the result dict (the JSON line's, plus the best pose, the
    validity mask, the scored mask and the scores). ``res``, ``voxel`` and
    ``clip_cfg`` shrink the run for a dry run on the CPU."""
    dev = resolve_device(device)
    grid_res = [int(v) for v in grid_res]
    scene, K, cams, rgbs, depths, insts = synth_scan(n_views, 0.55, 0.45, res)
    field, loss = train_field(cams, rgbs, depths, K, train_steps, dev, res)
    log(f"# field trained {train_steps} steps: loss {loss:.5f}")
    cuda = dev.type == "cuda"

    # ---- Physics models from the scan (bg = the table and the other boxes).
    masks = np.stack([np.where(i == 1, 1, 0).astype(np.uint8) for i in insts])
    t0 = time.time()
    (bg_phys, fg_phys), init_poses = get_phys_models(
        np.stack(depths), list(cams), K, masks, num_objs=2, scene_bounds=SCENE_BOUNDS,
        save_dir=None, use_cache=False, voxel_size=voxel, device=dev,
    )
    t_models = time.time() - t0
    init_pose = init_poses[1]
    log(f"# physics models in {t_models:.1f} s")

    # ---- The grid, its masks and the chunked check over every pose.
    t0 = time.time()
    pose_batch, oris, dedup, regrasp = shelf_grid(scene.centre, grid_res, dev)
    n = len(pose_batch)
    log(f"# grid sampled: {n} poses in {time.time() - t0:.1f} s")
    check = make_unsupcol_check(bg_phys.tsdf, fg_phys.points, init_pose, scene.centre, grid_res,
                                disallow_regrasp=True, device=dev)
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    is_valid = check(pose_batch).cpu().numpy()
    t_phys = time.time() - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    n_valid = int(is_valid.sum())
    log(f"# physics over {n} poses: {t_phys:.2f} s ({n / t_phys:.0f} poses/s); dedup keep "
        f"{dedup.mean():.4f}, regrasp keep {regrasp.mean():.4f}, valid {n_valid}")

    # ---- Production slab scoring over the valid subset (cut to the cap).
    scored_mask = score_subset(is_valid, score_cap)
    b0 = scene.boxes[0]
    pad = 0.06  # rotated candidates' projections swing wider than the box
    obj_aabb = (tuple(np.asarray(b0.lo) - pad), tuple(np.asarray(b0.hi) + pad))
    data_dir = tempfile.mkdtemp(prefix="d2r_shelfscale_")
    renderer = CombinedRenderer(
        field, field, settings=SETTINGS, res=res, intrinsics=K, obj_aabb=obj_aabb,
        fg_crop=min(160, res), out_render_path=os.path.join(data_dir, "cb_render"), device=dev,
    )
    scorer = ClipScorer(init_clip_params(clip_cfg, torch.Generator(device=dev).manual_seed(0),
                                         device=dev))
    tm = task_model(scene, cams[0], init_pose, insts[0] != 1, "a red box on the top shelf")
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    best_pose, pb, pose_scores = scoring.optimise_pose_grid(
        renderer, np.stack([depths[0]]), [0], tm, data_dir, sample_res=grid_res,
        phys_check=lambda p: scored_mask, scene_type=1, bounds_override=BOUNDS,
        clip_scorer=scorer, tokenizer=partial(hash_tokenize, context_length=clip_cfg.context_length,
                                                vocab_size=clip_cfg.vocab_size), save_renders=False,
    )
    t_score = time.time() - t0
    shutil.rmtree(data_dir, ignore_errors=True)
    n_scored = int(scored_mask.sum())
    if cuda:
        peak = max(peak, torch.cuda.max_memory_allocated(dev))
    out = {
        "n_poses": n,
        "grid": grid_res,
        "oris_per_pos": oris,
        "dedup_keep_frac": float(dedup.mean()),
        "regrasp_keep_frac": float(regrasp.mean()),
        "valid_frac": float(is_valid.mean()),
        "n_valid": n_valid,
        "phys_wall_s": t_phys,
        "phys_poses_per_s": n / t_phys,
        "phys_chunk": int(os.environ.get("D2R_PHYS_CHUNK", "16384")),
        "n_scored": n_scored,
        "score_subsampled": n_scored < n_valid,
        "score_wall_s": t_score,
        "score_poses_per_s": n_scored / t_score,
        "peak_hbm_gb": peak / 2**30,
        "scores_nonzero": int((pose_scores != 0).sum()),
        "best_pose_t": [float(v) for v in best_pose[:3, 3]],
        "fg_crop_final": renderer.fg_crop,
        "models_s": t_models,
        "device": device_line(dev),
    }
    if pb.shape != (n, 16) or not np.isfinite(pose_scores).all():
        raise AssertionError("run_shelfscale: the pose batch is misshapen or a score not finite")
    out.update(best_pose=best_pose, is_valid=is_valid, scored_mask=scored_mask,
               pose_scores=pose_scores)
    return out


def main(argv=None, device=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    out_path = argv[0] if argv else None
    dev = resolve_device(device)
    wait_cuda_healthy(1800.0, device=dev)
    grid = [int(v) for v in os.environ.get("D2R_SHELF_GRID", ",".join(map(str, GRID))).split(",")]
    out = run(grid, int(os.environ.get("D2R_SHELF_SCORE_CAP", "65536")), device=dev)
    record = {k: v for k, v in out.items()
              if k not in ("best_pose", "is_valid", "scored_mask", "pose_scores")}
    print(json.dumps(record), flush=True)
    if out_path:
        with open(out_path, "w") as fh:
            json.dump(record, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
