"""Reference-scale scoring through the production ``optimise_pose_grid``
(port of the repo's experiments/run_refscale.py).

The shopping demo's full grid is 100 x 100 x 7 = 70,000 candidate poses.
This drives the slab dispatcher, the pending-bytes cap, the writer thread,
the score scatter, the smoothing and the argmax that the demo runs, at that
scale on one GPU: the flagship field trained 500 steps on the synthetic
tabletop (8 views of 336^2; fidelity is beside the point, a realistic
density distribution is not), ``CombinedRenderer`` (fg crop 128) and a
random-weight ViT-L/14-336 at full size (no checkpoint is assumed; the work
per pose is the real scorer's), every pose valid (``phys_check=None``).

    python -m dream2real_tpu_torch.experiments.run_refscale [out.json]

Knobs: D2R_REFSCALE_GRID="100,100,7" (default); D2R_REFSCALE_SAVE=1 streams
the cb_render PNGs through the writer thread (about 24 GB of files at full
scale; off by default, the fused no-artifact path of save_renders=false
configs). Prints one JSON line: the JAX script's keys plus ``device`` (the
card's name and power limit) and ``peak_mem_gb`` (the device's peak
allocated memory). The captions are hash-tokenized
(``clip/tokenizer.py::hash_tokenize``), so no tokenizer files are read.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time
from functools import partial
import types

import numpy as np
import torch

from dream2real_tpu_torch import scoring
from dream2real_tpu_torch.cli.bench import device_line
from dream2real_tpu_torch.cli.selftest import SELFTEST_AABB, SETTINGS
from dream2real_tpu_torch.clip.model import CLIPConfig, init_clip_params
from dream2real_tpu_torch.clip.scorer import ClipScorer
from dream2real_tpu_torch.clip.tokenizer import hash_tokenize
from dream2real_tpu_torch.data import synth
from dream2real_tpu_torch.device import F32, resolve_device
from dream2real_tpu_torch.nerf.combined import CombinedRenderer
from dream2real_tpu_torch.nerf.model import NGPConfig
from dream2real_tpu_torch.nerf.trainer import (
    TrainConfig, init_train_state, make_train_chunk, train_with_governor,
)
from dream2real_tpu_torch.ops import cameras
from dream2real_tpu_torch.utils.health import wait_cuda_healthy

RES = 336


def synth_scan(n_views: int, radius: float, height: float, res: int = RES):
    """The synthetic tabletop seen from an orbit: -> (scene, K, cams (N, 4, 4)
    f32, rgbs, depths, insts)."""
    scene = synth.default_scene()
    f = 0.9 * res
    K = np.array([[f, 0, res / 2], [0, f, res / 2], [0, 0, 1.0]])
    cams = synth.orbit_poses(scene.centre, n_views, radius=radius, height=height)
    rgbs, depths, insts = [], [], []
    for cam in cams:
        rgb, depth, inst = synth.render_scene(scene, cam, K, res, res)
        rgbs.append(rgb)
        depths.append(depth)
        insts.append(inst)
    return scene, K, cams.astype(np.float32), rgbs, depths, insts


def train_field(cams, rgbs, depths, K, steps: int, dev, res: int = RES, poll: int = 250):
    """The flagship field trained ``steps`` steps on the scan (8192 rays,
    32 + 32 samples, depth supervision) in chunks of ``poll`` steps. ->
    (field, last chunk's loss)."""
    rgba = np.concatenate([np.stack(rgbs), np.full((len(cams), res, res, 1), 255, np.uint8)], -1)
    ngp_cfg = NGPConfig(**SELFTEST_AABB)
    tc = TrainConfig(n_steps=steps, batch_rays=8192, poll_steps=min(poll, steps),
                     dynamic_time_extension=False)
    state = init_train_state(ngp_cfg, tc, n_images=len(cams), device=dev)
    chunk = make_train_chunk(
        ngp_cfg, tc, SETTINGS, torch.as_tensor(rgba, device=dev),
        torch.as_tensor(cams, dtype=F32, device=dev), cameras.pixel_dirs(res, res, K, device=dev),
        depths=torch.as_tensor(np.stack(depths), device=dev))
    state, losses = train_with_governor(chunk, state, tc)
    return state["field"], losses[-1]


def task_model(scene, cam, T_WO_1, movable_mask, goal_caption: str):
    """A duck-typed task model, as the grid scorer reads it."""
    return types.SimpleNamespace(
        goal_caption=goal_caption, norm_captions=["a red box and a green box"],
        scene_model=types.SimpleNamespace(scene_centre=list(scene.centre),
                                          opt_cam_poses=[cam]),
        movable_obj=types.SimpleNamespace(pose=T_WO_1),
        movable_masks=np.stack([movable_mask]),
        free_visual_models=lambda: None,
    )


def run(grid_res=(100, 100, 7), save_renders: bool = False, train_steps: int = 500,
        n_views: int = 8, data_dir: str | None = None, device=None, res: int = RES,
        clip_cfg: CLIPConfig = CLIPConfig(),
        log=lambda m: print(m, file=sys.stderr, flush=True)) -> dict:
    """Train, then score the grid through optimise_pose_grid. -> the result
    dict (the JSON line's, plus the best pose, the pose batch and the
    scores). ``res`` and ``clip_cfg`` shrink the run for a dry run on the
    CPU."""
    dev = resolve_device(device)
    sample_res = list(grid_res) + [1] * (6 - len(grid_res))
    scene, K, cams, rgbs, depths, insts = synth_scan(n_views, 0.5, 0.4, res)
    field, loss = train_field(cams, rgbs, depths, K, train_steps, dev, res)
    log(f"# field trained {train_steps} steps: loss {loss:.5f}")

    b0 = scene.boxes[0]
    pad = 0.03
    obj_aabb = (tuple(np.asarray(b0.lo) - pad), tuple(np.asarray(b0.hi) + pad))
    T_WO_1 = np.eye(4, dtype=np.float32)
    T_WO_1[:3, 3] = (np.asarray(b0.lo) + np.asarray(b0.hi)) / 2
    own_dir = data_dir is None
    data_dir = data_dir or tempfile.mkdtemp(prefix="d2r_refscale_")
    renderer = CombinedRenderer(
        field, field, settings=SETTINGS, res=res, intrinsics=K, obj_aabb=obj_aabb,
        fg_crop=min(128, res),
        out_render_path=os.path.join(data_dir, "cb_render"), device=dev,
    )
    scorer = ClipScorer(init_clip_params(clip_cfg, torch.Generator(device=dev).manual_seed(0),
                                         device=dev))
    tm = task_model(scene, cams[0], T_WO_1, insts[0] != 1, "a red box on top of the green box")

    n = int(np.prod(sample_res))
    log(f"# grid {sample_res} = {n} poses; save_renders={save_renders}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    best_pose, pose_batch, pose_scores = scoring.optimise_pose_grid(
        renderer, np.stack([depths[0]]), [0], tm, data_dir,
        sample_res=sample_res,
        phys_check=None,  # every pose valid: the point is throughput at full scale
        scene_type=3,
        bounds_override=((-0.2, 0.2), (-0.2, 0.2), (0.0, 0.12),
                         (0.0, 0.0), (0.0, 0.0), (0.0, 0.0)),
        clip_scorer=scorer, tokenizer=partial(hash_tokenize, context_length=clip_cfg.context_length,
                                                vocab_size=clip_cfg.vocab_size), save_renders=save_renders,
    )
    dt = time.time() - t0
    info = dict(scoring.LAST_RUN_INFO)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else 0.0
    out = {
        "n_poses": n,
        "wall_s": dt,
        "poses_per_s_sustained": n / dt,
        "mesh_devices": info.get("mesh_devices"),
        "slab": info.get("slab"),
        "peak_pending_mb": info.get("peak_pending_mb"),
        "save_renders": save_renders,
        "scores_nonzero": int((pose_scores != 0).sum()),
        "best_pose_t": [float(v) for v in best_pose[:3, 3]],
        "grid": sample_res,
        "stage_s": info.get("stage_s"),
        "dispatch_s": info.get("dispatch_s"),
        "drain_s": info.get("drain_s"),
        "n_slabs": info.get("n_slabs"),
        "device": device_line(dev),
        "peak_mem_gb": peak,
    }
    if not np.isfinite(pose_scores).all() or pose_batch.shape != (n, 16):
        raise AssertionError("run_refscale: scores not finite or the pose batch misshapen")
    if save_renders:
        n_files = len(os.listdir(os.path.join(data_dir, "cb_render")))
        if n_files != n:
            raise AssertionError(f"run_refscale: {n_files} renders saved of {n}")
    if own_dir:
        shutil.rmtree(data_dir, ignore_errors=True)
    out["best_pose"] = best_pose
    out["pose_batch"] = pose_batch
    out["pose_scores"] = pose_scores
    return out


def main(argv=None, device=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    out_path = argv[0] if argv else None
    dev = resolve_device(device)
    wait_cuda_healthy(1800.0, device=dev)
    grid = [int(v) for v in os.environ.get("D2R_REFSCALE_GRID", "100,100,7").split(",")]
    out = run(grid, save_renders=os.environ.get("D2R_REFSCALE_SAVE", "0") == "1", device=dev)
    record = {k: v for k, v in out.items() if k not in ("best_pose", "pose_batch", "pose_scores")}
    print(json.dumps(record), flush=True)
    if out_path:
        with open(out_path, "w") as fh:
            json.dump(record, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
