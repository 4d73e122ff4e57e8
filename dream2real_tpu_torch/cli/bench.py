"""Headline benchmark of the port: candidate poses rendered + CLIP-scored per
second on one GPU (the reference's bench.py through the port).

    python -m dream2real_tpu_torch.cli.bench

The workload is bench.py's: the flagship field trained briefly on the
synthetic tabletop (16 views, D2R_BENCH_TRAIN_STEPS, default 600), a 336^2
background view rendered once, a random-weight ViT-L/14-336 (no checkpoint
is assumed; the work per pose is that of the real scorer), random text
embeddings, and D2R_BENCH_POSES (512) poses of the shopping grid through
``make_imagine_and_score`` with D2R_BENCH_CLIP_BATCH (32), D2R_BENCH_FG_CROP
(128) and D2R_BENCH_DISPATCH (256) poses a dispatch, after one warm
dispatch, after a bounded wait for a healthy card (D2R_BENCH_HEALTH_WAIT_S,
default 1800 s; 0 skips it). Prints ONE JSON line last: {"metric", "value", "unit", "device"},
the device as nvidia-smi names it with its power limit. The reference's
"vs_baseline" is left out: its denominator was an estimate nobody measured.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from dream2real_tpu_torch.cli.selftest import SELFTEST_AABB, SETTINGS
from dream2real_tpu_torch.clip.model import CLIPConfig, init_clip_params
from dream2real_tpu_torch.data import synth
from dream2real_tpu_torch.device import F32, resolve_device
from dream2real_tpu_torch.nerf.combined import BackgroundView
from dream2real_tpu_torch.nerf.model import NGPConfig
from dream2real_tpu_torch.nerf.render import render_image
from dream2real_tpu_torch.nerf.trainer import (
    TrainConfig, init_train_state, make_train_chunk, train_with_governor,
)
from dream2real_tpu_torch.ops import cameras
from dream2real_tpu_torch.parallel.imagine import make_imagine_and_score
from dream2real_tpu_torch.sampling import sample_poses_grid
from dream2real_tpu_torch.utils.health import wait_cuda_healthy


def device_line(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[dev.index or 0]


def run_bench(device=None, log=lambda m: print(m, file=sys.stderr, flush=True)) -> dict:
    """Train, then time the imagine-and-score loop. -> the JSON line's dict."""
    dev = resolve_device(device)
    # The bench runs unattended: a wedged or degraded card would hang it or
    # record a number off by orders of magnitude (utils/health.py).
    wait_cuda_healthy(1800.0, env_var="D2R_BENCH_HEALTH_WAIT_S", device=dev)
    t_start = time.time()
    res = 336
    clip_cfg = CLIPConfig()

    # ---- Train the flagship field briefly on the synthetic tabletop (the
    # bench measures render + score throughput; a trained field has a
    # realistic density distribution).
    scene = synth.default_scene()
    f = 0.9 * res
    K = np.array([[f, 0, res / 2], [0, f, res / 2], [0, 0, 1.0]])
    cams = synth.orbit_poses(scene.centre, 16, radius=0.5, height=0.4)
    rgbs, depths = [], []
    for cam in cams:
        rgb, depth, _ = synth.render_scene(scene, cam, K, res, res)
        rgbs.append(rgb)
        depths.append(depth)
    rgba = np.concatenate([np.stack(rgbs), np.full((len(cams), res, res, 1), 255, np.uint8)], -1)
    ngp_cfg = NGPConfig(**SELFTEST_AABB)
    tc = TrainConfig(
        n_steps=int(os.environ.get("D2R_BENCH_TRAIN_STEPS", "600")),
        batch_rays=8192, poll_steps=250, dynamic_time_extension=False,
    )
    settings = SETTINGS
    dirs_cam = cameras.pixel_dirs(res, res, K, device=dev)
    state = init_train_state(ngp_cfg, tc, n_images=len(cams), device=dev)
    chunk = make_train_chunk(
        ngp_cfg, tc, settings, images_rgba=torch.as_tensor(rgba, device=dev),
        init_poses=torch.as_tensor(cams, dtype=F32, device=dev), dirs_cam=dirs_cam,
        depths=torch.as_tensor(np.stack(depths), device=dev),
    )
    state, losses = train_with_governor(chunk, state, tc)
    field = state["field"]
    log(f"# field trained: loss {losses[-1]:.5f}")

    # ---- Background view (amortised per task, like the reference).
    T_WC = torch.as_tensor(cams[0], dtype=F32, device=dev)
    with torch.inference_mode():
        bg_out = render_image(field, T_WC, dirs_cam, settings, row_chunk=56)
    bg = BackgroundView(rgb=bg_out["rgb"], alpha=torch.ones_like(bg_out["alpha"]),
                        depth=bg_out["depth"])

    # ---- CLIP ViT-L/14-336-shaped scorer.
    clip = init_clip_params(clip_cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    txt_emb = torch.as_tensor(
        np.random.default_rng(0).normal(size=(2, clip_cfg.projection_dim)).astype(np.float32),
        device=dev)

    clip_batch = int(os.environ.get("D2R_BENCH_CLIP_BATCH", "32"))
    # The movable object's box (the red box) with margin drives the cropped
    # fast path: the fg marched only in its projected window.
    b0 = scene.boxes[0]
    obj_aabb = (tuple(np.asarray(b0.lo) - 0.03), tuple(np.asarray(b0.hi) + 0.03))
    fg_crop = int(os.environ.get("D2R_BENCH_FG_CROP", "128"))
    score_fn = make_imagine_and_score(
        ngp_cfg, clip_cfg, settings, dirs_cam, n_norm_captions=1, clip_batch=clip_batch,
        obj_aabb=obj_aabb, fg_crop=fg_crop, intrinsics=K, device=dev,
    )
    T_WO = torch.eye(4, dtype=F32, device=dev)
    T_WO[:3, 3] = torch.as_tensor(np.asarray(scene.centre, np.float32), device=dev)

    n_poses = int(os.environ.get("D2R_BENCH_POSES", "512"))
    n_poses = max(clip_batch, n_poses // clip_batch * clip_batch)
    grid = sample_poses_grid(scene.centre, [16, max(n_poses // 16, 1), 1, 1, 1, 1], scene_type=3)
    grid = grid.reshape(-1, 4, 4)
    reps = int(np.ceil(n_poses / len(grid)))
    poses = torch.as_tensor(np.tile(grid, (reps, 1, 1))[:n_poses], device=dev)

    dispatch = int(os.environ.get("D2R_BENCH_DISPATCH", "256"))
    dispatch = max(clip_batch, dispatch // clip_batch * clip_batch)
    args = (field, clip, T_WO, T_WC, bg, txt_emb)
    float(score_fn(*args, poses[:dispatch]).sum())  # the warm dispatch
    t0 = time.time()
    acc = 0.0
    for s in range(0, n_poses, dispatch):
        acc += float(score_fn(*args, poses[s : s + dispatch]).sum())  # waits for the device
    dt = time.time() - t0
    if not np.isfinite(acc):
        raise FloatingPointError("the bench's scores are not finite")
    log(f"# {n_poses} poses rendered+scored in {dt:.2f}s; total bench wall-clock "
        f"{time.time() - t_start:.0f}s")
    return {
        "metric": "candidate poses rendered+CLIP-scored per second (336x336, ViT-L/14-336)",
        "value": round(n_poses / dt, 2),
        "unit": "poses/s",
        "device": device_line(dev),
    }


def main(argv=None, device=None) -> int:
    print(json.dumps(run_bench(device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
