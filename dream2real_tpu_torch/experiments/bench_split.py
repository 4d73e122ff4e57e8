"""The imagine-and-score loop split into render and CLIP (port of the repo's
experiments/bench_split.py).

At the bench's shapes and dispatch protocol (the flagship field trained on
16 views of the synthetic tabletop, D2R_BENCH_POSES = 512 poses in
D2R_BENCH_DISPATCH = 256-pose dispatches, clip_batch 32, crop 128,
ViT-L/14-336 with random weights) it times, each after a warm dispatch and
waiting for the device after every dispatch:

  A. the fused render + score (``make_imagine_and_score``, the bench);
  B. render only: the same crop renders and composites per clip group
     (``render_pose_batch``, one K1 launch a group), summed on the device;
  C. CLIP only: rot90, preprocess, the image tower, logits and the score
     reduction per clip group, from frames rendered beforehand.

A is about B + C (``sum_vs_full``); the larger of B and C is where the
loop's time goes.

    python -m dream2real_tpu_torch.experiments.bench_split [out.json]

Prints one JSON line: the JAX script's keys plus the card's name and power
limit and the peak memory.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from dream2real_tpu_torch.cli.bench import device_line
from dream2real_tpu_torch.cli.selftest import SETTINGS
from dream2real_tpu_torch.clip.model import (
    CLIPConfig, encode_image, init_clip_params, logits_per_image, preprocess_images,
)
from dream2real_tpu_torch.clip.scorer import reduce_logits
from dream2real_tpu_torch.device import F32, resolve_device
from dream2real_tpu_torch.experiments.run_refscale import synth_scan, train_field
from dream2real_tpu_torch.nerf.combined import (
    BackgroundView, background_only_image, render_pose_batch,
)
from dream2real_tpu_torch.nerf.march_kernel import pack_params
from dream2real_tpu_torch.nerf.render import render_image
from dream2real_tpu_torch.ops import cameras
from dream2real_tpu_torch.parallel.imagine import make_imagine_and_score
from dream2real_tpu_torch.sampling import sample_poses_grid
from dream2real_tpu_torch.utils.health import wait_cuda_healthy


def run(device=None, res: int = 336, clip_cfg: CLIPConfig = CLIPConfig(),
        train_steps: int | None = None, log=print) -> dict:
    """Train, then time A, B and C. ``res``, ``clip_cfg`` and
    ``train_steps`` shrink the run for a dry run on the CPU."""
    dev = resolve_device(device)
    steps = int(os.environ.get("D2R_BENCH_TRAIN_STEPS", "600")) if train_steps is None \
        else train_steps
    scene, K, cams, rgbs, depths, _ = synth_scan(16, 0.5, 0.4, res)
    field, loss = train_field(cams, rgbs, depths, K, steps, dev, res)
    log(f"# field trained: loss {loss:.5f}")
    dirs_cam = cameras.pixel_dirs(res, res, K, device=dev)
    T_WC = torch.as_tensor(cams[0], dtype=F32, device=dev)
    with torch.inference_mode():
        out = render_image(field, T_WC, dirs_cam, SETTINGS, row_chunk=56)
    bg = BackgroundView(rgb=out["rgb"], alpha=torch.ones_like(out["alpha"]), depth=out["depth"])
    clip = init_clip_params(clip_cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    txt_emb = torch.as_tensor(np.random.default_rng(0).normal(
        size=(2, clip_cfg.projection_dim)).astype(np.float32), device=dev)
    clip_batch = int(os.environ.get("D2R_BENCH_CLIP_BATCH", "32"))
    b0 = scene.boxes[0]
    obj_aabb = (tuple(np.asarray(b0.lo) - 0.03), tuple(np.asarray(b0.hi) + 0.03))
    fg_crop = int(os.environ.get("D2R_BENCH_FG_CROP", "128")) * res // 336
    crop_settings = SETTINGS._replace(
        n_coarse=int(os.environ.get("D2R_CROP_SAMPLES", "20")), n_fine=0)
    T_WO = torch.eye(4, dtype=F32, device=dev)
    T_WO[:3, 3] = torch.as_tensor(np.asarray(scene.centre, np.float32))
    n_poses = int(os.environ.get("D2R_BENCH_POSES", "512"))
    n_poses = max(clip_batch, n_poses // clip_batch * clip_batch)
    grid = np.asarray(sample_poses_grid(scene.centre, [16, max(n_poses // 16, 1), 1, 1, 1, 1],
                                        scene_type=3)).reshape(-1, 4, 4)
    poses = torch.as_tensor(np.tile(grid, (max(1, n_poses // len(grid) + 1), 1, 1))[:n_poses],
                            dtype=F32, device=dev)
    dispatch = int(os.environ.get("D2R_BENCH_DISPATCH", "256"))
    dispatch = max(clip_batch, dispatch // clip_batch * clip_batch)
    slabs = [poses[s : s + dispatch] for s in range(0, n_poses, dispatch)]

    def time_dispatches(fn, inputs):
        """Warm once, then time one call an input, each reduced to a host
        number (which waits for the device)."""
        float(fn(inputs[0]))
        t0 = time.time()
        for x in inputs:
            float(fn(x))
        return time.time() - t0

    # A: the fused loop, the bench's program.
    score_fn = make_imagine_and_score(
        field.cfg, clip_cfg, SETTINGS, dirs_cam, n_norm_captions=1, clip_batch=clip_batch,
        obj_aabb=obj_aabb, fg_crop=fg_crop, crop_settings=crop_settings, intrinsics=K,
        device=dev)
    dt_a = time_dispatches(
        lambda p: score_fn(field, clip, T_WO, T_WC, bg, txt_emb, p).sum(), slabs)

    # B: the renders alone, the same crop path and clip groups.
    Kt = torch.as_tensor(K, dtype=F32, device=dev)
    box = tuple(torch.as_tensor(v, dtype=F32, device=dev) for v in obj_aabb)

    @torch.inference_mode()
    def render_only(p):
        bg_only = background_only_image(bg)
        packed = pack_params(field)
        acc = torch.zeros((), dtype=torch.float64, device=dev)
        for s in range(0, p.shape[0], clip_batch):
            imgs = render_pose_batch(field, SETTINGS, crop_settings, dirs_cam, Kt, box, fg_crop,
                                     0, T_WO, T_WC, bg, bg_only, p[s : s + clip_batch],
                                     packed=packed)
            acc += imgs.sum(dtype=torch.float64)
        return acc

    dt_b = time_dispatches(render_only, slabs)

    # C: CLIP alone, from one dispatch's frames rendered beforehand.
    render_fn = make_imagine_and_score(
        field.cfg, clip_cfg, SETTINGS, dirs_cam, n_norm_captions=1, clip_batch=clip_batch,
        obj_aabb=obj_aabb, fg_crop=fg_crop, crop_settings=crop_settings, intrinsics=K,
        return_renders=True, device=dev)
    _, frames = render_fn(field, clip, T_WO, T_WC, bg, txt_emb, slabs[0])

    @torch.inference_mode()
    def clip_only(frames_u8):
        scores = []
        for s in range(0, frames_u8.shape[0], clip_batch):
            imgs = torch.rot90(frames_u8[s : s + clip_batch], k=1, dims=(1, 2))
            emb = encode_image(clip, preprocess_images(imgs, clip_cfg))
            scores.append(reduce_logits(logits_per_image(clip, emb, txt_emb), 1, False))
        return torch.cat(scores).sum()

    dt_c = time_dispatches(clip_only, [frames] * len(slabs))
    return {
        "n_poses": n_poses, "dispatch": dispatch, "clip_batch": clip_batch,
        "fg_crop": fg_crop, "crop_samples": crop_settings.n_coarse,
        "full_s": dt_a, "render_only_s": dt_b, "clip_only_s": dt_c,
        "full_poses_per_s": n_poses / dt_a,
        "render_ms_per_pose": 1e3 * dt_b / n_poses,
        "clip_ms_per_pose": 1e3 * dt_c / n_poses,
        "sum_vs_full": (dt_b + dt_c) / dt_a,
        "device": device_line(dev),
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else 0.0,
    }


def main(argv=None, device=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    dev = resolve_device(device)
    wait_cuda_healthy(1800.0, device=dev)
    out = run(device=dev)
    print(json.dumps(out), flush=True)
    if argv:
        with open(argv[0], "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
