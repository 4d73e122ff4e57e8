"""The crop render (K1) alone, per pose, across the early-exit knob (port of
the repo's experiments/bench_march.py).

Times ``render_pose_batch``'s crop path, the render half of the imagine
loop (one K1 launch a clip group of 32 poses, the composite over the
background), on the flagship field trained 300 steps on the synthetic
tabletop (8 views of 336^2), for each variant: ``D2R_MARCH_EARLY`` 0 and 1
(the exact early-transmittance exit, default on). The knob is read at each
launch, so one process runs both. Each variant renders the poses once to
warm and ``D2R_BENCH_MARCH_REPS`` (2) times timed; the sum of every pixel
must come out the same under both, since the exit is exact.

    python -m dream2real_tpu_torch.experiments.bench_march [n_poses] [out.json]

Prints a line a variant and one JSON line: the JAX script's keys (ms/pose
per rep) plus the card's name and power limit and the peak memory.
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
from dream2real_tpu_torch.device import F32, resolve_device
from dream2real_tpu_torch.experiments.run_refscale import synth_scan, train_field
from dream2real_tpu_torch.nerf.combined import (
    BackgroundView, background_only_image, render_pose_batch,
)
from dream2real_tpu_torch.nerf.march_kernel import pack_params
from dream2real_tpu_torch.nerf.render import render_image
from dream2real_tpu_torch.ops import cameras
from dream2real_tpu_torch.sampling import sample_poses_grid
from dream2real_tpu_torch.utils.health import wait_cuda_healthy

# (tag, D2R_MARCH_EARLY): the JAX script's variants.
VARIANTS = [("flat", "0"), ("flat", "1")]
CLIP_BATCH = 32


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(n_poses: int = 256, device=None, res: int = 336, train_steps: int = 300,
        reps: int | None = None, log=print) -> dict:
    """Train, then time the crop render under each variant. ``res`` and
    ``train_steps`` shrink the run for a dry run on the CPU."""
    dev = resolve_device(device)
    reps = int(os.environ.get("D2R_BENCH_MARCH_REPS", "2")) if reps is None else reps
    scene, K, cams, rgbs, depths, _ = synth_scan(8, 0.5, 0.4, res)
    field, loss = train_field(cams, rgbs, depths, K, train_steps, dev, res, poll=150)
    log(f"# field trained: loss {loss:.5f}")
    dirs_cam = cameras.pixel_dirs(res, res, K, device=dev)
    T_WC = torch.as_tensor(cams[0], dtype=F32, device=dev)
    with torch.inference_mode():
        out = render_image(field, T_WC, dirs_cam, SETTINGS, row_chunk=56)
    bg = BackgroundView(rgb=out["rgb"], alpha=torch.ones_like(out["alpha"]), depth=out["depth"])
    b0 = scene.boxes[0]
    obj_aabb = tuple(torch.as_tensor(v, dtype=F32, device=dev) for v in
                     (np.asarray(b0.lo) - 0.03, np.asarray(b0.hi) + 0.03))
    crop = int(os.environ.get("D2R_BENCH_FG_CROP", "128")) * res // 336
    crop_settings = SETTINGS._replace(
        n_coarse=int(os.environ.get("D2R_CROP_SAMPLES", "20")), n_fine=0)
    Kt = torch.as_tensor(K, dtype=F32, device=dev)
    T_WO = torch.eye(4, dtype=F32, device=dev)
    T_WO[:3, 3] = torch.as_tensor(np.asarray(scene.centre, np.float32))
    grid = sample_poses_grid(scene.centre, [16, max(n_poses // 16, 1), 1, 1, 1, 1],
                             scene_type=3)
    poses = torch.as_tensor(np.asarray(grid).reshape(-1, 4, 4)[:n_poses], dtype=F32, device=dev)
    n_poses = poses.shape[0]

    with torch.inference_mode():
        bg_only = background_only_image(bg)
        packed = pack_params(field)

        def render_all():
            acc = torch.zeros((), dtype=torch.float64, device=dev)
            for s in range(0, n_poses, CLIP_BATCH):
                imgs = render_pose_batch(field, SETTINGS, crop_settings, dirs_cam, Kt, obj_aabb,
                                         crop, 0, T_WO, T_WC, bg, bg_only,
                                         poses[s : s + CLIP_BATCH], packed=packed)
                acc += imgs.sum(dtype=torch.float64)
            return float(acc)

        results, acc0 = {}, None
        stock = os.environ.get("D2R_MARCH_EARLY")
        try:
            for tag, early in VARIANTS:
                key = tag + ("+early" if early == "1" else "")
                os.environ["D2R_MARCH_EARLY"] = early
                acc = render_all()  # warm
                times = []
                for _ in range(reps):
                    _sync(dev)
                    t0 = time.time()
                    acc = render_all()  # the float() waits for the device
                    times.append(time.time() - t0)
                results[key] = [round(1e3 * t / n_poses, 3) for t in times]
                acc0 = acc if acc0 is None else acc0
                exact = "bitexact" if acc == acc0 else f"ACC MISMATCH {acc} vs {acc0}"
                log(f"tile {key:>13}: {results[key]} ms/pose ({exact})")
                if acc != acc0:
                    raise AssertionError(f"bench_march: the early exit changed the renders: {exact}")
        finally:
            if stock is None:
                os.environ.pop("D2R_MARCH_EARLY", None)
            else:
                os.environ["D2R_MARCH_EARLY"] = stock
    return {"n_poses": n_poses, "crop": crop, "crop_samples": crop_settings.n_coarse,
            "ms_per_pose": results, "device": device_line(dev),
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 2**30
            if dev.type == "cuda" else 0.0}


def main(argv=None, device=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    dev = resolve_device(device)
    wait_cuda_healthy(1800.0, device=dev)
    out = run(int(argv[0]) if argv else 256, device=dev)
    print(json.dumps(out), flush=True)
    if len(argv) > 1:
        with open(argv[1], "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
