"""The training step's extrinsics overhead, one thing toggled at a time (port
of the repo's experiments/bench_train_extr.py).

The dataset (24 views of 128^2 of the synthetic tabletop, alpha from the
instance masks, depth) and the sampler stay fixed; the variants are the
JAX script's:

  1. extr-off:       the baseline;
  2. extr-on:        joint pose refinement (``ext_start_step`` 256);
  3. extr-on-gated:  ``ext_start_step`` past the run, the same graph with no
                     pose motion (graph cost apart from convergence);
  4. glue-only:      ``so3_exp``, the pose compose, the one-hot pick and the
                     direction product, forward and backward, with a scalar
                     in place of the render (the extrinsics glue alone).

Each variant trains the flagship field (4096 rays, 32 + 32 samples; K5-K7
on the card) in chunks of ``POLL`` steps: one chunk to warm, then ``reps``
chunks timed, waiting for the device at the end.

    python -m dream2real_tpu_torch.experiments.bench_train_extr [reps] [out.json]

Prints a line a variant and one JSON line (ms a step a variant, the
extr-on overhead, the card's name and power limit, the peak memory).
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from dream2real_tpu_torch.cli.bench import device_line
from dream2real_tpu_torch.data import synth
from dream2real_tpu_torch.device import F32, resolve_device
from dream2real_tpu_torch.nerf.model import NGPConfig
from dream2real_tpu_torch.nerf.render import RenderSettings
from dream2real_tpu_torch.nerf.trainer import (
    TrainConfig, init_train_state, make_train_chunk, optimized_poses,
)
from dream2real_tpu_torch.ops import cameras

POLL = 50  # steps a chunk
# (name, optimize_extrinsics, ext_start_step): the JAX script's variants.
VARIANTS = [("extr-off", False, 0), ("extr-on", True, 256), ("extr-on-gated", True, 10**9)]
BATCH_RAYS = 4096


def dataset(dev, res: int = 128, n_views: int = 24):
    """-> (rgba (N, res, res, 4) u8, cams (N, 4, 4), dirs (res, res, 3),
    depths (N, res, res)) on ``dev``."""
    scene = synth.default_scene()
    f = 0.9 * res
    K = np.array([[f, 0, res / 2], [0, f, res / 2], [0, 0, 1.0]])
    cams = synth.orbit_poses(scene.centre, n_views, radius=0.5, height=0.4)
    rgba, depths = [], []
    for cam in cams:
        rgb, depth, inst = synth.render_scene(scene, cam, K, res, res)
        rgba.append(np.concatenate([rgb, np.where(inst > 0, 255, 0).astype(np.uint8)[..., None]],
                                   -1))
        depths.append(depth)
    return (torch.as_tensor(np.stack(rgba), device=dev),
            torch.as_tensor(cams, dtype=F32, device=dev),
            cameras.pixel_dirs(res, res, K, device=dev),
            torch.as_tensor(np.stack(depths), dtype=F32, device=dev))


def train_config(extr: bool, start: int, reps: int) -> TrainConfig:
    return TrainConfig(n_steps=POLL * (reps + 1), batch_rays=BATCH_RAYS, poll_steps=POLL,
                       optimize_extrinsics=extr, ext_start_step=start,
                       dynamic_time_extension=False)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(reps: int = 4, device=None, res: int = 128, log=print) -> dict:
    dev = resolve_device(device)
    rgba, cams, dirs, depths = dataset(dev, res)
    ncfg = NGPConfig(aabb_min=(0.0, -0.6, -0.1), aabb_max=(1.1, 0.6, 0.9))
    settings = RenderSettings(n_coarse=32, n_fine=32, near=0.05, far=2.0)
    ms = {}
    for name, extr, start in VARIANTS:
        tc = train_config(extr, start, reps)
        state = init_train_state(ncfg, tc, n_images=rgba.shape[0], device=dev)
        chunk = make_train_chunk(ncfg, tc, settings, rgba, cams, dirs, depths=depths)
        state, _ = chunk(state)  # warm
        _sync(dev)
        t0 = time.time()
        for _ in range(reps):
            state, loss = chunk(state)  # the chunk's float() waits for the device
        ms[name] = 1e3 * (time.time() - t0) / (reps * POLL)
        log(f"{name:16s}: {ms[name]:6.2f} ms/step ({1e3 / ms[name]:5.0f} steps/s)")

    # 4. The extrinsics glue alone, fwd + bwd, a scalar for the render.
    n_img = rgba.shape[0]
    d_cam = dirs[: BATCH_RAYS // 128, :128].reshape(BATCH_RAYS, 3)
    ext_rot = torch.zeros(n_img, 3, device=dev, requires_grad=True)
    ext_trans = torch.zeros(n_img, 3, device=dev, requires_grad=True)
    gen = torch.Generator(device=dev).manual_seed(0)

    def glue_chunk():
        for _ in range(POLL):
            img_idx = torch.randint(0, n_img, (BATCH_RAYS,), generator=gen, device=dev)
            poses = optimized_poses(ext_rot, ext_trans, cams)
            sel = torch.nn.functional.one_hot(img_idx, n_img).to(F32)
            T = torch.einsum("bn,nij->bij", sel, poses)
            d = torch.einsum("bij,bj->bi", T[:, :3, :3], d_cam)
            loss = (d * d).sum() + T[:, :3, 3].sum()
            g_rot, g_trans = torch.autograd.grad(loss, [ext_rot, ext_trans])
            with torch.no_grad():
                ext_rot.sub_(1e-9 * g_rot)
                ext_trans.sub_(1e-9 * g_trans)
        return float(loss.detach())

    glue_chunk()
    _sync(dev)
    t0 = time.time()
    for _ in range(reps):
        glue_chunk()
    ms["glue-only"] = 1e3 * (time.time() - t0) / (reps * POLL)
    log(f"{'glue-only':16s}: {ms['glue-only']:6.2f} ms/step")
    off, on = ms["extr-off"], ms["extr-on"]
    log(f"extr-on overhead: {on - off:.2f} ms/step ({(on / off - 1) * 100:.0f}%)")
    return {"ms_per_step": ms, "extr_on_overhead_ms": on - off,
            "extr_on_overhead_frac": on / off - 1, "reps": reps, "poll": POLL,
            "batch_rays": BATCH_RAYS, "res": res, "device": device_line(dev),
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 2**30
            if dev.type == "cuda" else 0.0}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    out = run(int(argv[0]) if argv else 4)
    print(json.dumps(out), flush=True)
    if len(argv) > 1:
        with open(argv[1], "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
