"""A/B of the fused training kernels' approximate extrinsics gradients
against exact autograd (port of the repo's experiments/extr_grad_ab.py).

The fused training step (K5-K7, ``nerf/train_kernel.py``) backpropagates to
the ray origins and directions through the sample positions only: the |d|
delta scale, the SH colour basis and the ray-box t-range paths are dropped.
Pose refinement therefore sees the dominant term, not the exact gradient
that plain autograd (``D2R_PALLAS_TRAIN=0``) computes. This measures what
that costs where it matters, the recovered camera poses.

Protocol (the JAX script's): the synthetic scene, 16 orbit views of 336^2;
the odd cameras perturbed by a fixed rotation about a random axis and a
fixed translation (``perturb``, from ``default_rng(7)``), the even cameras
exact, anchoring the gauge. The full-scene configuration
(optimize_extrinsics, TrainConfig's defaults, 4096 rays, seed 3) trains
once per (gradient arm x initial error), and each run reports its final
loss, the perturbed cameras' mean and largest rotation (degrees) and
translation (mm) errors, the anchors' mean rotation drift and steps/s.

Levels: 1 deg / 10 mm, 5 deg / 30 mm, 10 deg / 60 mm.

    python -m dream2real_tpu_torch.experiments.extr_grad_ab [n_steps] [out.json] [deg:mm ...]

Knobs: D2R_BENCH_RES / D2R_BENCH_VIEWS / D2R_BENCH_BATCH (smaller for a
smoke run); D2R_EXTR_SEED (default 3, the JAX script's) for other training
seeds. The arms are "fused_approx" (the kernels) and "plain_exact"
(plain autograd; the JAX script's "xla_exact").
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from dream2real_tpu_torch.cli.bench import device_line
from dream2real_tpu_torch.cli.selftest import SELFTEST_AABB, SETTINGS
from dream2real_tpu_torch.device import F32, resolve_device
from dream2real_tpu_torch.experiments.run_refscale import synth_scan
from dream2real_tpu_torch.nerf.model import NGPConfig
from dream2real_tpu_torch.nerf.trainer import (
    TrainConfig, init_train_state, make_train_chunk, optimized_poses, train_with_governor,
)
from dream2real_tpu_torch.ops import cameras
from dream2real_tpu_torch.utils.health import wait_cuda_healthy

LEVELS = ((1.0, 10.0), (5.0, 30.0), (10.0, 60.0))
ARMS = (("plain_exact", "0"), ("fused_approx", "1"))


def rot_err_deg(Ra, Rb) -> float:
    cos = (np.trace(Ra.T @ Rb) - 1) / 2
    return float(np.degrees(np.arccos(np.clip(cos, -1, 1))))


def perturb(true_poses: np.ndarray, rot_deg: float, trans_mm: float) -> np.ndarray:
    """The odd cameras turned by ``rot_deg`` about a random axis and moved
    by ``trans_mm``, from default_rng(7); the even ones exact."""
    rng = np.random.default_rng(7)
    poses = true_poses.copy()
    for i in range(1, len(true_poses), 2):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        ang = np.radians(rot_deg)
        kx, ky, kz = axis
        Kx = np.array([[0, -kz, ky], [kz, 0, -kx], [-ky, kx, 0]], np.float32)
        R = np.eye(3, dtype=np.float32) + np.sin(ang) * Kx + (1 - np.cos(ang)) * Kx @ Kx
        poses[i, :3, :3] = poses[i, :3, :3] @ R
        t = rng.normal(size=3)
        poses[i, :3, 3] += (trans_mm / 1e3 * t / np.linalg.norm(t)).astype(np.float32)
    return poses


def run(n_steps: int = 4000, levels=LEVELS, arms=ARMS, res: int = 336, n_views: int = 16,
        batch_rays: int = 4096, seed: int = 3, device=None,
        log=lambda m: print(m, file=sys.stderr, flush=True)) -> dict:
    """Every (level, arm) run. -> {"n_steps", "seed", "levels": {key:
    {"init", arm: {...}}}} as the JAX script's JSON. ``seed`` seeds the
    field and the rays (the perturbation stays default_rng(7)'s)."""
    dev = resolve_device(device)
    _, K, true_poses, rgbs, depths, _ = synth_scan(n_views, 0.5, 0.4, res)
    rgba = torch.as_tensor(np.concatenate(
        [np.stack(rgbs), np.full((n_views, res, res, 1), 255, np.uint8)], -1), device=dev)
    depths_t = torch.as_tensor(np.stack(depths), device=dev)
    dirs_cam = cameras.pixel_dirs(res, res, K, device=dev)
    ngp_cfg = NGPConfig(**SELFTEST_AABB)
    tc = TrainConfig(n_steps=n_steps, batch_rays=batch_rays, optimize_extrinsics=True,
                     poll_steps=200, dynamic_time_extension=False, seed=seed)
    perturbed = list(range(1, n_views, 2))
    anchors = list(range(0, n_views, 2))
    results = {"n_steps": n_steps, "seed": seed, "levels": {}}
    for rot_deg, trans_mm in levels:
        poses = perturb(true_poses, rot_deg, trans_mm)
        init_rot = [rot_err_deg(poses[i, :3, :3], true_poses[i, :3, :3]) for i in perturbed]
        init_tr = [1e3 * np.linalg.norm(poses[i, :3, 3] - true_poses[i, :3, 3])
                   for i in perturbed]
        key = f"{rot_deg:g}deg_{trans_mm:g}mm"
        lvl = {"init": {"rot_deg": float(np.mean(init_rot)), "trans_mm": float(np.mean(init_tr)),
                        "rot_deg_max": float(np.max(init_rot)),
                        "trans_mm_max": float(np.max(init_tr))}}
        log(f"## level {key}: init rot {np.mean(init_rot):.3f} deg, trans "
            f"{np.mean(init_tr):.1f} mm")
        poses_t = torch.as_tensor(poses, dtype=F32, device=dev)
        for name, flag in arms:
            before = os.environ.get("D2R_PALLAS_TRAIN")
            os.environ["D2R_PALLAS_TRAIN"] = flag
            try:
                state = init_train_state(ngp_cfg, tc, n_images=n_views, device=dev)
                chunk = make_train_chunk(ngp_cfg, tc, SETTINGS, rgba, poses_t, dirs_cam,
                                         depths=depths_t)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                t0 = time.time()
                state, losses = train_with_governor(chunk, state, tc)
                dt = time.time() - t0
            finally:
                if before is None:
                    os.environ.pop("D2R_PALLAS_TRAIN", None)
                else:
                    os.environ["D2R_PALLAS_TRAIN"] = before
            with torch.no_grad():
                opt = optimized_poses(state["ext_rot"], state["ext_trans"], poses_t).cpu().numpy()
            rot = [rot_err_deg(opt[i, :3, :3], true_poses[i, :3, :3]) for i in perturbed]
            tr = [1e3 * np.linalg.norm(opt[i, :3, 3] - true_poses[i, :3, 3]) for i in perturbed]
            anc = [rot_err_deg(opt[i, :3, :3], true_poses[i, :3, :3]) for i in anchors]
            lvl[name] = {
                "final_loss": float(losses[-1]),
                "rot_deg": float(np.mean(rot)), "rot_deg_max": float(np.max(rot)),
                "trans_mm": float(np.mean(tr)), "trans_mm_max": float(np.max(tr)),
                "anchor_rot_deg": float(np.mean(anc)),
                "steps_per_s": len(losses) * tc.poll_steps / dt,
            }
            log(f"{name:13s}: loss {losses[-1]:.5f}  rot {np.mean(rot):.3f} deg (max "
                f"{np.max(rot):.3f})  trans {np.mean(tr):.1f} mm (max {np.max(tr):.1f})  "
                f"anchors {np.mean(anc):.3f} deg  {lvl[name]['steps_per_s']:.1f} steps/s")
        if all(name in lvl for name, _ in ARMS):
            pe, fa = lvl["plain_exact"], lvl["fused_approx"]
            log(f"approx-vs-exact @ {key}: rot {fa['rot_deg'] - pe['rot_deg']:+.3f} deg, trans "
                f"{fa['trans_mm'] - pe['trans_mm']:+.2f} mm, speed "
                f"{fa['steps_per_s'] / max(pe['steps_per_s'], 1e-9):.2f}x")
        results["levels"][key] = lvl
    return results


def main(argv=None, device=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n_steps = int(argv[0]) if argv else 4000
    out_path = argv[1] if len(argv) > 1 else None
    levels = [tuple(float(v) for v in a.split(":")) for a in argv[2:]] or LEVELS
    dev = resolve_device(device)
    wait_cuda_healthy(900.0, device=dev)
    results = run(n_steps, levels, res=int(os.environ.get("D2R_BENCH_RES", "336")),
                  n_views=int(os.environ.get("D2R_BENCH_VIEWS", "16")),
                  batch_rays=int(os.environ.get("D2R_BENCH_BATCH", "4096")),
                  seed=int(os.environ.get("D2R_EXTR_SEED", "3")), device=dev)
    results["device"] = device_line(dev)
    print(json.dumps(results), flush=True)
    if out_path:
        with open(out_path, "w") as fh:
            json.dump(results, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
