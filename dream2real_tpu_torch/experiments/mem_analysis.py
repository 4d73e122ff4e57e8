"""Peak device memory of the full-shape imagine-and-score program on each
device it runs on (port of the repo's experiments/mem_analysis.py).

The JAX script compiles bench.py's program ahead of time and reads XLA's
memory analysis (arguments, outputs, temporaries, code) against the TPU's
16 GB. PyTorch compiles nothing ahead, so the port runs one dispatch of the
same program (336^2 view, 128^2 fg crop, flagship field, ViT-L/14-336,
clip_batch 32, D2R_BENCH_DISPATCH = 256 poses; random weights, as there)
and reads ``torch.cuda.max_memory_allocated`` on each device of the
program's mesh (the one card, or every card when there are several). Under
pose-batch sharding each device runs the single-device program on its
share, so one card's peak is the per-device footprint.

    python -m dream2real_tpu_torch.experiments.mem_analysis [out.json]

Prints one JSON line: the JAX script's keys where the port has them
(``compile_s`` is the first dispatch's seconds, the kernels' build
included; ``code_mb`` the built kernel libraries; ``temp_mb`` the peak
above the arguments), ``per_device_mb``, ``hbm_gb`` the card's memory, the
card's name and power limit. Gate: the peak stays under 7/8 of the card.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from dream2real_tpu_torch import build
from dream2real_tpu_torch.cli.bench import device_line
from dream2real_tpu_torch.clip.model import CLIPConfig, init_clip_params
from dream2real_tpu_torch.data import synth
from dream2real_tpu_torch.device import F32, resolve_device
from dream2real_tpu_torch.nerf.combined import BackgroundView
from dream2real_tpu_torch.nerf.model import NGPConfig, init_ngp_params
from dream2real_tpu_torch.nerf.render import RenderSettings
from dream2real_tpu_torch.ops import cameras
from dream2real_tpu_torch.parallel.imagine import make_imagine_and_score
from dream2real_tpu_torch.parallel.mesh import auto_mesh, canonical, leads
from dream2real_tpu_torch.utils.health import wait_cuda_healthy


def _bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def run(device=None) -> dict:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("mem_analysis reads the card's allocator: it needs a GPU")
    dev = canonical(dev)
    mesh = leads(auto_mesh(), dev)
    devices = [dev] if mesh is None else list(mesh.distinct())
    res = 336
    scene = synth.default_scene()
    f = 0.9 * res
    K = np.array([[f, 0, res / 2], [0, f, res / 2], [0, 0, 1.0]])
    ngp_cfg = NGPConfig(aabb_min=(0.0, -0.6, -0.1), aabb_max=(1.1, 0.6, 0.9))
    settings = RenderSettings(n_coarse=32, n_fine=32, near=0.05, far=2.0)
    dirs_cam = cameras.pixel_dirs(res, res, K, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    field = init_ngp_params(ngp_cfg, gen, device=dev)
    clip_cfg = CLIPConfig()
    clip = init_clip_params(clip_cfg, gen, device=dev)
    # Random text embeddings: the JAX script's zeros normalise to NaN
    # logits, which it never executes.
    txt_emb = torch.as_tensor(np.random.default_rng(0).normal(
        size=(2, clip_cfg.projection_dim)).astype(np.float32), device=dev)
    b0 = scene.boxes[0]
    obj_aabb = (tuple(np.asarray(b0.lo) - 0.03), tuple(np.asarray(b0.hi) + 0.03))
    clip_batch = int(os.environ.get("D2R_BENCH_CLIP_BATCH", "32"))
    dispatch_poses = int(os.environ.get("D2R_BENCH_DISPATCH", "256"))
    score_fn = make_imagine_and_score(
        ngp_cfg, clip_cfg, settings, dirs_cam, n_norm_captions=1, clip_batch=clip_batch,
        obj_aabb=obj_aabb, fg_crop=int(os.environ.get("D2R_BENCH_FG_CROP", "128")),
        intrinsics=K, mesh=mesh, device=dev)
    T_WO = torch.eye(4, dtype=F32, device=dev)
    T_WC = torch.as_tensor(synth.orbit_poses(scene.centre, 1, radius=0.5, height=0.4)[0],
                           dtype=F32, device=dev)
    bg = BackgroundView(rgb=torch.zeros(res, res, 3, device=dev),
                        alpha=torch.ones(res, res, device=dev),
                        depth=torch.ones(res, res, device=dev))
    poses = torch.eye(4, dtype=F32, device=dev).repeat(dispatch_poses, 1, 1)
    args_bytes = _bytes(*field.parameters(), *clip.parameters(), T_WO, T_WC, *bg, txt_emb, poses)
    for d in devices:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
    base = {d: torch.cuda.memory_allocated(d) for d in devices}
    t0 = time.time()
    scores = score_fn(field, clip, T_WO, T_WC, bg, txt_emb, poses)
    for d in devices:
        torch.cuda.synchronize(d)
    compile_s = time.time() - t0
    peak = {d: torch.cuda.max_memory_allocated(d) for d in devices}
    lead_peak = peak[dev]
    code = sum(p.stat().st_size for p in build.BUILD_DIR.glob("*.so"))
    hbm = torch.cuda.get_device_properties(dev).total_memory
    out = {
        "dispatch_poses": dispatch_poses,
        "clip_batch": clip_batch,
        "compile_s": round(compile_s, 1),
        "argument_mb": round(args_bytes / 2**20, 1),
        "output_mb": round(_bytes(scores) / 2**20, 3),
        "temp_mb": round((lead_peak - base[dev]) / 2**20, 1),
        "code_mb": round(code / 2**20, 1),
        "alias_mb": 0.0,
        "total_mb": round(lead_peak / 2**20, 1),
        "per_device_mb": {str(d): round(p / 2**20, 1) for d, p in peak.items()},
        "mesh_devices": 1 if mesh is None else mesh.size,
        "hbm_gb": round(hbm / 1e9, 1),
        "device": device_line(dev),
        "peak_mem_gb": lead_peak / 2**30,
    }
    if not torch.isfinite(scores).all() or max(peak.values()) > 0.875 * hbm:
        raise AssertionError(f"mem_analysis: {out}")
    return out


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
