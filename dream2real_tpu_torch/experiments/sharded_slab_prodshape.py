"""One production-shape slab, sharded, against one device (port of the repo's
experiments/sharded_slab_prodshape.py).

The JAX script executes one slab of the full-width program (ViT-L/14-336,
the flagship field, 128 px crop, clip_batch 32) sharded over two virtual
CPU devices and compares the per-pose scores with the single-device
program. Here the same slab runs through the port's
``make_imagine_and_score`` with a mesh of ``n`` shards: over ``n`` cards
when the machine has them, else ``n`` shards that repeat the one card (the
port's stand-in for XLA's virtual devices). Shard boundaries fall on clip
groups, so the scores must equal the single device's bit for bit; the
script also times both ways.

    python -m dream2real_tpu_torch.experiments.sharded_slab_prodshape [n_shards] [out.json]

Prints one JSON line: the JAX script's keys plus ``bit_identical``,
``mesh`` (the devices), ``poses_per_s_sharded`` / ``_single``, ``device``
(the card's name and power limit) and ``peak_mem_gb``. Random weights from
seeds; the inputs are the JAX script's.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from dream2real_tpu_torch.cli.bench import device_line
from dream2real_tpu_torch.clip.model import CLIPConfig, init_clip_params
from dream2real_tpu_torch.device import F32, resolve_device
from dream2real_tpu_torch.nerf.combined import BackgroundView
from dream2real_tpu_torch.nerf.model import NGPConfig, init_ngp_params
from dream2real_tpu_torch.nerf.render import RenderSettings
from dream2real_tpu_torch.ops import cameras
from dream2real_tpu_torch.parallel.imagine import make_imagine_and_score
from dream2real_tpu_torch.parallel.mesh import DataMesh, data_mesh

CLIP_BATCH = 32


def shard_mesh(n: int, dev: torch.device) -> DataMesh:
    """``n`` cards when there are as many, else ``n`` shards of ``dev``."""
    if dev.type == "cuda" and torch.cuda.device_count() >= n:
        return data_mesh(n)
    return data_mesh(devices=[dev] * n)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def compare(make_args: tuple, make_kwargs: dict, score_args: tuple, mesh: DataMesh,
            reps: int = 1) -> dict:
    """``make_imagine_and_score(*make_args, **make_kwargs)`` on one device and
    on ``mesh``, each called on ``score_args`` once to warm and ``reps``
    times timed. -> the scores' gap and both timings."""
    dev = mesh.lead
    n_poses = score_args[-1].shape[0]
    out = {}
    scores = {}
    for tag, mesh_arg in (("single", None), ("sharded", mesh)):
        fn = make_imagine_and_score(*make_args, mesh=mesh_arg, device=dev, **make_kwargs)
        s = fn(*score_args)
        _sync(dev)
        t0 = time.time()
        for _ in range(reps):
            s = fn(*score_args)
        _sync(dev)
        dt = (time.time() - t0) / reps
        scores[tag] = s.double().cpu().numpy()
        out[f"wall_s_{tag}"] = dt
        out[f"poses_per_s_{tag}"] = n_poses / dt
    s1, s2 = scores["single"], scores["sharded"]
    rel = np.abs(s2 - s1) / np.maximum(np.abs(s1), 1e-12)
    out.update(
        n_poses=n_poses, n_devices=mesh.size, mesh=[str(d) for d in mesh.devices],
        max_abs_diff=float(np.abs(s2 - s1).max()), max_rel_diff=float(rel.max()),
        bit_identical=bool(np.array_equal(s1, s2)),
        scores_finite=bool(np.isfinite(s2).all()), scores_nonconstant=bool(np.std(s2) > 0),
    )
    return out


def run(n_shards: int = 2, n_poses: int | None = None, device=None, res: int = 336,
        clip_cfg: CLIPConfig = CLIPConfig(), clip_batch: int = CLIP_BATCH, fg_crop: int = 128,
        reps: int = 1) -> dict:
    """The JAX script's slab (``n_shards * clip_batch`` poses by default) on
    ``n_shards`` shards against one device. ``res``, ``clip_cfg``,
    ``clip_batch`` and ``fg_crop`` shrink it for a dry run on the CPU."""
    dev = resolve_device(device)
    n_poses = n_shards * clip_batch if n_poses is None else n_poses
    gen = torch.Generator(device=dev).manual_seed(0)
    ngp_cfg = NGPConfig(aabb_min=(0.0, -0.6, -0.1), aabb_max=(1.1, 0.6, 0.9))
    field = init_ngp_params(ngp_cfg, gen, device=dev)
    clip = init_clip_params(clip_cfg, gen, device=dev)
    settings = RenderSettings(n_coarse=32, n_fine=32, near=0.05, far=2.0)
    crop_settings = RenderSettings(n_coarse=20, n_fine=0, near=0.05, far=2.0)
    f = 0.9 * res
    K = np.array([[f, 0, res / 2], [0, f, res / 2], [0, 0, 1.0]])
    dirs_cam = cameras.pixel_dirs(res, res, K, device=dev)
    rng = np.random.default_rng(7)
    bg = BackgroundView(
        rgb=torch.as_tensor(rng.uniform(size=(res, res, 3)).astype(np.float32), device=dev),
        alpha=torch.ones(res, res, device=dev), depth=torch.full((res, res), 0.9, device=dev))
    T_WC = torch.tensor([[1, 0, 0, 0.5], [0, -1, 0, 0.0], [0, 0, -1, 0.6], [0, 0, 0, 1]],
                        dtype=F32, device=dev)
    T_WO = torch.eye(4, dtype=F32, device=dev)
    T_WO[:3, 3] = torch.tensor([0.5, 0.0, 0.05])
    txt = torch.as_tensor(rng.normal(size=(2, clip_cfg.projection_dim)).astype(np.float32),
                          device=dev)
    obj_aabb = (np.array([0.42, -0.08, 0.0]), np.array([0.58, 0.08, 0.14]))
    poses = np.tile(np.eye(4, dtype=np.float32)[None], (n_poses, 1, 1))
    poses[:, 0, 3] = np.linspace(0.38, 0.62, n_poses)
    poses[:, 1, 3] = np.tile(np.linspace(-0.12, 0.12, 8), -(-n_poses // 8))[:n_poses]
    poses[:, 2, 3] = 0.06
    mesh = shard_mesh(n_shards, dev)
    out = compare(
        (ngp_cfg, clip_cfg, settings, dirs_cam),
        dict(n_norm_captions=1, clip_batch=clip_batch, obj_aabb=obj_aabb, fg_crop=fg_crop,
             crop_settings=crop_settings, intrinsics=K, row_chunk=56),
        (field, clip, T_WO, T_WC, bg, txt, torch.as_tensor(poses, device=dev)), mesh, reps)
    out.update(res=res, clip=f"{clip_cfg.vision_layers}-layer ViT, width {clip_cfg.vision_width}"
               " (random init)", fg_crop=fg_crop, crop_samples=crop_settings.n_coarse,
               device=device_line(dev),
               peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2**30
               if dev.type == "cuda" else 0.0)
    if not (out["scores_finite"] and out["scores_nonconstant"] and out["bit_identical"]):
        raise AssertionError(f"sharded_slab_prodshape: {out}")
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 2
    out = run(n)
    print(json.dumps(out), flush=True)
    if len(argv) > 1:
        with open(argv[1], "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
