"""The ``save_renders`` writer backlog under its cap (port of the repo's
experiments/verify_save_drive.py).

Small shapes, but ``D2R_RENDER_PENDING_MB=1`` (and ``D2R_SCORE_SLAB=8``)
put every slab over the pending-bytes cap, so the drive goes through each
part of ``scoring._fused_score``'s saving path: dispatch ahead, the slab's
D2H into pinned memory on the side stream (on the card; plain tensors on
the CPU), the writer thread, the backlog bound and the PNG writes. It
checks that every PNG lands, that the scores are finite and vary, and that
``LAST_RUN_INFO["peak_pending_mb"]`` stays within twice the cap plus one
slab.

    python -m dream2real_tpu_torch.experiments.verify_save_drive [out_dir]

On a machine with a GPU it drives the card and then the CPU; without one,
the CPU alone. One JSON line a device: the device (the card's name and
power limit), the PNG count, the peak pending megabytes, the slab and the
peak device memory. The weights are random, from seeds.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import tempfile

import numpy as np
import torch

from dream2real_tpu_torch import scoring
from dream2real_tpu_torch.cli.bench import device_line
from dream2real_tpu_torch.clip.model import CLIPConfig, init_clip_params
from dream2real_tpu_torch.clip.scorer import ClipScorer
from dream2real_tpu_torch.device import resolve_device
from dream2real_tpu_torch.nerf.combined import CombinedRenderer
from dream2real_tpu_torch.nerf.model import NGPConfig, init_ngp_params
from dream2real_tpu_torch.nerf.render import RenderSettings

RES = 112
N_POSES = 96
FIELD = NGPConfig(field_type="mlp", mlp_width=64, mlp_depth=4, skip_layer=2, posenc_deg=5,
                  geo_feat_dim=15, aabb_min=(0.0, -0.6, -0.1), aabb_max=(1.1, 0.6, 0.9))
CLIP = CLIPConfig(eot_id=127, image_size=RES, patch_size=14, vision_width=256, vision_layers=4,
                  vision_heads=4, vocab_size=128, context_length=16, text_width=128,
                  text_layers=2, text_heads=2, projection_dim=96)


class _TaskCaptions:
    goal_caption = "a red box on the green box"
    norm_captions = ["a red box and a green box"]


def _tok(texts, ctx=16):
    """The JAX script's tokenizer of the 128-word test vocabulary: md5 of each
    word, end token 127."""
    ids = np.zeros((len(texts), ctx), np.int32)
    for r, t in enumerate(texts):
        toks = [1] + [2 + int(hashlib.md5(wd.encode()).hexdigest(), 16) % 124 for wd in t.split()]
        toks = toks[: ctx - 1] + [127]
        ids[r, : len(toks)] = toks
    return ids


def run(out_dir: str, device=None, n_poses: int = N_POSES, res: int = RES,
        clip_cfg: CLIPConfig = CLIP) -> dict:
    """Score ``n_poses`` candidates with save_renders under the backlog cap
    (D2R_RENDER_PENDING_MB, default 1 here; D2R_SCORE_SLAB, default 8).
    -> the record; raises when a check fails."""
    dev = resolve_device(device)
    f = 0.9 * res
    K = np.array([[f, 0, res / 2], [0, f, res / 2], [0, 0, 1.0]])
    field = init_ngp_params(FIELD, torch.Generator(device=dev).manual_seed(0), device=dev)
    renderer = CombinedRenderer(
        field, field, settings=RenderSettings(n_coarse=16, n_fine=16, near=0.05, far=2.0),
        res=res, intrinsics=K, row_chunk=28, obj_aabb=((0.35, -0.1, 0.0), (0.65, 0.1, 0.15)),
        fg_crop=48 * res // RES, out_render_path=out_dir, device=dev)
    scorer = ClipScorer(init_clip_params(clip_cfg, torch.Generator(device=dev).manual_seed(7),
                                         device=dev), batch_size=8)
    T_WO_1 = np.eye(4, dtype=np.float32)
    T_WO_1[:3, 3] = [0.5, 0.0, 0.05]
    cam = np.array([[1, 0, 0, 0.5], [0, -1, 0, 0.0], [0, 0, -1, 0.7], [0, 0, 0, 1]], np.float32)
    poses = np.tile(T_WO_1[None], (n_poses, 1, 1))
    poses[:, 0, 3] += np.linspace(-0.08, 0.12, n_poses)
    poses[:, 2, 3] += np.linspace(0.0, 0.04, n_poses)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    knobs = {"D2R_RENDER_PENDING_MB": os.environ.get("D2R_RENDER_PENDING_MB", "1"),
             "D2R_SCORE_SLAB": os.environ.get("D2R_SCORE_SLAB", "8")}
    saved = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    try:
        scores = scoring._fused_score(renderer, scorer, _tok, _TaskCaptions(), poses, cam[None],
                                      None, None, T_WO_1, use_templates=False,
                                      save_renders=True)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    files = sorted(os.listdir(out_dir))
    info = scoring.LAST_RUN_INFO
    cap_mb = float(knobs["D2R_RENDER_PENDING_MB"])
    slab_mb = info["slab"] * res * res * 3 / 2**20
    out = {
        "pngs": len(files),
        "n_poses": n_poses,
        "scores_finite": bool(np.isfinite(scores).all()),
        "scores_std": float(np.std(scores)),
        "peak_pending_mb": info.get("peak_pending_mb"),
        "pending_cap_mb": cap_mb,
        "bound_mb": 2 * cap_mb + slab_mb,
        "slab": info["slab"],
        "n_slabs": info.get("n_slabs"),
        "device": device_line(dev),
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else 0.0,
    }
    if files != [f"cb_rgb_{i:04d}.png" for i in range(n_poses)]:
        raise AssertionError(f"verify_save_drive: {len(files)} PNGs of {n_poses}")
    if not (out["scores_finite"] and out["scores_std"] > 0):
        raise AssertionError(f"verify_save_drive: scores {out}")
    if out["peak_pending_mb"] > out["bound_mb"] + 0.05:  # the peak is rounded to 0.1 MB
        raise AssertionError(f"verify_save_drive: the backlog passed its bound: {out}")
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    root = argv[0] if argv else tempfile.mkdtemp(prefix="d2r_verify_save_")
    devices = (["cuda"] if torch.cuda.is_available() else []) + ["cpu"]
    for dev in devices:
        out = run(os.path.join(root, dev), device=dev)
        print(json.dumps(out), flush=True)
    print("SAVE-DRIVE PASS", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
