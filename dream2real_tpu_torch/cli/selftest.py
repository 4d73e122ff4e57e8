"""End-to-end NeRF selftest of the port (the reference's cli/selftest.py):
trains the flagship mlp field on the analytic synthetic tabletop and reports
steps/s, render latency, PSNR and the median depth error.

    python -m dream2real_tpu_torch.cli.selftest            # 336^2, 36 views, 3000 steps
    python -m dream2real_tpu_torch.cli.selftest --small    # 64^2, 1200 steps
    python -m dream2real_tpu_torch.cli.selftest --device cpu --small --steps 40
    python -m dream2real_tpu_torch.cli.selftest --clip-load-dryrun

The pass bar is the reference's: PSNR > 22 dB (15 with --small) and a median
|depth error| < 5 cm, on view 5 of the training orbit. A held-out view, half
an orbit step past view 5, is rendered and reported beside it.

--clip-load-dryrun instead exercises the CLIP checkpoint load path: it
writes a random-weight checkpoint with the tensor names, shapes and file
layout of openai/clip-vit-large-patch14-336 (needs ``transformers`` and
``safetensors``), loads it through ``load_clip`` and scores one 336^2 image
on the device. After it, the only untested step of real scoring is the
weights' values.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from dream2real_tpu_torch.data import synth
from dream2real_tpu_torch.device import F32, resolve_device
from dream2real_tpu_torch.nerf.model import NGPConfig
from dream2real_tpu_torch.nerf.render import RenderSettings, render_image
from dream2real_tpu_torch.nerf.trainer import (
    TrainConfig, init_train_state, make_train_chunk, train_with_governor,
)
from dream2real_tpu_torch.ops import cameras
from dream2real_tpu_torch.ops.image import linear_to_srgb

# The selftest's field box: the synthetic tabletop with margin.
SELFTEST_AABB = dict(aabb_min=(0.0, -0.6, -0.1), aabb_max=(1.1, 0.6, 0.9))
SETTINGS = RenderSettings(n_coarse=32, n_fine=32, near=0.05, far=2.0)
VIEW = 5  # the view the reference's selftest scores


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _score(field, T_WC, dirs_cam, gt_rgb, gt_depth, row_chunk):
    """Render one view -> (PSNR dB, median |depth error| m, sRGB u8 image)."""
    with torch.inference_mode():
        out = render_image(field, T_WC, dirs_cam, SETTINGS, row_chunk=row_chunk)
    alpha = out["alpha"].cpu().numpy()[..., None]
    rgb = np.where(alpha > 0, out["rgb"].cpu().numpy() / np.maximum(alpha, 1e-6), 0)
    img = (linear_to_srgb(torch.from_numpy(rgb)).numpy() * 255).astype(np.uint8)
    mse = np.mean((img.astype(np.float64) - gt_rgb.astype(np.float64)) ** 2)
    d_err = np.abs(out["depth"].cpu().numpy() - gt_depth)
    return 10 * np.log10(255**2 / mse), float(np.median(d_err)), img


def run_selftest(views: int = 36, steps: int = 3000, small: bool = False, device=None,
                 log=print, seed: int = 0) -> dict:
    """Train and score; -> dict of the measured numbers, the pass verdict,
    the trained train state ("state") and what make_train_chunk took
    ("cfg", "tc", "data")."""
    dev = resolve_device(device)
    scene = synth.default_scene()
    h = w = 64 if small else 336
    f = 0.9 * w
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]])
    poses = synth.orbit_poses(scene.centre, views, radius=0.5, height=0.4)
    rgbs, depths = [], []
    for pose in poses:
        rgb, depth, _ = synth.render_scene(scene, pose, K, h, w)
        rgbs.append(rgb)
        depths.append(depth)
    rgba = np.concatenate([np.stack(rgbs), np.full((views, h, w, 1), 255, np.uint8)], axis=-1)
    log(f"dataset ready ({views} views {h}x{w})")

    cfg = NGPConfig(**SELFTEST_AABB)
    tc = TrainConfig(n_steps=steps, batch_rays=2048 if small else 8192,
                     poll_steps=100 if small else 250, dynamic_time_extension=False, seed=seed)
    dirs_cam = cameras.pixel_dirs(h, w, K, device=dev)
    state = init_train_state(cfg, tc, n_images=views, device=dev)
    data = dict(images_rgba=torch.as_tensor(rgba, device=dev),
                init_poses=torch.as_tensor(poses, dtype=F32, device=dev), dirs_cam=dirs_cam,
                depths=torch.as_tensor(np.stack(depths), device=dev))
    chunk = make_train_chunk(cfg, tc, SETTINGS, **data)
    t0 = time.perf_counter()
    state, loss0 = chunk(state)
    log(f"chunk0 (kernel load + {tc.poll_steps} steps): {time.perf_counter() - t0:.1f}s "
        f"loss={loss0:.5f}")
    if not np.isfinite(loss0):
        raise FloatingPointError("NaN/inf loss on the first chunk")
    t0 = time.perf_counter()
    state, losses = train_with_governor(chunk, state, tc)
    _sync(dev)
    dt = time.perf_counter() - t0
    n_done = state["step"] - tc.poll_steps
    log(f"{n_done} steps in {dt:.1f}s = {n_done / max(dt, 1e-9):.2f} steps/s; "
        f"final loss {losses[-1]:.5f}")

    row_chunk = 0 if small else 56
    field = state["field"]
    t_r = time.perf_counter()
    psnr, d_err, img = _score(field, torch.as_tensor(poses[VIEW], dtype=F32, device=dev),
                              dirs_cam, rgbs[VIEW], depths[VIEW], row_chunk)
    ms_img = (time.perf_counter() - t_r) * 1e3
    held = synth.orbit_poses(scene.centre, 2 * views, radius=0.5, height=0.4)[2 * VIEW + 1]
    gt_rgb, gt_depth, _ = synth.render_scene(scene, held, K, h, w)
    psnr_h, d_err_h, _ = _score(field, torch.as_tensor(held, dtype=F32, device=dev), dirs_cam,
                                gt_rgb, gt_depth, row_chunk)
    log(f"{h}x{w} render: {ms_img:.0f} ms/img (incl host sync)")
    log(f"PSNR view{VIEW}: {psnr:.2f} dB; median |depth err|: {d_err * 1000:.1f} mm")
    log(f"PSNR held-out view: {psnr_h:.2f} dB; median |depth err|: {d_err_h * 1000:.1f} mm")
    bar = 15 if small else 22
    ok = bool(psnr > bar and d_err < 0.05)
    return {
        "ok": ok, "psnr": psnr, "depth_err_m": d_err, "psnr_held_out": psnr_h,
        "depth_err_held_out_m": d_err_h, "steps": state["step"], "timed_steps": n_done,
        "steps_per_s": n_done / max(dt, 1e-9), "final_loss": losses[-1], "image": img,
        "state": state, "cfg": cfg, "tc": tc, "data": data,
    }


def clip_load_dryrun(ckpt_dir: str | None = None, device=None, hf_config=None) -> int:
    """Write (unless ``ckpt_dir`` holds one) and load a full-layout CLIP
    checkpoint, then run one scoring forward. ``hf_config`` shrinks the
    model for CPU tests."""
    import os
    import shutil
    import tempfile

    from dream2real_tpu_torch.clip.convert import load_clip, write_random_hf_checkpoint
    from dream2real_tpu_torch.clip.model import (
        encode_image, encode_text, logits_per_image, preprocess_images,
    )

    dev = resolve_device(device)
    cleanup = ckpt_dir is None
    if ckpt_dir is None:
        ckpt_dir = tempfile.mkdtemp(prefix="d2r_clip_dryrun_")
    try:
        if not os.path.isfile(os.path.join(ckpt_dir, "model.safetensors")):
            t0 = time.perf_counter()
            write_random_hf_checkpoint(ckpt_dir, hf_config)
            print(f"wrote full-layout checkpoint in {time.perf_counter() - t0:.1f}s ({ckpt_dir})",
                  flush=True)
        t0 = time.perf_counter()
        model, cfg = load_clip(ckpt_dir, device=dev)
        print(f"load_clip: {time.perf_counter() - t0:.1f}s; vision {cfg.vision_layers}L/"
              f"{cfg.vision_width}w, text {cfg.text_layers}L/{cfg.text_width}w, image "
              f"{cfg.image_size}px", flush=True)
        img = torch.zeros(1, cfg.image_size, cfg.image_size, 3, dtype=torch.uint8, device=dev)
        ids = np.zeros((2, cfg.context_length), np.int64)
        ids[:, 0] = cfg.eot_id - 1
        ids[0, 1:3] = [320, cfg.eot_id]
        ids[1, 1:4] = [320, 525, cfg.eot_id]
        ids = np.minimum(ids, cfg.vocab_size - 1)
        t0 = time.perf_counter()
        with torch.inference_mode():
            lg = logits_per_image(
                model, encode_image(model, preprocess_images(img, cfg)),
                encode_text(model, torch.as_tensor(ids, device=dev)),
            ).cpu().numpy()
        print(f"{cfg.image_size}px scoring forward: {time.perf_counter() - t0:.1f}s; "
              f"logits {lg.ravel()}", flush=True)
        ok = lg.shape == (1, 2) and bool(np.isfinite(lg).all())
        print("CLIP LOAD DRYRUN", "PASS" if ok else "FAIL", flush=True)
        return 0 if ok else 1
    finally:
        if cleanup:
            shutil.rmtree(ckpt_dir, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true", help="64x64, 1200 steps")
    ap.add_argument("--views", type=int, default=36)
    ap.add_argument("--steps", type=int, default=None,
                    help="training steps (default 3000; 1200 with --small)")
    ap.add_argument("--device", type=str, default=None, help="default: cuda")
    ap.add_argument("--seed", type=int, default=0, help="the training run's seed")
    ap.add_argument("--out", type=str, default=None, help="directory for render.png")
    ap.add_argument("--clip-load-dryrun", action="store_true",
                    help="full-layout ViT-L/14-336 checkpoint load + one 336px forward")
    ap.add_argument("--clip-ckpt-dir", type=str, default=None)
    args = ap.parse_args(argv)
    if args.clip_load_dryrun:
        return clip_load_dryrun(args.clip_ckpt_dir, args.device)
    steps = args.steps or (1200 if args.small else 3000)
    res = run_selftest(args.views, steps, args.small, args.device, seed=args.seed)
    if args.out:
        import os

        from dream2real_tpu_torch.utils.png import write_png

        os.makedirs(args.out, exist_ok=True)
        write_png(os.path.join(args.out, "render.png"), res["image"])
    print("SELFTEST", "PASS" if res["ok"] else "FAIL", flush=True)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
