"""Drive the PyTorch/CUDA port's imagine-and-score path on one GPU.

    python3 chip_smoke.py            # needs one card
    python3 chip_smoke.py --profile  # also print a torch.profiler breakdown
                                     # of one 32-pose clip group

Phases (any failure raises; the exit code is then nonzero):
  0 device      require CUDA; print the card's name and power limit
  1 build       compile every kernel under dream2real_tpu_torch/csrc (nvcc)
  2 kernels     each kernel against its plain PyTorch version on the card at
                the main path's shapes, timed (CUDA events, median), with its
                roofline bound and a one-call PyTorch yardstick
  3 main path   bench.py's workload: synth scene, 336^2 view, plain-torch
                background render, random-weight ViT-L/14-336, hash-tokenized
                captions through encode_text (K4), 512 poses through
                make_imagine_and_score (fg_crop 128, clip_batch 32), smoothed
                [16, 32, 1, 1, 1, 1] argmax; launch counters checked
  4 main vs plain  one 32-pose clip group through the kernels and through
                their plain versions: renders, image and text embeddings and
                logits held; the score ratio and argmax reported
The second-to-last line is the kernels JSON, the last the device JSON.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from contextlib import ExitStack
from unittest import mock

import numpy as np
import torch

# Peaks of one H100 SXM (NVIDIA data sheet, dense): bf16 tensor cores and HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
SEED = 0


def log(*args):
    print(*args, flush=True)


def phase(name):
    log(f"== {name}")


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def time_ms(fn, runs: int) -> float:
    """Median of `runs` single-call CUDA-event timings, after one warm call."""
    fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2

    from dream2real_tpu_torch import build
    from dream2real_tpu_torch.clip import model as cm
    from dream2real_tpu_torch.clip.scorer import build_captions
    from dream2real_tpu_torch.clip.tokenizer import hash_tokenize
    from dream2real_tpu_torch.data import synth
    from dream2real_tpu_torch.nerf import combined, march_kernel as mk
    from dream2real_tpu_torch.nerf.model import NGPConfig, init_ngp_params
    from dream2real_tpu_torch.nerf.render import RenderSettings, render_image
    from dream2real_tpu_torch.ops import attention as att
    from dream2real_tpu_torch.ops import cameras
    from dream2real_tpu_torch.parallel.imagine import make_imagine_and_score
    from dream2real_tpu_torch.sampling import sample_poses_grid
    from dream2real_tpu_torch.smoothing import spatially_smooth_heatmap

    profile = "--profile" in sys.argv[1:]
    dev = torch.device("cuda")

    # ------------------------------------------------------------ 0 device
    phase("0 device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")

    # ------------------------------------------------------------- 1 build
    phase("1 build")
    secs = build.build_all()
    log(f"built {', '.join(build.SOURCES)} in {secs:.2f} s")
    for src in build.SOURCES:
        for line in build.build_log(src).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")

    # ------------------------------------------------ scene (phases 2 to 4)
    res, crop, clip_batch = 336, 128, 32
    scene = synth.default_scene()
    f = 0.9 * res
    K = np.array([[f, 0, res / 2], [0, f, res / 2], [0, 0, 1.0]])
    cams = synth.orbit_poses(scene.centre, 16, radius=0.5, height=0.4)
    ngp_cfg = NGPConfig(aabb_min=(0.0, -0.6, -0.1), aabb_max=(1.1, 0.6, 0.9))
    settings = RenderSettings(n_coarse=32, n_fine=32, near=0.05, far=2.0)
    crop_settings = settings._replace(n_coarse=int(os.environ.get("D2R_CROP_SAMPLES", "20")),
                                      n_fine=0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    field = init_ngp_params(ngp_cfg, gen, device=dev)
    dirs_cam = cameras.pixel_dirs(res, res, K, device=dev)
    T_WC = torch.as_tensor(cams[0], dtype=torch.float32, device=dev)
    T_WO = torch.eye(4, device=dev)
    T_WO[:3, 3] = torch.tensor(scene.centre, device=dev)
    b0 = scene.boxes[0]
    obj_aabb = (tuple(np.asarray(b0.lo) - 0.03), tuple(np.asarray(b0.hi) + 0.03))
    grid = sample_poses_grid(scene.centre, [16, 32, 1, 1, 1, 1], scene_type=3).reshape(-1, 4, 4)
    poses = torch.as_tensor(grid, device=dev)
    kernels = []

    def record(name_, source, replaces, max_err, ms, plain_ms, flops, nbytes, library_ms):
        b_ms, b_by = bound_ms(flops, nbytes)
        kernels.append({
            "name": name_, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
        })
        log(f"  {name_}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}), library {library_ms if library_ms is None else f'{library_ms:.4f} ms'}, "
            f"max |kernel - plain| {max_err:.3e}")

    # ---------------------------------------------------------- 2 kernels
    phase("2 kernels against their plain versions (main-path shapes)")
    with torch.inference_mode():
        # K1: one clip group of candidate poses, 128^2 crop rays each; the
        # kernel gets the rays that hit the object box, as on the main path.
        T_WC_2, _, _, dirs = combined.crop_rays(dirs_cam, K, obj_aabb, crop, T_WO, T_WC,
                                                poses[:clip_batch])
        live, *k1_in, box = mk.march_inputs(ngp_cfg, T_WC_2[:, :3, 3].contiguous(), dirs,
                                            obj_aabb, crop_settings)
        w, b = mk.pack_params(field)
        args = (*k1_in, box, w, b, crop_settings.n_coarse, crop_settings.min_transmittance)
        got = mk.march(*args, True)
        *ref, needed = mk.march_plain(*args, True, count_samples=True)
        off = mk.march(*args, False)
        for a, c in zip(got, off):
            if not torch.equal(a, c):
                raise AssertionError("K1: early exit on != off")
        err = max(float((a - c).abs().max()) for a, c in zip(got, ref))
        if err > 5e-3:
            raise AssertionError(f"K1: kernel vs plain max abs {err} > 5e-3")
        if float(got[1].max()) <= 0.0:
            raise AssertionError("K1: the crop renders are empty")
        n_all, n_live = dirs.shape[0] * dirs.shape[1], int(live.numel())
        touched = torch.zeros(n_all, dtype=torch.bool, device=dev)
        touched[live] = True
        log(f"  K1: {clip_batch} poses x {crop * crop} rays x {crop_settings.n_coarse} samples; "
            f"{n_live} rays hit the box, touching {int(touched.reshape(-1, 128).any(1).sum())} "
            f"of {n_all // 128} 128-ray blocks, {-(-n_live // 128)} blocks when launched "
            f"alone; {needed} samples needed")
        macs = 63 * 256 + 2 * 256 * 256 + 319 * 256 + 256 * 16 + 31 * 64 + 64 * 64 + 64 * 3
        record(
            "march (K1)", "dream2real_tpu_torch/csrc/march.cu",
            "dream2real_tpu/nerf/march_kernel.py:421", err,
            time_ms(lambda: mk.march(*args, True), 10),
            time_ms(lambda: mk.march_plain(*args, True), 3),
            # bytes: origin, dir, t0, t1 in and rgb, alpha, depth out per live
            # ray; the box and the weights once
            2.0 * macs * needed, n_live * 13 * 4 + 12 * 4 + w.numel() * 2 + b.numel() * 4, None,
        )

        # K2 / K3: one clip group through a vision block, both softmax modes.
        B, T, W, H = clip_batch, 577, 1024, 16
        x = (torch.randn(B, T, W, generator=gen, device=dev) * 2.0).to(torch.bfloat16)
        wqkv = (torch.randn(W, 3 * W, generator=gen, device=dev) * W**-0.5).to(torch.bfloat16)
        bqkv = torch.randn(3 * W, generator=gen, device=dev) * 0.02
        g = 1.0 + 0.1 * torch.randn(W, generator=gen, device=dev)
        beta = 0.1 * torch.randn(W, generator=gen, device=dev)
        qkv = (torch.randn(B, T, 3 * W, generator=gen, device=dev) * 2.0).to(torch.bfloat16)
        hd = W // H
        attn_flops = 4.0 * B * H * T * T * hd
        errs2, errs3 = [], []
        for maxsub in ("0", "1"):
            os.environ["D2R_ATTN_MAXSUB"] = maxsub
            o2 = att.mha_ln_qkv(x, wqkv, bqkv, g, beta, H)
            r2 = att.mha_ln_qkv_plain(x, wqkv, bqkv, g, beta, H, maxsub == "1")
            o3 = att.mha_qkv(qkv, H)
            r3 = att.mha_qkv_plain(qkv, H, maxsub == "1")
            for o, r, errs, tag in ((o2, r2, errs2, "K2"), (o3, r3, errs3, "K3")):
                o, r = o.float(), r.float()
                if not torch.allclose(o, r, atol=0.02, rtol=0.05):
                    raise AssertionError(f"{tag} (MAXSUB={maxsub}): kernel vs plain outside "
                                         f"atol 0.02 / rtol 0.05, max {float((o - r).abs().max())}")
                errs.append(float((o - r).abs().max()))
        os.environ["D2R_ATTN_MAXSUB"] = "0"
        F = torch.nn.functional

        def lib_k2():
            xn = F.layer_norm(x, (W,), g.to(torch.bfloat16), beta.to(torch.bfloat16), 1e-5)
            y = torch.matmul(xn, wqkv) + bqkv.to(torch.bfloat16)
            q, k, v = (t.view(B, T, H, hd).transpose(1, 2) for t in y.split(W, dim=-1))
            return F.scaled_dot_product_attention(q, k, v)

        q3, k3, v3 = (t.view(B, T, H, hd).transpose(1, 2) for t in qkv.split(W, dim=-1))
        record(
            "ln_qkv_attention (K2)", "dream2real_tpu_torch/csrc/attention.cu",
            "dream2real_tpu/ops/attention.py:274", max(errs2),
            time_ms(lambda: att.mha_ln_qkv(x, wqkv, bqkv, g, beta, H), 10),
            time_ms(lambda: att.mha_ln_qkv_plain(x, wqkv, bqkv, g, beta, H, False), 3),
            2.0 * B * T * W * 3 * W + attn_flops, 2 * B * T * W * 2 + W * 3 * W * 2 + 5 * W * 4,
            time_ms(lib_k2, 10),
        )
        record(
            "attention_qkv (K3)", "dream2real_tpu_torch/csrc/attention.cu",
            "dream2real_tpu/ops/attention.py:195", max(errs3),
            time_ms(lambda: att.mha_qkv(qkv, H), 10),
            time_ms(lambda: att.mha_qkv_plain(qkv, H, False), 3),
            attn_flops, B * T * 4 * W * 2,
            time_ms(lambda: F.scaled_dot_product_attention(q3, k3, v3), 10),
        )

        # K4: the text tower's causal attention (3 captions, 12 heads, 77 tokens).
        Bt, Ht, Tt, Dt = 3, 12, 77, 64
        q4, k4, v4 = ((torch.randn(Bt, Ht, Tt, Dt, generator=gen, device=dev)).to(torch.bfloat16)
                      for _ in range(3))
        o4, r4 = att.mha(q4, k4, v4, causal=True).float(), att.mha_causal_plain(q4, k4, v4).float()
        if not torch.allclose(o4, r4, atol=0.02, rtol=0.05):
            raise AssertionError(f"K4: kernel vs plain max {float((o4 - r4).abs().max())}")
        record(
            "attention_causal (K4)", "dream2real_tpu_torch/csrc/attention.cu",
            "dream2real_tpu/ops/attention.py:66", float((o4 - r4).abs().max()),
            time_ms(lambda: att.mha(q4, k4, v4, causal=True), 20),
            time_ms(lambda: att.mha_causal_plain(q4, k4, v4), 10),
            2.0 * Bt * Ht * Dt * Tt * (Tt + 1), 4 * Bt * Ht * Tt * Dt * 2,
            time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True), 20),
        )
        del x, qkv, q3, k3, v3

    # -------------------------------------------------------- 3 main path
    phase("3 main path (bench.py workload, 512 poses)")
    wrappers = {"march (K1)": mk.march, "ln_qkv_attention (K2)": att.mha_ln_qkv,
                "attention_qkv (K3)": att.mha_qkv, "attention_causal (K4)": att.mha}
    for fn in wrappers.values():
        fn.launches = 0
    t_setup = time.perf_counter()
    with torch.inference_mode():
        bg_out = render_image(field, T_WC, dirs_cam, settings, row_chunk=56)
        # Depth as CombinedRenderer.render_background takes it from a scan:
        # the view's ground truth with the movable object pushed to 100.
        _, gt_depth, inst = synth.render_scene(scene, cams[0], K, res, res)
        bg_depth = torch.as_tensor(np.where(inst == 1, 100.0, gt_depth), dtype=torch.float32,
                                   device=dev)
        bg = combined.BackgroundView(rgb=bg_out["rgb"], alpha=torch.ones_like(bg_out["alpha"]),
                                     depth=bg_depth)
        clip_cfg = cm.CLIPConfig()
        # CLIP draws from its own generator, so its weights do not depend on
        # what phase 2 drew.
        clip = cm.init_clip_params(clip_cfg, torch.Generator(device=dev).manual_seed(SEED + 1),
                                   device=dev)
        captions = build_captions("a red box on the green box", ["a red box", "a green box"])
        # The hash tokenizer, whatever transformers files the machine has:
        # random CLIP weights give no meaning to real BPE ids either.
        ids = torch.as_tensor(hash_tokenize(captions), device=dev)
        txt_emb = cm.encode_text(clip, ids)
        torch.cuda.synchronize()
    log(f"  set-up (background render, CLIP init, text tower) {time.perf_counter() - t_setup:.2f} s")
    score_fn = make_imagine_and_score(
        ngp_cfg, clip_cfg, settings, dirs_cam, n_norm_captions=2, clip_batch=clip_batch,
        obj_aabb=obj_aabb, fg_crop=crop, intrinsics=K,
    )
    args3 = (field, clip, T_WO, T_WC, bg, txt_emb)
    groups = 0
    warm = score_fn(*args3, poses[:clip_batch])
    groups += 1
    torch.cuda.synchronize()
    dispatch = 256
    t0 = time.perf_counter()
    scores = torch.cat([score_fn(*args3, poses[s : s + dispatch])
                        for s in range(0, poses.shape[0], dispatch)])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    groups += poses.shape[0] // clip_batch
    smoothed = spatially_smooth_heatmap(scores, [16, 32, 1, 1, 1, 1])
    best = int(torch.argmax(smoothed))
    n = poses.shape[0]
    if scores.shape != (n,) or not bool(torch.isfinite(scores).all()):
        raise AssertionError("main path: scores are not finite (512,)")
    if not bool(torch.allclose(warm, scores[:clip_batch], rtol=1e-5, atol=1e-6)):
        raise AssertionError("main path: the warm dispatch and the timed run disagree")
    log(f"  {n} poses in {dt:.3f} s: {n / dt:.2f} poses/s, {dt / n * 1e3:.3f} ms/pose "
        f"({name}; {smi})")
    log(f"  scores: mean {float(scores.mean()):.6f}, std {float(scores.std()):.6f}; "
        f"smoothed argmax {best} (pose {grid[best][:3, 3].round(4).tolist()})")
    launches = {k: fn.launches for k, fn in wrappers.items()}
    log(f"  launches: {launches}; clip groups dispatched {groups}")
    if launches["march (K1)"] <= 0:
        raise AssertionError("K1 never launched on the main path")
    if launches["ln_qkv_attention (K2)"] != 23 * groups:
        raise AssertionError(f"K2 launched {launches['ln_qkv_attention (K2)']} != 23 x {groups}")
    if launches["attention_qkv (K3)"] != 23 * groups:
        raise AssertionError("K3 (K2's attention half) launch count is off")
    if launches["attention_causal (K4)"] != clip_cfg.text_layers:
        raise AssertionError(f"K4 launched {launches['attention_causal (K4)']} != 12")
    for k in kernels:
        k["launches"] = launches[k["name"]]

    if profile:
        from torch.profiler import ProfilerActivity, profile as tprofile

        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            score_fn(*args3, poses[:clip_batch])
            torch.cuda.synchronize()
        log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=15))

    # --------------------------------------------------- 4 main vs plain
    phase("4 main path through the kernels vs through their plain versions")
    # One clip group through the kernels and through their plain versions,
    # held at the levels that are well conditioned on random weights: the
    # renders, the image and text embeddings, the logits. The goal /
    # mean(norm) score ratio is reported, not held: random towers give
    # near-orthogonal image and text embeddings (tiny logits), so the bf16
    # residue of the embeddings moves the ratio by far more than 2%
    # (PERF.md, Findings).
    group = poses[:clip_batch]
    render_fn = make_imagine_and_score(
        ngp_cfg, clip_cfg, settings, dirs_cam, n_norm_captions=2, clip_batch=clip_batch,
        obj_aabb=obj_aabb, fg_crop=crop, intrinsics=K, return_renders=True,
    )

    def run_group(txt):
        s_, r_ = render_fn(field, clip, T_WO, T_WC, bg, txt, group)
        with torch.inference_mode():
            e_ = cm.encode_image(clip, cm.preprocess_images(torch.rot90(r_, 1, (1, 2)), clip_cfg))
            return s_, r_, e_, cm.logits_per_image(clip, e_, txt)

    k_scores, k_renders, k_emb, k_logits = run_group(txt_emb)
    with ExitStack() as stack:
        stack.enter_context(mock.patch.object(
            mk, "march", lambda *a: mk.march_plain(*a)))
        stack.enter_context(mock.patch.object(
            cm, "mha_ln_qkv", lambda *a: att.mha_ln_qkv_plain(*a, att._maxsub())))
        stack.enter_context(mock.patch.object(
            cm, "mha_qkv", lambda qkv_, h: att.mha_qkv_plain(qkv_, h, att._maxsub())))
        stack.enter_context(mock.patch.object(
            cm, "mha", lambda q_, k_, v_, causal: att.mha_causal_plain(q_, k_, v_)))
        with torch.inference_mode():
            txt_plain = cm.encode_text(clip, ids)
        p_scores, p_renders, p_emb, p_logits = run_group(txt_plain)
    cos = torch.nn.functional.cosine_similarity
    level = (k_renders.int() - p_renders.int()).abs().amax(dim=-1)
    same_px = float((level == 0).float().mean())
    img_cos = float(cos(k_emb, p_emb, dim=-1).min())
    txt_cos = float(cos(txt_emb, txt_plain, dim=-1).min())
    d_logit = float((k_logits - p_logits).abs().max())
    rel = float(((k_scores - p_scores).abs() / p_scores.abs()).max())
    log(f"  renders: {same_px:.6f} of pixels identical, max {int(level.max())} levels apart")
    log(f"  embeddings: min cosine image {img_cos:.7f}, text {txt_cos:.8f}; "
        f"max |logit difference| {d_logit:.4e} (logits up to {float(k_logits.abs().max()):.3f})")
    log(f"  scores (reported): max relative difference {rel:.3e}; argmax kernel "
        f"{int(k_scores.argmax())}, plain {int(p_scores.argmax())}")
    if same_px < 0.999 or int(level.max()) > 2:
        raise AssertionError("main vs plain: the renders differ")
    if img_cos < 0.9995 or txt_cos < 0.99999:
        raise AssertionError("main vs plain: the embeddings differ")
    if d_logit > 0.1:
        raise AssertionError(f"main vs plain: logits differ by {d_logit}")
    if not (bool(torch.isfinite(p_scores).all()) and bool(torch.isfinite(k_scores).all())):
        raise AssertionError("main vs plain: scores are not finite")

    # ------------------------------------------------------------ results
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
