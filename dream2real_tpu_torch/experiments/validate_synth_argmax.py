"""End-to-end argmax validation against a ray-tracing oracle, no CLIP (port
of experiments/validate_synth_argmax.py).

The real pipeline (segmentation -> field training -> task fg / bg fields ->
the combined crop renderer) runs on a synthetic scene; only the CLIP score
is replaced, by a negative MSE against a ray-traced goal image, and every
grid pose is scored a second time with a perfect ray-traced render at its
actual placement. The oracle's argmax is the expected answer: do the field's
renders rank poses the way perfect images would?

Gates (the run fails on any): field fidelity, the identity-move render
against the ray tracer, >= 22 dB PSNR (relevant objects only, black
background); the raw argmax equal to the oracle's (grid index, orientation
axes included); the smoothed argmax within one translation cell with the
orientation exact; Spearman rank correlation over the top 5% of the oracle's
poses >= 0.9 (0.8 in --combined mode).

Modes: default = translation grid on the standard scene; --rect = a 6-DoF
grid with a yaw {0, 90 deg} axis on the rectangular-footprint scene;
--distort = the xyz validation on a Brown-Conrady-distorted scan (the config
configs/synth_demo_distort.json, transforms.json regenerated through
raw_poses_convert); --noise = the xyz validation on a scan with sensor noise,
depth holes and SE(3) pose jitter, extrinsics optimisation on; --combined =
all of them at once. The first positional argument is the data directory:
stages whose artifacts exist there are replayed from them.

    python -m dream2real_tpu_torch.experiments.validate_synth_argmax [DIR] \
        [--rect | --distort | --noise | --combined] [--ablate] [--res N] [--device cuda|cpu]
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "configs")


def fake_llm(prompt: str, temperature: float) -> str:
    if "extract the goal caption" in prompt:
        return (
            "Goal caption: a red box on top of the green box\n"
            "Normalising caption: a red box and a green box"
        )
    if "which one object the user wants the robot to move" in prompt:
        return "1"
    if "determine whether it is a distractor" in prompt:
        return "Object 1: No\nObject 2: No\nObject 3: Yes"
    if "aggregate the caption information" in prompt:
        return "a box"
    raise AssertionError(f"unexpected prompt: {prompt[:80]}")


def main(argv=None, device=None, **engine_kwargs):
    """Run the validation; ``argv`` as the command line's. -> the result dict
    (also written to DIR/validate_synth_argmax.json); its "ok" is every gate.
    ``engine_kwargs`` go to ImaginationEngine."""
    from dream2real_tpu_torch.cfg import Config
    from dream2real_tpu_torch.data import synth
    from dream2real_tpu_torch.device import F32, resolve_device
    from dream2real_tpu_torch.engine import ImaginationEngine
    from dream2real_tpu_torch.sampling import get_virtual_cam_poses, sample_poses_grid
    from dream2real_tpu_torch.smoothing import spatially_smooth_heatmap
    from dream2real_tpu_torch.utils.png import write_png

    argv = list(sys.argv[1:] if argv is None else argv)
    if "--device" in argv:
        device = argv[argv.index("--device") + 1]
        del argv[argv.index("--device") : argv.index("--device") + 2]
    dev = resolve_device(device)
    print(f"device: {dev}", flush=True)
    flags = set(argv)
    res_xy = 15
    if "--res" in argv:
        res_xy = int(argv[argv.index("--res") + 1])
        del argv[argv.index("--res") : argv.index("--res") + 2]
    args = [a for a in argv if not a.startswith("-")]
    rect = "--rect" in flags
    distort = "--distort" in flags
    noisy = "--noise" in flags
    combined = "--combined" in flags
    assert rect + distort + noisy + combined <= 1, (
        "--rect / --distort / --noise / --combined are separate modes"
    )
    if combined:
        # Every rehearsal stressor at once — the closest hermetic proxy to a
        # real handheld scan (reference README.md:77-91): rectangular-movable
        # 6-DoF grid with a yaw axis, Brown-Conrady lens distortion, sensor
        # noise + depth holes + SE(3) pose jitter, and joint extrinsics
        # optimisation ON to recover the jittered poses.
        rect = distort = noisy = True
    data_dir = args[0] if args else tempfile.mkdtemp(prefix="d2r_validate_")
    # --rect: rectangular-footprint movable box + a 6-DoF grid with a yaw
    # axis {0, 90 deg} — validates the ORIENTATION path (euler grids,
    # virtual-camera rotation, orientation-aware smoothing) end-to-end.
    scene = synth.rect_scene() if rect else synth.default_scene()
    fresh = not os.path.exists(os.path.join(data_dir, "poses.txt"))
    if fresh:
        synth.write_dataset(
            data_dir, scene=scene, n_views=14,
            distortion=synth.DEFAULT_DISTORTION if distort else None,
            noise=synth.DEFAULT_NOISE if noisy else None,
        )
    with open(os.path.join(data_dir, "captions.json"), "w") as f:
        json.dump(["__background__", "a red box", "a green box", "a blue box"], f)
    cfg_name = "synth_demo_distort.json" if distort else "synth_demo.json"
    cfg = Config(os.path.join(CONFIGS, cfg_name), data_dir)
    if distort and fresh:
        # Exercise the poses.txt -> transforms.json converter on the
        # distorted camera block (reference utils/accio2ngp.py:45-130):
        # overwrite the generator's transforms.json with the converter's.
        from dream2real_tpu_torch.reconstruction import raw_poses_convert

        raw_poses_convert(cfg, cfg.files)
        print("transforms.json regenerated via raw_poses_convert "
              f"(k1={cfg.k1}, k2={cfg.k2}, p1={cfg.p1}, p2={cfg.p2})",
              flush=True)
    # Synthetic camera poses are EXACT: joint extrinsics optimisation can only
    # wander (measured: up to 7.6 mm / 0.45 deg drift on clean poses), which
    # blurs the field and biases the argmax by ~1 grid cell. The reference
    # enables it for real handheld scans; for the oracle check we disable it —
    # EXCEPT in --noise mode, whose dataset poses carry SLAM-grade SE(3)
    # jitter (synth.DEFAULT_NOISE): there extrinsics optimisation is doing
    # its real job and the gates measure the full noisy-scan stack.
    cfg.optimize_extrinsics = noisy
    if not fresh:  # replay cached stages whose artifacts exist (delete an
        # artifact, e.g. fg_base.ingp, to force that stage to re-run)
        gate = {
            "use_cache_dynamic_masks": "masks",
            "use_cache_segs": "XMem_masks",
            "use_cache_cam_poses": "opt_cam_poses.npy",
            "use_cache_phys": "phys_mod",
            "use_cache_vis": "fg_base.ingp",
        }
        for flag, artifact in gate.items():
            if os.path.exists(os.path.join(data_dir, artifact)):
                setattr(cfg, flag, True)
        print(f"replaying cached stages from {data_dir}", flush=True)

    engine_kwargs.setdefault("llm_backend", fake_llm)
    eng = ImaginationEngine(cfg, device=dev, **engine_kwargs)
    eng.build_scene_model()
    task_model = eng.interpret_user_instr("put the red box on the green box")
    assert task_model.movable_obj.mask_idx == 1, "movable must be the red box"

    # Build eng.renderer (the real crop renderer) without CLIP: physics_only
    # runs the same renderer construction + physics, then returns early.
    eng.physics_only = True
    eng.dream_best_pose(task_model, vis_cost_vol=False)
    renderer = eng.renderer
    assert renderer is not None and renderer.fg_crop, "crop fast path expected"

    render_poses = get_virtual_cam_poses(
        eng.scene_model.opt_cam_poses, eng.render_cam_pose_idx
    )
    movable_masks = np.asarray(task_model.movable_masks)[[0]]
    depths_gt = eng.depths_gt
    T_WO_1 = np.asarray(task_model.movable_obj.pose)

    # The imagined renders contain ONLY the relevant objects (red + green
    # box): the task-bground model masks out the table AND distractors by
    # design (reference scene_model.py:66-76 — "Encourage movable object,
    # distractors, and background to be transparent"). The oracle must render
    # the same world: relevant boxes only, black plane/sky.
    def relevant_scene(boxes):
        return dataclasses.replace(
            scene, boxes=boxes, plane_color=(0, 0, 0), plane_z=-100.0
        )

    # --- Check 1: field fidelity at the identity move -------------------
    K_clip = renderer.intrinsics
    res = renderer.res
    ident = renderer.render(
        T_WO_1[None], render_poses, [0], depths_gt=depths_gt,
        movable_masks=movable_masks, T_WO_1=T_WO_1, save=False,
    )[0].astype(np.float32)
    gt_rgb, _, _ = synth.render_scene(
        relevant_scene(scene.boxes[:2]), render_poses[0], K_clip, res, res
    )
    mse = float(((ident - gt_rgb.astype(np.float32)) ** 2).mean())
    psnr = 10.0 * np.log10(255.0**2 / max(mse, 1e-9))
    print(f"identity-move render PSNR vs ray tracer: {psnr:.2f} dB", flush=True)
    write_png(os.path.join(data_dir, "dbg_identity.png"), ident.astype(np.uint8))
    write_png(os.path.join(data_dir, "dbg_gt.png"), gt_rgb)

    # --- Check 2: geometric-oracle argmax --------------------------------
    red, green = scene.boxes[0], scene.boxes[1]
    red_lo, red_hi = np.asarray(red.lo), np.asarray(red.hi)
    red_size = red_hi - red_lo
    green_c = 0.5 * (np.asarray(green.lo) + np.asarray(green.hi))
    # True goal: red box centred on the green box's top face.
    goal_lo = np.array(
        [green_c[0] - red_size[0] / 2, green_c[1] - red_size[1] / 2,
         np.asarray(green.hi)[2]]
    )
    goal_centroid = goal_lo + red_size / 2
    red_centroid = 0.5 * (red_lo + red_hi)
    # Grid poses are absolute object poses; the render applies the move
    # T_WO_2 @ inv(T_WO_1), so a grid pose with translation t2 puts the box
    # centroid at red_centroid + (t2 - t1). t1 comes from the physics model
    # (TSDF centroid) and carries a systematic bias (~+1.7 cm in z: depth
    # cameras only see top/side surfaces), so the ACTUAL placements are
    # offset from the commanded grid and no grid pose hits the goal exactly.
    # The reference behaves identically (its init poses are TSDF-derived
    # too); CLIP/the scorer ranks *images*, so the correct expected argmax is
    # the grid pose whose RENDERED image best matches the goal image — which
    # the ray-tracing oracle below computes, not a nearest-commanded-cell
    # formula.
    t1 = T_WO_1[:3, 3]

    def placed_aabb(T2):
        """AABB of the red box under grid pose T2: the renderer applies
        T_move = T2 @ inv(T_WO_1) (R1 == I), i.e. p' = R2 (p - t1) + t2.
        Valid for axis-preserving R2 (the yaw grid uses 0/90 deg)."""
        corners = np.stack(
            [np.where([i & 1, i & 2, i & 4], red_hi, red_lo) for i in range(8)]
        ).astype(np.float64)
        R2, t2 = T2[:3, :3], T2[:3, 3]
        moved = (corners - t1) @ R2.T + t2
        return moved.min(0), moved.max(0)

    centre = np.asarray(eng.scene_centre)
    # --res N: translation-grid density (rect mode). The 3x3 sigma=0.7
    # smoothing kernel acts in grid cells, so its physical footprint shrinks
    # as the grid densifies.
    if rect:
        # 6-DoF: translation grid x yaw {0, 90 deg}. The rectangular red box
        # makes yaw observable; the goal is the 90-deg placement.
        sample_res = [res_xy, res_xy, 2, 1, 1, 2]
        bounds = (
            (-0.2, 0.2), (-0.2, 0.2), (0.0, 0.06),
            (0.0, 0.0), (0.0, 0.0), (0.0, math.pi / 2),
        )
        goal_R = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    else:
        sample_res = [21, 21, 3, 1, 1, 1]
        bounds = (
            (-0.2, 0.2), (-0.2, 0.2), (0.0, 0.12),
            (0.0, 0.0), (0.0, 0.0), (0.0, 0.0),
        )
        goal_R = np.eye(3)
    grid = np.asarray(
        sample_poses_grid(centre, sample_res, scene_type=3, bounds_override=bounds)
    ).reshape(-1, 4, 4)
    # Goal AABB: the red box rotated by goal_R, centred on the green top.
    half_rot = np.abs(goal_R) @ (red_size / 2)
    goal_centroid = np.array([green_c[0], green_c[1],
                              np.asarray(green.hi)[2] + half_rot[2]])
    goal_t2 = goal_centroid - goal_R @ (red_centroid - t1)
    print(
        f"grid: {len(grid)} poses (yaw axis: {sample_res[5]}); "
        f"true goal t2 = {np.round(goal_t2, 4)}",
        flush=True,
    )

    # Ground-truth goal image from the synthetic ray tracer (exact geometry:
    # red box moved onto the green box, original location emptied).
    goal_scene = relevant_scene(
        [dataclasses.replace(
            red, lo=tuple(goal_centroid - half_rot), hi=tuple(goal_centroid + half_rot)
        ), scene.boxes[1]]
    )
    goal_img, _, _ = synth.render_scene(goal_scene, render_poses[0], K_clip, res, res)
    goal_img = goal_img.astype(np.float32)

    renders = renderer.render(
        grid, render_poses, [0], depths_gt=depths_gt,
        movable_masks=movable_masks, T_WO_1=T_WO_1, save=False,
    ).astype(np.float32)
    write_png(os.path.join(data_dir, "dbg_goal_gt.png"), goal_img.astype(np.uint8))
    scores = -((renders - goal_img[None]) ** 2).mean(axis=(1, 2, 3))
    raw_best = grid[int(np.argmax(scores))]
    write_png(os.path.join(data_dir, "dbg_best_render.png"),
              renders[int(np.argmax(scores))].astype(np.uint8))

    # Ray-tracing oracle: score EVERY grid pose with a perfect render at its
    # actual placement; its argmax is the expected answer. This is the
    # ground truth for "do the NeRF renders rank poses the way perfect
    # images would?" — the actual output contract of the imagination stack.
    print("ray-tracing oracle over the grid (CPU)...", flush=True)
    def oracle_score(T2):
        nlo, nhi = placed_aabb(T2)
        img, _, _ = synth.render_scene(
            relevant_scene(
                [dataclasses.replace(red, lo=tuple(nlo), hi=tuple(nhi)),
                 scene.boxes[1]]
            ),
            render_poses[0], K_clip, res, res,
        )
        return -((img.astype(np.float32) - goal_img) ** 2).mean()

    # One pose a task; numpy releases the interpreter lock in its array
    # operations, so threads share the host's cores.
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        oracle_scores = np.array(list(pool.map(oracle_score, grid)), np.float64)
    oracle_idx = int(np.argmax(oracle_scores))
    t_oracle = grid[oracle_idx][:3, 3]

    # Same tail as optimise_pose_grid: positive scores, zero = invalid.
    raw_idx = int(np.argmax(scores))
    scores = scores - scores.min() + 1e-3
    smoothed = spatially_smooth_heatmap(
        torch.as_tensor(scores, dtype=F32, device=dev), sample_res).cpu().numpy()
    sm_idx = int(np.argmax(smoothed))
    sm_best = grid[sm_idx]
    t_raw = raw_best[:3, 3]
    t_sm = sm_best[:3, 3]
    err_raw = np.abs(t_raw - t_oracle)
    err_sm = np.abs(t_sm - t_oracle)
    # Grid-index comparison (covers orientation axes too; the flattened
    # ordering is last-axis-fastest, so unravel by sample_res directly).
    mi_raw = np.array(np.unravel_index(raw_idx, sample_res))
    mi_sm = np.array(np.unravel_index(sm_idx, sample_res))
    mi_orc = np.array(np.unravel_index(oracle_idx, sample_res))
    # Raw argmax must BE the oracle argmax. The smoothing prior (denoiser
    # for CLIP scores) may tip a flat noise-free peak by one translation
    # cell; orientation must match exactly.
    ok_raw = bool(raw_idx == oracle_idx)
    ok_sm = bool(
        np.all(np.abs(mi_sm[:3] - mi_orc[:3]) <= 1)
        and np.all(mi_sm[3:] == mi_orc[3:])
    )
    cell = np.array([0.4 / 20, 0.4 / 20, 0.06])
    # Rank agreement over the competitive region (top-5% of oracle scores).
    k = max(10, len(grid) // 20)
    top = np.argsort(oracle_scores)[::-1][:k]
    from scipy.stats import spearmanr

    rho = float(spearmanr(oracle_scores[top], scores[top]).statistic)
    rho_smoothed = float(spearmanr(oracle_scores[top], smoothed[top]).statistic)
    print(
        f"oracle argmax idx {mi_orc.tolist()} t2 = {np.round(t_oracle, 4)} "
        f"(goal_t2 = {np.round(goal_t2, 4)}; grid is TSDF-t1-offset from it)",
        flush=True,
    )
    print(
        f"raw argmax idx {mi_raw.tolist()} t2 = {np.round(t_raw, 4)}; "
        f"|err vs oracle| = {np.round(err_raw, 4)}",
        flush=True,
    )
    print(
        f"smoothed argmax idx {mi_sm.tolist()} t2 = {np.round(t_sm, 4)}; "
        f"|err vs oracle| = {np.round(err_sm, 4)} (cell = {np.round(cell, 4)})",
        flush=True,
    )
    print(f"rank corr (top-{k} oracle poses): rho = {rho:.3f}", flush=True)

    # --- Optional ablations (--ablate): attribute rank-corr disagreement.
    # (a) full-window render (fg_crop == res, same tight-march semantics):
    #     removes any crop-window clipping/border effect;
    # (b) smoothed scores vs oracle: does the smoothing prior help or hurt
    #     rank agreement in the competitive region;
    # (c) per-yaw-slice correlation: is the disagreement concentrated in one
    #     orientation (field anisotropy) or uniform (metric noise).
    ablations = None
    if "--ablate" in flags:
        from dream2real_tpu_torch.nerf.combined import CombinedRenderer

        print("ablation: full-window (fg_crop = res) re-render...", flush=True)
        full_r = CombinedRenderer(
            renderer.fg, renderer.bg,
            settings=renderer.settings, res=res, intrinsics=K_clip,
            out_render_path=renderer.out_render_path,
            obj_aabb=renderer.obj_aabb, fg_crop=res,
            crop_settings=renderer.crop_settings, device=dev,
        )
        renders_fw = full_r.render(
            grid, render_poses, [0], depths_gt=depths_gt,
            movable_masks=movable_masks, T_WO_1=T_WO_1, save=False,
        ).astype(np.float32)
        scores_fw = -((renders_fw - goal_img[None]) ** 2).mean(axis=(1, 2, 3))
        rho_fw = float(spearmanr(oracle_scores[top], scores_fw[top]).statistic)
        rho_sm = float(spearmanr(oracle_scores[top], smoothed[top]).statistic)
        per_yaw = {}
        if rect:
            n_yaw = sample_res[5]
            for yw in range(n_yaw):
                sel = np.array([i for i in top if i % n_yaw == yw])
                if len(sel) >= 5:
                    per_yaw[f"yaw{yw}"] = {
                        "n": int(len(sel)),
                        "rho_crop": round(float(
                            spearmanr(oracle_scores[sel], scores[sel]).statistic), 3),
                        "rho_fullwin": round(float(
                            spearmanr(oracle_scores[sel], scores_fw[sel]).statistic), 3),
                    }
        ablations = {
            "rank_corr_fullwin": round(rho_fw, 3),
            "rank_corr_smoothed": round(rho_sm, 3),
            "per_yaw": per_yaw,
            "argmax_fullwin_matches_oracle": bool(
                int(np.argmax(scores_fw)) == oracle_idx),
        }
        print(f"ablations: {json.dumps(ablations)}", flush=True)

    ok_psnr = bool(psnr >= 22.0)
    # The reference package's gates: 0.9, and 0.8 in --combined mode, where
    # the pose jitter that extrinsics optimisation only partly removes blurs
    # the field's fine ranking while the argmax checks above stay exact.
    rho_gate = 0.8 if combined else 0.9
    ok_argmax = bool(ok_raw and ok_sm and rho >= rho_gate)
    print(f"PSNR check (>=22 dB): {'PASS' if ok_psnr else 'FAIL'}", flush=True)
    print(f"argmax-parity check: {'PASS' if ok_argmax else 'FAIL'}", flush=True)
    out = {
        "mode": "combined" if combined else ("rect6dof" if rect else (
            "xyz_distort" if distort else ("xyz_noise" if noisy else "xyz")
        )),
        "psnr_db": round(psnr, 2),
        "argmax_t2": [round(float(v), 4) for v in t_raw],
        "argmax_idx": mi_raw.tolist(),
        "smoothed_argmax_t2": [round(float(v), 4) for v in t_sm],
        "oracle_t2": [round(float(v), 4) for v in t_oracle],
        "oracle_idx": mi_orc.tolist(),
        "goal_t2": [round(float(v), 4) for v in goal_t2],
        "err_m": [round(float(v), 4) for v in err_raw],
        "rank_corr_top": round(rho, 3),
        "rank_corr_smoothed_top": round(rho_smoothed, 3),
        "grid": sample_res,
        "ok": bool(ok_psnr and ok_argmax),
    }
    if ablations is not None:
        out["ablations"] = ablations
    print(json.dumps(out))
    with open(os.path.join(data_dir, "validate_synth_argmax.json"), "w") as f:
        json.dump(out, f)
    return out


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
