"""Drive the PyTorch/CUDA port on one GPU: train the NeRF field, build the
physics models of its scan and check the configs' pose grids, imagine and
score with the field, run the grid scorer on it (with and without the
physics check), run the attention bench, the demo from scan to goal pose,
the native ingest, the point-cloud ablation and the artifacts, the
hash-grid field, the reference-scale scoring runs and joint extrinsics
refinement.

    python3 chip_smoke.py            # needs one card
    python3 chip_smoke.py --profile  # also print torch.profiler tables of
                                     # phase T's five training steps and of
                                     # one 32-pose clip group

Phases (any failure raises; the exit code is then nonzero):
  0 device      require CUDA; print the card's name and power limit
  1 build       compile every kernel under dream2real_tpu_torch/csrc (nvcc)
  2 kernels     the kernel table: each kernel and its plain PyTorch version
                timed on the card at its path's shapes (CUDA events,
                median), beside its roofline bound (benchmark/roofline.py)
                and a one-call PyTorch yardstick where one exists, with the
                largest |kernel - plain| there: K1 on the rays of a clip
                group compacted on the device (its L2 weight traffic
                logged), K2, K3, K9 and the attention bench's variants
                (X1-X4) at the scoring shape (B 32, H 16, T 577, D 64, W
                1024), K4 at the text tower's (3 x 12 heads x 77; K4 and
                SDPA also from the profiler's kernel table),
                K2's qkv GEMM and X3's out-projection GEMM alone, the
                tower's GEMM epilogues and L1 (ln_rows, ln_fc1) at 18,464
                rows, K5-K8 at one training batch (8192 rays, 32 coarse + 64
                drawn samples; K7 also as its two parts, the row pass and
                the weight-gradient products, timed from the profiler's
                kernel table, the products held against f32 act^T delta
                over the scratch of a one-chunk K7 call), H1 at 4096 rays x
                64 ray-ordered samples, H2 on the clip group's crop rays
                through an instant-ngp field; each kernel's ptxas registers and
                spills, and the C75xx (wgmma serialisation) lines of each
                source counted. Each row fails the run where its kernel
                lies beyond the card tests' tolerance of that kernel; the
                card tests also hold the ragged shapes, the rows past T and
                the double-rounding witness:
                python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
                tests/test_torch_hashgrid_train.py tests/test_torch_train.py
  A bench      experiments/bench_attention.main() at the full shape with
                few reps: its table, every wrapper's launch count, both
                maxrel cross-checks under 2e-2
  T training    the port's selftest (cli/selftest.py): the flagship field on
                the synth scene, 336^2, 36 views, 8192 rays, 32 + 32 samples,
                depth supervision, 3000 steps; steps/s, final loss, and the
                selftest's bar (PSNR > 22 dB, median depth error < 5 cm);
                K5, K6 and K7 launched by the host twice (the warm-up and
                the capture of the step's CUDA graph), no K8; K5,
                K7 and K8 against their plain versions on the trained field;
                two fresh 20-step runs from one seed bit-identical; a 20-step
                run with D2R_FUSED_SAMPLER=0, which launches K8; five steps
                under the profiler: the device time a step, by kernel, and
                1 K5, 1 K6 and 1 K7 run a step on the device (K7's row pass
                and weight-gradient products once a chunk of rays)
  P physics     (while phase 1's nvcc runs: it launches no kernel of the
                port) on phase T's scan (36 x 336^2, rendered again and held
                against T's depths after T): TaskModel.create_lazy_phys_mods
                over the shopping configs' bounds at 4 mm (two 200 x 450 x
                309 grids; fusion, host mesh extraction and the whole call
                timed; the cache replayed with identical handles);
                make_unsupcol_check over the shopping grid (70,000 poses:
                valid share, poses/s, one chunk under the profiler, the
                card's mask against the CPU path's on 2,048 poses, every
                difference a tie) and over the shelf grid (2,211,840 poses,
                829,440 dedup survivors in chunks of D2R_PHYS_CHUNK: seconds,
                peak memory, chunked == one launch on 16,384 survivors); the
                oracle experiment at its defaults (agreement 1.0 beyond the
                structural band, n >= 100)
  3 main path   bench.py's workload on the trained field: synth scene, 336^2
                view, plain-torch background render, random-weight
                ViT-L/14-336, hash-tokenized captions through encode_text
                (K4), 512 poses through make_imagine_and_score (fg_crop 128,
                clip_batch 32), smoothed [16, 32, 1, 1, 1, 1] argmax; launch
                counters checked (the tower's LayerNorms and GEMMs too); one clip group
                rendered under torch.cuda.set_sync_debug_mode("error"), which
                raises on any call that waits for the device; K1 timed on the
                trained field and held
                against its plain version there: at most 2e-4 of the rays
                beyond 5e-3, each of them shown ill-conditioned (the plain
                version moves by half the ray's gap or more under 1-64 ulp
                nudges of the ray), their gaps under (0.25, 0.5, 0.5); the
                flagged rays also through the plain march in f64 (a second
                witness): how far K1 and the f32 plain version each stand
                from it, printed
  4 main vs plain  one 32-pose clip group through the kernels and through
                their plain versions: renders (99.9% of pixels identical, none
                more than 2 levels apart unless on one of K1's flagged rays
                or at a shown tie of the depth test or the alpha cut),
                image and text embeddings and logits held (the plain side
                rounds each tower layer once from f32 products); the score
                ratio and argmax reported
  5 grid scorer    scoring.optimise_pose_grid on the trained field
                through CombinedRenderer and ClipScorer: 512 poses
                ([32, 16, 1, 1, 1, 1]) without and with save_renders (512
                cb_render PNGs + best_render.png under build/chip_smoke/):
                raw scores bit-identical between the two and equal to
                make_imagine_and_score's, launch counts as the group count
                predicts, one saved PNG decoded against its render; the
                saving run again with D2R_WRITER_THREADS=2; 256 poses under
                D2R_ATTN_FUSED_LN=0 (K3 on the path); the 512 poses again
                with phys_check=make_unsupcol_check(...) built from phase
                P's models: the pass count, the mask against the CPU path's,
                the valid poses' raw scores against the unmasked run's
  E engine      the whole demo from scan to goal pose. E1: the port's writer
                writes the README's scan (synth scene, 24 views, 180 x 320);
                every images/, depth/ and masks/ file decodes bit for bit to
                what was rendered; the decoder's seconds per frame, also on
                Paeth-filtered files at 180 x 320 and 720 x 1280. E2:
                cli/demo.py's main on configs/synth_demo.json, "put the red
                box on the green box": the LLM answered from the port's
                cache copy (no backend), phase 3's full-size random
                ViT-L/14-336 as the CLIP, physics on, the configs' step
                counts halved (the full-scene field 1000, the task fields
                8000, the governor capped there); each stage's seconds, each
                field's steps, the poses scored and the valid count; the
                artifact set, the goal pose scored and physics-valid, the
                card's validity mask against the CPU path's, K1, K2, K4, K5,
                K6 and K7 launched (K3 only beneath K2, K8 not; K6 at each
                field's graph's warm-up and capture), the fields
                and the tower on the card, and a replay from the caches
                (dynamic masks, segs, camera poses, physics, fields) with
                the same goal pose to 1e-5; the scan decoded by the native
                ingest (the loader's record). E3: the synth argmax oracle
                (experiments/validate_synth_argmax.py, xyz mode) on E2's
                directory: its four gates
  N ingest      on phase E's scan: the native ingest (native/, built with
                the host compiler and zlib) against the numpy codec
                (utils/png.py), rgb, depth and masks byte for byte, and a
                720 x 1280 Paeth-filtered frame decoded both ways, timed
  V periphery   on phase E's scan. V1: cli/demo.py's main on
                configs/synth/pcd.json (single_view_idx 10, see PCD_VIEW):
                the point-cloud visual models and the device splat
                (pcd/renderer.py) scored by phase 3's ViT-L/14-336, the
                full-scene field's steps halved as in E2; each stage's
                seconds, the goal pose physics-valid, K2, K4 and K5-K7
                launched and K1 not; the splat's frames of the valid poses
                against the plain per-pose loop on the host (every differing
                pixel a shown tie) and both rates. V2: E2's directory
                replayed from its caches with vis.gui: the goal pose equal
                to E2's to 1e-5, cost_volume.png and multiverse.png decoded,
                viewer.html's JSON parsed. V3: inpaint_telea on a 720 x 1280
                frame with a band of holes, timed (host)
  H hash grid   HashGridConfig()'s defaults (16 levels, F 2, 2^19 entries,
                16-2048), hidden_dim 64: H1 (hash_encode on the card) on
                2^20 points and its table gradient against the CPU path
                (features within one bf16 step plus 2^-20 of the sum of
                |corner terms|, the gradient within 1e-5 of its largest
                entry, cosine 0.99999); the field trained 1000
                steps on phase T's scan through H1 and the step's CUDA
                graph (the host launching H1 only at the warm-up and the
                capture; steps/s, held-out PSNR over 22 dB, the last 50
                steps' loss under half the first 50's); one clip group with
                the hash-grid field as the movable's, one H2 launch and no K1
  R ref scale   experiments/run_refscale.py (70,000 shopping poses through
                optimise_pose_grid, a field trained 500 steps, the
                full-size random ViT-L/14-336; sustained poses/s, peak
                pending MB, peak device memory, the stages) and
                run_shelfscale.py (2,211,840 shelf poses through dedup,
                regrasp and make_unsupcol_check, the valid ones scored up
                to the cap of 65,536): K1, K2 and K4 launched in each, every
                score finite, the best pose a (scored) grid pose, valid
                poses found, the keep fractions 0.375 and 0.25
  M mesh        (after phase 5) four shards that repeat the card, the port's
                stand-in for four cards: torch.cuda.device_count() and
                auto_mesh() (None on one card; phase 5's _fused_score took
                mesh_devices 1); experiments/sharded_slab_prodshape.compare
                on phase 3's 512 poses (ViT-L/14-336, clip_batch 32, crop
                128): scores bit-identical to mesh=None, poses/s both ways;
                _fused_score with save_renders under D2R_MESH=0 and under
                the auto mesh patched to the shards: mesh_devices, scores
                bit for bit, every PNG identical and in order; phase P's
                shelf grid through make_unsupcol_check on the shards: masks
                identical; one step of the selftest configuration on the
                kernel path, sharded against unsharded over the same rays
                and draws: the loss, max |diff| / scale and the least cosine
                of the gradients (>= 0.9999), K5-K7 once a shard (and at
                the unsharded step graph's warm-up and capture). With
                several cards, the scoring and the check again over them
  X extrinsics  experiments/extr_grad_ab.py at 5 deg / 30 mm for X_STEPS
                steps, the fused arm (K5-K7 in the step's graph, K7 with
                ray gradients) and the plain autograd arm (no training kernel):
                each lowers the perturbed cameras' mean rotation error and
                keeps the anchors' drift below the start
The second-to-last line is the kernels JSON, the last the device JSON.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import types
from contextlib import ExitStack
from unittest import mock

import numpy as np
import torch

# The yardstick's arithmetic (peaks, bounds, MAC counts) is the benchmark's.
from benchmark.roofline import (DELTA_MACS, DENSITY_MACS, FIELD_MACS, bound_ms, gemm_flops_bytes,
                                k1_bytes, k1_flops, k7_bytes, k7_flops)

SEED = 0
# The selftest's training steps, which phase T runs in full.
TRAIN_STEPS = 3000
# The host's launches of each training kernel for a state trained on one
# card through the fused kernels: the warm-up and the capture of the step's
# CUDA graph (nerf/trainer.py::_capture); every step is a replay.
GRAPH_LAUNCHES = 2
# Columns of K7's scratch a row at the real widths (benchmark/roofline.py has
# no count of them): the activations enc 63, h0-h3, h4 16, SH 16, c0, c1
# (1247) and the deltas rgb 3, c1, c0, h4 16, h3-h0 (1107), bf16.
SCRATCH_COLS = 63 + 4 * 256 + 16 + 16 + 64 + 64 + 3 + 64 + 64 + 16 + 4 * 256


def log(*args):
    print(*args, flush=True)


def phase(name):
    log(f"== {name}")


def device_ops(prof) -> list:
    """(name, ms) of each operation a torch.profiler saw on the device:
    kernels, copies and sets, but not the annotations (a host range's
    mirror on the device timeline, which spans the kernels under it)."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        kind = str(getattr(ev, "activity_type", lambda: "")()).lower()
        if ("annotation" in kind or getattr(ev, "is_user_annotation", lambda: False)()
                or "CUDA" not in str(ev.device_type())):
            continue
        try:
            ms = ev.duration_ns() * 1e-6
        except AttributeError:  # older builds: microseconds
            ms = ev.duration_us() * 1e-3
        out.append((ev.name(), ms))
    return out


def time_ms(fn, runs: int, inner: int = 1) -> float:
    """Median of `runs` CUDA-event timings of `inner` back-to-back calls (ms a
    call), after one warm call. With one call between the events the host's
    time to reach the launch (tens of microseconds through ctypes) is part
    of the reading; rows whose kernels take a few tenths of a millisecond
    queue several calls, so that the reading is the device's time, for the
    kernel and for its library yardstick alike."""
    fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def ptxas_report(log_text: str) -> dict:
    """ptxas -v's lines of one source's build, kernel by kernel: {name:
    (registers, spill store bytes, spill load bytes)}, the names demangled
    (c++filt) and cut to the template."""
    fns, cur = {}, None
    for line in log_text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if m:
            cur = m.group(1)
            fns.setdefault(cur, [0, 0, 0])
        elif cur and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            fns[cur][1:] = int(m[1]), int(m[2])
        elif cur and (m := re.search(r"Used (\d+) registers", line)):
            fns[cur][0] = int(m[1])
    names = list(fns)
    try:
        plain = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                               text=True, check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        plain = names
    out = {}
    for raw, name in zip(names, plain if len(plain) == len(names) else names):
        name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
        out[name.split("(")[0]] = tuple(fns[raw])
    return out


def kernel_ms(fn, parts: dict, calls: int) -> dict:
    """Device ms a call of fn spent in each part's kernels (names containing
    any of the part's words), from the profiler's kernel table of `calls`
    calls after one warm call. Raises if a part shows no device time."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(parts, 0.0)
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        us = ev.cuda_time_total if us is None else us
        for part, words in parts.items():
            if any(wd in ev.key for wd in words):
                out[part] += us / 1e3 / calls
    if not all(v > 0 for v in out.values()):
        raise AssertionError(f"the profiler shows no device time for a part: {out} (kernels: "
                             f"{[ev.key for ev in prof.key_averages()]})")
    return out


# K1 against its plain version: the tolerance of the JAX package's march test,
# and on the trained field (phase 3) the share of live rays allowed beyond
# it and the largest rgb, alpha and depth gaps, near what the seed-0 field
# shows (PERF.md, Findings).
K1_TOL = 5e-3
K1_FLAGGED = 2e-4
K1_TRAINED_GAPS = (0.25, 0.5, 0.5)


def k1_gaps(got, ref):
    """Per-ray |rgb| (largest channel), |alpha| and |depth| gaps."""
    return [(got[0] - ref[0]).abs().amax(1), (got[1] - ref[1]).abs(), (got[2] - ref[2]).abs()]


# Phase 2 holds each row of the kernel table to the card tests' tolerance of
# its kernel; attention outputs within atol 0.02 / rtol 0.05 (the reference's).
ATT_TOL = (0.02, 0.05)


def gap(got, ref, atol, rtol=0.0) -> tuple:
    """(max |kernel - plain|, the worst excess over atol + rtol |plain|; an
    excess over 0 fails the row): rtol 2^-7 is one bf16 step of the plain
    value, a tensor atol a slack element by element."""
    ref = ref.float()
    diff = (got.float() - ref).abs()
    return float(diff.max()), float((diff - atol - rtol * ref.abs()).max())


def worst(gaps) -> tuple:
    """The largest of several gap()s, part by part."""
    return tuple(max(part) for part in zip(*gaps))


def epilogue_gap(got, layer, after, slack) -> tuple:
    """gap() of a GEMM epilogue by the card tests' model: within one bf16
    step plus the slack of after(c), c the plain layer output or the nearer
    of its bf16 neighbours (QuickGELU and a nearly cancelling residual turn
    one step of the layer into several of the result)."""
    bits = layer.view(torch.int16)
    near = [after(c).float() for c in (layer, (bits + 1).view(torch.bfloat16), torch.where(
        layer == 0, layer, (bits - 1).view(torch.bfloat16)))]
    over = torch.stack([(got.float() - c).abs() - 2.0**-7 * c.abs() - slack
                        for c in near]).amin(0)
    return float((got.float() - near[0]).abs().max()), float(over.max())


# Calls queued per timing of the attention and GEMM rows (K2, K3, K9, X1-X4),
# and of the K5-K8 rows (0.5-9 ms a call: queued, the reading is the
# device's time, not the wrapper's and the host's launch path).
QUEUED = 10
TRAIN_QUEUED = 3


# Phase P: the shopping configs' physics bounds and 4 mm voxels, their
# sampling grid, the shelf configs' sampling resolution (and orientation
# ranges), the oracle experiment's defaults; card-vs-CPU masks on a subset of
# P2_SUBSET poses; a mask difference must be a tie: some sampled value of the
# pose within TIE of occ_thresh (0.5).
PHYS_BOUNDS = [[0.2, -0.4, 0.0], [1.0, 1.4, 1.2]]
PHYS_VOXEL = 0.004
P2_RES = [100, 100, 7, 1, 1, 1]
P2_SUBSET = 2048
P3_RES = [60, 16, 36, 4, 4, 4]
P3_SINGLE = 16384
P4_GRID = [12, 12, 7, 1, 1, 4]
TIE = 1e-5


def masks_against_cpu(check_cpu, pose_batch, mask_dev) -> tuple[int, float]:
    """The card's mask against the CPU path's on the same poses ->
    (differences, the largest of their least |sample - 0.5|); raises unless
    every difference is a tie."""
    mask_cpu = check_cpu(pose_batch).numpy()
    differ = np.flatnonzero(mask_cpu != mask_dev)
    gap = 0.0
    if len(differ):
        s = check_cpu.samples(pose_batch[differ])
        gap = float((s - 0.5).abs().amin(dim=(0, 2)).max())
        if gap > TIE:
            raise AssertionError(f"{len(differ)} masks differ between the card and the CPU, "
                                 f"not all at ties (largest least gap {gap})")
    return len(differ), gap


def physics_phase(dev, smi, views=36, res=336) -> dict:
    """Phase P on phase T's scan (the synth scene at res^2, `views` orbit
    views, rendered here). -> {"bg", "fg", "init"}: the physics models
    phase 5's check is built from; the shelf grid and its mask, phase M's;
    "depths", the scan's, which main holds against phase T's."""
    from dream2real_tpu_torch.data import synth
    from dream2real_tpu_torch.experiments import physics_oracle
    from dream2real_tpu_torch.physics import models as pm
    from dream2real_tpu_torch.physics.collision import (
        make_unsupcol_check, orientation_dedup_mask,
    )
    from dream2real_tpu_torch.physics.tsdf import grid_coords
    from dream2real_tpu_torch.sampling import SCENE_TYPE_BOUNDS, sample_poses_grid
    from dream2real_tpu_torch.scene_model import TaskModel

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def peak_mb():
        return torch.cuda.max_memory_allocated(dev) / 2**20 if dev.type == "cuda" else 0.0

    def reset_peak():
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)

    t_p = time.perf_counter()
    scene = synth.default_scene()
    f = 0.9 * res
    K = np.array([[f, 0, res / 2], [0, f, res / 2], [0, 0, 1.0]])
    cams = synth.orbit_poses(scene.centre, views, radius=0.5, height=0.4)
    rendered = [synth.render_scene(scene, pose, K, res, res) for pose in cams]
    scan_depths = torch.as_tensor(np.stack([r[1] for r in rendered]), device=dev)

    class Scan:
        """A duck-typed SceneModel: phase T's scan with its instance ids
        (1 = the movable box)."""
        depths = scan_depths
        opt_cam_poses = list(cams.astype(np.float32))
        intrinsics = K
        masks = np.stack([r[2] for r in rendered])
        distortion = None

    class Movable:
        mask_idx = 1

    # P1: the lazy two-body models at the configs' size.
    phys_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_phys")
    shutil.rmtree(phys_dir, ignore_errors=True)
    sync()
    t0 = time.perf_counter()
    handles, inits = TaskModel.create_lazy_phys_mods(Scan, Movable, PHYS_BOUNDS, phys_dir,
                                                     voxel_size=PHYS_VOXEL, device=dev)
    t_build = time.perf_counter() - t0
    stages = {k: round(v, 3) for k, v in pm.LAST_BUILD_INFO["stage_s"].items()}
    bg, fg = handles
    z_pad = 3.0 * PHYS_VOXEL + 0.02 + PHYS_VOXEL
    _, dims = grid_coords([[*PHYS_BOUNDS[0][:2], PHYS_BOUNDS[0][2] - z_pad], PHYS_BOUNDS[1]],
                          PHYS_VOXEL)
    n_pts = [int((h.points[:, 3] > 0).sum()) for h in handles]
    grid_mb = (bg.tsdf.tsdf.numel() + bg.tsdf.weight.numel()) * 4 / 1e6
    log(f"  P1 create_lazy_phys_mods: 2 grids of {tuple(bg.tsdf.shape)} voxels "
        f"({bg.tsdf.tsdf.numel():,}), {grid_mb:.1f} MB each (tsdf + weight, f32); "
        f"{views} frames of {res}^2; points bg {n_pts[0]} of {len(bg.points)}, movable "
        f"{n_pts[1]} of {len(fg.points)}; seconds: fusion {stages.get('fuse', 0):.3f} "
        f"(synchronised), mesh extraction (host) {stages.get('mesh', 0):.3f}, points "
        f"{stages.get('points', 0):.3f}, artifacts {stages.get('save', 0):.3f}, the whole call "
        f"{t_build:.3f}; movable init pose t = {np.round(inits[1][:3, 3], 4).tolist()} "
        f"({smi})")
    if tuple(bg.tsdf.shape) != dims or tuple(fg.tsdf.shape) != dims or n_pts[1] == 0:
        raise AssertionError(f"P1: grids {bg.tsdf.shape} / {fg.tsdf.shape} (want {dims}), "
                             f"movable points {n_pts[1]}")
    box = scene.boxes[0]
    centre_xy = (np.asarray(box.lo[:2]) + np.asarray(box.hi[:2])) / 2
    if np.abs(inits[1][:2, 3] - centre_xy).max() > 0.02:
        raise AssertionError(f"P1: the movable's init pose {inits[1][:3, 3]} is off its box")
    t0 = time.perf_counter()
    again, inits_again = TaskModel.create_lazy_phys_mods(
        Scan, Movable, PHYS_BOUNDS, phys_dir, use_cache=True, voxel_size=PHYS_VOXEL, device=dev)
    t_replay = time.perf_counter() - t0
    for a, b, ia, ib in zip(handles, again, inits, inits_again):
        if not (a.mesh_path == b.mesh_path and np.array_equal(ia, ib)
                and np.array_equal(a.points, b.points) and a.tsdf.voxel_size == b.tsdf.voxel_size
                and all(torch.equal(getattr(a.tsdf, k), getattr(b.tsdf, k))
                        for k in ("tsdf", "weight", "origin"))):
            raise AssertionError("P1: the cached replay's handles differ")
    log(f"  P1 replay with use_cache=True: identical handles in {t_replay:.3f} s")
    shutil.rmtree(phys_dir, ignore_errors=True)

    # P2: the check over the shopping configuration's grid.
    grid2 = sample_poses_grid(scene.centre, P2_RES, scene_type=3)
    check2 = make_unsupcol_check(bg.tsdf, fg.points, inits[1], scene.centre, P2_RES, device=dev)
    sync()
    reset_peak()
    t0 = time.perf_counter()
    valid2 = check2(grid2)
    sync()
    t2 = time.perf_counter() - t0
    mask2 = valid2.cpu().numpy()
    sub = np.unique(np.linspace(0, len(grid2) - 1, P2_SUBSET).round().astype(int))
    cpu_check2 = make_unsupcol_check(bg.tsdf.to("cpu"), fg.points, inits[1], scene.centre,
                                     P2_RES, device="cpu")
    t0 = time.perf_counter()
    n_diff2, gap2 = masks_against_cpu(cpu_check2, grid2[sub], mask2[sub])
    t2_cpu = time.perf_counter() - t0
    log(f"  P2 check over {P2_RES} ({len(grid2):,} poses, scene_type 3): {int(mask2.sum()):,} "
        f"valid ({mask2.mean() * 100:.2f}%), {t2:.3f} s = {len(grid2) / t2:,.0f} poses/s in "
        f"{check2.last_chunks} chunks, peak device memory {peak_mb():.0f} MiB ({smi}); card vs "
        f"CPU on {len(sub)} poses spread over the grid: {n_diff2} differences (each a tie, "
        f"least |sample - 0.5| at most {gap2:.1e}); the CPU path took {t2_cpu:.2f} s")
    if not 0 < mask2.sum() < len(grid2):
        raise AssertionError("P2: the grid exercises one outcome only")
    if dev.type == "cuda":
        # One full chunk of the geometric tests under the profiler: where a
        # later kernel would start from.
        from torch.profiler import ProfilerActivity, profile as tprofile

        chunk = torch.as_tensor(grid2[:16384].reshape(-1, 4, 4), device=dev)
        check2.geom(chunk)
        sync()
        t0 = time.perf_counter()
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            check2.geom(chunk)
            sync()
        wall_c = (time.perf_counter() - t0) * 1e3
        by_kernel = {}
        for ev in prof.key_averages():
            us = getattr(ev, "device_time_total", None)
            us = ev.cuda_time_total if us is None else us
            if us > 0:
                by_kernel[ev.key] = (us / 1e3, ev.count)
        dev_c = sum(ms for ms, _ in by_kernel.values())
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:4]
        log(f"  P2 one chunk of 16384 poses x {len(fg.points)} points under the profiler: "
            f"{dev_c:.2f} ms of device time in {sum(c for _, c in by_kernel.values())} kernel "
            f"launches, {wall_c:.2f} ms of wall (device idle "
            f"{max(0.0, 1 - dev_c / wall_c) * 100:.1f}%); most: "
            + "; ".join(f"{k[:60]} {ms:.2f} ms x {c}" for k, (ms, c) in top))
        if dev_c <= 0:
            raise AssertionError("P2: the profiler shows no device time")

    # P3: shelf-scale chunking: the shelf's resolution and orientations over
    # the shopping type's positions, which land on the synth table.
    shelf_bounds = SCENE_TYPE_BOUNDS[3][:3] + SCENE_TYPE_BOUNDS[1][3:]
    t0 = time.perf_counter()
    grid3 = sample_poses_grid(scene.centre, P3_RES, bounds_override=shelf_bounds)
    t_gen = time.perf_counter() - t0
    check3 = make_unsupcol_check(bg.tsdf, fg.points, inits[1], scene.centre, P3_RES, device=dev)
    sync()
    reset_peak()
    t0 = time.perf_counter()
    valid3 = check3(grid3)
    sync()
    t3 = time.perf_counter() - t0
    peak3 = peak_mb()
    mask3 = valid3.cpu().numpy()
    oris = P3_RES[3] * P3_RES[4] * P3_RES[5]
    positions = len(grid3) // oris
    keep = orientation_dedup_mask(torch.as_tensor(grid3[:oris].reshape(-1, 4, 4)), oris).numpy()
    surv = np.flatnonzero(np.tile(keep, positions))
    dead = np.ones(len(grid3), bool)
    dead[surv] = False
    pick = surv[np.unique(np.linspace(0, len(surv) - 1, P3_SINGLE).round().astype(int))]
    single = check3.geom(torch.as_tensor(grid3[pick].reshape(-1, 4, 4), device=dev)).cpu().numpy()
    log(f"  P3 check over {P3_RES} ({len(grid3):,} poses; generated on the host in "
        f"{t_gen:.2f} s): {check3.last_survivors:,} dedup survivors ({int(keep.sum())} of {oris} "
        f"orientations a position), {check3.last_chunks} chunks of "
        f"{os.environ.get('D2R_PHYS_CHUNK', '16384')}, {int(mask3.sum()):,} valid; {t3:.3f} s "
        f"= {len(grid3) / t3:,.0f} poses/s ({check3.last_survivors / t3:,.0f} survivors/s), "
        f"peak device memory {peak3:.0f} MiB ({smi}); chunked == one launch on {len(pick)} "
        f"survivors: {bool(np.array_equal(single, mask3[pick]))}")
    if check3.last_survivors != int(keep.sum()) * positions or not np.array_equal(
            single, mask3[pick]) or mask3[dead].any():
        raise AssertionError("P3: survivors, or chunked against one launch, are off")
    if P3_RES == [60, 16, 36, 4, 4, 4] and check3.last_survivors != 829440:
        raise AssertionError(f"P3: {check3.last_survivors} survivors, not 829,440")

    # P4: the oracle experiment at its defaults.
    t0 = time.perf_counter()
    out4 = physics_oracle.run(P4_GRID, PHYS_VOXEL, n_views=10, res=336, device=dev)
    t4 = time.perf_counter() - t0
    band = out4["bands"]["above_table_beyond_structural"]
    log(f"  P4 oracle ({P4_GRID}, {PHYS_VOXEL * 1000:.0f} mm, 10 views, 336^2; {t4:.2f} s): "
        f"{out4['n_poses']} poses, SDF valid {out4['sdf_valid_frac']:.4f}, oracle valid "
        f"{out4['oracle_valid_frac']:.4f}, agreement {out4['agreement']:.4f} "
        f"({out4['n_disagree']} disagree, at most {out4['disagree_margin_max_above_table']:.4f} "
        f"m from a boundary above the table; structural band {out4['structural_band']:.4f}); "
        f"beyond the structural band above the table {band['agreement']} over n = {band['n']}")
    physics_oracle.check_agreement(out4, min_n=100)
    log(f"  phase P took {time.perf_counter() - t_p:.1f} s of wall")
    return {"bg": bg, "fg": fg, "init": inits[1], "centre": scene.centre, "shelf_grid": grid3,
            "shelf_mask": mask3, "shelf_seconds": t3, "depths": scan_depths}


# The README's scan and the demo's run (phase E).
ENGINE_VIEWS, ENGINE_H, ENGINE_W = 24, 180, 320
ENGINE_INSTR = "put the red box on the green box"
# The fields' steps in phase E: the configs' counts halved
# (D2R_TRAIN_STEPS_SCALE: the full-scene field 1000, the task fields 8000,
# the count 37 of the 45 trainer blocks under configs/ give), and the
# convergence governor capped at 8000, so that the task fields stop there.
# At 2000 (the governor took them to 4400 and 3500) the fg field keeps a
# halo of fog and E3's identity-move PSNR is 16.8 dB; at 8000, 29.05 dB (one
# H100 80GB HBM3 at 700 W).
ENGINE_STEPS_SCALE = "0.5"
ENGINE_TRAIN = {"max_infinity_steps": 8000}
# The JAX package's record of the oracle check, xyz mode, on a TPU
# (experiments/results/validate_synth_argmax_xyz.json): a quality record.
ORACLE_RECORD = {"psnr_db": 28.35, "argmax_idx": [15, 16, 1, 0, 0, 0], "rank_corr_top": 0.985}


def engine_phase(dev, smi, clip, clip_cfg, counters) -> dict:
    """Phase E: the scan written and decoded (E1), the demo from scan to goal
    pose and its cache replay (E2), the synth argmax oracle on E2's
    directory (E3). ``counters``: {name: wrapper} of the launch counters.
    -> {"launches": {name: launches in E2's run}, and what phase V reuses:
    the directories, E2's goal pose, the engine's keyword arguments, the
    scan's frames}; the caller removes ``root``."""
    from dream2real_tpu_torch import reconstruction, scoring
    from dream2real_tpu_torch.cli import demo
    from dream2real_tpu_torch.data import synth
    from dream2real_tpu_torch.experiments import validate_synth_argmax as vsa
    from dream2real_tpu_torch.physics.collision import make_unsupcol_check
    from dream2real_tpu_torch.utils import png

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_engine")
    shutil.rmtree(root, ignore_errors=True)
    scan, out = os.path.join(root, "scan"), os.path.join(root, "out")
    cfg_path = os.path.join(vsa.CONFIGS, "synth_demo.json")

    # ---- E1: the scan, written by the port and decoded bit for bit.
    t0 = time.perf_counter()
    meta = synth.write_dataset(scan, n_views=ENGINE_VIEWS, h=ENGINE_H, w=ENGINE_W)
    t_write = time.perf_counter() - t0
    K = np.asarray(meta["intrinsics"])
    poses = synth.orbit_poses(synth.default_scene().centre, ENGINE_VIEWS)
    want = [synth.render_scene(synth.default_scene(), p, K, ENGINE_H, ENGINE_W) for p in poses]
    dec_s = {}
    for sub, prefix, k in (("images", "rgb", 0), ("depth", "depth", 1), ("masks", "mask", 2)):
        paths = [os.path.join(scan, sub, f"{prefix}_{i:04d}.png") for i in range(ENGINE_VIEWS)]
        t0 = time.perf_counter()
        got = png.read_pngs(paths)
        dec_s[sub] = (time.perf_counter() - t0) / ENGINE_VIEWS
        ref = np.stack([w[k] for w in want])
        if k == 1:
            ref = np.clip(ref * 1000.0, 0, 65535).astype(np.uint16)
        if got.dtype != ref.dtype or not np.array_equal(got, ref):
            raise AssertionError(f"E1: {sub}/ does not decode to what was written")
    # Paeth rows, the slowest filter to undo (PIL writes it on most rows).
    rgb = np.stack([w[0] for w in want])
    big = np.ascontiguousarray(np.tile(rgb[:8], (1, 4, 4, 1)))  # 720 x 1280
    paeth_s = {}
    for tag, imgs in (("180x320", rgb), ("720x1280", big)):
        blobs = [png.encode_png(im, filter_type=4) for im in imgs]
        t0 = time.perf_counter()
        got = png.decode_pngs(blobs)
        paeth_s[tag] = (time.perf_counter() - t0) / len(imgs)
        if not np.array_equal(got, imgs):
            raise AssertionError(f"E1: Paeth-filtered {tag} frames do not decode bit for bit")
    log(f"  E1: wrote {ENGINE_VIEWS} views of {ENGINE_H} x {ENGINE_W} in {t_write:.2f} s; "
        f"every images/, depth/ and masks/ file decodes bit for bit; decode seconds a frame "
        f"(filter 0, as the port writes): "
        + ", ".join(f"{k} {v:.4f}" for k, v in dec_s.items())
        + f"; Paeth rows: 180 x 320 RGB {paeth_s['180x320']:.4f}, 720 x 1280 RGB "
        f"{paeth_s['720x1280']:.4f} (host, {os.cpu_count()} cores)")

    # ---- E2: the demo, from the scan to the goal pose.
    argv = [scan, out, cfg_path, ENGINE_INSTR, "--device", str(dev)]
    kw = dict(clip_loader=lambda: (clip, clip_cfg), ngp_overrides={"train": ENGINE_TRAIN})
    # No transformers files: the engine's tokenizer hashes, as phase 3's.
    os.environ["D2R_CLIP_PATH"] = os.path.join(root, "no_clip_checkpoint")
    os.environ["D2R_TRAIN_STEPS_SCALE"] = ENGINE_STEPS_SCALE
    cwd = os.getcwd()
    os.chdir(root)  # result.txt goes to the working directory
    try:
        for fn in counters.values():
            fn.launches = 0
        reconstruction.TRAIN_LOG.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng, task, goal = demo.main(argv, **kw)
        torch.cuda.synchronize()
        t_demo = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        fields = list(reconstruction.TRAIN_LOG)
        with open("result.txt") as f:
            result = f.read()
    finally:
        os.chdir(cwd)
    info = dict(scoring.LAST_RUN_INFO)
    stages = eng.stage_timer.stages
    batch = np.loadtxt(os.path.join(out, "pose_batch.txt"))
    scores = np.loadtxt(os.path.join(out, "pose_scores.txt"))
    n_valid = int(np.count_nonzero(info["raw_scores"]))
    log(f"  E2: scan to goal pose {t_demo:.2f} s ({smi}); stages "
        + ", ".join(f"{k} {v:.2f} s" for k, v in stages.items())
        + "; fields: " + ", ".join(f"{f['files']} {f['steps']} steps (loss "
                                    f"{f['final_loss']:.5f})" for f in fields)
        + f"; {len(batch)} poses, {n_valid} physics-valid and scored "
        f"(fused_score {info['stage_s'].get('fused_score', float('nan')):.2f} s); "
        f"launches {launches}")
    log(f"  E2: goal pose {np.round(goal[:3, 3], 4).tolist()}; result.txt "
        f"{result.splitlines()[:3]}; the scan's frames decoded by the {eng.frame_decoder} "
        f"ingest")
    if eng.frame_decoder != "native":
        raise AssertionError(f"E2: the loader decoded the scan with {eng.frame_decoder}")
    for artifact in (
        "goal_pose.txt", "pose_batch.txt", "pose_scores.txt", "best_render.png",
        "opt_cam_poses.npy", "full_base.ingp", "fg_base.ingp", "bg_base.ingp",
        "fg_transforms.json", "bg_transforms.json", "phys_mod/mesh_concave_0.obj",
        "phys_mod/init_pose_1.txt", "cb_render/cb_rgb_0000.png",
        "images/dynamic_mask_rgb_0000.png", "XMem_masks/rgb_0000.png",
    ):
        if not os.path.exists(os.path.join(out, artifact)):
            raise AssertionError(f"E2: {artifact} was not written")
    if not (result.startswith(f"user_instr: {ENGINE_INSTR}\n") and "goal_pose:" in result):
        raise AssertionError(f"E2: result.txt reads {result!r}")
    if ([f["files"] for f in fields] != ["transforms.json", "fg_transforms.json",
                                         "bg_transforms.json"]
            or fields[0]["steps"] != 1000
            or not all(0 < f["steps"] <= ENGINE_TRAIN["max_infinity_steps"] for f in fields)):
        raise AssertionError(f"E2: trained {fields}")
    # The goal pose: a grid pose, scored, and valid on the card as on the CPU.
    hit = np.flatnonzero(np.all(np.isclose(batch, goal.reshape(1, 16), atol=1e-6), axis=1))
    bg_phys, fg_phys = eng.static_phys_handles[0], eng.movable_phys_handle
    init = np.asarray(task.movable_obj.pose)
    check = make_unsupcol_check(bg_phys.tsdf, fg_phys.points, init, eng.scene_centre,
                                eng.sample_res, device=dev)
    mask = check(batch).cpu().numpy()
    cpu_check = make_unsupcol_check(bg_phys.tsdf.to("cpu"), fg_phys.points, init,
                                    eng.scene_centre, eng.sample_res, device="cpu")
    n_diff, gap = masks_against_cpu(cpu_check, batch, mask)
    log(f"  E2: goal pose is grid pose {hit.tolist()}; {int(mask.sum())} valid poses on the "
        f"card, card vs CPU masks: {n_diff} differences (least |sample - 0.5| at most "
        f"{gap:.1e})")
    if len(hit) != 1 or scores[hit[0]] == 0 or not mask[hit[0]]:
        raise AssertionError("E2: the goal pose is not a scored, physics-valid grid pose")
    if int(mask.sum()) != n_valid or np.any(info["raw_scores"][~mask] != 0):
        raise AssertionError("E2: the scored poses are not the physics-valid ones")
    for key in ("march (K1)", "ln_qkv_attention (K2)", "attention_causal (K4)",
                "density_sample (K5)", "train_fwd (K6)", "train_bwd (K7)"):
        if launches[key] == 0:
            raise AssertionError(f"E2: {key} was not launched")
    if (launches["attention_qkv (K3)"] != launches["ln_qkv_attention (K2)"]
            or launches["density_weights (K8)"] != 0):
        raise AssertionError(f"E2: K3 outside K2 or K8 launched: {launches}")
    if launches["train_fwd (K6)"] != GRAPH_LAUNCHES * len(fields):
        raise AssertionError(f"E2: K6 launched {launches['train_fwd (K6)']} times for "
                             f"{len(fields)} fields, not each field's graph's warm-up and capture")
    # The renderer holds the task fields (the task model drops the bg
    # field's handle once scoring is done, as the reference does).
    tensors = {"fg field": eng.renderer.fg, "bg field": eng.renderer.bg,
               "full-scene field": eng._full_model.field, "CLIP": eng._clip_scorer.params}
    for what, module in tensors.items():
        devs = {p.device.type for p in module.parameters()}
        if devs != {dev.type}:
            raise AssertionError(f"E2: the {what}'s parameters are on {devs}")

    # The replay: every cache flag of a finished run, the goal pose scored
    # again from the cached fields.
    with open(cfg_path) as f:
        raw = json.load(f)
    raw["engine"].update({flag: True for flag in (
        "use_cache_dynamic_masks", "use_cache_segs", "use_cache_cam_poses", "use_cache_phys",
        "use_cache_vis")})
    cached_cfg = os.path.join(root, "synth_demo_cached.json")
    with open(cached_cfg, "w") as f:
        json.dump(raw, f)
    os.chdir(root)
    try:
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        eng2, _, goal2 = demo.main([scan, out, cached_cfg] + argv[3:], **kw)
        torch.cuda.synchronize()
        t_replay = time.perf_counter() - t0
        replay_launches = {k: fn.launches for k, fn in counters.items()}
    finally:
        os.chdir(cwd)
    gap2 = float(np.abs(np.loadtxt(os.path.join(out, "goal_pose.txt")) - goal).max())
    log(f"  E2 replay from the caches: {t_replay:.2f} s, stages "
        + ", ".join(f"{k} {v:.2f} s" for k, v in eng2.stage_timer.stages.items())
        + f"; goal pose max |difference| {gap2:.1e}; training launches "
        f"{replay_launches['train_fwd (K6)']}")
    if gap2 > 1e-5 or replay_launches["train_fwd (K6)"] != 0:
        raise AssertionError(f"E2 replay: the goal pose moves by {gap2} or a field trained")

    # ---- E3: the argmax oracle on E2's directory (its cached fields).
    t0 = time.perf_counter()
    res = vsa.main([out, "--device", str(dev)], clip_loader=kw["clip_loader"])
    t_oracle = time.perf_counter() - t0
    log(f"  E3: validate_synth_argmax (xyz) in {t_oracle:.2f} s: PSNR {res['psnr_db']} dB, "
        f"argmax {res['argmax_idx']}, oracle {res['oracle_idx']}, smoothed argmax t2 "
        f"{res['smoothed_argmax_t2']}, rank corr {res['rank_corr_top']} (smoothed "
        f"{res['rank_corr_smoothed_top']}); the JAX package's TPU record (quality, not speed): "
        f"{ORACLE_RECORD}")
    if not res["ok"]:
        raise AssertionError(f"E3: the oracle's gates failed: {res}")
    del os.environ["D2R_CLIP_PATH"], os.environ["D2R_TRAIN_STEPS_SCALE"]
    return dict(launches=launches, root=root, scan=scan, out=out, goal=goal, kw=kw,
                cfg_path=cfg_path, frames=rgb)


# Phase V: the pcd ablation's config, the gui replay, the hole inpainting.
PCD_CFG = os.path.join("configs", "synth", "pcd.json")
# The ablation builds its physics (and its clouds) from one view of the scan
# (the reference's physics_utils.py:64-65). On phase E's scan view 0, the
# config's default, leaves no valid pose of the 800 (so the run stops before
# scoring, in the JAX package too); view 10 leaves 79 (counted on the CPU
# path, whose masks equal the card's). V1 sets single_view_idx to it.
PCD_VIEW = 10
# The device splat against the plain per-pose loop on this many of V1's
# valid poses (the loop takes tens of ms a pose on the host); each pixel
# that differs must be a tie (pcd/renderer.py::shown_ties).
SPLAT_CHECK_POSES = 48
# V3: the frame and its holes (a 12-row band and 0.2% of single pixels).
TELEA_H, TELEA_W = 720, 1280


def periphery_phase(dev, smi, counters, ctx) -> dict:
    """Phase V on phase E's scan: V1 the pcd ablation from scan to goal pose
    (cli/demo.py's main on configs/synth/pcd.json) and its device splat
    against the plain per-pose loop, V2 a replay of E2's directory with
    vis.gui (cost_volume.png, multiverse.png, viewer.html), V3 Telea's
    inpainting of a 720 x 1280 frame. -> {name: launches in V1's run}."""
    from dream2real_tpu_torch import reconstruction, scoring
    from dream2real_tpu_torch.cli import demo
    from dream2real_tpu_torch.pcd import renderer as pren
    from dream2real_tpu_torch.pcd.visual_model import get_vis_pcds
    from dream2real_tpu_torch.perception.imgproc import inpaint_telea
    from dream2real_tpu_torch.physics.collision import make_unsupcol_check
    from dream2real_tpu_torch.sampling import get_virtual_cam_poses
    from dream2real_tpu_torch.utils import png

    root, scan, kw = ctx["root"], ctx["scan"], ctx["kw"]
    here = os.path.dirname(os.path.abspath(__file__))
    os.environ["D2R_CLIP_PATH"] = os.path.join(root, "no_clip_checkpoint")
    os.environ["D2R_TRAIN_STEPS_SCALE"] = ENGINE_STEPS_SCALE
    cwd = os.getcwd()

    # ---- V1: the pcd ablation, from the scan to the goal pose.
    out = os.path.join(root, "out_pcd")
    with open(os.path.join(here, PCD_CFG)) as f:
        raw_pcd = json.load(f)
    raw_pcd["engine"]["single_view_idx"] = PCD_VIEW
    pcd_cfg = os.path.join(root, "synth_pcd.json")
    with open(pcd_cfg, "w") as f:
        json.dump(raw_pcd, f)
    os.chdir(root)
    try:
        for fn in counters.values():
            fn.launches = 0
        reconstruction.TRAIN_LOG.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng, task, goal = demo.main([scan, out, pcd_cfg, ENGINE_INSTR, "--device", str(dev)],
                                    **kw)
        torch.cuda.synchronize()
        t_demo = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        fields = list(reconstruction.TRAIN_LOG)
    finally:
        os.chdir(cwd)
    info = dict(scoring.LAST_RUN_INFO)
    batch = np.loadtxt(os.path.join(out, "pose_batch.txt"))
    raw = np.asarray(info["raw_scores"])
    valid = np.flatnonzero(raw != 0)
    log(f"  V1: pcd ablation scan to goal pose {t_demo:.2f} s ({smi}); stages "
        + ", ".join(f"{k} {v:.2f} s" for k, v in eng.stage_timer.stages.items())
        + f"; fields {[(f['files'], f['steps']) for f in fields]}; {len(batch)} "
        f"poses, {len(valid)} physics-valid and scored; launches {launches}")
    if not isinstance(eng.renderer, pren.PointCloudRenderer):
        raise AssertionError(f"V1: the renderer is {type(eng.renderer).__name__}")
    if [f["files"] for f in fields] != ["transforms.json"]:
        raise AssertionError(f"V1: trained {fields}")
    for key in ("ln_qkv_attention (K2)", "attention_causal (K4)", "density_sample (K5)",
                "train_fwd (K6)", "train_bwd (K7)"):
        if launches[key] == 0:
            raise AssertionError(f"V1: {key} was not launched")
    if launches["march (K1)"] != 0:
        raise AssertionError("V1: K1 launched on the pcd path (it has no fg field)")
    for artifact in ("goal_pose.txt", "cost_volume.png", "multiverse.png",
                     "movable_vis_mod/obj_vis_0.npz", "task_bground_vis_mod/obj_vis_0.npz"):
        if not os.path.exists(os.path.join(out, artifact)):
            raise AssertionError(f"V1: {artifact} was not written")
    hit = np.flatnonzero(np.all(np.isclose(batch, goal.reshape(1, 16), atol=1e-6), axis=1))
    init = np.asarray(task.movable_obj.pose)
    check = make_unsupcol_check(eng.static_phys_handles[0].tsdf, eng.movable_phys_handle.points,
                                init, eng.scene_centre, eng.sample_res, device=dev)
    mask = check(batch).cpu().numpy()
    if len(hit) != 1 or raw[hit[0]] == 0 or not mask[hit[0]] or not np.array_equal(
            mask, raw != 0):
        raise AssertionError("V1: the goal pose is not a scored, physics-valid grid pose, or "
                             "the scored poses are not the physics-valid ones")
    log(f"  V1: goal pose {np.round(goal[:3, 3], 4).tolist()} is grid pose {hit.tolist()}, "
        f"physics-valid")

    # The device splat against the plain per-pose loop, on the task's
    # clouds (replayed from V1's caches) and the valid poses.
    bg_pcd, = get_vis_pcds(None, None, None, None, None, 1, None,
                           save_dir=os.path.join(out, "task_bground_vis_mod"))
    mv_pcd, = get_vis_pcds(None, None, None, None, None, 1, None,
                           save_dir=os.path.join(out, "movable_vis_mod"))

    Task = types.SimpleNamespace(
        task_bground_obj=types.SimpleNamespace(vis_model=bg_pcd),
        movable_obj=types.SimpleNamespace(vis_model=mv_pcd, pose=init))

    T_WC = np.asarray(get_virtual_cam_poses(eng.scene_model.opt_cam_poses,
                                            eng.render_cam_pose_idx)[0], np.float64)
    rend = pren.PointCloudRenderer(device=dev)
    poses_all = batch.reshape(-1, 4, 4)
    poses_v = poses_all[valid]
    n_pts = len(bg_pcd.points) + len(mv_pcd.points)
    rend.render(T_WC, poses_v[:8], Task)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = rend.render(T_WC, poses_v, Task)
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    rend.render(T_WC, poses_all, Task)  # the whole grid, valid or not
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    splat_peak = torch.cuda.max_memory_allocated(dev) - base
    sub = poses_v[:SPLAT_CHECK_POSES]
    t0 = time.perf_counter()
    plain = rend.render_plain(T_WC, sub, Task)
    t_plain = time.perf_counter() - t0
    inv_old = np.linalg.inv(np.asarray(init, np.float64))
    n_diff = n_tie = 0
    bg_t = torch.as_tensor(bg_pcd.points, device=dev)
    bgc_t = torch.as_tensor(bg_pcd.colors, device=dev)
    mv_t = torch.as_tensor(mv_pcd.points, device=dev)
    mvc_t = torch.as_tensor(mv_pcd.colors, device=dev)
    for i, (g, w) in enumerate(zip(frames[:len(sub)], plain)):
        if np.array_equal(g, w):
            continue
        tf = sub[i] @ inv_old
        _, winner = pren.splat_batch(bg_t, bgc_t, mv_t, mvc_t, torch.as_tensor(tf[None],
                                     device=dev), T_WC, rend.K, return_winner=True)
        moved = mv_pcd.transformed(tf)
        d, t = pren.shown_ties(g, w, winner[0].cpu().numpy(),
                               np.concatenate([bg_pcd.points, moved.points]),
                               np.concatenate([bg_pcd.colors, moved.colors]), T_WC, rend.K)
        n_diff, n_tie = n_diff + d, n_tie + t
    log(f"  V1: device splat {len(poses_v)} poses of {n_pts} points in {t_dev:.3f} s = "
        f"{len(poses_v) / t_dev:.1f} poses/s, the whole grid's {len(poses_all)} in "
        f"{t_all:.3f} s = {len(poses_all) / t_all:.1f} poses/s (chunk {rend._chunk(n_pts)}, "
        f"frames copied to the host; peak device memory {splat_peak / 2**20:.1f} MiB of the "
        f"{pren.CHUNK_BYTES['cuda'] / 2**20:.0f} MiB budget); the plain per-pose loop on the host "
        f"{len(sub) / t_plain:.2f} poses/s "
        f"({os.cpu_count()} cores); {len(sub)} frames against the plain loop: {n_diff} pixels "
        f"differ, {n_tie} of them shown ties ({smi})")
    if n_tie != n_diff:
        raise AssertionError(f"V1: {n_diff - n_tie} differing splat pixels are not ties")
    if splat_peak > pren.CHUNK_BYTES["cuda"]:
        raise AssertionError(f"V1: the splat took {splat_peak} bytes, over its chunk budget")
    if not all(f.shape == (336, 336, 3) and f.dtype == np.uint8 for f in frames):
        raise AssertionError("V1: the splat's frames are not (336, 336, 3) u8")

    # ---- V2: E2's directory replayed from its caches with vis.gui.
    with open(ctx["cfg_path"]) as f:
        raw_cfg = json.load(f)
    raw_cfg["engine"].update({flag: True for flag in (
        "use_cache_dynamic_masks", "use_cache_segs", "use_cache_cam_poses", "use_cache_phys",
        "use_cache_vis")})
    raw_cfg["vis"]["gui"] = True
    gui_cfg = os.path.join(root, "synth_demo_gui.json")
    with open(gui_cfg, "w") as f:
        json.dump(raw_cfg, f)
    e2 = ctx["out"]
    for name_ in ("cost_volume.png", "multiverse.png", "viewer.html"):
        if os.path.exists(os.path.join(e2, name_)):
            os.remove(os.path.join(e2, name_))
    os.chdir(root)
    try:
        t0 = time.perf_counter()
        eng2, _, goal2 = demo.main([scan, e2, gui_cfg, ENGINE_INSTR, "--device", str(dev)], **kw)
        torch.cuda.synchronize()
        t_gui = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    gap = float(np.abs(goal2 - ctx["goal"]).max())
    shapes = {n_: png.read_png(os.path.join(e2, n_)).shape for n_ in ("cost_volume.png",
                                                                    "multiverse.png")}
    with open(os.path.join(e2, "viewer.html")) as f:
        html = f.read()
    data = json.loads(re.search(r"const DATA = (.*);\n", html).group(1))
    t_art = eng2.stage_timer.stages.get("artifacts", 0.0)
    log(f"  V2: gui replay {t_gui:.2f} s (artifacts {t_art:.2f} s); goal pose max |difference| "
        f"from E2's {gap:.1e}; PNGs {shapes}; viewer.html {len(html)} bytes, layers "
        f"{[(L['kind'], L['name']) for L in data['layers']]}")
    if gap > 1e-5:
        raise AssertionError(f"V2: the goal pose moves by {gap}")
    if not any(L["name"] == "goal" for L in data["layers"]):
        raise AssertionError("V2: viewer.html has no goal frame")

    # ---- V3: Telea's inpainting of a 720 x 1280 frame (the host).
    big = np.ascontiguousarray(np.tile(ctx["frames"][0], (4, 4, 1)))[:TELEA_H, :TELEA_W]
    holes = np.zeros((TELEA_H, TELEA_W), np.uint8)
    holes[TELEA_H // 2:TELEA_H // 2 + 12] = 1
    holes[np.random.default_rng(SEED).random((TELEA_H, TELEA_W)) < 0.002] = 1
    t0 = time.perf_counter()
    filled = inpaint_telea(big, holes, 3)
    t_telea = time.perf_counter() - t0
    log(f"  V3: inpaint_telea on {TELEA_H} x {TELEA_W} with {int(holes.sum())} hole pixels: "
        f"{t_telea:.2f} s ({int(holes.sum()) / t_telea:.0f} pixels/s, host, {os.cpu_count()} "
        f"cores)")
    if not np.array_equal(filled[holes == 0], big[holes == 0]):
        raise AssertionError("V3: inpaint_telea changed a pixel outside the holes")
    del os.environ["D2R_CLIP_PATH"], os.environ["D2R_TRAIN_STEPS_SCALE"]
    return launches


#: H2 against render_rays: tests/test_torch_cuda.py's tolerance (rgb and
#: alpha, depth over the far plane; the twin's cuBLAS sums and torch
#: reductions add in other orders, so a layer's output may round to the
#: neighbouring bf16 value now and then).
H2_TOL = 5e-3
H2_NAME = "hash_march (H2)"


def hash_march_record(dev, record, aabb, crop_args, crop_settings) -> None:
    """H2's row of the kernel table: one clip group of phase 2's crop rays
    marched through an instant-ngp field at the published widths (its table
    uniform in +-1, features of order one) against its twin render_rays.
    The bound counts the needed samples' interpolation and MLP operations
    and the live rays' bytes, not the corner reads
    (benchmark/metrics/_hash_march.py)."""
    from benchmark.metrics import _hash_march
    from dream2real_tpu_torch.nerf import combined, hash_march as hm, march_kernel as mk
    from dream2real_tpu_torch.nerf.hashgrid import HashGridConfig
    from dream2real_tpu_torch.nerf.model import NGPConfig, init_ngp_params
    from dream2real_tpu_torch.nerf.render import render_rays

    cfg = NGPConfig(field_type="hashgrid", grid=HashGridConfig(), **aabb)
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    field = init_ngp_params(cfg, gen, device=dev)
    with torch.no_grad():
        field.table.uniform_(-1.0, 1.0, generator=gen)
    T_WC_2, _, _, dirs = combined.crop_rays(*crop_args)
    origins = T_WC_2[:, :3, 3].contiguous()
    box = crop_args[2]
    st = crop_settings
    packed = hm.pack(field)
    got = hm.march_rays_hash(packed, origins, dirs, box, st)
    want = render_rays(field, origins[:, None].expand(dirs.shape), dirs, st, march_aabb=box)
    if float(got["alpha"].max()) <= 0.0:
        raise AssertionError("H2: the crop renders are empty")
    t0, t1 = mk.march_ranges(origins, dirs, box, st)
    live = t1 > t0
    w = want["weights"].double().reshape(live.numel(), -1)
    needed = int(((1.0 - torch.cumsum(w, -1) + w >= st.min_transmittance) & live[:, None]).sum())
    g = cfg.grid
    fdict = {"grid": {"n_levels": g.n_levels, "n_features": g.n_features,
                      "log2_hashmap_size": g.log2_hashmap_size},
             "hidden_dim": cfg.hidden_dim, "n_density_layers": cfg.n_density_layers,
             "geo_feat_dim": cfg.geo_feat_dim, "sh_degree": cfg.sh_degree,
             "color_width": cfg.color_width, "n_color_layers": cfg.n_color_layers}
    flops, nbytes = _hash_march.flops_bytes(fdict, needed, int(live.sum()), 1)
    log(f"  H2: {dirs.shape[0]} poses x {dirs.shape[1]} rays x {st.n_coarse} samples; "
        f"{int(live.sum())} rays hit the box; {needed} samples needed")
    record(H2_NAME, "dream2real_tpu_torch/csrc/hash_march.cu", "none (render_rays on H1)",
           worst(gap(got[k], want[k], H2_TOL * (st.far if k == "depth" else 1.0))
                 for k in ("rgb", "alpha", "depth")),
           time_ms(lambda: hm.march_rays_hash(packed, origins, dirs, box, st), 10),
           time_ms(lambda: render_rays(field, origins[:, None].expand(dirs.shape), dirs, st,
                                       march_aabb=box), 3),
           flops, nbytes, None)


# Phase H: the hash-grid field at full width (HashGridConfig()'s defaults,
# hidden_dim 64), trained through H1 and the step's graph on phase T's scan.
HG_POINTS = 1 << 20
HG_STEPS = 1000
HG_POLL = 50
# Phase 2's H1 rows: the cell instant-ngp-base.fg_task's shapes, 4096 rays
# of 64 samples (those the loss uses).
HG_RAYS = 4096
HG_RAY_SAMPLES = 64
H1_NAMES = ("hash_encode forward (H1)", "hash_encode backward (H1)")


def hash_kernel_records(dev, record, cams, dirs_cam, aabb) -> None:
    """H1's two rows of the kernel table against its plain version
    (``hash_encode_plain`` on the card) on ray-ordered points: each ray of a
    random view and pixel sampled at sorted uniform depths across the box,
    at HashGridConfig()'s widths on a table in +-1 (features of order one),
    held to the card test's bounds (the features within one bf16 step plus
    2^-20 of their sum of |corner terms|, the table's gradient within 1e-5
    of its largest entry).
    The bound counts the positions, the features or their gradient, and the
    table's gradient written once, not the corner reads
    (benchmark/metrics/_hashgrid.py)."""
    from dream2real_tpu_torch.nerf import hashgrid as hg

    grid = hg.HashGridConfig()
    L, T, F = grid.n_levels, grid.table_size, grid.n_features
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    table = hg.init_hash_table(grid, gen, dev) * 1e4
    poses = torch.as_tensor(np.stack(cams), dtype=torch.float32, device=dev)
    view = torch.randint(0, len(cams), (HG_RAYS,), generator=gen, device=dev)
    pix = torch.randint(0, dirs_cam.shape[0] * dirs_cam.shape[1], (HG_RAYS,), generator=gen,
                        device=dev)
    d = torch.einsum("nij,nj->ni", poses[view, :3, :3], dirs_cam.reshape(-1, 3)[pix])
    o = poses[view, :3, 3]
    lo, hi = (torch.tensor(v, dtype=torch.float32, device=dev) for v in aabb)
    a, b = (lo - o) / d, (hi - o) / d
    t0 = torch.minimum(a, b).amax(-1).clamp(min=0.05)
    t1 = torch.maximum(t0 + 1e-3, torch.maximum(a, b).amin(-1))
    u = torch.sort(torch.rand(HG_RAYS, HG_RAY_SAMPLES, generator=gen, device=dev), -1).values
    ts = t0[:, None] + (t1 - t0)[:, None] * u
    pos = ((o[:, None] + d[:, None] * ts[..., None] - lo) / (hi - lo)).reshape(-1, 3)
    if not bool(torch.isfinite(pos).all()):
        raise AssertionError("H1's ray samples are not finite")
    pos = pos.contiguous()
    n = pos.shape[0]
    cot = torch.randn(n, L * F, generator=gen, device=dev).to(torch.bfloat16)
    feats = torch.empty(n, L * F, dtype=torch.bfloat16, device=dev)
    dtable = torch.empty_like(table)

    def fwd():
        hg._launch("d2r_hash_fwd", pos, table, grid, feats)

    def bwd():  # the autograd function's backward: a zeroed gradient, then H1
        dtable.zero_()
        hg._launch("d2r_hash_bwd", pos, cot, grid, dtable)

    fwd()
    bwd()
    t_req = table.clone().requires_grad_(True)
    want = hg.hash_encode_plain(pos, t_req, grid)
    (g_plain,) = torch.autograd.grad(want, t_req, cot.float(), retain_graph=True)
    with torch.no_grad():
        terms = hg.hash_encode_plain(pos, table.abs(), grid)
        step = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=2.0**-100))) - 7)
        err_f = gap(feats, want, step + 2.0**-20 * terms)
        err_b = gap(dtable, g_plain, 1e-5 * float(g_plain.abs().max()))
    ops = n * L * (3 + 3 + 3 + 8 * (2 + 2 * F))
    point_bytes = n * (3 * 4 + L * F * 2)
    record(H1_NAMES[0], "dream2real_tpu_torch/csrc/hashgrid.cu",
           "dream2real_tpu/nerf/hashgrid.py:98", err_f, time_ms(fwd, 10, TRAIN_QUEUED),
           time_ms(lambda: hg.hash_encode_plain(pos, table, grid), 3), ops, point_bytes, None)
    record(H1_NAMES[1], "dream2real_tpu_torch/csrc/hashgrid.cu",
           "dream2real_tpu/nerf/hashgrid.py:98", err_b, time_ms(bwd, 10, TRAIN_QUEUED),
           time_ms(lambda: torch.autograd.grad(want, t_req, cot.float(), retain_graph=True), 3),
           ops, point_bytes + L * T * F * 4, None)


def hashgrid_phase(dev, smi, st, bg_field, render_args) -> tuple:
    """Phase H: H1 (hash_encode on the card) and its table gradient against
    the CPU path; the field trained on phase T's scan through H1 and the
    step's graph (steps/s, held-out PSNR, the loss); one clip group rendered
    with a hash-grid fg field (one H2 launch, no K1). -> the host's H1
    launches (forward, backward) for that training."""
    from dream2real_tpu_torch.cli.selftest import SELFTEST_AABB, SETTINGS, VIEW, _score
    from dream2real_tpu_torch.data import synth
    from dream2real_tpu_torch.nerf import combined, hash_march, march_kernel as mk
    from dream2real_tpu_torch.nerf.hashgrid import HashGridConfig, hash_encode, init_hash_table
    from dream2real_tpu_torch.nerf.model import NGPConfig
    from dream2real_tpu_torch.nerf.trainer import (TrainConfig, init_train_state,
                                                   make_train_chunk, use_step_graph,
                                                   use_train_kernel)

    grid = HashGridConfig()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    table = init_hash_table(grid, gen, dev)
    pos = torch.rand((HG_POINTS, 3), generator=gen, device=dev) * 1.1 - 0.05
    # bf16 numbers: the card's features are bf16, so their gradient is too.
    cot = torch.randn((HG_POINTS, grid.out_dim), generator=gen, device=dev).bfloat16().float()
    enc, grads = {}, {}
    for where in (dev, torch.device("cpu")):
        t = table.detach().to(where).clone().requires_grad_(True)
        p_, c_ = pos.to(where), cot.to(where)
        if where.type == "cuda":  # warm: one forward and backward
            warm = table.detach().clone().requires_grad_(True)
            (hash_encode(p_, warm, grid) * c_).sum().backward()
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        e = hash_encode(p_, t, grid)
        (e * c_).sum().backward()
        if where.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        enc[where.type] = (e.detach().cpu(), dt)
        grads[where.type] = t.grad.detach().cpu().double().reshape(-1)
    # The card's features are bf16, each rounded once from its f32 sum: one
    # bf16 step of the CPU's f32 feature at most, plus 2^-20 of the sum of
    # |corner terms| for the f32 sums' other order (near-cancelling sums
    # differ by more than their own step). The table's gradient sums with
    # atomics, in another order each run.
    want = enc["cpu"][0]
    terms = hash_encode(pos.cpu(), table.detach().cpu().abs(), grid)
    step = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=2.0**-100))) - 7)
    err = float(((enc[dev.type][0].float() - want).abs() / (step + 2.0**-20 * terms)).max())
    g_gap = float((grads[dev.type] - grads["cpu"]).abs().max() / grads["cpu"].abs().max())
    cos = float(torch.nn.functional.cosine_similarity(grads[dev.type], grads["cpu"], dim=0))
    log(f"  H: H1 on {HG_POINTS} points, {grid.n_levels} levels of {grid.table_size} x "
        f"{grid.n_features}: forward + table gradient {enc[dev.type][1] * 1e3:.2f} ms on the "
        f"card, {enc['cpu'][1] * 1e3:.0f} ms on the host; card vs CPU worst feature gap "
        f"{err:.3f} of a bf16 step + 2^-20 of its terms (<= 1), table gradient gap "
        f"{g_gap:.2e} of its largest entry (<= 1e-5), cosine {cos:.7f} (>= 0.99999); launches "
        f"{hash_encode.launches} forward, {hash_encode.backward_launches} backward ({smi})")
    if err > 1 or g_gap > 1e-5 or cos < 0.99999:
        raise AssertionError(f"H: H1 card vs CPU: {err}, gradient {g_gap}, cosine {cos}")

    cfg = NGPConfig(field_type="hashgrid", grid=grid, hidden_dim=64, **SELFTEST_AABB)
    if use_train_kernel(cfg) or not use_step_graph(cfg):
        raise AssertionError("H: the hash-grid field would not train through H1 and the step's "
                             "graph (or would through K5-K7)")
    launched = hash_encode.launches, hash_encode.backward_launches
    tc = TrainConfig(n_steps=HG_STEPS, batch_rays=8192, poll_steps=HG_POLL,
                     dynamic_time_extension=False, seed=SEED)
    state = init_train_state(cfg, tc, n_images=st["data"]["images_rgba"].shape[0], device=dev)
    chunk = make_train_chunk(cfg, tc, SETTINGS, **st["data"])
    state, first = chunk(state)  # the first 50 steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [first]
    while state["step"] < HG_STEPS:
        state, loss = chunk(state)
        losses.append(loss)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    # The host launches H1 at the graph's warm-up and capture only: 2
    # encodes (coarse, samples; phase T's scan has no opaque-pixel mask, so
    # no carving) and 1 backward each.
    host = (hash_encode.launches - launched[0], hash_encode.backward_launches - launched[1])
    field = state["field"]
    scene = synth.default_scene()
    h, w = st["data"]["dirs_cam"].shape[:2]
    f = 0.9 * w  # the selftest's camera
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]])
    views = st["data"]["images_rgba"].shape[0]
    held = synth.orbit_poses(scene.centre, 2 * views, radius=0.5, height=0.4)[2 * VIEW + 1]
    gt_rgb, gt_depth, _ = synth.render_scene(scene, held, K, h, w)
    psnr, d_err, _ = _score(field, torch.as_tensor(held, dtype=torch.float32, device=dev),
                            st["data"]["dirs_cam"], gt_rgb, gt_depth, 56 if h % 56 == 0 else 0)
    log(f"  H: hash-grid field (hidden 64) trained {state['step']} steps on phase T's scan "
        f"through H1 and the step's graph: {(state['step'] - HG_POLL) / dt:.2f} steps/s; H1 "
        f"launched by the host {host[0]} forward, {host[1]} backward; loss first {HG_POLL} "
        f"steps {first:.5f}, last {HG_POLL} {losses[-1]:.5f}; held-out view PSNR {psnr:.2f} dB "
        f"(> 22), median depth error {d_err * 1000:.1f} mm ({smi})")
    if not (np.isfinite(losses).all() and losses[-1] < 0.5 * first):
        raise AssertionError(f"H: the loss went {losses}")
    if host != (4, 2):
        raise AssertionError(f"H: the host launched H1 {host} times, not at warm-up and capture")
    if not psnr > 22.0:
        raise AssertionError(f"H: held-out PSNR {psnr:.2f} dB, not over 22")

    # One clip group with the hash-grid field as the movable's: H2, one
    # launch, not K1.
    renderer = combined.CombinedRenderer(field, bg_field, device=dev, **render_args["renderer"])
    mk.march.launches = hash_march.hash_march.launches = 0
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        imgs = renderer.render(**render_args["render"])
        torch.cuda.synchronize()
        t_group = time.perf_counter() - t0
    h2 = hash_march.hash_march.launches
    log(f"  H: one clip group ({len(imgs)} poses) with the hash-grid fg field in {t_group:.2f} s; "
        f"H2 launches {h2}, K1 launches {mk.march.launches}")
    if mk.march.launches != 0 or h2 != 1 or imgs.shape[1:] != (336, 336, 3):
        raise AssertionError("H: the hash-grid group launched K1, not H2 once, or rendered the "
                             "wrong shape")
    return host


# Phase N: the native ingest (native/d2r_native.cpp, built with the host
# compiler and zlib) against the numpy codec, and the host decode of a 720 x
# 1280 Paeth-filtered frame that PERF.md records (133 ms through the codec).
CODEC_PAETH_MS = 133


def ingest_phase(ctx) -> None:
    """Phase N on phase E's scan: the native RGB-D ingest and PNG decoder
    against utils/png.py, byte for byte, each timed (host)."""
    from dream2real_tpu_torch import build, native
    from dream2real_tpu_torch.utils import png

    t0 = time.perf_counter()
    native.get_lib()
    t_build = time.perf_counter() - t0
    scan, n = ctx["scan"], ENGINE_VIEWS
    paths = {sub: [os.path.join(scan, sub, f"{prefix}_{i:04d}.png") for i in range(n)]
             for sub, prefix in (("images", "rgb"), ("depth", "depth"), ("masks", "mask"))}
    t0 = time.perf_counter()
    loaded = native.load_rgbd_dataset(scan, n, ENGINE_H, ENGINE_W)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    rgb = png.read_pngs(paths["images"])
    depth = png.read_pngs(paths["depth"]).astype(np.float32) / 1000.0
    t_codec = time.perf_counter() - t0
    if loaded is None or loaded[0].tobytes() != rgb.tobytes() \
            or loaded[1].tobytes() != depth.tobytes():
        raise AssertionError("N: the native ingest of phase E's scan differs from the codec's")
    masks = png.read_pngs(paths["masks"])
    if b"".join(native.png_read(p).tobytes() for p in paths["masks"]) != masks.tobytes():
        raise AssertionError("N: the native decoder's masks differ from the codec's")
    big = np.ascontiguousarray(np.tile(ctx["frames"][0], (4, 4, 1)))  # 720 x 1280
    path = os.path.join(ctx["root"], "paeth_720x1280.png")
    png.write_png(path, big, filter_type=4)
    times = {"native": [], "codec": []}
    for _ in range(5):
        for way, read in (("native", native.png_read), ("codec", png.read_png)):
            t0 = time.perf_counter()
            got = read(path)
            times[way].append(time.perf_counter() - t0)
            if got.tobytes() != big.tobytes():
                raise AssertionError(f"N: the {way} decode of the Paeth frame differs")
    ms = {k: statistics.median(v) * 1e3 for k, v in times.items()}
    log(f"  N: native library built in {t_build:.2f} s ({build.NATIVE_DIR}); phase E's scan ({n} "
        f"views of {ENGINE_H} x {ENGINE_W}, rgb + depth): native ingest {t_native * 1e3:.1f} ms, "
        f"the codec {t_codec * 1e3:.1f} ms, bytes identical (masks too); a 720 x 1280 "
        f"Paeth-filtered RGB frame from the file, median of 5: native {ms['native']:.2f} ms, "
        f"codec {ms['codec']:.2f} ms (PERF.md records {CODEC_PAETH_MS} ms for the codec; host, "
        f"{os.cpu_count()} cores)")


# Phase R: the reference-scale runs (experiments/run_refscale.py,
# run_shelfscale.py at their defaults). The JAX package's TPU v5e records,
# history and not targets (experiments/results/refscale_final_r5.json,
# shelfscale_r5_postfix.json).
REFSCALE_RECORD = {"poses_per_s_sustained": 235.3, "wall_s": 297.4}
SHELF_RECORD = {"phys_poses_per_s": 2736.5, "n_valid": 10484, "score_poses_per_s": 119.6}
SHELF_KEEP = (0.375, 0.25)  # the JAX package's dedup and regrasp keep fractions


def _in_grid(best, pose_batch) -> np.ndarray:
    return np.flatnonzero(np.all(np.isclose(pose_batch, best.reshape(1, 16), atol=1e-6), axis=1))


def refscale_phase(dev, smi, counters) -> None:
    """Phase R: 70,000 shopping poses and the shelf's 2,211,840-pose grid
    through the port's scripts; K1, K2 and K4 launched in each."""
    from dream2real_tpu_torch.data import synth
    from dream2real_tpu_torch.experiments import run_refscale, run_shelfscale

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_ref")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    for tag, fn in (("R1 run_refscale", lambda: run_refscale.run(device=dev, data_dir=root,
                                                                  log=log)),
                    ("R2 run_shelfscale", lambda: run_shelfscale.run(device=dev, log=log))):
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        t_all = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()
                    if k in ("march (K1)", "ln_qkv_attention (K2)", "attention_causal (K4)")}
        record = {k: v for k, v in out.items()
                  if k not in ("best_pose", "pose_batch", "pose_scores", "is_valid", "scored_mask")}
        log(f"  {tag}: {json.dumps(record)}; the whole run {t_all:.2f} s; launches {launches}")
        if any(v == 0 for v in launches.values()):
            raise AssertionError(f"{tag}: a kernel of the path was not launched: {launches}")
        scores = out["pose_scores"]
        if not np.isfinite(scores).all():
            raise AssertionError(f"{tag}: a score is not finite")
        if tag.startswith("R1"):
            hit = _in_grid(out["best_pose"], out["pose_batch"])
            log(f"  R1: {out['n_poses']} poses at {out['poses_per_s_sustained']:.2f} poses/s "
                f"sustained, peak pending {out['peak_pending_mb']} MB, peak device memory "
                f"{out['peak_mem_gb']:.3f} GiB, stages {out['stage_s']} ({smi}); the JAX "
                f"package's TPU v5e record (history, not a target): {REFSCALE_RECORD}")
            if out["scores_nonzero"] != out["n_poses"] or len(hit) != 1:
                raise AssertionError(f"R1: {out['scores_nonzero']} scored poses; best pose in the "
                                     f"grid at {hit.tolist()}")
        else:
            grid, *_ = run_shelfscale.shelf_grid(synth.default_scene().centre, out["grid"], dev)
            hit = _in_grid(out["best_pose"], grid)
            log(f"  R2: physics {out['n_poses']} poses in {out['phys_wall_s']:.2f} s = "
                f"{out['phys_poses_per_s']:.1f} poses/s, {out['n_valid']} valid, "
                f"{out['n_scored']} scored at {out['score_poses_per_s']:.2f} poses/s, peak "
                f"{out['peak_hbm_gb']:.3f} GiB ({smi}); the JAX package's TPU v5e record "
                f"(history): {SHELF_RECORD}")
            keep = (out["dedup_keep_frac"], out["regrasp_keep_frac"])
            if keep != SHELF_KEEP:
                raise AssertionError(f"R2: dedup / regrasp keep fractions {keep}, not {SHELF_KEEP}")
            # The orientation grid repeats rotations (what the dedup drops),
            # so the best pose may equal several grid poses: one is scored.
            if (out["n_valid"] == 0 or not out["scored_mask"][hit].any()
                    or out["scores_nonzero"] != out["n_scored"]):
                raise AssertionError(f"R2: {out['n_valid']} valid, best pose at {hit.tolist()}")
    shutil.rmtree(root, ignore_errors=True)


# Phase X: joint extrinsics refinement (experiments/extr_grad_ab.py) at one
# level, both arms, at the protocol's 4000 steps: at 1000 the field is still
# fog (loss 0.020) and pulls the plain arm's cameras further off (5.000 ->
# 5.117 deg on an H100). The JAX package's TPU record
# (experiments/results/extr_grad_ab.json, 5 deg / 30 mm) is history, not a
# target.
X_STEPS = 4000
X_LEVEL = (5.0, 30.0)
EXTR_RECORD = {"xla_exact": {"rot_deg": 2.837, "trans_mm": 29.43, "anchor_rot_deg": 1.608,
                             "steps_per_s": 55.6},
               "fused_approx": {"rot_deg": 1.651, "trans_mm": 21.90, "anchor_rot_deg": 0.283,
                                "steps_per_s": 120.7}}


def extrinsics_phase(dev, smi, counters) -> None:
    """Phase X: the perturbed cameras refined by the fused kernels (K5-K7,
    K7 with ray gradients) and by plain autograd; each arm must lower the
    mean rotation error and keep the anchors nearer than the start."""
    from dream2real_tpu_torch.experiments import extr_grad_ab as ea
    from dream2real_tpu_torch.nerf import train_kernel as tk

    train = ("density_sample (K5)", "train_fwd (K6)", "train_bwd (K7)")
    for name, flag in ea.ARMS:
        for c in counters.values():
            c.launches = 0
        tk.train_bwd.ray_grad_launches = 0
        torch.cuda.synchronize()
        res = ea.run(X_STEPS, levels=[X_LEVEL], arms=[(name, flag)], device=dev, log=log)
        lvl = next(iter(res["levels"].values()))
        init, arm = lvl["init"], lvl[name]
        launches = {k: counters[k].launches for k in train}
        ray = tk.train_bwd.ray_grad_launches
        log(f"  X {name}: {X_STEPS} steps at {arm['steps_per_s']:.2f} steps/s; rotation "
            f"{init['rot_deg']:.3f} -> {arm['rot_deg']:.3f} deg (max {arm['rot_deg_max']:.3f}), "
            f"translation {init['trans_mm']:.2f} -> {arm['trans_mm']:.2f} mm, anchors "
            f"{arm['anchor_rot_deg']:.3f} deg, loss {arm['final_loss']:.5f}; launches {launches}, "
            f"K7 with ray gradients {ray} ({smi}); the JAX package's TPU record at 4000 steps "
            f"(history): {EXTR_RECORD['fused_approx' if flag == '1' else 'xla_exact']}")
        fused = flag == "1"
        if fused and not (all(v == GRAPH_LAUNCHES for v in launches.values())
                          and ray == GRAPH_LAUNCHES):
            raise AssertionError(f"X {name}: launches {launches}, ray-gradient K7 {ray}, not the "
                                 f"graph's warm-up and capture")
        if not fused and any(launches.values()):
            raise AssertionError(f"X {name}: a training kernel launched: {launches}")
        if not (arm["rot_deg"] < init["rot_deg"] and arm["anchor_rot_deg"] < init["rot_deg"]):
            raise AssertionError(f"X {name}: rotation {init['rot_deg']} -> {arm['rot_deg']}, "
                                 f"anchors {arm['anchor_rot_deg']}")

# Phase M: the mesh's shards. Four shards that repeat the one card stand in
# for four cards (the port's counterpart of XLA's virtual devices).
MESH_SHARDS = 4
MESH_MIN_COSINE = 0.9999


def mesh_phase(dev, smi, ctx) -> None:
    """Phase M on phase 3's workload, phase 5's scorer, phase P's shelf grid
    and phase T's selftest configuration: the auto mesh; the scores of 512
    poses on MESH_SHARDS shards of the card against one device, bit for bit,
    and the grid scorer's scores and PNGs under a patched auto mesh; the
    shelf check's masks on the shards; one training step on the shards
    against one unsharded step over the same rays and draws. Where the
    machine has several cards, the scoring and the check again over them."""
    from dream2real_tpu_torch import scoring
    from dream2real_tpu_torch.cli.selftest import SETTINGS
    from dream2real_tpu_torch.clip.tokenizer import hash_tokenize
    from dream2real_tpu_torch.experiments import sharded_slab_prodshape as ssp
    from dream2real_tpu_torch.nerf import train_kernel as tk
    from dream2real_tpu_torch.nerf.trainer import init_train_state, make_train_chunk
    from dream2real_tpu_torch.parallel import mesh as pmesh
    from dream2real_tpu_torch.physics.collision import make_unsupcol_check
    from dream2real_tpu_torch.utils.png import read_png

    t_m = time.perf_counter()
    n_cards = torch.cuda.device_count()
    auto = pmesh.auto_mesh()
    log(f"  M1 torch.cuda.device_count() {n_cards}; auto_mesh() {auto}; phase 5's last "
        f"_fused_score: mesh_devices {ctx['info5']['mesh_devices']}")
    if n_cards == 1 and (auto is not None or ctx["info5"]["mesh_devices"] != 1):
        raise AssertionError("M1: one card, yet a mesh was taken")
    shards = pmesh.data_mesh(devices=[dev] * MESH_SHARDS)
    meshes = [("shards of the card", shards)]
    if n_cards > 1:
        meshes.append(("cards", pmesh.data_mesh(min(n_cards, MESH_SHARDS))))

    # M2: the main path's 512 poses, one device against the shards.
    for label, mesh in meshes:
        out = ssp.compare(ctx["make_args"], ctx["make_kwargs"], ctx["score_args"], mesh, reps=2)
        log(f"  M2 make_imagine_and_score, {out['n_poses']} poses on {mesh.size} {label} "
            f"{out['mesh']}: bit-identical {out['bit_identical']} (max |diff| "
            f"{out['max_abs_diff']:.3e}); {out['poses_per_s_sharded']:.2f} poses/s sharded, "
            f"{out['poses_per_s_single']:.2f} one device ({smi})")
        if not (out["bit_identical"] and out["scores_finite"]):
            raise AssertionError(f"M2: sharded scores differ from one device's: {out}")

    # The grid scorer with saved renders, D2R_MESH=0 against the auto mesh
    # patched to the shards for this block only.
    renderer, root = ctx["renderer"], ctx["out_dir"]
    args = (renderer, ctx["scorer"], hash_tokenize, ctx["task"], ctx["grid"], ctx["cams"][:1],
            ctx["gt_depth"][None], ctx["task"].movable_masks, ctx["task"].movable_obj.pose, False)
    runs = {}
    for tag, env, mesh in (("one", "0", None), ("mesh", "1", shards)):
        renderer.out_render_path = os.path.join(root, f"cb_{tag}")
        with mock.patch.dict(os.environ, {"D2R_MESH": env}), \
                mock.patch.object(pmesh, "auto_mesh", lambda m=mesh: m):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scores = scoring._fused_score(*args, save_renders=True)
            wall = time.perf_counter() - t0
        info = dict(scoring.LAST_RUN_INFO)
        runs[tag] = (scores, info)
        log(f"  M2 _fused_score with save_renders, D2R_MESH={env}: mesh_devices "
            f"{info['mesh_devices']}, {info['n_slabs']} slab(s) of {info['slab']}, {wall:.2f} s "
            f"= {len(scores) / wall:.1f} poses/s")
    if (runs["one"][1]["mesh_devices"], runs["mesh"][1]["mesh_devices"]) != (1, MESH_SHARDS):
        raise AssertionError(f"M2: mesh_devices {runs['one'][1]} / {runs['mesh'][1]}")
    if not np.array_equal(runs["one"][0], runs["mesh"][0]):
        raise AssertionError("M2: the grid scorer's scores differ on the mesh")
    names = [f"cb_rgb_{i:04d}.png" for i in range(len(ctx["grid"]))]
    for tag in ("one", "mesh"):
        if sorted(os.listdir(os.path.join(root, f"cb_{tag}"))) != names:
            raise AssertionError(f"M2: cb_{tag} does not hold the {len(names)} PNGs in order")
    differ = [n for n in names if not np.array_equal(read_png(os.path.join(root, "cb_one", n)),
                                                      read_png(os.path.join(root, "cb_mesh", n)))]
    log(f"  M2 scores bit-identical; {len(names)} PNGs each, {len(differ)} differ")
    if differ:
        raise AssertionError(f"M2: {len(differ)} PNGs differ on the mesh, the first {differ[0]}")

    # M3: the shelf grid's check on the shards.
    phys = ctx["phys"]
    for label, mesh in meshes:
        check = make_unsupcol_check(phys["bg"].tsdf, phys["fg"].points, phys["init"],
                                    phys["centre"], P3_RES, device=dev,
                                    pose_sharding=pmesh.pose_sharding(mesh))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mask = check(phys["shelf_grid"]).cpu().numpy()
        t3 = time.perf_counter() - t0
        same = bool(np.array_equal(mask, phys["shelf_mask"]))
        log(f"  M3 make_unsupcol_check over {P3_RES} ({len(mask):,} poses) on {mesh.size} "
            f"{label}: {check.last_survivors:,} survivors in {check.last_chunks} chunks, "
            f"{int(mask.sum()):,} valid, {t3:.3f} s (one device in phase P "
            f"{phys['shelf_seconds']:.3f} s); masks identical {same}")
        if not same:
            raise AssertionError(f"M3: {int((mask != phys['shelf_mask']).sum())} masks differ")

    # M4: one training step of the selftest configuration on the kernel
    # path, sharded against unsharded: the same rays (drawn once), and the
    # same draws (each shard's rows of the step's one draw, ShardDraws).
    st = ctx["st"]
    tc1 = dataclasses.replace(st["tc"], poll_steps=1)
    steps = {}
    for tag, sharding in (("unsharded", None), ("sharded", pmesh.pose_sharding(shards))):
        state = init_train_state(st["cfg"], tc1, n_images=st["data"]["images_rgba"].shape[0],
                                 device=dev)
        with torch.no_grad():
            for p, q in zip(state["field"].parameters(), ctx["field"].parameters()):
                p.copy_(q)
        chunk = make_train_chunk(st["cfg"], tc1, SETTINGS, ray_sharding=sharding, **st["data"])
        for fn in (tk.density_sample, tk.train_fwd, tk.train_bwd):
            fn.launches = 0
        _, loss = chunk(state)
        launches = [fn.launches for fn in (tk.density_sample, tk.train_fwd, tk.train_bwd)]
        steps[tag] = (loss, {k: p.grad.detach().clone()
                             for k, p in state["field"].named_parameters()}, launches)
    (lu, gu, nu), (ls, gs, ns) = steps["unsharded"], steps["sharded"]
    errs = {k: float((gs[k] - gu[k]).abs().max() / gu[k].abs().max().clamp_min(1e-30))
            for k in gu}
    coss = {k: float(torch.nn.functional.cosine_similarity(gs[k].flatten().double(),
                                                           gu[k].flatten().double(), dim=0))
            for k in gu}
    worst = min(coss, key=coss.get)
    log(f"  M4 one step, {tc1.batch_rays} rays on {MESH_SHARDS} shards against one device: loss "
        f"{ls:.7f} / {lu:.7f}; max |diff| / scale {max(errs.values()):.3e} "
        f"({max(errs, key=errs.get)}); least cosine {coss[worst]:.8f} ({worst}); K5, K6, K7 "
        f"launches {ns} sharded, {nu} unsharded")
    if nu != [GRAPH_LAUNCHES] * 3 or ns != [MESH_SHARDS] * 3:
        raise AssertionError(f"M4: the kernel path did not run as expected: {nu} / {ns}")
    if coss[worst] < MESH_MIN_COSINE or abs(ls - lu) > 1e-4 * abs(lu):
        raise AssertionError(f"M4: sharded step off: cosine {coss[worst]}, loss {ls} / {lu}")
    if n_cards == 1:
        log("  M5 one card: the scoring and the check over physically distinct cards wait for "
            "a machine with several")
    log(f"  phase M took {time.perf_counter() - t_m:.1f} s of wall")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2

    from dream2real_tpu_torch import build, scoring
    from dream2real_tpu_torch.cli.selftest import SELFTEST_AABB, run_selftest
    from dream2real_tpu_torch.clip import model as cm
    from dream2real_tpu_torch.clip.scorer import ClipScorer, build_captions
    from dream2real_tpu_torch.clip.tokenizer import hash_tokenize
    from dream2real_tpu_torch.data import synth
    from dream2real_tpu_torch.experiments import bench_attention as ba
    from dream2real_tpu_torch.nerf import combined, march_kernel as mk, train_kernel as tk
    from dream2real_tpu_torch.nerf.model import NGPConfig, init_ngp_params
    from dream2real_tpu_torch.nerf.render import RenderSettings, render_image
    from dream2real_tpu_torch.nerf.trainer import init_train_state, make_train_chunk
    from dream2real_tpu_torch.ops import attention as att
    from dream2real_tpu_torch.ops import cameras
    from dream2real_tpu_torch.parallel.imagine import make_imagine_and_score
    from dream2real_tpu_torch.sampling import sample_poses_grid
    from dream2real_tpu_torch.smoothing import spatially_smooth_heatmap
    from dream2real_tpu_torch.utils.png import read_png

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
    # Phase P launches no kernel of the port, so it runs while nvcc builds.
    phase("1 build (one nvcc a source, all at once; phase P runs meanwhile)")
    t_build = time.perf_counter()
    started = build.start_build()

    # ------------------------------------------------------------- P physics
    phase("P physics (create_lazy_phys_mods, make_unsupcol_check, the oracle) on phase T's scan")
    phys = physics_phase(dev, smi)
    build.finish_build(started)
    secs = time.perf_counter() - t_build
    log(f"built {', '.join(build.SOURCES)} in {secs:.2f} s of wall, phase P inside it")
    ptxas = {src: ptxas_report(build.build_log(src)) for src in build.SOURCES}
    for src in build.SOURCES:
        for kname, (regs, st_b, ld_b) in ptxas[src].items():
            log(f"  {src}: {kname}: {regs} registers, {st_b} bytes spill stores, {ld_b} bytes "
                f"spill loads")
        for line in build.build_log(src).splitlines():
            if "C75" in line:
                log(f"  {src}: {line.strip()}")
    # ptxas serialises wgmma where it cannot prove them safe to overlap and
    # says so only as C75xx lines (see .claude/skills/verify/SKILL.md).
    serialised = {src: sum("C75" in line for line in build.build_log(src).splitlines())
                  for src in build.SOURCES}
    log(f"  ptxas wgmma serialisation (C75xx) lines: {serialised}")

    # ------------------------------------------------ scene (phases 2 to 4)
    res, crop, clip_batch = 336, 128, 32
    scene = synth.default_scene()
    f = 0.9 * res
    K = np.array([[f, 0, res / 2], [0, f, res / 2], [0, 0, 1.0]])
    cams = synth.orbit_poses(scene.centre, 16, radius=0.5, height=0.4)
    ngp_cfg = NGPConfig(**SELFTEST_AABB)  # the selftest's field box, which bench.py uses too
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
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    kernels = []

    def march_group(field_, origins_, dirs_):
        """K1's inputs for a clip group, as march_rays_fused makes them: the
        rays' ranges over the object box, the live rays compacted on the
        device, the box. -> ((origins, dirs, t0, t1, live, count), box)."""
        t0_, t1_ = mk.march_ranges(origins_, dirs_, obj_aabb, crop_settings)
        live_, count_ = mk.compact_live(t0_, t1_)
        box_ = torch.cat([mk.pack_params(field_).field_box,
                          torch.tensor(obj_aabb[0] + obj_aabb[1], dtype=torch.float32,
                                       device=dev)])
        return (origins_, dirs_, t0_, t1_, live_, count_), box_

    def record(name_, source, replaces, err, ms, plain_ms, flops, nbytes, library_ms):
        """One row of the kernel table; err is the row's gap()."""
        max_err, over = err
        if not over <= 0.0:
            raise AssertionError(f"{name_}: kernel vs plain beyond its limit by {over:.3e}")
        b_ms, b_by = bound_ms(flops, nbytes)
        kernels.append({
            "name": name_, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
        })
        log(f"  {name_}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}), library {library_ms if library_ms is None else f'{library_ms:.4f} ms'}, "
            f"max |kernel - plain| {max_err:.3e}, {over:.3e} past its limit")

    # ---------------------------------------------------------- 2 kernels
    # The kernel table: each kernel and its plain version timed at its
    # path's shapes, beside its roofline bound (benchmark/roofline.py) and a
    # library yardstick where one exists, with the largest |kernel - plain|
    # there, held to the card tests' tolerance of the kernel. The card tests
    # (pytest -m cuda) also hold the ragged shapes, the poisoned rows past T
    # and the double-rounding witness.
    phase("2 kernels: the kernel table at their paths' shapes")
    F = torch.nn.functional
    bf = torch.bfloat16

    with torch.inference_mode():
        # K1: one clip group of candidate poses, 128^2 crop rays each, marched
        # as the main path marches them: the rays that hit the object box,
        # compacted on the device.
        T_WC_2, _, _, dirs = combined.crop_rays(dirs_cam, K, obj_aabb, crop, T_WO, T_WC,
                                                poses[:clip_batch])
        k1_rays, box = march_group(field, T_WC_2[:, :3, 3].contiguous(), dirs)
        packed = mk.pack_params(field)
        args = (*k1_rays, box, packed, crop_settings.n_coarse, crop_settings.min_transmittance)
        got = mk.march(*args, True)
        *per_ray, g_live = mk.live_rays(*k1_rays)
        plain_args = (*per_ray, box, packed.w, packed.b, crop_settings.n_coarse,
                      crop_settings.min_transmittance)
        *ref, needed = mk.march_plain(*plain_args, True, count_samples=True)
        if float(got[1].max()) <= 0.0:
            raise AssertionError("K1: the crop renders are empty")
        n_all, n_live = dirs.shape[0] * dirs.shape[1], int(g_live.numel())
        geo1 = mk.march_geometry(n_all, crop_settings.n_coarse, n_sm)
        k1_ms = time_ms(lambda: mk.march(*args, True), 10)
        tile_steps = -(-n_live // geo1["rays_per_tile"]) * geo1["steps"]
        log(f"  K1: {clip_batch} poses x {crop * crop} rays x {crop_settings.n_coarse} samples; "
            f"{n_live} rays hit the box; tiles of {geo1['rays_per_tile']} rays x "
            f"{geo1['samples_per_tile']} samples, {tile_steps} tile-steps without early exit, "
            f"grid {geo1['grid']}; {needed} samples needed; weights read from L2 at most "
            f"{tile_steps * mk.IMAGE_BYTES / 1e9:.2f} GB, "
            f"{tile_steps * mk.IMAGE_BYTES / k1_ms / 1e9:.2f} TB/s")
        record(
            "march (K1)", "dream2real_tpu_torch/csrc/march.cu",
            "dream2real_tpu/nerf/march_kernel.py:421",
            worst(gap(a[g_live], c, K1_TOL) for a, c in zip(got, ref)), k1_ms,
            time_ms(lambda: mk.march_plain(*plain_args, True), 3),
            k1_flops(needed), k1_bytes(n_live), None,
        )

        # K2 / K3: one clip group through a vision block, both softmax modes.
        B, T, W, H = clip_batch, 577, 1024, 16
        x = (torch.randn(B, T, W, generator=gen, device=dev) * 2.0).to(bf)
        wqkv = (torch.randn(W, 3 * W, generator=gen, device=dev) * W**-0.5).to(bf)
        bqkv = torch.randn(3 * W, generator=gen, device=dev) * 0.02
        g = 1.0 + 0.1 * torch.randn(W, generator=gen, device=dev)
        beta = 0.1 * torch.randn(W, generator=gen, device=dev)
        qkv = (torch.randn(B, T, 3 * W, generator=gen, device=dev) * 2.0).to(bf)
        hd = W // H
        attn_flops = 4.0 * B * H * T * T * hd
        err2 = worst(gap(att.mha_ln_qkv(x, wqkv, bqkv, g, beta, H, maxsub=ms),
                         att.mha_ln_qkv_plain(x, wqkv, bqkv, g, beta, H, ms), *ATT_TOL)
                     for ms in (False, True))
        err3 = worst(gap(att.mha_qkv(qkv, H, ms), att.mha_qkv_plain(qkv, H, ms), *ATT_TOL)
                     for ms in (False, True))

        def lib_k2():
            xn = F.layer_norm(x, (W,), g.to(bf), beta.to(bf), 1e-5)
            y = torch.matmul(xn, wqkv) + bqkv.to(bf)
            q, k, v = (t.view(B, T, H, hd).transpose(1, 2) for t in y.split(W, dim=-1))
            return F.scaled_dot_product_attention(q, k, v)

        q3, k3, v3 = (t.view(B, T, H, hd).transpose(1, 2) for t in qkv.split(W, dim=-1))
        k2_flops = 2.0 * B * T * W * 3 * W + attn_flops
        k2_bytes = 2 * B * T * W * 2 + W * 3 * W * 2 + 5 * W * 4
        record(
            "ln_qkv_attention (K2)", "dream2real_tpu_torch/csrc/attention.cu",
            "dream2real_tpu/ops/attention.py:274", err2,
            time_ms(lambda: att.mha_ln_qkv(x, wqkv, bqkv, g, beta, H), 10, QUEUED),
            time_ms(lambda: att.mha_ln_qkv_plain(x, wqkv, bqkv, g, beta, H, False), 3),
            k2_flops, k2_bytes, time_ms(lib_k2, 10, QUEUED),
        )
        record(
            "attention_qkv (K3)", "dream2real_tpu_torch/csrc/attention.cu",
            "dream2real_tpu/ops/attention.py:195", err3,
            time_ms(lambda: att.mha_qkv(qkv, H), 10, QUEUED),
            time_ms(lambda: att.mha_qkv_plain(qkv, H, False), 3),
            attn_flops, B * T * 4 * W * 2,
            time_ms(lambda: F.scaled_dot_product_attention(q3, k3, v3), 10, QUEUED),
        )
        log(f"  K2 / K3 with one call between the events (the host's launch path included): "
            f"{time_ms(lambda: att.mha_ln_qkv(x, wqkv, bqkv, g, beta, H), 10):.4f} / "
            f"{time_ms(lambda: att.mha_qkv(qkv, H), 10):.4f} ms")

        # K4: the text tower's causal attention (3 captions, 12 heads, 77
        # tokens), timed like the other attention rows: 10 calls queued, for
        # the kernel and SDPA alike (one call between the events reads the
        # host's launch path, logged too).
        Bt, Ht, Tt, Dt = 3, 12, 77, 64
        q4, k4, v4 = ((torch.randn(Bt, Ht, Tt, Dt, generator=gen, device=dev)).to(bf)
                      for _ in range(3))
        k4_call = lambda: att.mha(q4, k4, v4, causal=True)  # noqa: E731
        sdpa4 = lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)  # noqa: E731
        record(
            "attention_causal (K4)", "dream2real_tpu_torch/csrc/attention.cu",
            "dream2real_tpu/ops/attention.py:66",
            gap(k4_call(), att.mha_causal_plain(q4, k4, v4), *ATT_TOL),
            time_ms(k4_call, 10, QUEUED), time_ms(lambda: att.mha_causal_plain(q4, k4, v4), 10),
            2.0 * Bt * Ht * Dt * Tt * (Tt + 1), 4 * Bt * Ht * Tt * Dt * 2,
            time_ms(sdpa4, 10, QUEUED),
        )
        log(f"  K4 / SDPA with one call between the events (the host's launch path included): "
            f"{time_ms(k4_call, 20):.4f} / {time_ms(sdpa4, 20):.4f} ms")
        # At this size 10 queued calls still wait on the host between launches:
        # the profiler's kernel table gives the device's time of each (every
        # kernel a call launches: K4 is one), beside the launch-latency floor
        # (a one-element add_, device and queued).
        tiny = torch.zeros(1, device=dev)
        floor = lambda: tiny.add_(1.0)  # noqa: E731
        dev4 = {tag: kernel_ms(fn_, {tag: words}, 20)[tag]
                for tag, fn_, words in (("K4", k4_call, ("",)), ("SDPA", sdpa4, ("",)),
                                        ("floor", floor, ("",)))}
        log(f"  K4 / SDPA / one-element add_ device time from the profiler: {dev4['K4']:.4f} / "
            f"{dev4['SDPA']:.4f} / {dev4['floor']:.4f} ms; the add_ with 10 calls queued "
            f"{time_ms(floor, 10, QUEUED):.4f} ms")

        # K9 and the attention bench's variants (X1-X4) at the scoring shape.
        ATT_SRC = "dream2real_tpu_torch/csrc/attention.cu"
        XREF = "experiments/bench_attention.py"
        q9, k9, v9 = (torch.randn(B, H, T, hd, generator=gen, device=dev).to(bf)
                      for _ in range(3))
        head_bytes = 4 * B * H * T * hd * 2
        Tp = T + (-T % 8)  # X1 attends over the keys padded to a multiple of 8
        x1_flops = 4.0 * B * H * T * Tp * hd
        record(
            "attention_bidirectional (K9)", ATT_SRC, "dream2real_tpu/ops/attention.py:123",
            gap(att.mha(q9, k9, v9), att.mha_plain(q9, k9, v9), *ATT_TOL),
            time_ms(lambda: att.mha(q9, k9, v9), 10, QUEUED),
            time_ms(lambda: att.mha_plain(q9, k9, v9), 3),
            attn_flops, head_bytes,
            time_ms(lambda: F.scaled_dot_product_attention(q9, k9, v9), 10, QUEUED),
        )
        x1_padded = ba._pad8(q9, k9, v9)[:3]
        for tag, fn, nomax in (("bench_v1_unrolled (X1, K9's launch)", ba.mha_v1_unrolled, False),
                               ("bench_v2_nomax (X1)", ba.mha_v2_nomax, True)):
            record(
                tag, ATT_SRC, f"{XREF}:103",
                gap(fn(q9, k9, v9), ba.mha_x1_plain(q9, k9, v9, nomax=nomax), *ATT_TOL),
                time_ms(lambda: fn(q9, k9, v9), 10, QUEUED),
                time_ms(lambda: ba.mha_x1_plain(q9, k9, v9, nomax=nomax), 3),
                # One library call on the padded inputs computes the same
                # function (v2 too, unless a logit overflows): timed only.
                x1_flops, head_bytes,
                time_ms(lambda: F.scaled_dot_product_attention(*x1_padded), 10, QUEUED),
            )
        for pname in ba.PROBES:
            pfn = ba.probe(pname)
            products = pname == "matmul_only"
            want = ba.probe_plain(pname, q9, k9, v9)
            record(  # the products' unnormalised sums: 2e-2 of the largest (maxrel)
                f"bench_probe_{pname} (X1)", ATT_SRC, f"{XREF}:103",
                gap(pfn(q9, k9, v9), want,
                    *((2e-2 * float(want.float().abs().max()),) if products else ATT_TOL)),
                time_ms(lambda: pfn(q9, k9, v9), 10, QUEUED),
                time_ms(lambda: ba.probe_plain(pname, q9, k9, v9), 3),
                # The products run on the tensor cores; the fabricated probes'
                # only operations are T x Tp exponentials a head in f32, which
                # no rate of this table prices above their bytes (q in, out).
                x1_flops if products else 0.0, head_bytes if products else head_bytes // 2, None,
            )
        # The attention kernel alone in every mode (the X1 rows above carry
        # their zero-padding copies), and the clamp mode without a ragged
        # edge (T 512).
        alone = {m: time_ms(lambda: att.head_attention(q9, k9, v9, m), 10, QUEUED)
                 for m in att.MODES if m != "exact"}
        q512, k512, v512 = (t[:, :, :512].contiguous() for t in (q9, k9, v9))
        alone["clamp at T 512"] = time_ms(
            lambda: att.head_attention(q512, k512, v512, "clamp"), 10, QUEUED)
        log("  the attention kernel alone, head-split: "
            + ", ".join(f"{m} {t:.4f}" for m, t in alone.items()) + " ms")
        del q9, k9, v9, x1_padded, q512, k512, v512, want
        for kern in ("v8", "v9"):
            record(
                f"bench_projlayout_{kern} (X2)", ATT_SRC, f"{XREF}:243",
                gap(ba.mha_v8_projlayout(qkv, H, kern),
                    att.mha_qkv_plain(qkv, H, ba.V8_KERNELS[kern]), *ATT_TOL),
                time_ms(lambda: ba.mha_v8_projlayout(qkv, H, kern), 10, QUEUED),
                time_ms(lambda: att.mha_qkv_plain(qkv, H, ba.V8_KERNELS[kern]), 3),
                attn_flops, B * T * 4 * W * 2,
                time_ms(lambda: F.scaled_dot_product_attention(q3, k3, v3), 10, QUEUED),
            )
        wo = (torch.randn(W, W, generator=gen, device=dev) * W**-0.5).to(bf)
        bo = torch.randn(W, generator=gen, device=dev) * 0.02
        record(
            "bench_block_fused (X4)", ATT_SRC, f"{XREF}:358",
            gap(ba.block_fused(x, wqkv, bqkv, g, beta, H),
                att.mha_ln_qkv_plain(x, wqkv, bqkv, g, beta, H, False), *ATT_TOL),
            time_ms(lambda: ba.block_fused(x, wqkv, bqkv, g, beta, H), 10, QUEUED),
            time_ms(lambda: att.mha_ln_qkv_plain(x, wqkv, bqkv, g, beta, H, False), 3),
            k2_flops, k2_bytes, time_ms(lib_k2, 10, QUEUED),
        )

        def lib_x3():
            return x + torch.addmm(bo.to(bf), lib_k2().transpose(1, 2).reshape(B * T, W),
                                   wo).view(B, T, W)

        want = ba.block_fused_o_plain(x, wqkv, bqkv, g, beta, wo, bo, H)
        record(  # the residual stream: 2e-2 of the largest output (maxrel)
            "bench_block_fused_o (X3)", ATT_SRC, f"{XREF}:334",
            gap(ba.block_fused_o(x, wqkv, bqkv, g, beta, wo, bo, H), want,
                2e-2 * float(want.float().abs().max())),
            time_ms(lambda: ba.block_fused_o(x, wqkv, bqkv, g, beta, wo, bo, H), 10, QUEUED),
            time_ms(lambda: ba.block_fused_o_plain(x, wqkv, bqkv, g, beta, wo, bo, H), 3),
            k2_flops + 2.0 * B * T * W * W, k2_bytes + W * W * 2 + W * 4,
            time_ms(lib_x3, 10, QUEUED),
        )
        # The two GEMMs alone: K2's qkv GEMM with its LN pass, and X3's
        # out-projection on the attention output the path gives it (its
        # error with a zero residual, where the product is all of the result),
        # within one bf16 step plus 2e-3 and 5e-4.
        a_x3 = att.mha_ln_qkv(x, wqkv, bqkv, g, beta, H, maxsub=False)
        zero = torch.zeros_like(x)
        M_rows = B * T
        xn2 = att.layer_norm(x, g, beta).view(M_rows, W)
        record(
            "ln_qkv_gemm (inside K2)", ATT_SRC, "dream2real_tpu/ops/attention.py:274",
            gap(att.ln_qkv(x, wqkv, bqkv, g, beta), att.ln_qkv_plain(x, wqkv, bqkv, g, beta),
                2e-3, 2.0**-7),
            time_ms(lambda: att.ln_qkv(x, wqkv, bqkv, g, beta), 10, QUEUED),
            time_ms(lambda: att.ln_qkv_plain(x, wqkv, bqkv, g, beta), 3),
            *gemm_flops_bytes(M_rows, W, 3 * W, False),
            time_ms(lambda: torch.matmul(xn2, wqkv), 10, QUEUED),
        )
        record(
            "out_proj_gemm (inside X3)", ATT_SRC, f"{XREF}:334",
            gap(att.proj_residual(a_x3, wo, bo, zero), att.proj_residual_plain(a_x3, wo, bo, zero),
                5e-4, 2.0**-7),
            time_ms(lambda: att.proj_residual(a_x3, wo, bo, x), 10, QUEUED),
            time_ms(lambda: att.proj_residual_plain(a_x3, wo, bo, x), 3),
            *gemm_flops_bytes(M_rows, W, W, True),
            time_ms(lambda: torch.matmul(a_x3.view(M_rows, W), wo), 10, QUEUED),
        )
        del a_x3, xn2, zero, want

        # The tower's biased layers on the same GEMM, its epilogues rounding
        # where the reference rounds: qkv (bias; the last vision block's and
        # the text tower's), fc1 + QuickGELU, fc2 + residual, at the vision
        # tower's shapes. Library: torch.matmul in bf16 and the PyTorch glue
        # the port ran before (bias add, casts, QuickGELU, residual), which
        # rounds the product before the bias.
        def gelu(c):
            return c * torch.sigmoid(1.702 * c.float()).to(bf)

        x_t = (torch.randn(B, T, W, generator=gen, device=dev)).to(bf)
        tw = {n: (torch.randn(k_, n_, generator=gen, device=dev) * k_**-0.5).to(bf)
              for n, (k_, n_) in {"qkv": (W, 3 * W), "proj": (W, W), "fc1": (W, 4 * W),
                                  "fc2": (4 * W, W)}.items()}
        tb = {n: 0.1 * torch.randn(w_.shape[1], generator=gen, device=dev) for n, w_ in tw.items()}
        h_t = att.linear_bias_gelu_plain(x_t, tw["fc1"], tb["fc1"])

        def glue(a_, n_):  # the former bf16 matmul, then the f32 bias add and the cast
            return (torch.matmul(a_, tw[n_]).float() + tb[n_]).to(bf)

        # (name, wrapper, arguments, what the epilogue does past the layer's
        # rounding, library call, the reference's line: jnp.dot + b of qkv in
        # _attn, fc1 and fc2 in _mlp_block). Each within one bf16 step plus
        # 2^-20 of the element's sum of |products| (the two f32 sums' orders).
        CLIP_REF = "dream2real_tpu/clip/model.py"
        tower_rows = (
            ("tower_qkv_gemm (bias)", att.linear_bias, (x_t, tw["qkv"], tb["qkv"]),
             lambda c: c, lambda: glue(x_t, "qkv"), f"{CLIP_REF}:104"),
            ("tower_fc1_gemm (bias_gelu)", att.linear_bias_gelu, (x_t, tw["fc1"], tb["fc1"]),
             gelu, lambda: gelu(glue(x_t, "fc1")), f"{CLIP_REF}:186"),
            ("tower_fc2_gemm (bias_then_resid)", att.linear_bias_then_resid,
             (h_t, tw["fc2"], tb["fc2"], x_t), lambda c: x_t + c,
             lambda: x_t + glue(h_t, "fc2"), f"{CLIP_REF}:192"),
        )
        for tag, fn, fargs, after, lib, ref_line in tower_rows:
            plain = getattr(att, fn.__name__ + "_plain")
            k_, n_ = fargs[1].shape
            slack = 2.0**-20 * (fargs[0].float().abs() @ fargs[1].float().abs())
            record(
                tag, ATT_SRC, ref_line,
                epilogue_gap(fn(*fargs), att.linear_bias_plain(*fargs[:3]), after, slack),
                time_ms(lambda: fn(*fargs), 10, QUEUED), time_ms(lambda: plain(*fargs), 3),
                *gemm_flops_bytes(B * T, k_, n_, len(fargs) == 4), time_ms(lib, 10, QUEUED),
            )
        proj_args = (x_t, tw["proj"], tb["proj"], x_t)
        log(f"  tower proj GEMM (bias_then_resid, W x W): kernel "
            f"{time_ms(lambda: att.linear_bias_then_resid(*proj_args), 10, QUEUED):.4f} ms, "
            f"matmul + glue {time_ms(lambda: x_t + glue(x_t, 'proj'), 10, QUEUED):.4f} ms")
        # L1, the LayerNorm row pass (ln_rows) at the main path's shape (32 x
        # 577 rows of 1024), alone and as fc1's prologue (ln_fc1). Bound: the
        # bf16 rows read and written once (75.6 MB), and for ln_fc1 fc1's
        # GEMM's. Library: torch.nn.functional.layer_norm on the bf16 rows
        # (its gain and bias in bf16), then matmul + glue for fc1.
        g_l = 1.0 + 0.1 * torch.randn(W, generator=gen, device=dev)
        b_l = 0.1 * torch.randn(W, generator=gen, device=dev)
        g_lb, b_lb = g_l.to(bf), b_l.to(bf)
        fc1_args = (x_t, tw["fc1"], tb["fc1"], g_l, b_l)
        xn_k, xn_p = att.ln_rows(x_t, g_l, b_l), att.layer_norm(x_t, g_l, b_l)
        record(  # one bf16 step + 2^-16 (its row sums run in another order)
            "ln_rows (L1)", ATT_SRC, f"{CLIP_REF}:93", gap(xn_k, xn_p, 2.0**-16, 2.0**-7),
            time_ms(lambda: att.ln_rows(x_t, g_l, b_l), 10, QUEUED),
            time_ms(lambda: att.layer_norm(x_t, g_l, b_l), 3), 0.0,
            2 * B * T * W * 2 + 2 * W * 4,
            time_ms(lambda: F.layer_norm(x_t, (W,), g_lb, b_lb, 1e-5), 10, QUEUED),
        )
        # ln_fc1 is fc1's GEMM on the row pass's own rows, bit for bit, and is
        # held as fc1's row above, its slack widened by twice what the rows'
        # differences from layer_norm's move each sum (QuickGELU's slope < 1.1).
        if not torch.equal(att.ln_fc1(*fc1_args), att.linear_bias_gelu(xn_k, *fc1_args[1:3])):
            raise AssertionError("ln_fc1 is not fc1's GEMM on the row pass's own rows")
        wa = tw["fc1"].float().abs()
        slack = 2.0**-20 * (xn_p.float().abs() @ wa) + 2 * (xn_k.float() - xn_p.float()).abs() @ wa
        record(
            "ln_fc1 (L1 + fc1)", ATT_SRC, f"{CLIP_REF}:213",
            epilogue_gap(att.ln_fc1(*fc1_args), att.linear_bias_plain(xn_p, *fc1_args[1:3]), gelu,
                         slack),
            time_ms(lambda: att.ln_fc1(*fc1_args), 10, QUEUED),
            time_ms(lambda: att.ln_fc1_plain(*fc1_args), 3),
            *gemm_flops_bytes(B * T, W, 4 * W, False),
            time_ms(lambda: gelu((torch.matmul(F.layer_norm(x_t, (W,), g_lb, b_lb, 1e-5),
                                               tw["fc1"]).float() + tb["fc1"]).to(bf)),
                    10, QUEUED),
        )
        del x_t, tw, tb, h_t, x, qkv, q3, k3, v3, xn_k, xn_p, wa, slack

        # K5-K8: one training batch of the selftest configuration on the
        # seeded field: 8192 rays through random pixels of the 36-view synth
        # orbit, jittered coarse samples, K5's 64 draws as the samples of K6
        # and K7, K8 on the coarse samples.
        R, nc, n_draw = 8192, settings.n_coarse, settings.n_coarse + settings.n_fine
        orbit = torch.as_tensor(synth.orbit_poses(scene.centre, 36, radius=0.5, height=0.4),
                                dtype=torch.float32, device=dev)
        pick = torch.randint(0, 36, (R,), generator=gen, device=dev)
        pix = torch.randint(0, res * res, (R,), generator=gen, device=dev)
        o_t = orbit[pick, :3, 3].contiguous()
        d_t = torch.einsum("bij,bj->bi", orbit[pick, :3, :3], dirs_cam.reshape(-1, 3)[pix])
        d_t = d_t.contiguous()
        tw, tb = tk.pack_train_params(field.params())
        tbox = tk.field_box(ngp_cfg, dev)
        ts_c, _ = tk.coarse_samples(ngp_cfg, o_t, d_t, settings, gen)
        draws = tk.exp_draws(R, n_draw, gen, dev)
        k5_args = (o_t, d_t, ts_c, draws, tbox, tw, tb, n_draw, settings.min_transmittance,
                   tk.sampler_mix_default())
        ts_t = tk.density_sample(*k5_args)
        record(
            "density_sample (K5)", "dream2real_tpu_torch/csrc/train.cu",
            "dream2real_tpu/nerf/train_kernel.py:872",
            gap(ts_t, tk.density_sample_plain(*k5_args), 1e-2),
            time_ms(lambda: tk.density_sample(*k5_args), 10, TRAIN_QUEUED),
            time_ms(lambda: tk.density_sample_plain(*k5_args), 3),
            2.0 * DENSITY_MACS * R * nc, R * (6 + nc + n_draw + 1 + n_draw) * 4 + tw.numel() * 2,
            None,
        )
        k6_args = (o_t, d_t, ts_t, tbox, tw, tb, settings.min_transmittance)
        C, A, D = tk.train_fwd(*k6_args)
        fwd_plain = tk.train_fwd_plain(*k6_args)
        record(
            "train_fwd (K6)", "dream2real_tpu_torch/csrc/train.cu",
            "dream2real_tpu/nerf/train_kernel.py:508",
            worst(gap(a, c, 5e-3) for a, c in zip((C, A, D), fwd_plain)),
            time_ms(lambda: tk.train_fwd(*k6_args), 10, TRAIN_QUEUED),
            time_ms(lambda: tk.train_fwd_plain(*k6_args), 3),
            2.0 * FIELD_MACS * R * n_draw, R * (6 + n_draw + 5) * 4 + tw.numel() * 2, None,
        )
        cot = (torch.randn(R, 3, generator=gen, device=dev),
               torch.randn(R, generator=gen, device=dev),
               0.1 * torch.randn(R, generator=gen, device=dev))
        # K7 without ray gradients, the training default. Each backward takes
        # its own forward's outputs, as in training. Its error: the largest
        # of the parameters' max |kernel - plain| / max |plain|, within 8e-2.
        geo7 = tk.train_geometry(R, n_draw, n_sm)
        k7 = lambda: tk.train_bwd(*k6_args, *cot, C, A, D, False)  # noqa: E731
        g_k7, g_plain = (tk.unpack_grads(g_[0]) for g_ in (
            k7(), tk.train_bwd_plain(*k6_args, *cot, *fwd_plain, False)))
        rel7 = max(float((gk - g_plain[key]).abs().max()) / max(float(g_plain[key].abs().max()),
                                                                1e-12) for key, gk in g_k7.items())
        err7 = (rel7, rel7 - 8e-2)
        plain7_ms = time_ms(lambda: tk.train_bwd_plain(*k6_args, *cot, *fwd_plain, False), 3)
        record(
            "train_bwd (K7)", "dream2real_tpu_torch/csrc/train.cu",
            "dream2real_tpu/nerf/train_kernel.py:581", err7,
            time_ms(k7, 10, TRAIN_QUEUED), plain7_ms, k7_flops(R, n_draw), k7_bytes(R, n_draw),
            None,
        )
        # K7's two parts, timed from the profiler's kernel table of full K7
        # calls: the row pass (train_rows<true>, one launch a chunk) writes
        # each row's bf16 activations and deltas (SCRATCH_COLS of them, the
        # weight gradients' exact inputs); the weight-gradient products
        # (dw_gemm a chunk, then reduce_grads) read them back.
        part_ms = kernel_ms(k7, {"rows": ("train_rows",), "dw": ("dw_gemm", "reduce_grads")},
                            TRAIN_QUEUED)
        log(f"  K7's parts from the profiler ({TRAIN_QUEUED} calls): row pass "
            f"{part_ms['rows']:.4f} ms, weight-gradient products {part_ms['dw']:.4f} ms a call")
        # The products held alone (no card test reads K7's scratch): a K7
        # call of one chunk of rays (the main path's shape of a launch), its
        # scratch read back as the plain version's f32 act^T delta, in
        # relative terms (the kernel's f32 sums run in another order: 1e-3 of
        # the largest gradient).
        R1 = geo7["chunk_groups"] * geo7["rays_per_tile"]
        geo1 = tk.train_geometry(R1, n_draw, n_sm)
        bufs1 = tk.bwd_buffers(geo1, dev)
        first = [t[:R1].contiguous() for t in (o_t, d_t, ts_t, *cot, C, A, D)]
        g_one = tk._train_bwd_launch(*first[:3], tbox, tk._image(tw), tb,
                                     settings.min_transmittance, *first[3:], False, bufs1)[0]
        rows_chunk = geo1["chunk_groups"] * geo1["steps"] * 2  # 64-row blocks of a chunk
        plain_dw = tk.weight_grads_plain(tk.scratch_rows(bufs1["scratch"], rows_chunk))
        dw_max = float(plain_dw.abs().max())
        err_dw = gap(g_one[: tk.N_G - tk.N_BIAS], plain_dw, 1e-3 * dw_max)
        log(f"  K7's weight-gradient products vs plain f32 act^T delta ({geo1['n_chunks']} chunk of "
            f"{R1} rays): max abs {err_dw[0]:.3e} at max |plain| {dw_max:.3e}")
        if geo1["n_chunks"] != 1:
            raise AssertionError(f"K7's weight-gradient products: {geo1['n_chunks']} chunks, not 1")
        rows_rs = R * n_draw
        record(
            "train_bwd row pass (inside K7)", "dream2real_tpu_torch/csrc/train.cu",
            "dream2real_tpu/nerf/train_kernel.py:581", err7, part_ms["rows"], plain7_ms,
            2.0 * (FIELD_MACS + DELTA_MACS) * R * n_draw,
            R * (6 + n_draw + 10) * 4 + tw.numel() * 2 + rows_rs * SCRATCH_COLS * 2, None,
        )
        # The library call: torch.matmul of the same act^T delta at the real
        # widths, one call a weight matrix (8 calls, bf16 in and out).
        shapes = ((63, 256), (256, 256), (256, 256), (319, 256), (256, 16), (31, 64), (64, 64),
                  (64, 3))
        lib_in = [(torch.randn(rows_rs, k, device=dev).to(bf),
                   torch.randn(rows_rs, n, device=dev).to(bf)) for k, n in shapes]
        lib_dw = time_ms(lambda: [torch.matmul(a_.t(), d_) for a_, d_ in lib_in], 10, TRAIN_QUEUED)
        del lib_in
        record(
            "train_bwd weight gradients (inside K7)", "dream2real_tpu_torch/csrc/train.cu",
            "dream2real_tpu/nerf/train_kernel.py:581", err_dw, part_ms["dw"],
            geo7["n_chunks"] * time_ms(
                lambda: tk.weight_grads_plain(tk.scratch_rows(bufs1["scratch"], rows_chunk)), 3),
            2.0 * FIELD_MACS * R * n_draw, rows_rs * SCRATCH_COLS * 2 + tk.N_G * 4, lib_dw,
        )
        del bufs1, plain_dw, first
        k8_args = (o_t, d_t, ts_c, tbox, tw, tb, settings.min_transmittance)
        record(
            "density_weights (K8)", "dream2real_tpu_torch/csrc/train.cu",
            "dream2real_tpu/nerf/train_kernel.py:450",
            gap(tk.density_weights(*k8_args), tk.density_weights_plain(*k8_args), 5e-3),
            time_ms(lambda: tk.density_weights(*k8_args), 10, TRAIN_QUEUED),
            time_ms(lambda: tk.density_weights_plain(*k8_args), 3),
            2.0 * DENSITY_MACS * R * nc, R * (6 + 2 * nc) * 4 + tw.numel() * 2, None,
        )
        for kname, (regs, st_b, ld_b) in ptxas["train"].items():
            if kname.startswith("density_rows"):
                log(f"  ptxas {kname} ({'K5' if 'true' in kname else 'K8'}): {regs} registers, "
                    f"{st_b} bytes spill stores, {ld_b} bytes spill loads")
        del C, A, D, fwd_plain, g_k7, g_plain, g_one
    hash_kernel_records(dev, record, cams, dirs_cam,
                        (SELFTEST_AABB["aabb_min"], SELFTEST_AABB["aabb_max"]))
    with torch.inference_mode():
        hash_march_record(dev, record, SELFTEST_AABB,
                          (dirs_cam, K, obj_aabb, crop, T_WO, T_WC, poses[:clip_batch]),
                          crop_settings)

    # ------------------------------------------------------ A attention bench
    phase("A attention bench (experiments/bench_attention.main, full shape, 3 reps)")
    reps_a = 3
    x_counters = {
        "attention_bidirectional (K9)": lambda: att.mha.launches,
        "bench_v1_unrolled (X1, K9's launch)": lambda: ba.mha_v1_unrolled.launches,
        "bench_v2_nomax (X1)": lambda: ba.mha_v2_nomax.launches,
        "bench_v3_pipelined (X1)": lambda: ba.mha_v3_pipelined.launches,
        **{f"bench_probe_{n} (X1)": (lambda n=n: ba.probe.launches[n]) for n in ba.PROBES},
        **{f"bench_projlayout_{k} (X2)": (lambda k=k: ba.mha_v8_projlayout.launches[k])
           for k in ba.V8_KERNELS},
        "bench_block_fused (X4)": lambda: ba.block_fused.launches,
        "bench_block_fused_o (X3)": lambda: ba.block_fused_o.launches,
        "out_proj_gemm (inside X3)": lambda: att.proj_residual.launches,
    }
    att.mha.launches = att.proj_residual.launches = 0
    ba.mha_v1_unrolled.launches = ba.mha_v2_nomax.launches = ba.mha_v3_pipelined.launches = 0
    ba.block_fused.launches = ba.block_fused_o.launches = 0
    for counts in (ba.probe.launches, ba.mha_v8_projlayout.launches):
        for key in counts:
            counts[key] = 0
    bench = ba.main([str(reps_a)], out=lambda m: log(f"  {m}"))
    bench_launches = {k: read() for k, read in x_counters.items()}
    # A timed row is one warm call and reps_a timed ones; the cross-checks
    # and the composed layers add the rest.
    row = reps_a + 1
    expected = {
        "attention_bidirectional (K9)": row + 1,
        "bench_v1_unrolled (X1, K9's launch)": row + 1, "bench_v2_nomax (X1)": row + 1,
        "bench_v3_pipelined (X1)": row + 1,
        **{f"bench_probe_{n} (X1)": row for n in ba.PROBES},
        "bench_projlayout_v8 (X2)": row, "bench_projlayout_v10 (X2)": row,
        "bench_projlayout_v11 (X2)": row,
        "bench_projlayout_v9 (X2)": row + 3 * row + 2,  # its row, 3 baseline rows, 2 checks
        "bench_block_fused (X4)": 2 * row,
        # The out-projection GEMM also closes the composed baselines' sub-blocks
        # (5 timed rows, 4 in the cross-checks).
        "bench_block_fused_o (X3)": 2 * row + 2, "out_proj_gemm (inside X3)": 5 * row + 4,
    }
    log(f"  launches: {bench_launches}")
    if bench_launches != expected:
        raise AssertionError(f"attention bench: launches {bench_launches} != {expected}")
    if len(bench["rows"]) != 18 or not all(v > 0 and np.isfinite(v) for v in bench["rows"].values()):
        raise AssertionError(f"attention bench: rows {bench['rows']}")
    for key in ("v13", "full-block"):
        if not bench["maxrel"][key] < 2e-2:
            raise AssertionError(f"attention bench: {key} maxrel {bench['maxrel'][key]} >= 2e-2")
    for k in kernels:
        if k["name"] in bench_launches:
            k["launches"] = bench_launches[k["name"]]

    # ------------------------------------------------------------- T training
    phase("T training (the port's selftest: 336^2, 36 views, 8192 rays, 32 + 32)")
    train_fns = {"density_sample (K5)": tk.density_sample, "train_fwd (K6)": tk.train_fwd,
                 "train_bwd (K7)": tk.train_bwd, "density_weights (K8)": tk.density_weights}
    for fn in train_fns.values():
        fn.launches = 0
    tk.train_bwd.row_pass_launches = tk.train_bwd.weight_grad_launches = 0
    t_train = time.perf_counter()
    st = run_selftest(views=36, steps=TRAIN_STEPS, device=dev, log=lambda m: log(f"  {m}"))
    train_launches = {k: fn.launches for k, fn in train_fns.items()}
    train_launches["train_bwd row pass (inside K7)"] = tk.train_bwd.row_pass_launches
    train_launches["train_bwd weight gradients (inside K7)"] = tk.train_bwd.weight_grad_launches
    log(f"  trained {st['steps']} steps in {time.perf_counter() - t_train:.1f} s of wall "
        f"(data, kernel load, training and two 336^2 renders): {st['steps_per_s']:.2f} steps/s "
        f"over the last {st['timed_steps']}; final loss {st['final_loss']:.5f}; launches "
        f"{train_launches} ({name}; {smi})")
    # The host launches each training kernel at the warm-up and the capture
    # of the step's graph; the replays run them on the device (counted from
    # the profiled steps below).
    chunks = tk.train_geometry(8192, n_draw, torch.cuda.get_device_properties(dev)
                               .multi_processor_count)["n_chunks"]
    for key, per in (("density_sample (K5)", 1), ("train_fwd (K6)", 1), ("train_bwd (K7)", 1),
                     ("train_bwd row pass (inside K7)", chunks),
                     ("train_bwd weight gradients (inside K7)", chunks)):
        if train_launches[key] != GRAPH_LAUNCHES * per:
            raise AssertionError(f"{key} launched {train_launches[key]} times by the host, not "
                                 f"{GRAPH_LAUNCHES * per} (the graph's warm-up and capture)")
    if train_launches["density_weights (K8)"] != 0:
        raise AssertionError("K8 launched on the fused-sampler path")
    for tag, psnr_, derr_ in (("view 5", st["psnr"], st["depth_err_m"]),
                              ("held-out view", st["psnr_held_out"], st["depth_err_held_out_m"])):
        if not (psnr_ > 22.0 and derr_ < 0.05):
            raise AssertionError(f"selftest bar missed on the {tag}: PSNR {psnr_:.2f} dB (> 22), "
                                 f"median depth error {derr_ * 1000:.1f} mm (< 50)")
    # K7 against its plain version on a batch of the trained field.
    field_t = st["state"]["field"]
    tw_t, tb_t = tk.pack_train_params(field_t.params())
    with torch.inference_mode():
        ts_tr = tk.density_sample(o_t, d_t, ts_c, draws, tbox, tw_t, tb_t, n_draw,
                                  settings.min_transmittance, tk.sampler_mix_default())
        k6_tr = (o_t, d_t, ts_tr, tbox, tw_t, tb_t, settings.min_transmittance)
        g_k = tk.unpack_grads(tk.train_bwd(*k6_tr, *cot, *tk.train_fwd(*k6_tr), False)[0])
        g_p = tk.unpack_grads(
            tk.train_bwd_plain(*k6_tr, *cot, *tk.train_fwd_plain(*k6_tr), False)[0])
    cos_f = torch.nn.functional.cosine_similarity
    err_tr, cos_tr = 0.0, 1.0
    for key in g_k:
        scale = max(float(g_p[key].abs().max()), 1e-12)
        err_tr = max(err_tr, float((g_k[key] - g_p[key]).abs().max()) / scale)
        cos_tr = min(cos_tr, float(cos_f(g_k[key].reshape(1, -1).double(),
                                         g_p[key].reshape(1, -1).double())))
    log(f"  K7 on the trained field: parameter gradients within {err_tr:.3e} x scale of the plain "
        f"version, least cosine {cos_tr:.6f}")
    if err_tr > 8e-2 or cos_tr <= 0.995:
        raise AssertionError(f"K7 on the trained field: {err_tr} x scale, cosine {cos_tr}")
    # K5 and K8 against their plain versions on the same batch of the
    # trained field, at the card tests' bounds on every ray.
    with torch.inference_mode():
        k5_tr = (o_t, d_t, ts_c, draws, tbox, tw_t, tb_t, n_draw, settings.min_transmittance,
                 tk.sampler_mix_default())
        err5_tr = float((ts_tr - tk.density_sample_plain(*k5_tr)).abs().max())
        step5_tr = float((ts_tr[:, 1:] - ts_tr[:, :-1]).min())
        inside_tr = bool((ts_tr >= ts_c[:, :1] - 1e-5).all()
                         and (ts_tr <= ts_c[:, -1:] + 1e-5).all())
        k8_tr = (o_t, d_t, ts_c, tbox, tw_t, tb_t, settings.min_transmittance)
        w8_tr = tk.density_weights(*k8_tr)
        err8_tr = float((w8_tr - tk.density_weights_plain(*k8_tr)).abs().max())
    log(f"  K5 on the trained field: max |kernel - plain| {err5_tr:.3e} (1e-2), draws sorted "
        f"(least step {step5_tr:.3e}), inside the coarse range: {inside_tr}; K8: {err8_tr:.3e} "
        f"(5e-3); mean coarse alpha {float(w8_tr.sum(dim=1).mean()):.4f}")
    if err5_tr > 1e-2 or step5_tr < -1e-6 or not inside_tr or err8_tr > 5e-3:
        raise AssertionError(f"K5 / K8 on the trained field: {err5_tr}, {step5_tr}, {inside_tr}, "
                             f"{err8_tr}")
    # Training is deterministic: two fresh 20-step runs from one seed end
    # with the same parameters, bit for bit.
    tc20 = dataclasses.replace(st["tc"], poll_steps=20)
    runs = []
    for _ in range(2):
        state20 = init_train_state(st["cfg"], tc20, n_images=36, device=dev)
        make_train_chunk(st["cfg"], tc20, settings, **st["data"])(state20)
        runs.append([p.detach().clone() for p in state20["field"].parameters()])
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError("two training runs from one seed differ")
    log("  two 20-step training runs from one seed: parameters bit-identical")
    # The D2R_FUSED_SAMPLER=0 path: K8's coarse weights, sample_pdf and the
    # sorted union, on a fresh state for a few steps.
    os.environ["D2R_FUSED_SAMPLER"] = "0"
    try:
        for fn in train_fns.values():
            fn.launches = 0
        state8 = init_train_state(st["cfg"], tc20, n_images=36, device=dev)
        _, loss8 = make_train_chunk(st["cfg"], tc20, settings, **st["data"])(state8)
        k8_launches = {k: fn.launches for k, fn in train_fns.items()}
    finally:
        os.environ["D2R_FUSED_SAMPLER"] = "1"
    log(f"  D2R_FUSED_SAMPLER=0: 20 steps, loss {loss8:.5f}, launches {k8_launches}")
    if (k8_launches["density_weights (K8)"] != GRAPH_LAUNCHES
            or k8_launches["density_sample (K5)"] != 0):
        raise AssertionError("the D2R_FUSED_SAMPLER=0 path did not run through K8")
    # Five training steps of the selftest configuration on a fresh state,
    # after one warm chunk (which also captures the step's CUDA graph),
    # under the profiler: the device time a step, by kernel.
    from torch.profiler import ProfilerActivity, profile as tprofile

    tc5 = dataclasses.replace(st["tc"], poll_steps=5)
    state5 = init_train_state(st["cfg"], tc5, n_images=36, device=dev)
    chunk5 = make_train_chunk(st["cfg"], tc5, settings, **st["data"])
    chunk5(state5)
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof5:
        chunk5(state5)
        torch.cuda.synchronize()
    wall5 = (time.perf_counter() - t5) * 1e3 / 5
    ops5 = device_ops(prof5)
    step_parts = {"K5 density_rows<true>": ("density_rows<true>",),
                  "K6 train_rows<false>": ("train_rows<false>",),
                  "K7 train_rows<true>": ("train_rows<true>",),
                  "K7 dw_gemm + reduce_grads": ("dw_gemm", "reduce_grads")}
    split = {part: sum(ms for key, ms in ops5 if any(w_ in key for w_ in words)) / 5
             for part, words in step_parts.items()}
    dev_step = sum(ms for _, ms in ops5) / 5
    split["the rest"] = dev_step - sum(split.values())
    runs5 = {word: sum(word in key for key, _ in ops5) / 5 for word in (
        "density_rows<true>", "train_rows<false>", "train_rows<true>", "dw_gemm",
        "reduce_grads", "density_rows<false>")}
    log(f"  5 profiled training steps: {dev_step:.3f} ms of device time a step ("
        + ", ".join(f"{k_} {v_:.3f}" for k_, v_ in split.items())
        + f"); unprofiled a step takes {1e3 / st['steps_per_s']:.2f} ms (the selftest's steps/s), "
        f"so the device is idle {max(0.0, 1.0 - dev_step * st['steps_per_s'] / 1e3) * 100:.1f}% of "
        f"it; {wall5:.2f} ms of wall a step under the profiler ({smi})")
    log(f"  kernels run a step on the device: {runs5}")
    if not all(split[k_] > 0 for k_ in step_parts):
        raise AssertionError(f"the profiler shows no device time for a training kernel: {split}")
    if dev_step > wall5:
        raise AssertionError(f"{dev_step} ms of device work a step in {wall5} ms of wall")
    want5 = {"density_rows<true>": 1, "train_rows<false>": 1, "train_rows<true>": chunks,
             "dw_gemm": chunks, "reduce_grads": 1, "density_rows<false>": 0}
    if runs5 != want5:
        raise AssertionError(f"kernels run a training step: {runs5}, not {want5}")
    for k in kernels:
        if k["name"] in train_launches:
            k["launches"] = (k8_launches if k["name"] == "density_weights (K8)"
                             else train_launches)[k["name"]]
    field = field_t

    if not torch.equal(phys["depths"], st["data"]["depths"]):
        raise AssertionError("phase P: its scan's depths are not phase T's")

    # -------------------------------------------------------- 3 main path
    phase("3 main path (bench.py workload, 512 poses)")
    wrappers = {"march (K1)": mk.march, "ln_qkv_attention (K2)": att.mha_ln_qkv,
                "ln_qkv_gemm (inside K2)": att.ln_qkv,
                "attention_qkv (K3)": att.mha_qkv, "attention_causal (K4)": att.mha,
                "ln_rows (L1)": att.ln_rows, "ln_fc1 (L1 + fc1)": att.ln_fc1,
                "tower_qkv_gemm (bias)": att.linear_bias,
                "tower_fc1_gemm (bias_gelu)": att.linear_bias_gelu,
                "tower_fc2_gemm (bias_then_resid)": att.linear_bias_then_resid}

    def tower_launches(groups_, text=1, split=False):
        """The tower's LayerNorm and GEMM launches for `groups_` clip groups
        and `text` runs of the text tower. LN1 and qkv (ln_qkv): K2's in a
        vision group's first 23 blocks, the last block's, every text
        block's; under D2R_ATTN_FUSED_LN=0 (`split`) the 23 run the row pass
        (ln_rows) and the qkv GEMM (bias) apart. LN2 and fc1 (ln_fc1) in
        every block, proj and fc2 (bias_then_resid) too; ln_pre and ln_post,
        ln_final (ln_rows). No LayerNorm runs plain, so fc1 never runs
        alone."""
        L, Lt = 24, 12
        k2 = (L - 1) * groups_
        return {"ln_qkv_gemm (inside K2)": (0 if split else k2) + groups_ + Lt * text,
                "tower_qkv_gemm (bias)": k2 if split else 0,
                "ln_rows (L1)": 2 * groups_ + text + (k2 if split else 0),
                "ln_fc1 (L1 + fc1)": L * groups_ + Lt * text,
                "tower_fc1_gemm (bias_gelu)": 0,
                "tower_fc2_gemm (bias_then_resid)": 2 * L * groups_ + 2 * Lt * text}
    for fn in wrappers.values():
        fn.launches = 0
    t_setup = time.perf_counter()
    with torch.inference_mode():
        torch.cuda.synchronize()
        t_bg = time.perf_counter()
        bg_out = render_image(field, T_WC, dirs_cam, settings, row_chunk=56)
        torch.cuda.synchronize()
        t_bg = time.perf_counter() - t_bg
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
    log(f"  set-up (background render, CLIP init, text tower) {time.perf_counter() - t_setup:.2f} s; "
        f"the background render alone {t_bg:.3f} s")
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
    want_tower = tower_launches(groups)
    if {k: launches[k] for k in want_tower} != want_tower:
        raise AssertionError(f"the tower GEMMs' launches are off: {launches}, want {want_tower}")
    for k in kernels:
        if k["name"] in launches:
            k["launches"] = launches[k["name"]]
    # One clip group's render waits on the host nowhere: with the object box
    # and the intrinsics on the device and the field packed (as
    # make_imagine_and_score holds them), torch's sync debug mode "error"
    # raises on any synchronising call.
    with torch.inference_mode():
        aabb_d = tuple(torch.as_tensor(v, dtype=torch.float32, device=dev) for v in obj_aabb)
        K_d = torch.as_tensor(K, dtype=torch.float32, device=dev)
        packed_d = mk.pack_params(field)
        bg_u8 = combined.background_only_image(bg)
        group_args = (field, settings, crop_settings, dirs_cam, K_d, aabb_d, crop, 56, T_WO, T_WC,
                      bg, bg_u8, poses[:clip_batch])
        want_r = combined.render_pose_batch(*group_args, packed=packed_d)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got_r = combined.render_pose_batch(*group_args, packed=packed_d)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if not torch.equal(got_r, want_r):
            raise AssertionError("the clip group rendered under sync debug mode differs")
    log(f"  one clip group's render under torch.cuda.set_sync_debug_mode('error'): no "
        f"synchronising call, {tuple(got_r.shape)} u8 as rendered before")
    # K1 on the trained field: the first clip group's live rays, as phase 2
    # timed it on the random field, against its plain version. Its sharp
    # surfaces leave a few rays whose result turns on one rounding (K1_FLAGGED
    # below): those rays are counted, their gaps held, and each is shown to be
    # ill-conditioned by a second witness, the plain version on the same rays
    # with the origin, the direction, or t0 and t1 moved by 1 to 64 f32 ulps
    # (4e-6 m at most). A ray whose plain result moves by half its gap or more
    # under such a nudge has no answer to f32 precision at the scale of the
    # gap; a kernel fault would show on rays where the plain version holds
    # still.
    with torch.inference_mode():
        k1_rays_t, box_t = march_group(field, T_WC_2[:, :3, 3].contiguous(), dirs)
        packed_t = mk.pack_params(field)
        *k1_t, live_t = mk.live_rays(*k1_rays_t)
        k1_rest = (box_t, packed_t.w, packed_t.b, crop_settings.n_coarse,
                   crop_settings.min_transmittance, True)
        *ref_t, needed_t = mk.march_plain(*k1_t, *k1_rest, count_samples=True)
        args_t = (*k1_rays_t, box_t, packed_t, crop_settings.n_coarse,
                  crop_settings.min_transmittance, True)
        got_t = [o[live_t] for o in mk.march(*args_t)]
        gaps = k1_gaps(got_t, ref_t)
        err_t = [float(g.max()) for g in gaps]
        flagged = torch.nonzero(torch.stack(gaps, 1).amax(1) > K1_TOL).squeeze(1)
        sub = [x[flagged] for x in k1_t]
        base = mk.march_plain(*sub, *k1_rest)
        moved = torch.stack(k1_gaps(base, [r[flagged] for r in ref_t]), 1).amax(1)
        up = [torch.nextafter(x, torch.full_like(x, float("inf"))) - x for x in sub]
        for k in (1, 2, 4, 8, 16, 32, 64):
            for sgn in (1.0, -1.0):
                for nudged in ((sub[0] + sgn * k * up[0], *sub[1:]),
                               (sub[0], sub[1] + sgn * k * up[1], *sub[2:]),
                               (*sub[:2], sub[2] + sgn * k * up[2], sub[3] + sgn * k * up[3])):
                    out = mk.march_plain(*nudged, *k1_rest)
                    moved = torch.maximum(moved, torch.stack(k1_gaps(out, base), 1).amax(1))
        ratio = moved / torch.stack(gaps, 1).amax(1)[flagged]
        held = int((ratio >= 0.5).sum())
        # The second witness: the flagged rays through the plain march in
        # f64 (the same bf16 weights and activation roundings, every
        # operation in f64), and how far the f32 kernel and the f32 plain
        # version each stand from it (largest of the rgb, alpha, depth gaps).
        ref64 = mk.march_plain(*sub, *k1_rest, dtype=torch.float64)
        d_k1 = torch.stack(k1_gaps([g[flagged].double() for g in got_t], ref64), 1).amax(1)
        d_pl = torch.stack(k1_gaps([r[flagged].double() for r in ref_t], ref64), 1).amax(1)
    n_flag, n_live_t = int(flagged.numel()), int(live_t.numel())
    if n_flag:
        log(f"  K1's f64 witness on the {n_flag} flagged rays: K1 stands max "
            f"{float(d_k1.max()):.3e} (median {float(d_k1.median()):.3e}) from the f64 march, "
            f"the f32 plain version max {float(d_pl.max()):.3e} (median "
            f"{float(d_pl.median()):.3e}); K1 the nearer on {int((d_k1 < d_pl).sum())}, the "
            f"plain version on {int((d_pl < d_k1).sum())}; per ray (K1, plain): "
            + ", ".join(f"({a:.3e}, {b:.3e})" for a, b in zip(d_k1.tolist(), d_pl.tolist())))
    log(f"  K1 vs plain on the trained field: max |rgb|, |alpha|, |depth| differences "
        f"{err_t[0]:.3e}, {err_t[1]:.3e}, {err_t[2]:.3e} (held under {K1_TRAINED_GAPS}); "
        f"{n_flag} of {n_live_t} rays beyond {K1_TOL} (held under {K1_FLAGGED:.0e} of them); "
        f"on {held} of those the plain version itself moves by half the ray's gap or more "
        f"when the ray is nudged by 1-64 ulps (least move / gap "
        f"{float(ratio.min()) if n_flag else 0.0:.3f})")
    if (n_flag > K1_FLAGGED * n_live_t or held < n_flag
            or any(e > lim for e, lim in zip(err_t, K1_TRAINED_GAPS))):
        raise AssertionError("K1 on the trained field: the flagged rays exceed their limits or "
                             "are not all ill-conditioned")
    log(f"  K1 on the trained field: {time_ms(lambda: mk.march(*args_t), 10):.4f} ms "
        f"per clip group ({n_live_t} live rays, {needed_t} samples needed; bound "
        f"{bound_ms(k1_flops(needed_t), 0)[0]:.4f} ms)")

    if profile:
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            score_fn(*args3, poses[:clip_batch])
            torch.cuda.synchronize()
        log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=15))
        # Phase T's five profiled training steps, in full.
        log(prof5.key_averages().table(sort_by="cuda_time_total", row_limit=25))

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
        stack.enter_context(mock.patch.object(mk, "march", mk.march_plain_live))
        for name_p in ("linear_bias", "linear_bias_then_resid", "ln_qkv", "ln_fc1"):
            stack.enter_context(mock.patch.object(cm, name_p, getattr(att, name_p + "_plain")))
        stack.enter_context(mock.patch.object(cm, "ln_rows", att.layer_norm))
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
    # K4 alone, the rest on the kernels: the old 0.99999 of the text tower.
    with mock.patch.object(cm, "mha", lambda q_, k_, v_, causal: att.mha_causal_plain(q_, k_, v_)):
        with torch.inference_mode():
            txt_k4 = float(cos(txt_emb, cm.encode_text(clip, ids), dim=-1).min())
    d_logit = float((k_logits - p_logits).abs().max())
    rel = float(((k_scores - p_scores).abs() / p_scores.abs()).max())
    far = float((level > 2).float().mean())
    log(f"  renders: {same_px:.6f} of pixels identical, max {int(level.max())} levels apart, "
        f"{far:.2e} of pixels more than 2 apart")
    log(f"  embeddings: min cosine image {img_cos:.7f}, text {txt_cos:.8f} (K4 alone plain: "
        f"{txt_k4:.8f}); "
        f"max |logit difference| {d_logit:.4e} (logits up to {float(k_logits.abs().max()):.3f})")
    log(f"  scores (reported): max relative difference {rel:.3e}; argmax kernel "
        f"{int(k_scores.argmax())}, plain {int(p_scores.argmax())}")
    # No pixel may be more than 2 levels apart unless it is explained: its
    # crop ray is one of K1's flagged rays (phase 3 held them, on the same
    # clip group), or it is a tie: K1's two inputs agree within K1_TOL, yet
    # the composite's depth test or its alpha cut (alpha_u8 < 130) falls the
    # other way, and the plain input lies within K1_TOL of that threshold.
    with torch.inference_mode():
        T_WC_g, rows_g, cols_g, dirs_g = combined.crop_rays(dirs_cam, K, obj_aabb, crop, T_WO,
                                                            T_WC, group)
        march_g = (mk.pack_params(field), T_WC_g[:, :3, 3], dirs_g, obj_aabb, crop_settings)
        fg_k = mk.march_rays_fused(*march_g)
        with mock.patch.object(mk, "march", mk.march_plain_live):
            fg_p = mk.march_rays_fused(*march_g)
    shp = (group.shape[0], crop, crop)
    bg_c = combined.BackgroundView(rgb=bg.rgb[rows_g, cols_g], alpha=bg.alpha[rows_g, cols_g],
                                   depth=bg.depth[rows_g, cols_g])
    pidx = torch.arange(shp[0], device=dev)[:, None, None]

    def cuts(o):
        """The composite's two decisions on crop inputs o, and the plain
        distances to their thresholds."""
        img = combined.composite_one(o["rgb"].reshape(*shp, 3), o["alpha"].reshape(shp),
                                     o["depth"].reshape(shp), bg_c)
        fg_d = o["depth"].reshape(shp)
        fg_d = torch.where(fg_d < 0.05, torch.full_like(fg_d, 100.0), fg_d)
        bg_d = torch.where(bg_c.depth < 0.05, torch.full_like(bg_c.depth, 100.0), bg_c.depth)
        near = fg_d < bg_d
        alpha = torch.where(near, o["alpha"].reshape(shp), bg_c.alpha)
        cut = (torch.clamp(alpha, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8) < 130
        return img, near, cut, (fg_d - bg_d).abs(), (alpha - 129.5 / 255.0).abs()

    img_k, near_k, cut_k, _, _ = cuts(fg_k)
    img_p, near_p, cut_p, d_dist, a_dist = cuts(fg_p)
    if not (torch.equal(img_k, k_renders[pidx, rows_g, cols_g])
            and torch.equal(img_p, p_renders[pidx, rows_g, cols_g])):
        raise AssertionError("main vs plain: the crops recomposited are not the renders")
    lvl_c = level[pidx, rows_g, cols_g]
    bad = lvl_c > 2
    flat = lambda o: (o["rgb"].reshape(-1, 3), o["alpha"].reshape(-1), o["depth"].reshape(-1))  # noqa: E731
    on_flag = torch.stack(k1_gaps(flat(fg_k), flat(fg_p)), 1).amax(1).reshape(shp) > K1_TOL
    depth_tie = bad & ~on_flag & (near_k != near_p)
    alpha_tie = bad & ~on_flag & (near_k == near_p) & (cut_k != cut_p)
    unexplained = bad & ~on_flag & ~depth_tie & ~alpha_tie
    tie_dist = max([float(d_dist[depth_tie].max()) if bool(depth_tie.any()) else 0.0,
                    float(a_dist[alpha_tie].max()) if bool(alpha_tie.any()) else 0.0])
    log(f"  pixels more than 2 levels apart: {int(bad.sum())} (all inside the crops: "
        f"{int((level > 2).sum())}); on K1's flagged rays {int((bad & on_flag).sum())}, depth "
        f"ties {int(depth_tie.sum())}, alpha-cut ties {int(alpha_tie.sum())} (plain input at "
        f"most {tie_dist:.3e} from the threshold), unexplained {int(unexplained.sum())}")
    if (same_px < 0.999 or int((level > 2).sum()) != int(bad.sum())
            or bool(unexplained.any()) or tie_dist > K1_TOL):
        raise AssertionError("main vs plain: the renders differ")
    # The plain side rounds each tower layer once from f32 products (cuBLAS
    # SGEMM), the kernels from the tensor cores' sums: the two sums' rounding
    # flips run through the text tower's layers as through the image
    # tower's (0.99994 and 0.99992 measured on an H100). K4 alone against
    # its plain version, the rest on the kernels, is held at 0.99999.
    if img_cos < 0.9995 or txt_cos < 0.9999 or txt_k4 < 0.99999:
        raise AssertionError("main vs plain: the embeddings differ")
    if d_logit > 0.1:
        raise AssertionError(f"main vs plain: logits differ by {d_logit}")
    if not (bool(torch.isfinite(p_scores).all()) and bool(torch.isfinite(k_scores).all())):
        raise AssertionError("main vs plain: scores are not finite")

    # ----------------------------------------------------- 5 grid scorer
    phase("5 grid scorer (optimise_pose_grid, CombinedRenderer, ClipScorer)")
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    renderer = combined.CombinedRenderer(
        field, field, settings=settings, res=res, intrinsics=K, row_chunk=56, obj_aabb=obj_aabb,
        fg_crop=crop, out_render_path=os.path.join(out_dir, "cb_render"),
    )
    scorer = ClipScorer(clip, batch_size=clip_batch)

    class Obj:
        pose = T_WO.cpu().numpy()

    class SceneModel:
        scene_centre = scene.centre
        opt_cam_poses = [cams[0].astype(np.float32)]

    class TaskModel:
        """A duck-typed task model, as the tests use."""
        scene_model = SceneModel
        goal_caption, norm_captions = captions[0], captions[1:]
        movable_obj = Obj
        # Nonzero outside the movable object: render_background pushes its
        # pixels of the scan's depth to 100, the depth phase 3 built by hand.
        movable_masks = (inst != 1)[None]

        @staticmethod
        def free_visual_models():
            pass

    res5 = [32, 16, 1, 1, 1, 1]
    grid5 = sample_poses_grid(scene.centre, res5, scene_type=3).reshape(-1, 4, 4)
    want5 = torch.cat([score_fn(*args3, torch.as_tensor(grid5[s : s + dispatch], device=dev))
                       for s in range(0, len(grid5), dispatch)]).cpu().numpy()
    groups5 = len(grid5) // clip_batch

    def drive(save, sample_res=res5, phys_check=None):
        for fn in wrappers.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0_ = time.perf_counter()
        best_, batch_, scores_ = scoring.optimise_pose_grid(
            renderer, gt_depth[None], [0], TaskModel, out_dir, sample_res=sample_res,
            scene_type=3, clip_scorer=scorer, tokenizer=hash_tokenize, save_renders=save,
            phys_check=phys_check,
        )
        torch.cuda.synchronize()
        return (best_, batch_, scores_, dict(scoring.LAST_RUN_INFO),
                {k: fn.launches for k, fn in wrappers.items()}, time.perf_counter() - t0_)

    runs5 = {}
    for save in (False, True):
        best5, batch5, scores5, info5, launches5, wall5 = runs5[save] = drive(save)
        t_fused = info5["stage_s"]["fused_score"]
        log(f"  save_renders={save}: {len(grid5)} poses, fused_score {t_fused:.2f} s = "
            f"{len(grid5) / t_fused:.1f} poses/s (dispatch_s {info5['dispatch_s']}, drain_s "
            f"{info5['drain_s']}, peak pending {info5['peak_pending_mb']} MB, {info5['n_slabs']} "
            f"slabs of {info5['slab']}); the whole call {wall5:.2f} s, stages {info5['stage_s']}; "
            f"launches {launches5} ({name}; {smi})")
        if info5["n_slabs"] != 2 or info5["mesh_devices"] != 1 or info5["n_poses"] != len(grid5):
            raise AssertionError(f"grid scorer: LAST_RUN_INFO {info5}")
        # One K1 launch a clip group and one for best_render.png; K2 (and
        # K3 beneath it) in 23 blocks a group; K4 once a text layer.
        want_launches = {"march (K1)": groups5 + 1, "ln_qkv_attention (K2)": 23 * groups5,
                         "attention_qkv (K3)": 23 * groups5,
                         "attention_causal (K4)": clip_cfg.text_layers,
                         **tower_launches(groups5)}
        if launches5 != want_launches:
            raise AssertionError(f"grid scorer: launches {launches5} != {want_launches}")
        if not np.array_equal(batch5.reshape(-1, 4, 4), grid5):
            raise AssertionError("grid scorer: pose_batch is not the sampled grid")
        if not np.array_equal(info5["raw_scores"], want5):
            raise AssertionError(
                "grid scorer: raw scores differ from make_imagine_and_score's, max "
                f"{np.abs(info5['raw_scores'] - want5).max()}")
        sm5 = spatially_smooth_heatmap(torch.as_tensor(want5, device=dev), res5).cpu().numpy()
        if not (np.array_equal(scores5, sm5) and info5["best_idx"] == int(sm5.argmax())
                and np.array_equal(best5, grid5[int(sm5.argmax())])):
            raise AssertionError("grid scorer: smoothed scores or the best pose are off")
    if not np.array_equal(runs5[False][3]["raw_scores"], runs5[True][3]["raw_scores"]):
        raise AssertionError("grid scorer: scores differ with and without save_renders")
    log("  raw scores bit-identical with and without save_renders, and equal to "
        "make_imagine_and_score's on the same poses")
    files = sorted(os.listdir(renderer.out_render_path))
    if files != [f"cb_rgb_{i:04d}.png" for i in range(len(grid5))]:
        raise AssertionError(f"grid scorer: cb_render holds {len(files)} files")
    pick = 300
    again = renderer.render(grid5[pick : pick + 1], cams[:1], [0], depths_gt=gt_depth[None],
                            movable_masks=TaskModel.movable_masks, T_WO_1=Obj.pose)[0]
    if not np.array_equal(read_png(os.path.join(renderer.out_render_path, files[pick])), again):
        raise AssertionError("grid scorer: a saved PNG does not decode to its render")
    best_png = read_png(os.path.join(out_dir, "best_render.png"))
    if not np.array_equal(best_png, read_png(os.path.join(
            renderer.out_render_path, files[runs5[True][3]["best_idx"]]))):
        raise AssertionError("grid scorer: best_render.png is not the winning pose's render")
    log(f"  {len(files)} cb_render PNGs and best_render.png written; cb_rgb_{pick:04d}.png "
        f"decodes to its render")
    # The same saving run with two writer threads: one slab each to encode.
    os.environ["D2R_WRITER_THREADS"] = "2"
    try:
        *_, info_w2, _, wall_w2 = drive(True)
    finally:
        del os.environ["D2R_WRITER_THREADS"]
    t_w1, t_w2 = runs5[True][3]["stage_s"]["fused_score"], info_w2["stage_s"]["fused_score"]
    log(f"  save_renders=True, D2R_WRITER_THREADS=2: fused_score {t_w2:.2f} s = "
        f"{len(grid5) / t_w2:.1f} poses/s (one thread {t_w1:.2f} s; dispatch_s "
        f"{info_w2['dispatch_s']}, drain_s {info_w2['drain_s']}); the whole call {wall_w2:.2f} s")
    if not np.array_equal(info_w2["raw_scores"], want5):
        raise AssertionError("grid scorer: scores differ with two writer threads")
    if sorted(os.listdir(renderer.out_render_path)) != files:
        raise AssertionError("grid scorer: two writer threads left other files")
    os.environ["D2R_ATTN_FUSED_LN"] = "0"
    try:
        *_, info0, launches0, _ = drive(False, [16, 16, 1, 1, 1, 1])
    finally:
        os.environ["D2R_ATTN_FUSED_LN"] = "1"
    log(f"  D2R_ATTN_FUSED_LN=0, 256 poses in one slab: launches {launches0}")
    want0 = tower_launches(256 // clip_batch, split=True)
    if (info0["n_slabs"] != 1 or launches0["ln_qkv_attention (K2)"] != 0
            or {k: launches0[k] for k in want0} != want0
            or launches0["attention_qkv (K3)"] != 23 * (256 // clip_batch)):
        raise AssertionError(f"grid scorer, split attention path: {info0}, {launches0}")
    # The same grid through phase P's validity check (its models: the lazy
    # two-body build of phase T's scan), as the engine filters it.
    from dream2real_tpu_torch.physics.collision import make_unsupcol_check

    check5 = make_unsupcol_check(phys["bg"].tsdf, phys["fg"].points, phys["init"], scene.centre,
                                 res5, device=dev)
    seen5 = []

    def phys_check5(pose_batch_):
        mask_ = check5(pose_batch_)
        seen5.append(mask_.cpu().numpy())
        return mask_

    *_, info_p, launches_p, wall_p = drive(False, phys_check=phys_check5)
    mask5 = seen5[0]
    cpu_check5 = make_unsupcol_check(phys["bg"].tsdf.to("cpu"), phys["fg"].points, phys["init"],
                                     scene.centre, res5, device="cpu")
    n_diff5, gap5 = masks_against_cpu(cpu_check5, grid5.reshape(-1, 16), mask5)
    raw_p, raw_u = info_p["raw_scores"], runs5[False][3]["raw_scores"]
    same5 = bool(np.array_equal(raw_p[mask5], raw_u[mask5]))
    gap_s = float(np.abs(raw_p[mask5] - raw_u[mask5]).max()) if mask5.any() else 0.0
    log(f"  phys_check=make_unsupcol_check(...): {int(mask5.sum())} of {len(grid5)} poses "
        f"passed pre-render checks; card vs CPU masks: {n_diff5} differences (ties, least "
        f"|sample - 0.5| at most {gap5:.1e}); fused_score {info_p['stage_s']['fused_score']:.2f} "
        f"s, phys_check {info_p['stage_s']['phys_check']:.2f} s, the whole call {wall_p:.2f} s; "
        f"raw scores at the valid poses against the unmasked run's: "
        + ("bit-identical" if same5 else f"max |difference| {gap_s:.3e} (phase 4's logit gap "
           f"{d_logit:.3e})"))
    if len(seen5) != 1 or not 0 < mask5.sum() < len(grid5) or np.any(raw_p[~mask5] != 0):
        raise AssertionError("grid scorer with physics: the mask or the scores are off")
    if not same5 and gap_s > d_logit:
        raise AssertionError(f"grid scorer with physics: scores at the valid poses move by "
                             f"{gap_s} (phase 4's logit gap {d_logit})")

    # ------------------------------------------------------------ M mesh
    phase(f"M mesh ({MESH_SHARDS} shards: scoring, the grid scorer, the shelf check, a "
          "training step)")
    mesh_phase(dev, smi, {
        "info5": info_p, "make_args": (ngp_cfg, clip_cfg, settings, dirs_cam),
        "make_kwargs": dict(n_norm_captions=2, clip_batch=clip_batch, obj_aabb=obj_aabb,
                            fg_crop=crop, intrinsics=K),
        "score_args": (*args3, poses), "renderer": renderer, "scorer": scorer,
        "task": TaskModel, "grid": grid5, "cams": cams, "gt_depth": gt_depth,
        "out_dir": out_dir, "phys": phys, "st": st, "field": field_t})
    shutil.rmtree(out_dir, ignore_errors=True)

    # ------------------------------------------------------------ E engine
    phase("E engine (the scan, the demo from scan to goal pose, the argmax oracle)")
    ctx = engine_phase(dev, smi, clip, clip_cfg, {**wrappers, **train_fns})

    # ------------------------------------------------------------ N ingest
    phase("N native ingest (native/d2r_native.cpp) against the codec on phase E's scan")
    ingest_phase(ctx)

    # ------------------------------------------------------------ V periphery
    phase("V periphery (the pcd ablation, the gui replay, hole inpainting) on phase E's scan")
    periphery_phase(dev, smi, {**wrappers, **train_fns}, ctx)
    shutil.rmtree(ctx["root"], ignore_errors=True)

    # ------------------------------------------------------------ H hash grid
    phase("H hash-grid field (16 levels, F 2, 2^19 entries, 16-2048; hidden 64)")
    h1_launches = hashgrid_phase(dev, smi, st, field_t, {
        "renderer": dict(settings=settings, res=res, intrinsics=K, row_chunk=56,
                         obj_aabb=obj_aabb, fg_crop=crop),
        "render": dict(valid_poses=grid5[:clip_batch], render_poses=cams[0][None],
                       render_cam_pose_idx=[0], depths_gt=gt_depth[None],
                       movable_masks=(inst != 1)[None], T_WO_1=T_WO.cpu().numpy())})
    for k in kernels:
        if k["name"] in H1_NAMES:
            k["launches"] = h1_launches[H1_NAMES.index(k["name"])]

    # --------------------------------------------------- R reference scale
    phase("R reference scale (run_refscale: 70,000 poses; run_shelfscale: 2,211,840)")
    refscale_phase(dev, smi, {**wrappers, **train_fns})

    # --------------------------------------------------- X extrinsics
    phase(f"X extrinsics refinement (extr_grad_ab at {X_LEVEL[0]:g} deg / {X_LEVEL[1]:g} mm, "
          f"{X_STEPS} steps, both arms)")
    extrinsics_phase(dev, smi, {**wrappers, **train_fns})

    # ------------------------------------------------------------ results
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
