"""Grid pose optimisation: sample -> physics mask -> render -> CLIP -> argmax
(port of dream2real_tpu/scoring.py).

Flow and artifacts match the reference: cached-render replay from
cb_render/ + pose_scores.txt, the physics-only random-valid baseline, the
goal / mean(norm) logit ratio, the score scatter into the full grid, spatial
smoothing, argmax + best_render.png.

On one GPU: the fused path renders, composites and scores each slab of poses
on the device (``parallel/imagine.py``); nothing round-trips through the
host unless artifact saving is asked for. With ``save_renders`` each slab's
u8 composites are copied into pinned host memory on a side stream behind an
event and handed to a writer thread at once, which encodes the PNGs when the
event has passed, so the copy and the encode overlap the next slab's compute
(the reference hands a slab to its writer only when it drains it). The reference's
tail-warm thread (it compiled the tail's programs while the slabs ran) has
no counterpart: nothing is compiled here.

While a profiler runs (``utils/profiling.py``), a ``_fused_score`` call is a
``score.block`` span, timed on the device too, holding ``score.bg_render``
(device), a ``score.slab`` span a slab (holding each clip group's
``score.render`` and ``score.tower``, parallel/imagine.py) and
``score.drain``; ``score.poses`` and ``score.groups`` count its poses and
clip groups.
"""

from __future__ import annotations

import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from dream2real_tpu_torch.clip.scorer import build_captions
from dream2real_tpu_torch.device import F32
from dream2real_tpu_torch.parallel.imagine import make_imagine_and_score
from dream2real_tpu_torch.parallel.mesh import leads, score_mesh_for
from dream2real_tpu_torch.sampling import get_virtual_cam_poses, sample_poses_grid
from dream2real_tpu_torch.smoothing import spatially_smooth_heatmap
from dream2real_tpu_torch.utils.png import read_png, to_rgb, write_png
from dream2real_tpu_torch.utils.profiling import count, span

#: Observability: filled in by _fused_score with the dispatch decision of the
#: most recent run ("n_poses", "mesh_devices", "slab", "clip_batch",
#: "peak_pending_mb", "dispatch_s", "drain_s", "n_slabs"), then by
#: optimise_pose_grid with the score vectors ("raw_scores" before smoothing,
#: "smoothed_scores", "best_idx") and "stage_s", so that tests compare runs
#: on per-pose scores and not on an argmax that may flip on a tie.
LAST_RUN_INFO: dict = {}


def _to_numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _slab_spec(clip_batch: int, n_poses: int, device):
    """(mesh, slab, quantum) of a scoring run on ``device``. Dispatches pad
    to the quantum, ``n_dev * clip_batch``, so that each shard fills whole
    CLIP batches; D2R_SCORE_SLAB sets the slab (rounded down to a quantum
    multiple), by default 256 poses a device. The mesh is
    ``score_mesh_for``'s when it leads from ``device``."""
    mesh = leads(score_mesh_for(n_poses, clip_batch), device)
    n_dev = 1 if mesh is None else mesh.size
    q = n_dev * clip_batch
    slab = int(os.environ.get("D2R_SCORE_SLAB", "0")) // q * q
    if slab <= 0:
        slab = max(q, (256 * n_dev) // q * q)
    return mesh, slab, q


class _Slab:
    """One dispatched slab: its scores and (when saving) its renders, on
    their way to the host."""

    def __init__(self, start, n, scores, imgs, side):
        self.start, self.n = start, n
        self.done = None
        if side is None or imgs is None:
            # Nothing to stage: CPU tensors, or scores that are fetched
            # together after the last slab.
            self.scores, self.imgs = scores, imgs
            return
        # D2H of the slab into pinned memory on the side stream, behind the
        # slab's compute. The device buffers go back to the allocator once
        # the copy has run (record_stream), not when every slab has.
        ready = torch.cuda.current_stream(scores.device).record_event()
        with torch.cuda.stream(side):
            side.wait_event(ready)
            self.scores = torch.empty(scores.shape, dtype=scores.dtype, pin_memory=True)
            self.imgs = torch.empty(imgs.shape, dtype=imgs.dtype, pin_memory=True)
            self.scores.copy_(scores, non_blocking=True)
            self.imgs.copy_(imgs, non_blocking=True)
            self.done = side.record_event()
        scores.record_stream(side)
        imgs.record_stream(side)

    def wait(self):
        if self.done is not None:
            self.done.synchronize()


def _fused_score(
    renderer, clip_scorer, tokenizer, task_model, valid_poses, render_poses,
    depths_gt, movable_masks, T_WO_1, use_templates, save_renders=False,
    prefetch=None,
):
    """On-device render -> composite -> CLIP scoring of every valid pose.

    Dispatches in slabs padded to the CLIP batch; padding scores are
    discarded. save_renders=True streams each slab's u8 composites to
    renderer.out_render_path (cb_render/) from a writer thread.
    """
    with span("score.block", device=True):
        dev = renderer.device
        captions = build_captions(task_model.goal_caption, task_model.norm_captions, use_templates)
        n_norm = 0 if task_model.norm_captions is None else len(task_model.norm_captions)
        cb = min(32, clip_scorer.batch_size)
        save_dir = renderer.out_render_path if save_renders else None

        poses = np.asarray(valid_poses, np.float32).reshape(-1, 4, 4)
        k = len(poses)
        # Several devices: the pose batch shards over the mesh (parallel/mesh.py).
        mesh, slab, quantum = _slab_spec(cb, k, dev)
        n_dev = 1 if mesh is None else mesh.size
        LAST_RUN_INFO.clear()
        LAST_RUN_INFO.update(n_poses=k, mesh_devices=n_dev, slab=slab, clip_batch=cb)

        # Reuse prefetched text embeddings when they were made by this scorer
        # for this caption set, and a built score function when it was made for
        # exactly this renderer too.
        txt = score_fn = None
        if (
            prefetch is not None
            and prefetch.get("txt") is not None
            and prefetch.get("clip_scorer") is clip_scorer
            and prefetch.get("captions") == captions
        ):
            txt = prefetch["txt"]
            if (
                prefetch.get("score_fn") is not None
                and prefetch.get("renderer") is renderer
                and prefetch.get("score_fn_key")
                == (n_norm, use_templates, cb, save_dir is not None, n_dev)
            ):
                score_fn = prefetch["score_fn"]
        if txt is None:
            txt = clip_scorer.text_embeddings(np.asarray(tokenizer(captions)))
        if score_fn is None:
            score_fn = make_imagine_and_score(
                renderer.fg.cfg, clip_scorer.cfg, renderer.settings, renderer.dirs_cam,
                n_norm_captions=n_norm, use_templates=use_templates, clip_batch=cb,
                obj_aabb=renderer.obj_aabb, fg_crop=renderer.fg_crop,
                crop_settings=renderer.crop_settings, intrinsics=renderer.intrinsics,
                row_chunk=renderer.row_chunk, return_renders=save_dir is not None,
                mesh=mesh, device=dev,
            )
        with span("score.bg_render", device=True):
            bg = renderer.render_background(
                render_poses[0],
                None if depths_gt is None else depths_gt[0],
                None if movable_masks is None else movable_masks[0],
            )
        T_WC = torch.as_tensor(np.asarray(render_poses[0], np.float32), device=dev)
        T_WO = torch.as_tensor(np.asarray(T_WO_1, np.float32), device=dev)
        out = np.empty(k, np.float32)

        writer = futures = side = None
        if save_dir is not None:
            if os.path.exists(save_dir):
                shutil.rmtree(save_dir)
            os.makedirs(save_dir)
            if dev.type == "cuda":
                side = torch.cuda.Stream(device=dev)

            def _write(entry: _Slab):
                entry.wait()
                arr = entry.imgs.numpy()
                for j in range(entry.n):
                    write_png(os.path.join(save_dir, f"cb_rgb_{entry.start + j:04d}.png"), arr[j])

            # zlib releases the interpreter lock while it deflates, so
            # D2R_WRITER_THREADS > 1 encodes several slabs at once.
            writer = ThreadPoolExecutor(
                max_workers=max(1, int(os.environ.get("D2R_WRITER_THREADS", "1")))
            )
            futures = []

        # Dispatch every slab before fetching anything. Scores are tiny; the u8
        # render slabs leave the device on the side stream and go to the writer
        # as they are dispatched, under a pending-bytes cap, so that a
        # reference-scale run (70k poses are about 23 GB of renders) never holds
        # them all in device or pinned memory.
        pending: list[_Slab] = []
        peak_pending = 0
        img_bytes = slab * renderer.res * renderer.res * 3
        MAX_PENDING = int(os.environ.get("D2R_RENDER_PENDING_MB", "1536")) * 2**20
        t_dispatch0 = time.time()

        def _bound_backlog():
            # A slab's buffers (on the device until its copy has run, pinned on
            # the host until its files are written) live until the writer THREAD
            # is done with it. Retire finished slabs, then block on the oldest
            # while the backlog exceeds the cap: the host then dispatches no
            # faster than the encoder writes, which is the limit anyway, and
            # the renders in flight stay under the cap plus one slab.
            nonlocal peak_pending
            peak_pending = max(peak_pending, len(futures) * img_bytes)
            while futures and futures[0].done():
                futures.pop(0).result()
            while len(futures) * img_bytes > MAX_PENDING:
                futures.pop(0).result()

        # One H2D for the whole pose batch, sliced per slab on the device. The
        # tail is padded to the quantum with identity poses up front.
        pad_total = (-k) % quantum
        if pad_total:
            poses = np.concatenate(
                [poses, np.tile(np.eye(4, dtype=np.float32)[None], (pad_total, 1, 1))]
            )
        poses_dev = torch.as_tensor(poses, device=dev)
        count("score.poses", k)
        count("score.groups", len(poses) // cb)
        for s in range(0, k, slab):
            n = min(slab, k - s)
            with span("score.slab"):
                result = score_fn(
                    renderer.fg, clip_scorer.params, T_WO, T_WC, bg, txt,
                    poses_dev[s : s + min(slab, len(poses) - s)],
                )
            if save_dir is not None:
                pending.append(_Slab(s, n, *result, side))
                futures.append(writer.submit(_write, pending[-1]))
                _bound_backlog()
            else:
                pending.append(_Slab(s, n, result, None, None))
        t_drain0 = time.time()
        with span("score.drain"):
            if save_dir is None and pending:
                # One device-side concat and ONE D2H instead of a fetch per
                # slab. Each entry's valid prefix is sliced on the device, so
                # slabs that carry padding stay aligned.
                out[:] = _to_numpy(torch.cat([e.scores[: e.n] for e in pending]))
                pending.clear()
            for entry in pending:
                entry.wait()
                out[entry.start : entry.start + entry.n] = _to_numpy(entry.scores)[: entry.n]
            if writer is not None:
                for f in futures:
                    f.result()  # wait for the files; surface the writer threads' exceptions
                writer.shutdown()
        LAST_RUN_INFO["peak_pending_mb"] = round(peak_pending / 2**20, 1)
        LAST_RUN_INFO["dispatch_s"] = round(t_drain0 - t_dispatch0, 2)
        # From the last dispatch until every score is on the host and every
        # file is written.
        LAST_RUN_INFO["drain_s"] = round(time.time() - t_drain0, 2)
        LAST_RUN_INFO["n_slabs"] = -(-k // slab)
        return out


def optimise_pose_grid(
    renderer,
    depths_gt,
    render_cam_pose_idx,
    task_model,
    data_dir: str,
    sample_res=None,
    phys_check=None,
    use_templates: bool = False,
    scene_type: int = 0,
    use_vis_pcds: bool = False,
    use_cache_renders: bool = False,
    smoothing: bool = True,
    physics_only: bool = False,
    clip_scorer=None,
    tokenizer=None,
    bounds_override=None,
    seed: int = 0,
    save_renders: bool = True,
    prefetch=None,
):
    """Returns (best_pose (4, 4) np, pose_batch (N, 16) np, pose_scores (N,) np).

    Every single-view NeRF run takes the fused path (render -> composite ->
    CLIP on the device, slab by slab); save_renders streams cb_render/ from
    a writer thread, and without it the best render is rendered again
    afterwards for best_render.png. It runs on the renderer's device.
    ``phys_check`` is a callable (pose_batch (N, 16) np) -> (N,) validity;
    ``task_model`` is duck-typed as in the reference.
    """
    perf = os.environ.get("D2R_PERF_LOG") == "1"
    stage_s: dict = {}
    _t = time.time()

    def _lap(tag):
        nonlocal _t
        stage_s[tag] = round(time.time() - _t, 2)
        if perf:
            print(f"# optimise_pose_grid {tag}: {stage_s[tag]:.2f}s", flush=True)
        _t = time.time()

    if sample_res is None:
        sample_res = [40, 40, 1, 1, 1, 1]
    scene_model = task_model.scene_model
    pose_batch = np.asarray(
        sample_poses_grid(
            scene_model.scene_centre, sample_res, scene_type=scene_type,
            bounds_override=bounds_override,
        )
    )
    n = pose_batch.shape[0]
    _lap("sample_grid")

    if use_cache_renders:
        print("Using cached renders")
        old_scores = np.loadtxt(os.path.join(data_dir, "pose_scores.txt"))
        valid_idxs = np.nonzero(old_scores)[0]
        valid_poses = pose_batch[valid_idxs]
        render_dir = os.path.join(data_dir, "cb_render")
        renders = np.stack([to_rgb(read_png(os.path.join(render_dir, f)))
                            for f in sorted(os.listdir(render_dir))])
        assert len(renders) == len(valid_poses), (
            f"Expected {len(valid_poses)} renders, got {len(renders)}. "
            "Try running without use_cache_renders."
        )
    else:
        print("Running pre-render checks...")
        if (
            prefetch is not None
            and phys_check is not None
            and prefetch.get("is_valid") is not None
            and np.array_equal(prefetch.get("pose_batch"), pose_batch)
        ):
            is_valid = prefetch["is_valid"]  # computed during training
        elif phys_check is not None:
            is_valid = _to_numpy(phys_check(pose_batch))
        else:
            is_valid = np.ones(n, bool)
        valid_idxs = np.nonzero(is_valid)[0]
        valid_poses = pose_batch[valid_idxs]
        _lap("phys_check")
        print(
            f"Of {n} sampled poses, {len(valid_idxs)} passed pre-render checks "
            f"({100 * len(valid_idxs) / n:.2f}%)."
        )
        if len(valid_idxs) == 0:
            raise Exception("No poses passed pre-render checks. Exiting.")

        if physics_only:
            print("Physics only method")
            ridx = np.random.default_rng(seed).integers(len(valid_idxs))
            best = valid_poses[ridx].reshape(4, 4)
            return best, pose_batch, np.ones(n, np.float32)

        render_poses = get_virtual_cam_poses(scene_model.opt_cam_poses, render_cam_pose_idx)
        movable_masks = np.asarray(task_model.movable_masks)[list(render_cam_pose_idx)]
        T_WO_1 = np.asarray(task_model.movable_obj.pose)

        # fg_crop clipping guard: if a candidate's projected extent exceeds
        # the crop window, grow the window rather than lose fg pixels.
        if not use_vis_pcds and getattr(renderer, "fg_crop", 0):
            need = renderer.crop_required(T_WO_1, render_poses, valid_poses)
            if need > renderer.fg_crop:
                print(
                    f"# fg_crop guard: projected extent needs {need}px, window "
                    f"is {renderer.fg_crop}px: growing"
                )
                renderer.bump_crop(need)
                if prefetch is not None:
                    # The prefetched score function holds the old crop size.
                    prefetch = dict(prefetch)
                    prefetch.pop("score_fn", None)
                    prefetch.pop("score_fn_key", None)

        # The fused path needs a real ClipScorer (it runs the image tower).
        fused = (
            not use_vis_pcds
            and len(render_cam_pose_idx) == 1
            and hasattr(renderer, "render_background")
            and hasattr(clip_scorer, "params")
        )
        if fused:
            print(f"Fused imagine-and-score over {len(valid_poses)} poses...")
            scores_valid = _fused_score(
                renderer, clip_scorer, tokenizer, task_model, valid_poses,
                render_poses, depths_gt, movable_masks, T_WO_1, use_templates,
                save_renders=save_renders, prefetch=prefetch,
            )
            renders = None
            _lap("fused_score")
        elif use_vis_pcds:
            # The point-cloud ablation renderer's signature.
            print(f"Rendering {len(valid_poses)} imagined scenes (pcd)...")
            renders = np.stack(
                renderer.render(render_poses[0], valid_poses, task_model, hide_movable=False)
            )
        else:
            print(f"Rendering {len(valid_poses)} imagined scenes...")
            renders = renderer.render(
                valid_poses,
                render_poses,
                render_cam_pose_idx,
                depths_gt=depths_gt,
                movable_masks=movable_masks,
                T_WO_1=T_WO_1,
                save=save_renders,
            )

    task_model.free_visual_models()  # lifecycle parity with the reference

    if renders is not None:
        print("Evaluating rendered images using CLIP...")
        scores_valid = clip_scorer.score(
            renders,
            task_model.goal_caption,
            task_model.norm_captions,
            tokenizer,
            use_templates=use_templates,
        )

    pose_scores = np.zeros(n, np.float32)
    pose_scores[valid_idxs] = scores_valid
    render_idxs = np.zeros(n, np.int64)
    render_idxs[valid_idxs] = np.arange(len(valid_idxs))
    LAST_RUN_INFO["raw_scores"] = pose_scores.copy()

    if smoothing:
        print("Applying spatial smoothing...")
        dev = getattr(renderer, "device", None) or getattr(clip_scorer, "device", None) or "cpu"
        pose_scores = _to_numpy(
            spatially_smooth_heatmap(torch.as_tensor(pose_scores, dtype=F32, device=dev),
                                     sample_res)
        )
        _lap("smoothing")
    LAST_RUN_INFO["smoothed_scores"] = pose_scores.copy()

    best_pose_idx = int(np.argmax(pose_scores))
    LAST_RUN_INFO["best_idx"] = best_pose_idx
    best_pose = valid_poses[render_idxs[best_pose_idx]]
    if renders is not None:
        best_render = renders[render_idxs[best_pose_idx]]
    else:
        # Fused path: render just the winning pose again for the artifact.
        best_render = renderer.render(
            best_pose[None],
            get_virtual_cam_poses(scene_model.opt_cam_poses, render_cam_pose_idx),
            render_cam_pose_idx,
            depths_gt=depths_gt,
            movable_masks=np.asarray(task_model.movable_masks)[list(render_cam_pose_idx)],
            T_WO_1=np.asarray(task_model.movable_obj.pose),
            save=False,
        )[0]
    _lap("best_render")

    write_png(os.path.join(data_dir, "best_render.png"), np.asarray(best_render))
    _lap("artifacts")
    LAST_RUN_INFO["stage_s"] = stage_s
    return best_pose.reshape(4, 4), pose_batch, pose_scores
