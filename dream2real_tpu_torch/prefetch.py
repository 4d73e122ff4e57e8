"""Scoring-setup prefetch: the parts of imagine-and-score that do not need
the trained task fields run in a background thread while those fields train
(port of dream2real_tpu/prefetch.py).

- the physics check over the candidate grid (``make_unsupcol_check``, the
  grid and its validity mask), since the physics models exist before the
  fields train;
- the fg-crop clipping guard over the physics-valid candidates;
- the CLIP load (the engine's loader, under its lock) and the text
  embeddings.

The thread's device work goes on a side stream of its own and ends on an
event that the thread waits for, so the training loop on the default stream
takes no wait from it. Its results equal the serial path's bit for bit: the
same functions on the same inputs. The JAX package also warms its jit caches
here with renderers of dummy parameters; the port compiles nothing on the
side, so that part has no counterpart. A failure in the thread is reported
and the consumers take the serial path.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Optional

import numpy as np
import torch

from dream2real_tpu_torch.device import to_numpy


class ScoringPrefetch:
    """Handle of the background setup thread. ``result()`` joins it and
    returns the prefetch dict, or None when the thread failed."""

    def __init__(self):
        self._box: dict = {}
        self._thread: Optional[threading.Thread] = None

    def result(self, timeout: float = 1800.0):
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                print("# prefetch: still running past timeout; falling back")
                return None
        return self._box.get("out")


def start_scoring_prefetch(
    get_clip,
    goal_caption: str,
    norm_captions,
    use_templates: bool,
    res: int,
    clip_K: np.ndarray,
    obj_aabb,
    fg_crop: int,
    render_poses: Optional[np.ndarray],
    phys: Optional[dict] = None,
    scoring: bool = True,
    device=None,
) -> ScoringPrefetch:
    """Spawn the setup thread. ``phys``: optional dict(bg_phys=, fg_phys=,
    init_pose=, scene_centre=, sample_res=, scene_type=, bounds_override=,
    embodied=): the physics check is then built and evaluated over the real
    candidate grid. The consumer (``engine.dream_best_pose``) checks that
    each prefetched value was made for what it is about to use."""
    handle = ScoringPrefetch()
    dev = torch.device("cpu") if device is None else torch.device(device)

    def _run():
        t0 = time.time()
        out: dict = {}
        side = torch.cuda.Stream(device=dev) if dev.type == "cuda" else None
        ctx = torch.cuda.stream(side) if side is not None else contextlib.nullcontext()

        def _wait():
            if side is not None:
                side.record_event().synchronize()

        try:
            with ctx:
                if phys is not None:
                    from dream2real_tpu_torch.physics.collision import make_unsupcol_check
                    from dream2real_tpu_torch.sampling import sample_poses_grid

                    phys_check = make_unsupcol_check(
                        phys["bg_phys"].tsdf, phys["fg_phys"].points,
                        np.asarray(phys["init_pose"]), phys["scene_centre"],
                        phys["sample_res"], disallow_regrasp=phys["embodied"], device=dev,
                    )
                    pose_batch = np.asarray(sample_poses_grid(
                        phys["scene_centre"], phys["sample_res"], scene_type=phys["scene_type"],
                        bounds_override=phys["bounds_override"],
                    ))
                    is_valid = to_numpy(phys_check(pose_batch))
                    _wait()
                    out.update(phys_check=phys_check, phys_fg=phys["fg_phys"],
                               phys_bg=phys["bg_phys"],
                               phys_init_pose=np.asarray(phys["init_pose"]),
                               pose_batch=pose_batch, is_valid=is_valid)
                if not scoring:
                    print(f"# prefetch: physics done in {time.time() - t0:.1f}s", flush=True)
                    handle._box["out"] = out or None
                    return

                # The fg-crop guard over the physics-valid candidates, the
                # set optimise_pose_grid's own guard checks.
                crop = fg_crop
                if (obj_aabb is not None and crop and crop < res and render_poses is not None
                        and out.get("is_valid") is not None):
                    valid = out["pose_batch"][out["is_valid"]]
                    if len(valid):
                        from dream2real_tpu_torch.nerf.combined import required_crop

                        need = required_crop(obj_aabb, clip_K, res, out["phys_init_pose"],
                                             render_poses, valid)
                        if need > crop:
                            print(f"# prefetch fg_crop guard: valid candidates need {need}px, "
                                  f"growing window from {crop}px", flush=True)
                            crop = need
                out["obj_aabb"] = obj_aabb
                out["fg_crop"] = crop

                clip_scorer, tokenizer = get_clip()
                from dream2real_tpu_torch.clip.scorer import build_captions

                captions = build_captions(goal_caption, norm_captions, use_templates)
                txt = clip_scorer.text_embeddings(np.asarray(tokenizer(captions)))
                _wait()
                out.update(clip_scorer=clip_scorer, tokenizer=tokenizer, captions=captions,
                           txt=txt)
            print(f"# prefetch: scoring setup built in {time.time() - t0:.1f}s", flush=True)
            handle._box["out"] = out
        except Exception as e:  # the consumers take the serial path
            print(f"# prefetch failed (serial fallback): {type(e).__name__}: {e}", flush=True)
            handle._box["out"] = out or None

    t = threading.Thread(target=_run, name="scoring-prefetch", daemon=True)
    handle._thread = t
    t.start()
    return handle
