"""Traffic: a task's candidate pose grid through the port's scoring loop.

Set-up does what is done once a task: the fields' and CLIP's weights from
the seed, the render view's scan (depth and the movable object's mask), the
text embeddings (through ``prefetch.start_scoring_prefetch``), the score
function, the crop guard over the whole grid, and one warm block. The
window then hands consecutive blocks of the grid, in its own order from
pose 0, to ``scoring._fused_score``, the slab loop that
``optimise_pose_grid`` runs (each block renders its background view, then
renders, composites and CLIP-scores its slabs on the device). It runs until
``--seconds`` have passed, finishes the block under way, and the rate is all
poses scored over all of that time.

The traced run profiles ``trace.blocks`` blocks, then times the render
alone and the tower alone over ``trace.split_groups`` clip groups of the
traced poses with CUDA events, and counts the samples the first traced
group's rays need with the reference's march. Then, as in every run, the
check: the program's scores of ``check.poses`` poses drawn from the seed
among those it scored, against the reference's.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import statistics
import types
from unittest import mock

import numpy as np

from benchmark import harness, scene
from benchmark.profile import traced
from benchmark.reference import clip as ref_clip
from benchmark.reference import compare
from benchmark.reference import field as ref_field
from benchmark.reference import scoring as ref_scoring
from benchmark.reference.precision import REFERENCE, CONTROL, Precision
from benchmark.timing import span_ms


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


class Session:
    """One cell's set-up: the inputs the benchmark made, the program's
    objects built from them, and what the window scored."""

    def __init__(self, ctx: harness.RunContext):
        import torch

        self.torch = torch
        self.ctx = ctx
        self.stages = harness.Stages(ctx)
        self.dev = dev = ctx.device
        cfg, tr = ctx.cell.config, ctx.cell.traffic
        self.fcfg, self.ccfg = cfg["field"], cfg["clip"]
        eng = cfg["engine"]
        self.res, self.cb = eng["render_res"], eng["clip_batch"]
        self.settings_d = dict(cfg["render"])
        self.crop_d = dict(self.settings_d, n_coarse=eng["crop_samples"], n_fine=0)
        self.block = tr["block_poses"]

        # ---- inputs, from the seed
        gen = torch.Generator(device=dev).manual_seed(ctx.seed)
        self.K = scene.clip_view_intrinsics(cfg["camera"], self.res)
        sc = cfg["scan"]
        self.T_WC = scene.orbit(sc["views"], sc["radius"], sc["height"])[
            eng["render_cam_pose_idx"]]
        _, depth, inst = scene.render_tabletop(torch, self.T_WC[None], self.K, self.res,
                                               self.res, dev)
        self.gt_depth = depth
        self.movable = (inst != 1).to(torch.float32)  # nonzero outside the movable object
        lo, hi, _ = scene.BOXES[0]
        pad = eng["obj_pad"]
        self.obj_aabb = (tuple(v - pad for v in lo), tuple(v + pad for v in hi))
        self.T_WO_1 = np.eye(4, dtype=np.float32)
        self.T_WO_1[:3, 3] = (np.asarray(lo) + np.asarray(hi)) / 2
        self.fg_w = scene.field_weights(torch, gen, self.fcfg, dev)
        self.bg_w = scene.field_weights(torch, gen, self.fcfg, dev)
        self.clip_w = scene.clip_weights(torch, gen, self.ccfg, dev)
        caps = tr["captions"]
        self.goal, self.norm = caps["goal"], caps["norm"]
        self.tokenizer = functools.partial(scene.hash_tokenize,
                                           context_length=self.ccfg["context_length"],
                                           vocab_size=self.ccfg["vocab_size"])
        g = tr["grid"]
        self.poses = scene.pose_grid(g["sample_res"], g["bounds"])
        self.scored: list = []  # (indices, scores) of every block the window scored
        self.stages("inputs")
        self._build_program(eng)

    def _build_program(self, eng: dict) -> None:
        torch = self.torch
        from dream2real_tpu_torch import build
        from dream2real_tpu_torch.clip.model import CLIPConfig, CLIPModel
        from dream2real_tpu_torch.clip.scorer import ClipScorer
        from dream2real_tpu_torch.nerf.combined import CombinedRenderer, required_crop
        from dream2real_tpu_torch.nerf.model import NGPConfig, NGPField
        from dream2real_tpu_torch.nerf.render import RenderSettings
        from dream2real_tpu_torch.parallel.imagine import make_imagine_and_score
        from dream2real_tpu_torch.prefetch import start_scoring_prefetch

        if self.dev.type == "cuda":
            build.build_all()
        self.stages("kernels")
        ngp = NGPConfig(**_tuples(self.fcfg))
        fields = []
        for w in (self.fg_w, self.bg_w):
            f = NGPField(ngp, device="meta")
            f.load_state_dict(w, assign=True)
            fields.append(f)
        clip = CLIPModel(CLIPConfig(**self.ccfg), device="meta")
        clip.load_state_dict(self.clip_w, assign=True)
        settings = RenderSettings(**{k: self.settings_d[k] for k in
                                     ("n_coarse", "n_fine", "near", "far", "min_transmittance")})
        crop_settings = settings._replace(n_coarse=eng["crop_samples"], n_fine=0)
        self.renderer = CombinedRenderer(
            fields[0], fields[1], settings=settings, res=self.res, intrinsics=self.K,
            obj_aabb=self.obj_aabb, fg_crop=eng["fg_crop"], crop_settings=crop_settings,
            device=self.dev)
        # The engine's crop guard, over every pose of the grid.
        need = required_crop(self.obj_aabb, self.K, self.res, self.T_WO_1, self.T_WC[None],
                             self.poses)
        if need > self.renderer.fg_crop:
            self.renderer.bump_crop(need)
        self.scorer = ClipScorer(clip, batch_size=self.cb)
        self.tm = types.SimpleNamespace(goal_caption=self.goal, norm_captions=self.norm)
        pf = start_scoring_prefetch(
            lambda: (self.scorer, self.tokenizer), self.goal, self.norm, False, self.res,
            self.K, self.obj_aabb, self.renderer.fg_crop, self.T_WC[None], phys=None,
            device=self.dev).result()
        if pf is None or pf.get("txt") is None:
            raise RuntimeError("the scoring prefetch made no text embeddings")
        n_norm = len(self.norm)
        cb = min(32, self.scorer.batch_size)
        pf.update(
            renderer=self.renderer, score_fn_key=(n_norm, False, cb, False, 1),
            score_fn=make_imagine_and_score(
                ngp, clip.cfg, settings, self.renderer.dirs_cam, n_norm_captions=n_norm,
                use_templates=False, clip_batch=cb, obj_aabb=self.obj_aabb,
                fg_crop=self.renderer.fg_crop, crop_settings=crop_settings,
                intrinsics=self.renderer.intrinsics, row_chunk=self.renderer.row_chunk,
                return_renders=False, device=self.dev))
        self.prefetch = pf
        self.clip = clip
        self.stages("program")

    def score_block(self, idx: np.ndarray) -> np.ndarray:
        from dream2real_tpu_torch import scoring

        return scoring._fused_score(
            self.renderer, self.scorer, self.tokenizer, self.tm, self.poses[idx],
            self.T_WC[None], self.gt_depth, self.movable, self.T_WO_1, False,
            save_renders=False, prefetch=self.prefetch)

    def sync(self) -> None:
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize(self.dev)

    def blocks(self, n_blocks=None, seconds=None):
        """Score consecutive blocks from pose 0: ``n_blocks`` of them, or
        until ``seconds`` have passed (the block under way finished). ->
        (poses scored, seconds)."""
        t0 = harness.now()
        pos, done, times = 0, 0, []
        while True:
            idx = np.arange(pos, pos + self.block) % len(self.poses)
            t = harness.now()
            self.scored.append((idx, self.score_block(idx)))
            times.append(harness.now() - t)
            pos += self.block
            done += self.block
            if n_blocks is not None and done >= n_blocks * self.block:
                break
            if seconds is not None and harness.now() - t0 >= seconds:
                break
        self.ctx.log("block seconds: " + " ".join(f"{t:.3f}" for t in times))
        return done, harness.now() - t0

    # ------------------------------------------------------------ traced run

    def layer_spans(self, groups: int) -> dict:
        """The render alone and the tower alone, each over ``groups`` clip
        groups of the traced poses (bench_split's method)."""
        torch = self.torch
        from dream2real_tpu_torch.clip.model import encode_image, logits_per_image, \
            preprocess_images
        from dream2real_tpu_torch.clip.scorer import reduce_logits
        from dream2real_tpu_torch.nerf.combined import background_only_image, render_pose_batch
        from dream2real_tpu_torch.nerf.march_kernel import pack_params

        r, dev = self.renderer, self.dev
        idx = self.scored[0][0][: groups * self.cb]
        poses = torch.as_tensor(self.poses[idx], device=dev)
        chunks = [poses[s : s + self.cb] for s in range(0, len(idx), self.cb)]
        K = torch.as_tensor(r.intrinsics, dtype=torch.float32, device=dev)
        box = tuple(torch.as_tensor(v, dtype=torch.float32, device=dev) for v in r.obj_aabb)
        T_WO = torch.as_tensor(self.T_WO_1, device=dev)
        T_WC = torch.as_tensor(self.T_WC, device=dev)
        txt = self.prefetch["txt"]
        with torch.inference_mode():
            bg = r.render_background(self.T_WC, self.gt_depth[0], self.movable[0])
            bg_only = background_only_image(bg)
            packed = pack_params(r.fg)

            def render(p):
                return render_pose_batch(r.fg, r.settings, r.crop_settings, r.dirs_cam, K, box,
                                         r.fg_crop, 0, T_WO, T_WC, bg, bg_only, p, packed=packed)

            def tower(frames):
                img = preprocess_images(torch.rot90(frames, k=1, dims=(1, 2)), self.clip.cfg)
                lg = logits_per_image(self.clip, encode_image(self.clip, img), txt)
                return reduce_logits(lg, len(self.norm), False)

            frames = [render(p) for p in chunks]
            render_ms = span_ms(torch, render, chunks, dev)
            tower_ms = span_ms(torch, tower, frames, dev)
        return {"render_ms": render_ms, "tower_ms": tower_ms, "poses": len(idx)}

    def release(self) -> None:
        """Drop the program's objects; the benchmark's inputs stay."""
        for name in ("renderer", "scorer", "prefetch", "clip"):
            setattr(self, name, None)
        gc.collect()
        if self.dev.type == "cuda":
            self.torch.cuda.empty_cache()

    # ------------------------------------------------------------ the check

    # ------------------------------------------------------------ the check

    def reference_inputs(self) -> dict:
        torch = self.torch
        ids = self.tokenizer([self.goal] + list(self.norm))
        return {
            "field_cfg": self.fcfg, "clip_cfg": self.ccfg, "fg_w": self.fg_w,
            "bg_w": self.bg_w, "clip_w": self.clip_w,
            "T_WC": torch.as_tensor(self.T_WC, device=self.dev),
            "T_WO_1": torch.as_tensor(self.T_WO_1, device=self.dev),
            "dirs_cam": scene.pixel_dirs(torch, self.res, self.res, self.K, self.dev),
            "settings": self.settings_d, "crop_settings": self.crop_d,
            "gt_depth": self.gt_depth[0], "movable_mask": self.movable[0], "ids": ids,
            "n_norm": len(self.norm), "obj_box": self.obj_aabb,
        }

    def sample(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        """``n`` of the scored poses drawn from the seed: (indices, the
        window's scores)."""
        idx = np.concatenate([i for i, _ in self.scored])
        scores = np.concatenate([s for _, s in self.scored])
        pick = np.random.default_rng(self.ctx.seed).choice(len(idx), size=min(n, len(idx)),
                                                           replace=False)
        return idx[pick], scores[pick]

    def outputs(self, idx: np.ndarray) -> dict:
        """The poses ``idx`` scored again through the window's entry and
        objects, each clip group's composited frames and image embeddings
        recorded where the score function makes them; with the captions'
        embeddings that set-up made. All on the host."""
        torch = self.torch
        from dream2real_tpu_torch.parallel import imagine

        frames, embs = [], []
        render, encode = imagine.render_pose_batch, imagine.encode_image

        def rec_render(*args, **kw):
            out = render(*args, **kw)
            frames.append(out.cpu())
            return out

        def rec_encode(*args, **kw):
            out = encode(*args, **kw)
            embs.append(out.float().cpu())
            return out

        with mock.patch.object(imagine, "render_pose_batch", rec_render), \
                mock.patch.object(imagine, "encode_image", rec_encode):
            rescored = self.score_block(idx)
        n = len(idx)
        return {"frames": torch.cat(frames)[:n], "image_emb": torch.cat(embs)[:n],
                "text_emb": self.prefetch["txt"].float().cpu(), "rescored": rescored}

    def reference(self, idx: np.ndarray, prec: Precision) -> dict:
        """The reference's stages of scoring the poses ``idx``."""
        poses = self.torch.as_tensor(self.poses[idx], device=self.dev)
        return ref_scoring.forward(self.reference_inputs(), poses, prec)

    def first_group_samples(self) -> tuple[int, int]:
        """The samples the first traced clip group's rays need, and its live
        rays, counted by the reference's march."""
        torch = self.torch
        inp = self.reference_inputs()
        fg = ref_field.Field({k: v.float() for k, v in self.fg_w.items()}, self.fcfg,
                             REFERENCE)
        needed = live = 0
        for i in self.scored[0][0][: self.cb]:
            o, d = ref_scoring.pose_rays(inp["T_WO_1"],
                                         torch.as_tensor(self.poses[i], device=self.dev),
                                         inp["T_WC"], inp["dirs_cam"])
            _, _, _, n, lv = ref_field.march_box(fg, o, d, self.obj_aabb, self.crop_d,
                                                 count=True)
            needed, live = needed + n, live + lv
        return needed, live


def numbers(out: dict, ref: dict, scores, logit_scale, n_norm: int) -> dict:
    """The numbers compared, each the worst over the sampled poses:

    - ``frame_gap``: a composited frame's share of channel values more than
      one level from the reference's (the background view, K1's crop render
      and the composite);
    - ``embed_gap``: the unit-vector gap of a frame's image embedding, or of
      a caption's text embedding, from the reference's, each side from its
      own frames and token ids (the towers);
    - ``score_gap``: the gap, in logits, between the score the window gave a
      pose and the ratio of float32 logits over the program's own image and
      caption embeddings (the logits and ``reduce_logits``: step by step
      from the program's embeddings, which ``embed_gap`` checks).
    """
    lg = ref_clip.logits({"logit_scale": logit_scale.cpu()}, out["image_emb"], out["text_emb"],
                         REFERENCE)
    goal, norm = ref_scoring.goal_and_norm(lg, n_norm)
    emb = compare.unit_gaps(out["image_emb"], ref["image_emb"]) + compare.unit_gaps(
        out["text_emb"], ref["text_emb"])
    return {"frame_gap": compare.worst(compare.frame_gaps(out["frames"], ref["frames"])),
            "embed_gap": compare.worst(emb),
            "score_gap": compare.worst(compare.score_gap(scores, goal, norm))}


def diagnostics(s: Session, out: dict, ref: dict, scores) -> dict:
    """What the readings log beside the numbers: the frames' worst level
    gap and mean gap, the median pose's gaps, what the reference's own
    scores read against the program's (the whole chain at once), what a
    pose scored with its neighbour's score would read, what a frame of the
    background alone would read, and how far the re-scored poses lie from
    the window's scores."""
    i16 = s.torch.int16
    d = (out["frames"].to(i16) - ref["frames"].to(i16)).abs()
    lg = ref_clip.logits({"logit_scale": s.clip_w["logit_scale"].cpu()}, out["image_emb"],
                         out["text_emb"], REFERENCE)
    goal, norm = ref_scoring.goal_and_norm(lg, len(s.norm))
    bg = ref["background"].expand_as(ref["frames"])
    fr = compare.frame_gaps(out["frames"], ref["frames"])
    img = compare.unit_gaps(out["image_emb"], ref["image_emb"])
    sg = compare.score_gap(scores, goal, norm)
    return {
        "frame_level_max": int(d.max()),
        "frame_mean_max": float(d.float().flatten(1).mean(1).max()),
        "frame_gap_median": statistics.median(fr),
        "image_gap_median": statistics.median(img),
        "text_gap": compare.worst(compare.unit_gaps(out["text_emb"], ref["text_emb"])),
        "score_gap_median": statistics.median(sg),
        "chain_gap": compare.worst(compare.score_gap(scores, ref["goal"], ref["norm"])),
        "neighbour_score_gap": compare.worst(compare.score_gap(np.roll(scores, 1), goal, norm)),
        "background_frame_gap": compare.worst(compare.frame_gaps(bg, ref["frames"])),
    }


def check(s: Session, out: dict, scores, chk: dict):
    """-> (compared {name: (value, limit)}, failed): the sample fails as a
    whole, a number over its limit or a score that is not finite."""
    ref = s.reference(out["idx"], REFERENCE)
    vals = numbers(out, ref, scores, s.clip_w["logit_scale"], len(s.norm))
    s.ctx.log("check: " + ", ".join(f"{k} {v:.6g}" for k, v in
                                    diagnostics(s, out, ref, scores).items()))
    compared = {name: (vals[name], lim) for name, lim in chk["limits"].items()}
    failed = sum(not harness.within(v, lim) for v, lim in compared.values())
    return compared, failed + int(sum(not np.isfinite(v) for v in scores))


def program_outputs(s: Session, chk: dict):
    """The check's sample, drawn from the seed among the scored poses, and
    the program's outputs for it: (outputs, the window's scores)."""
    if chk["poses"] % s.cb:
        raise ValueError(f"the check's {chk['poses']} poses are not whole clip groups of {s.cb}")
    idx, scores = s.sample(chk["poses"])
    out = s.outputs(idx)
    out["idx"] = idx
    return out, scores


def readings(ctx: harness.RunContext, control: bool) -> dict:
    """The numbers of one seed for the limits: one block of the cell's
    size scored, its sample compared with the reference; with ``control``
    also the control's, the reference in the precision below in the
    program's place."""
    tr = ctx.cell.traffic
    chk = tr["check"]
    s = Session(ctx)
    s.score_block(np.arange(tr["warm_poses"]))
    s.blocks(n_blocks=1)
    out, scores = program_outputs(s, chk)
    s.release()
    ref = s.reference(out["idx"], REFERENCE)
    res = dict(numbers(out, ref, scores, s.clip_w["logit_scale"], len(s.norm)),
               **diagnostics(s, out, ref, scores),
               rescored_max=float(np.abs(out["rescored"] - scores).max()))
    if control:
        ctl = s.reference(out["idx"], CONTROL)
        cs = (ctl["goal"] / ctl["norm"]).numpy()  # its scores
        res["control"] = dict(numbers(ctl, ref, cs, s.clip_w["logit_scale"], len(s.norm)),
                              **diagnostics(s, ctl, ref, cs))
    return res


#: The faults the check has to see, planted where the cell's work is made.
FAULTS = ("half_batch", "altered")


@contextlib.contextmanager
def plant(fault: str):
    """``half_batch``: the second half of every clip group's frames left as
    the background alone, the group scored on them. ``altered``: every clip
    group's scores handed to the wrong poses (rolled by one)."""
    import torch
    from dream2real_tpu_torch.parallel import imagine

    if fault == "half_batch":
        orig = imagine.render_pose_batch

        def half(*args, **kw):
            frames = orig(*args, **kw)
            bg_only = args[11]
            frames[frames.shape[0] // 2:] = bg_only
            return frames

        with mock.patch.object(imagine, "render_pose_batch", half):
            yield
    elif fault == "altered":
        orig = imagine.reduce_logits
        with mock.patch.object(imagine, "reduce_logits",
                               lambda *a, **k: torch.roll(orig(*a, **k), 1)):
            yield
    else:
        raise ValueError(f"no fault {fault!r} for scoring")


def run(ctx: harness.RunContext) -> harness.Outcome:
    tr = ctx.cell.traffic
    s = Session(ctx)
    s.score_block(np.arange(tr["warm_poses"]))  # every shape the window takes
    s.sync()
    s.stages("warm block")
    s.stages.log()
    setup_s = harness.now() - ctx.t_start
    torch = s.torch
    e2e, layer_ctx, busy, window_s, breakdown = {}, None, None, None, None
    if not ctx.trace:
        done, elapsed = s.blocks(seconds=ctx.seconds)
        e2e["poses_per_s"] = done / elapsed
        attempted = done
    else:
        holder: dict = {}
        with traced(torch, s.sync, holder):
            done, elapsed = s.blocks(n_blocks=tr["trace"]["blocks"])
        trace = holder["trace"]
        attempted = done
        busy, window_s, breakdown = trace.busy_s(), trace.window_s, trace.breakdown()
    peak = torch.cuda.max_memory_allocated(s.dev) if s.dev.type == "cuda" else 0
    if ctx.trace:
        spans = s.layer_spans(tr["trace"]["split_groups"])
    out, scores = program_outputs(s, tr["check"])
    s.release()
    if ctx.trace:
        needed, live = s.first_group_samples()
        layer_ctx = {"trace": trace, "poses": done, "clip_batch": s.cb, "clip": s.ccfg,
                     "spans": spans, "k1_needed": needed, "k1_live": live}
    compared, failed = check(s, out, scores, tr["check"])
    failed += int(sum((~np.isfinite(sc)).sum() for _, sc in s.scored))
    return harness.Outcome(
        setup_s=setup_s, attempted=attempted, failed=failed, correct=failed == 0,
        end_to_end=e2e, compared=compared, memory_peak_bytes=peak, layer_ctx=layer_ctx,
        busy_s=busy, window_s=window_s, breakdown=breakdown)
