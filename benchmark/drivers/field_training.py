"""Traffic: a task field's training chunks, as
``reconstruction.build_vis_model`` builds them.

Set-up makes the scan on the device (the tabletop from an orbit of views at
the configuration's camera, the movable object's pixels opaque for the fg
field and everything else transparent, ground-truth depth), the opaque
pixels the sampler draws half of each batch from, and the program's
training state and chunk (``nerf/trainer.py``: ``init_train_state`` from the
seed, ``make_train_chunk``). It then drives that same state through its
first steps one step a call, reading what the check compares: each step's
task loss, the first gradient from Adam's state after one step (its first
moment over 1 - beta1), and the parameters' change after the steps. One
whole chunk warms the window's call. The window runs whole chunks of
``poll_steps`` steps until ``--seconds`` have passed; the rate is all steps
over all of that time.

The traced run profiles ``trace.chunks`` chunks. Every run ends with the
check: the reference follows the same first steps from the seed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
from unittest import mock

import numpy as np

from benchmark import harness, scene
from benchmark.profile import traced
from benchmark.reference import compare
from benchmark.reference import training as ref_training
from benchmark.reference.precision import REFERENCE, CONTROL, Precision

BETA1 = 0.9


class Session:
    def __init__(self, ctx: harness.RunContext):
        import torch

        self.torch, self.ctx, self.dev = torch, ctx, ctx.device
        self.stages = harness.Stages(ctx)
        cfg = ctx.cell.config
        self.fcfg, self.train_d = cfg["field"], dict(cfg["train"])
        self.settings_d = cfg["render"]
        sc = cfg["scan"]
        cam = cfg["camera"]
        self.K = scene.intrinsics(cam, sc["scale"])
        self.h, self.w = int(round(cam["h"] * sc["scale"])), int(round(cam["w"] * sc["scale"]))
        views = scene.orbit(sc["views"], sc["radius"], sc["height"])
        self.poses = torch.as_tensor(views, device=self.dev)
        rgb, depth, inst = scene.render_tabletop(torch, views, self.K, self.h, self.w, self.dev)
        opaque = (inst == 1) if cfg["task"] == "fg" else (inst != 1)
        alpha = opaque.to(torch.uint8) * 255
        self.images = torch.cat([rgb, alpha[..., None]], dim=-1).contiguous()
        self.depths = depth
        self.dirs_cam = scene.pixel_dirs(torch, self.h, self.w, self.K, self.dev)
        coords = torch.nonzero(alpha > 127)
        if len(coords) > (1 << 20):  # as build_vis_model caps them
            coords = coords[torch.as_tensor(
                np.linspace(0, len(coords) - 1, 1 << 20).astype(np.int64), device=self.dev)]
        self.fg_pixels = coords
        self.stages("inputs")
        self._build_program()

    def _build_program(self) -> None:
        torch = self.torch
        from dream2real_tpu_torch import build
        from dream2real_tpu_torch.nerf.model import NGPConfig
        from dream2real_tpu_torch.nerf.render import RenderSettings
        from dream2real_tpu_torch.nerf.trainer import TrainConfig, init_train_state, \
            make_train_chunk

        if self.dev.type == "cuda":
            build.build_all()
        self.stages("kernels")
        ngp = NGPConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in self.fcfg.items()})
        settings = RenderSettings(**{k: self.settings_d[k] for k in
                                     ("n_coarse", "n_fine", "near", "far", "min_transmittance")})
        self.tc = TrainConfig(**self.train_d, seed=self.ctx.seed)
        self.chunk_steps = self.tc.poll_steps
        self.state = init_train_state(ngp, self.tc, n_images=len(self.images), device=self.dev)
        self.chunk = make_train_chunk(ngp, self.tc, settings, self.images, self.poses,
                                      self.dirs_cam, depths=self.depths,
                                      fg_pixels=self.fg_pixels)
        self.losses: list = []
        self.stages("program")

    def first_steps(self, n: int) -> dict:
        """The state's first ``n`` steps, one a call of the window's own
        chunk. -> the program's readings."""
        torch = self.torch
        field = self.state["field"]
        start = {k: p.detach().clone() for k, p in field.named_parameters()}
        losses, grads = [], {}
        self.tc.poll_steps = 1
        try:
            for k in range(n):
                self.state, loss = self.chunk(self.state)
                losses.append(float(loss))
                if k == 0:
                    opt = self.state["opt_field"]
                    grads = {name: float(torch.linalg.norm(opt.state[p]["exp_avg"]) / (1 - BETA1))
                             for name, p in field.named_parameters()}
        finally:
            self.tc.poll_steps = self.chunk_steps
        change = {k: float(torch.linalg.norm(p.detach() - start[k]))
                  for k, p in field.named_parameters()}
        return {"losses": losses, "grad_norms": grads, "change_norms": change}

    def chunks(self, n=None, seconds=None):
        """Whole chunks: ``n`` of them, or until ``seconds`` have passed.
        -> (steps, seconds)."""
        t0 = harness.now()
        steps, times = 0, []
        while True:
            t = harness.now()
            self.state, loss = self.chunk(self.state)
            times.append(harness.now() - t)
            self.losses.append(loss)
            steps += self.chunk_steps
            if n is not None and steps >= n * self.chunk_steps:
                break
            if seconds is not None and harness.now() - t0 >= seconds:
                break
        self.ctx.log("chunk seconds: " + " ".join(f"{t:.3f}" for t in times))
        return steps, harness.now() - t0

    def sync(self) -> None:
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize(self.dev)

    def release(self) -> None:
        self.state = self.chunk = None
        gc.collect()
        if self.dev.type == "cuda":
            self.torch.cuda.empty_cache()

    def reference(self, n: int, prec: Precision) -> dict:
        data = {"images": self.images, "poses": self.poses, "dirs_cam": self.dirs_cam,
                "depths": self.depths, "fg_pixels": self.fg_pixels}
        tc = dict(dataclasses.asdict(self.tc))
        return ref_training.train_steps(self.ctx.seed, data, self.fcfg, self.settings_d, tc, n,
                                        prec)


def check(prog: dict, ref: dict, limits: dict) -> dict:
    gaps = compare.training_gaps(prog, ref)
    return {name: (gaps[name], limits[name]) for name in limits}


def run(ctx: harness.RunContext) -> harness.Outcome:
    tr = ctx.cell.traffic
    s = Session(ctx)
    n_check = tr["check"]["steps"]
    prog = s.first_steps(n_check)
    s.stages("first steps")
    s.chunks(n=tr["warm_chunks"])
    s.sync()
    s.stages("warm chunk")
    s.stages.log()
    setup_s = harness.now() - ctx.t_start
    torch = s.torch
    e2e, layer_ctx, busy, window_s, breakdown = {}, None, None, None, None
    if not ctx.trace:
        steps, elapsed = s.chunks(seconds=ctx.seconds)
        e2e["train_steps_per_s"] = steps / elapsed
    else:
        holder: dict = {}
        with traced(torch, s.sync, holder):
            steps, elapsed = s.chunks(n=tr["trace"]["chunks"])
        trace = holder["trace"]
        busy, window_s, breakdown = trace.busy_s(), trace.window_s, trace.breakdown()
        st = s.settings_d
        layer_ctx = {"trace": trace, "steps": steps, "rays": s.tc.batch_rays,
                     "samples": st["n_coarse"] + st["n_fine"], "coarse": st["n_coarse"],
                     "freespace": s.tc.freespace_samples}
    peak = torch.cuda.max_memory_allocated(s.dev) if s.dev.type == "cuda" else 0
    bad = sum(not math.isfinite(v) for v in s.losses)
    s.release()
    compared = check(prog, s.reference(n_check, REFERENCE), tr["check"]["limits"])
    failed = bad + sum(not harness.within(v, lim) for v, lim in compared.values())
    return harness.Outcome(
        setup_s=setup_s, attempted=steps, failed=failed, correct=failed == 0,
        end_to_end=e2e, compared=compared, memory_peak_bytes=peak, layer_ctx=layer_ctx,
        busy_s=busy, window_s=window_s, breakdown=breakdown)


def control_readings(s: Session, n: int) -> dict:
    """The control's readings: the reference in float8 in the program's
    place, against the reference."""
    return compare.training_gaps(s.reference(n, CONTROL), s.reference(n, REFERENCE))


def readings(ctx: harness.RunContext, control: bool) -> dict:
    """The numbers of one seed for the limits: the program's first steps
    against the reference's; with ``control`` also the control's."""
    n = ctx.cell.traffic["check"]["steps"]
    s = Session(ctx)
    prog = s.first_steps(n)
    s.release()
    ref = s.reference(n, REFERENCE)
    out = dict(compare.training_gaps(prog, ref), prog=prog, ref=ref)
    if control:
        out["control"] = control_readings(s, n)
    return out


#: The faults the check has to see, planted where the cell's work is made.
FAULTS = ("half_batch", "unchanged")


@contextlib.contextmanager
def plant(fault: str):
    """``half_batch``: each loss term's mean taken over the first half of the
    rays only. ``unchanged``: every step returns the parameters unchanged
    (the step's learning rate is 0)."""
    from dream2real_tpu_torch.nerf import trainer

    if fault == "half_batch":
        import torch

        orig = trainer._huber

        def half(x, delta):
            h = orig(x, delta)
            n = h.shape[0] // 2
            return torch.cat([h[:n], h[:n]])

        with mock.patch.object(trainer, "_huber", half):
            yield
    elif fault == "unchanged":
        with mock.patch.object(trainer, "cosine_lr", lambda tc, step: 0.0):
            yield
    else:
        raise ValueError(f"no fault {fault!r} for training")
