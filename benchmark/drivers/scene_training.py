"""Traffic: a full-scene field's training chunks with its cameras'
extrinsics optimised, as every shipped demo (shopping, shelf, pool) trains
its scene field (``optimize_extrinsics`` on).

``field_training``'s window, trace and check, with this module's
``Session`` in its place:

- every pixel of the scan opaque, so the field trains as
  ``reconstruction.build_vis_model`` trains an unmasked field: uniform
  pixels, no opaque-pixel half, no free-space carving;
- the images rendered from the orbit's true cameras, the program given
  those cameras perturbed from the seed (every odd one turned by
  ``perturb.rot_deg`` about a random axis and moved by ``perturb.trans_mm``
  in a random direction, as ``experiments/extr_grad_ab.py`` perturbs them),
  so that the extrinsics have something to correct;
- the workload's ``train`` settings over the configuration's (the
  extrinsics on, their rate and gate step);
- the check's steps taken from the seed's state with its step counter set
  to ``ext_start_step``, so that they move the extrinsics, as the
  reference's do;
- then, before the warm chunk, a fresh state from the seed trained closed
  loop through its first ``ext_start_step`` steps (the extrinsics still,
  under their gate), so that the warm chunk and every timed step train a
  field as far on as a demo's past the gate, and move the extrinsics;
- the check's readings and reference (``reference/extrinsics.py``) take the
  extrinsics as two more leaves: their change counts in ``change_gap``,
  their first gradient in ``ext_grad_gap``, apart from the field's
  (``grad_gap``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from unittest import mock

import numpy as np

from benchmark import harness
from benchmark.drivers import field_training
from benchmark.reference import compare
from benchmark.reference import extrinsics as ref_extrinsics
from benchmark.reference.precision import CONTROL, REFERENCE, Precision

BETA1 = field_training.BETA1


def perturbed(poses: np.ndarray, seed: int, rot_deg: float, trans_mm: float) -> np.ndarray:
    """The odd cameras of (N, 4, 4) poses turned by ``rot_deg`` about a
    random axis and moved by ``trans_mm``, from the seed; the even ones
    exact."""
    rng = np.random.default_rng(seed)
    out = poses.copy()
    for i in range(1, len(poses), 2):
        k = rng.normal(size=3)
        k /= np.linalg.norm(k)
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        a = np.radians(rot_deg)
        R = np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K
        out[i, :3, :3] = (poses[i, :3, :3].astype(np.float64) @ R).astype(np.float32)
        t = rng.normal(size=3)
        out[i, :3, 3] += (trans_mm / 1e3 * t / np.linalg.norm(t)).astype(np.float32)
    return out


class Session(field_training.Session):
    def _build_program(self) -> None:
        torch = self.torch
        tr = self.ctx.cell.traffic
        self.images[..., 3] = 255  # the full scene: every pixel opaque
        self.fg_pixels = None
        p = tr["perturb"]
        self.poses = torch.as_tensor(perturbed(self.poses.cpu().numpy(), self.ctx.seed,
                                               p["rot_deg"], p["trans_mm"]), device=self.dev)
        self.train_d.update(tr["train"])
        super()._build_program()
        self.state["step"] = self.tc.ext_start_step
        self.past_gate = False

    def chunks(self, n=None, seconds=None):
        if not self.past_gate:
            self.train_to_gate()
        return super().chunks(n=n, seconds=seconds)

    def train_to_gate(self) -> None:
        """A fresh state from the seed, trained closed loop from step 0 up
        to the extrinsics' gate in one call of the window's chunk."""
        from dream2real_tpu_torch.nerf.model import NGPConfig
        from dream2real_tpu_torch.nerf.trainer import init_train_state

        ngp = NGPConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in self.fcfg.items()})
        self.state = None
        self.state = init_train_state(ngp, self.tc, n_images=len(self.images), device=self.dev)
        self.tc.poll_steps = self.tc.ext_start_step
        try:
            self.state, loss = self.chunk(self.state)
        finally:
            self.tc.poll_steps = self.chunk_steps
        self.losses.append(loss)
        self.past_gate = True
        self.stages("steps to the gate")

    def first_steps(self, n: int) -> dict:
        """``field_training``'s readings with the extrinsics as two more
        leaves: the first steps one a call of the window's own chunk, each
        leaf's first gradient from its Adam's state after one step (zero
        where it has none) and its change over the steps."""
        torch = self.torch
        opts = {k: self.state["opt_field"] for k, _ in self.state["field"].named_parameters()}
        opts.update({k: self.state["opt_ext"] for k in ref_extrinsics.LEAVES})
        leaves = dict(self.state["field"].named_parameters())
        leaves.update({k: self.state[k] for k in ref_extrinsics.LEAVES})
        start = {k: p.detach().clone() for k, p in leaves.items()}
        losses, grads = [], {}
        self.tc.poll_steps = 1
        try:
            for k in range(n):
                self.state, loss = self.chunk(self.state)
                losses.append(float(loss))
                if k == 0:
                    for name, p in leaves.items():
                        st = opts[name].state.get(p, {})
                        grads[name] = float(torch.linalg.norm(st["exp_avg"]) / (1 - BETA1)) \
                            if "exp_avg" in st else 0.0
        finally:
            self.tc.poll_steps = self.chunk_steps
        change = {k: float(torch.linalg.norm(p.detach() - start[k])) for k, p in leaves.items()}
        return {"losses": losses, "grad_norms": grads, "change_norms": change}

    def reference(self, n: int, prec: Precision) -> dict:
        data = {"images": self.images, "poses": self.poses, "dirs_cam": self.dirs_cam,
                "depths": self.depths}
        tc = dict(dataclasses.asdict(self.tc))
        return ref_extrinsics.train_steps(self.ctx.seed, data, self.fcfg, self.settings_d, tc, n,
                                          prec, start_step=tc["ext_start_step"])


def gaps(prog: dict, ref: dict) -> dict:
    """The check's four numbers: the first step's task loss (``first_loss_gap``:
    the one state both sides share; later steps follow Adam's first,
    sign-like moves of every weight and extrinsic, which rounding flips,
    and ``change_gap`` holds them), the first gradient over the field's
    leaves (``grad_gap``), the change over every moved leaf, the
    extrinsics' included (``change_gap``), and the extrinsics' first
    gradient apart (``ext_grad_gap``)."""
    pg, rg = prog["grad_norms"], ref["grad_norms"]
    ext = set(ref_extrinsics.LEAVES)

    def part(d, keep):
        return {k: v for k, v in d.items() if (k in ext) == keep}

    return {
        "first_loss_gap": compare.loss_gap(prog["losses"][:1], ref["losses"][:1]),
        "grad_gap": compare.norm_gap(part(pg, False), part(rg, False)),
        "change_gap": compare.norm_gap(prog["change_norms"], ref["change_norms"],
                                       compare.moved_leaves(rg)),
        "ext_grad_gap": compare.norm_gap(part(pg, True), part(rg, True)),
    }


def check(prog: dict, ref: dict, limits: dict) -> dict:
    g = gaps(prog, ref)
    return {name: (g[name], limits[name]) for name in limits}


@contextlib.contextmanager
def _session():
    with mock.patch.object(field_training, "Session", Session), \
            mock.patch.object(field_training, "check", check):
        yield


def run(ctx: harness.RunContext) -> harness.Outcome:
    with _session():
        return field_training.run(ctx)


def readings(ctx: harness.RunContext, control: bool) -> dict:
    """The numbers of one seed for the limits: the program's first steps
    past the gate against the reference's; with ``control`` also the
    control's (the reference in float8 in the program's place)."""
    n = ctx.cell.traffic["check"]["steps"]
    s = Session(ctx)
    prog = s.first_steps(n)
    s.release()
    ref = s.reference(n, REFERENCE)
    out = dict(gaps(prog, ref), prog=prog, ref=ref)
    if control:
        ctl = s.reference(n, CONTROL)
        out["control"] = dict(gaps(ctl, ref), losses=ctl["losses"])
    return out


#: ``field_training``'s faults, and ``poses_fixed``: the cameras' poses left
#: as scanned (the corrections reach no ray, so they take no gradient).
FAULTS = field_training.FAULTS + ("poses_fixed",)


@contextlib.contextmanager
def plant(fault: str):
    if fault != "poses_fixed":
        with field_training.plant(fault):
            yield
        return
    from dream2real_tpu_torch.nerf import trainer

    with mock.patch.object(trainer, "optimized_poses", lambda rot, trans, init: init):
        yield

