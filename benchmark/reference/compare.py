"""The numbers ``correct`` compares, each a gap between the program's
output and the reference's, with the rule that reads it."""

from __future__ import annotations

import math
import statistics

import torch


def score_gap(prog, ref_goal, ref_norm) -> list[float]:
    """Each pose's score gap in the logits' own units: the least change of
    the reference's goal and normalising logits (g, n), the larger of the
    two, that makes their ratio the program's score s:
    |s n - g| / (1 + |s|). The score is a ratio, ill-conditioned where n
    nears zero; this reads no more than the program's own logit errors
    wherever n lies. Not finite where the program's score is not."""
    out = []
    for s, g, n in zip(prog, ref_goal, ref_norm):
        s, g, n = float(s), float(g), float(n)
        out.append(abs(s * n - g) / (1.0 + abs(s)) if math.isfinite(s) else math.inf)
    return out


def frame_gaps(prog, ref) -> list[float]:
    """Each frame's share of channel values more than one level from the
    reference's: (N, H, W, 3) u8 each. Rounding to u8 moves a value by one
    level where the two sides' colours straddle a step; more is a colour,
    an alpha or a depth order that differs."""
    d = (prog.to(torch.int16) - ref.to(torch.int16)).abs()
    return (d > 1).flatten(1).to(torch.float64).mean(1).tolist()


def unit_gaps(prog, ref) -> list[float]:
    """Each row's gap between two embeddings as unit vectors, |a/|a| - b/|b||:
    what their cosine logits see. Not finite where the program's row is
    not."""
    a = prog.to(torch.float64)
    b = ref.to(torch.float64)
    a = a / torch.linalg.norm(a, dim=-1, keepdim=True)
    b = b / torch.linalg.norm(b, dim=-1, keepdim=True)
    g = torch.linalg.norm(a - b, dim=-1)
    return torch.where(torch.isfinite(g), g, torch.full_like(g, math.inf)).tolist()


def worst(values) -> float:
    """The largest value, inf where any is not finite (0 for none)."""
    values = list(values)
    if any(not math.isfinite(v) for v in values):
        return math.inf
    return max(values, default=0.0)


def norm_gap(prog: dict, ref: dict, leaves=None) -> float:
    """The worst leaf's gap between two norms, |a - b| over the larger of the
    reference's norm of that leaf and of the median leaf."""
    leaves = list(ref) if leaves is None else list(leaves)
    med = statistics.median(ref[k] for k in ref)
    worst = 0.0
    for k in leaves:
        a = prog[k]
        if not math.isfinite(a):
            return math.inf
        worst = max(worst, abs(a - ref[k]) / max(ref[k], med, 1e-30))
    return worst


def moved_leaves(ref_grads: dict) -> list[str]:
    """Leaves whose first gradient in the reference is at least a thousandth
    of the median leaf's: the others move under Adam by round-off alone."""
    med = statistics.median(ref_grads.values())
    return [k for k, g in ref_grads.items() if g >= 1e-3 * med]


def loss_gap(prog: list, ref: list) -> float:
    """The worst step's relative gap of the task loss."""
    worst = 0.0
    for a, b in zip(prog, ref):
        if not math.isfinite(a):
            return math.inf
        worst = max(worst, abs(a - b) / max(abs(b), 1e-30))
    return worst


def training_gaps(prog: dict, ref: dict) -> dict:
    """The three numbers of a training cell: the steps' losses, the first
    gradient by leaf, the change by moved leaf."""
    return {
        "loss_gap": loss_gap(prog["losses"], ref["losses"]),
        "grad_gap": norm_gap(prog["grad_norms"], ref["grad_norms"]),
        "change_gap": norm_gap(prog["change_norms"], ref["change_norms"],
                               moved_leaves(ref["grad_norms"])),
    }
