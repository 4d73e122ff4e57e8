"""H2's counts, from the configuration's field and the samples the
reference's crop march counts in the first traced clip group
(``hash_needed``: each live ray's samples while its transmittance is at or
above the cut; ``hash_live``: its live rays), scaled by the window's clip
groups as ``score.k1_roofline`` scales K1's.

Operations at a needed sample: the encoding's interpolation
(``_hashgrid.interp_flops``) and the density and colour MLPs' multiply-adds,
two operations each. Bytes: each live ray's inputs (its direction, |d|, t0,
t1 and index: 7 float32 or int32) and outputs (rgb, alpha, depth: 5
float32); the packed weights (9,408 float32) and the boxes (12) once a
launch. No corner reads, for ``_hashgrid``'s reason: most hit L2, and
counting them would let a share of the bound pass 100%."""

from __future__ import annotations

from benchmark.metrics import _hashgrid

KERNEL = "hash_march"
RAY_BYTES = (7 + 5) * 4
LAUNCH_BYTES = (9408 + 12) * 4


def groups(ctx: dict) -> int:
    return ctx["poses"] // ctx["clip_batch"]


def samples(ctx: dict):
    """The samples the traced window's clip groups need, or None."""
    if not ctx.get("hash_needed") or not ctx.get("poses") or not ctx.get("clip_batch"):
        return None
    return ctx["hash_needed"] * groups(ctx)


def sample_flops(field: dict) -> float:
    return _hashgrid.interp_flops(field) + 2.0 * (_hashgrid.density_macs(field)
                                                 + _hashgrid.colour_macs(field))


def flops_bytes(field: dict, needed: int, live: int, launches: int) -> tuple[float, float]:
    """H2's operations and bytes over ``needed`` samples of ``live`` rays in
    ``launches`` launches."""
    return needed * sample_flops(field), live * RAY_BYTES + launches * LAUNCH_BYTES


def kernel_window(ctx: dict):
    """(H2's device seconds in the traced window, its launches), or None
    without the kernel (the plain render)."""
    trace = ctx.get("trace")
    if trace is None:
        return None
    seconds, launches = trace.time_of(KERNEL)
    return (seconds, launches) if launches and seconds > 0 else None
