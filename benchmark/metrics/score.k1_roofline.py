"""score.k1_roofline: K1 (march_rows) on the first traced clip group, as a
share of its roofline. The bound counts the samples these rays need (each
live ray's samples while its transmittance is at or above the cut, counted
by the reference's march) times the field's MACs, and each live ray's 13
f32 in and out plus the packed weights once; K1's time is the first
march_rows kernel of the traced window, which is that group's."""

from benchmark import roofline


def read(ctx: dict):
    trace = ctx.get("trace")
    needed = ctx.get("k1_needed")
    if trace is None or not needed:
        return None
    ops = trace.matching("march_rows")
    if not ops or ops[0][2] <= 0:
        return None
    bound, _ = roofline.bound_ms(roofline.k1_flops(needed), roofline.k1_bytes(ctx["k1_live"]))
    return 100.0 * bound / (ops[0][2] * 1e3)
