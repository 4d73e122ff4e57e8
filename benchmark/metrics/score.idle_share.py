"""score.idle_share: the share of the traced scoring window (blocks through
scoring._fused_score) in which no operation ran on the device."""


def read(ctx: dict):
    trace = ctx.get("trace")
    if trace is None or trace.window_s <= 0 or not trace.ops:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
