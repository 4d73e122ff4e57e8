"""train.k7_roofline: K7, the training step's backward (train_rows<true>,
dw_gemm, reduce_grads), as a share of its roofline: the bound of its
recompute, delta and weight-gradient products over every (ray, sample) row
of the step (rays x the sampler's samples) and its bytes, over its device
time a step in the traced window."""

from benchmark import roofline


def read(ctx: dict):
    trace = ctx.get("trace")
    if trace is None or not ctx.get("steps"):
        return None
    seconds, launches = trace.time_of("train_rows<true>", "dw_gemm", "reduce_grads")
    if launches == 0 or seconds <= 0:
        return None
    rays, samples = ctx["rays"], ctx["samples"]
    bound, _ = roofline.bound_ms(roofline.k7_flops(rays, samples),
                                 roofline.k7_bytes(rays, samples))
    return 100.0 * bound / (seconds * 1e3 / ctx["steps"])
