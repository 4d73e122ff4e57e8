"""train.mfu: the training window's model operations over the card's bf16
peak: per step the sampler's density pass over the coarse samples, the
forward and backward of the field at every sample the loss uses, and of the
density trunk at the free-space samples (roofline.train_step_flops), over
the traced window's length."""

from benchmark import roofline


def read(ctx: dict):
    trace = ctx.get("trace")
    if trace is None or not trace.ops or trace.window_s <= 0 or not ctx.get("steps"):
        return None
    flops = ctx["steps"] * roofline.train_step_flops(ctx["rays"], ctx["coarse"], ctx["samples"],
                                                     ctx["freespace"])
    return 100.0 * flops / trace.window_s / roofline.PEAK_BF16_FLOPS
