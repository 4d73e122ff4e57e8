"""train.hashgrid_mfu: the hash-grid field's training window's model
operations over the card's bf16 peak: per step the density MLP and the
encoding at the coarse samples (forward only: the sampler's pass), the
density and colour MLPs and the encoding at the samples the loss uses, and
the density MLP and the encoding at the free-space samples, each forward
and backward (the MLPs' backward twice their forward, the encoding's once),
counted as ``_hashgrid`` counts them, over the traced window's length."""

from benchmark import roofline
from benchmark.metrics import _hashgrid


def read(ctx: dict):
    trace, field = ctx.get("trace"), ctx.get("field")
    if trace is None or not trace.ops or trace.window_s <= 0 or not ctx.get("steps") \
            or not field:
        return None
    rays, enc = ctx["rays"], _hashgrid.interp_flops(field)
    dens, col = 2.0 * _hashgrid.density_macs(field), 2.0 * _hashgrid.colour_macs(field)
    per_step = (rays * ctx["coarse"] * (dens + enc)
                + rays * ctx["samples"] * (3 * (dens + col) + 2 * enc)
                + rays * ctx["freespace"] * (3 * dens + 2 * enc))
    return 100.0 * ctx["steps"] * per_step / trace.window_s / roofline.PEAK_BF16_FLOPS
