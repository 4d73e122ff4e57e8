"""score.tower_gemm_roofline: the vision tower's four GEMMs a block (qkv,
out-projection, fc1 + QuickGELU, fc2; csrc/attention.cu gemm_tma) over the
traced window, as a share of their roofline: the sum of each GEMM's bound
from its shapes (M = clip batch x 577 tokens; the last block's
out-projection and MLP on the class token alone) over the summed
gemm_tma time. Nothing is read where the window's gemm_tma launches are not
those GEMMs, four a block for every clip group."""

from benchmark import roofline


def read(ctx: dict):
    trace = ctx.get("trace")
    if trace is None or not ctx.get("poses"):
        return None
    c, cb = ctx["clip"], ctx["clip_batch"]
    groups = ctx["poses"] // cb
    tokens = (c["image_size"] // c["patch_size"]) ** 2 + 1
    kw = dict(tokens=tokens, width=c["vision_width"], layers=c["vision_layers"])
    seconds, launches = trace.time_of("gemm_tma")
    if seconds <= 0 or launches != groups * len(roofline.tower_gemms(cb, **kw)):
        return None
    return 100.0 * groups * roofline.tower_gemm_bound_ms(cb, **kw) / (seconds * 1e3)
