"""score.hashgrid_mfu: the scoring window's model operations over the
card's bf16 peak, for instant-ngp fields: every pose's forward through the
published ViT-L/14@336 vision tower (190.9 G multiply-adds) and its
render's hash-field samples (the first traced group's needed samples a
pose, for every pose, each counted as ``_hash_march`` counts it), over the
traced window's length. It reads whatever renders the field: H2 or the
plain render."""

from benchmark import roofline
from benchmark.metrics import _hash_march


def read(ctx: dict):
    trace, field = ctx.get("trace"), ctx.get("field")
    if trace is None or not trace.ops or trace.window_s <= 0 or not field \
            or not ctx.get("poses") or not ctx.get("hash_needed"):
        return None
    c = ctx["clip"]
    tower = 2.0 * roofline.vit_macs(c["image_size"], c["patch_size"], c["vision_width"],
                                    c["vision_layers"])
    render = ctx["hash_needed"] * _hash_march.sample_flops(field) / ctx["clip_batch"]
    return 100.0 * ctx["poses"] * (tower + render) / trace.window_s / roofline.PEAK_BF16_FLOPS
