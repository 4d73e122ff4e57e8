"""score.mfu: the scoring window's model operations over the card's bf16
peak: every pose's forward through the published ViT-L/14@336 vision tower
(190.9 G multiply-adds) and its render's field samples, counted as for K1
(the first traced group's needed samples a pose, for every pose), over the
traced window's length."""

from benchmark import roofline


def read(ctx: dict):
    trace = ctx.get("trace")
    if trace is None or not trace.ops or trace.window_s <= 0 or not ctx.get("poses") or not ctx.get("k1_needed"):
        return None
    c = ctx["clip"]
    tower = 2.0 * roofline.vit_macs(c["image_size"], c["patch_size"], c["vision_width"],
                                    c["vision_layers"])
    render = roofline.k1_flops(ctx["k1_needed"]) / ctx["clip_batch"]
    flops = ctx["poses"] * (tower + render)
    return 100.0 * flops / trace.window_s / roofline.PEAK_BF16_FLOPS
