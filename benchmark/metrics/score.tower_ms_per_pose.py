"""score.tower_ms_per_pose: device milliseconds a pose of the CLIP tower
alone (rot90, preprocess, clip/model.py::encode_image with K2/K3 and the
gemm_tma GEMMs, the logits and reduce_logits) over the same clip groups'
frames, rendered beforehand, timed with CUDA events."""


def read(ctx: dict):
    spans = ctx.get("spans")
    if not spans or not spans.get("poses"):
        return None
    return spans["tower_ms"] / spans["poses"]
