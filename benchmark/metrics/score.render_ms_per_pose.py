"""score.render_ms_per_pose: device milliseconds a pose of the crop render
alone (nerf/combined.py::render_pose_batch: crop rays, K1 through
nerf/march_kernel.py, the composite over the background view), timed with
CUDA events over the traced poses' clip groups, one group a call."""


def read(ctx: dict):
    spans = ctx.get("spans")
    if not spans or not spans.get("poses"):
        return None
    return spans["render_ms"] / spans["poses"]
