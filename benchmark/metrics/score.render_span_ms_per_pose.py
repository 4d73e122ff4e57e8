"""score.render_span_ms_per_pose: device milliseconds a pose of the crop
render inside the traced window: the program's ``score.render`` spans
(parallel/imagine.py, CUDA events around each clip group's
render_pose_batch on the scoring stream) summed, over the poses the
window's blocks scored (``score.poses``, counted by scoring._fused_score).
Nothing is read unless there is one span a clip group (``score.groups``),
each with its device time."""

from benchmark.metrics import _spans


def read(ctx: dict):
    got = _spans.scoring(ctx)
    if got is None:
        return None
    spans, counters = got
    return _spans.device_ms(spans, "score.render") / counters["score.poses"]
