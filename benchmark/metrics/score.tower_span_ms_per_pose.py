"""score.tower_span_ms_per_pose: device milliseconds a pose of the CLIP
tower inside the traced window: the program's ``score.tower`` spans
(parallel/imagine.py, CUDA events from each clip group's rot90 through
reduce_logits) summed, over the poses the window's blocks scored
(``score.poses``). Nothing is read unless there is one span a clip group
(``score.groups``), each with its device time."""

from benchmark.metrics import _spans


def read(ctx: dict):
    got = _spans.scoring(ctx)
    if got is None:
        return None
    spans, counters = got
    return _spans.device_ms(spans, "score.tower") / counters["score.poses"]
