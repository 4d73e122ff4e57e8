"""score.block_fixed_ms: device milliseconds of a scoring block outside its
clip groups, averaged over the traced window's blocks: each ``score.block``
span's device time (scoring._fused_score, CUDA events around the whole
call) less the device time of the ``score.render`` and ``score.tower`` spans
of its request. That is the background render, each slab's preparation,
the drain, and the device's idle time between them. Nothing is read unless
the render and tower spans are one a clip group, each with its device
time."""

from benchmark.metrics import _spans


def read(ctx: dict):
    got = _spans.scoring(ctx)
    if got is None:
        return None
    spans = got[0]
    blocks = _spans.named(spans, "score.block")
    if not blocks or any(b["device_ms"] is None for b in blocks):
        return None
    groups: dict = {}
    for s in spans:
        if s["name"] in ("score.render", "score.tower"):
            groups[s["request"]] = groups.get(s["request"], 0.0) + s["device_ms"]
    return sum(b["device_ms"] - groups.get(b["id"], 0.0) for b in blocks) / len(blocks)
