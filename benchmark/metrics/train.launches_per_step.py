"""train.launches_per_step: kernel launches a training step: the trace's
CUDA runtime calls whose name holds ``LaunchKernel`` that start inside one
of the program's ``train.step`` spans (nerf/trainer.py), over the
``train.steps`` counter. Nothing is read unless the window holds one span a
counted step, and a launch."""

import bisect

from benchmark.metrics import _spans


def read(ctx: dict):
    got = _spans.steps(ctx)
    if got is None:
        return None
    st, _ = got
    starts = [s["start_ns"] * 1e-9 for s in st]
    launches = 0
    for name, t, _ in ctx["trace"].host:
        i = bisect.bisect_right(starts, t) - 1
        if "LaunchKernel" in name and i >= 0 and t <= st[i]["end_ns"] * 1e-9:
            launches += 1
    return launches / len(st) if launches else None
