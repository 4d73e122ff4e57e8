"""train.graph_step_share: the share of the traced window's training steps
that were replays of the step's CUDA graph: the ``train.graph_steps``
counter over the ``train.steps`` counter (nerf/trainer.py), in percent.
Nothing is read unless the window holds one ``train.step`` span a counted
step, or where the program counts no replayed step (an eager trainer, or a
program without the graph)."""

from benchmark.metrics import _spans


def read(ctx: dict):
    got = _spans.steps(ctx)
    if got is None:
        return None
    st, _ = got
    counters = _spans.window(ctx)[1]
    graph_steps = counters.get("train.graph_steps")
    if not graph_steps:
        return None
    return 100.0 * graph_steps / len(st)
