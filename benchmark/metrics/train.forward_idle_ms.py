"""train.forward_idle_ms: milliseconds a training step that the device
idles while the host draws the batch or builds the loss: the traced
window's gaps between device operations whose midpoint falls inside a
``train.sample`` or ``train.forward`` span (nerf/trainer.py; the innermost
span there), over the ``train.steps`` counter."""

from benchmark.metrics import _spans


def read(ctx: dict):
    return _spans.idle_ms_per_step(ctx, ("train.sample", "train.forward"))
