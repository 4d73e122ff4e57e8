"""train.optim_idle_ms: milliseconds a training step that the device idles
while the host sets the learning rate and steps the optimizers: the traced
window's gaps whose midpoint falls inside a ``train.optim`` span
(nerf/trainer.py; the innermost span there), over the ``train.steps``
counter."""

from benchmark.metrics import _spans


def read(ctx: dict):
    return _spans.idle_ms_per_step(ctx, ("train.optim",))
