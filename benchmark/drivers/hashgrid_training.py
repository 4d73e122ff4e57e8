"""Traffic: a hash-grid task field's training chunks, as
``reconstruction.build_vis_model`` builds them with the field's type set to
``hashgrid`` (the engine's ``ngp.field`` overrides).

``field_training``'s run, readings, window, trace and faults, with this
module's ``Session`` in its place: the configuration's ``field.grid``
becomes the program's ``HashGridConfig``, and the check's reference is
``reference/hashgrid.py``. A traced run also hands the per-layer readers
the configuration's field (its grid and widths), for the hash encoding's
counts.
"""

from __future__ import annotations

from unittest import mock

from benchmark import harness
from benchmark.drivers import field_training
from benchmark.reference import hashgrid as ref_hashgrid
from benchmark.reference.precision import Precision

FAULTS = field_training.FAULTS
plant = field_training.plant
control_readings = field_training.control_readings


class Session(field_training.Session):
    def _build_program(self) -> None:
        from dream2real_tpu_torch.nerf.hashgrid import HashGridConfig

        fcfg = self.fcfg
        self.fcfg = dict(fcfg, grid=HashGridConfig(**fcfg["grid"]))
        try:
            super()._build_program()
        finally:
            self.fcfg = fcfg

    def reference(self, n: int, prec: Precision) -> dict:
        with mock.patch.object(field_training, "ref_training", ref_hashgrid):
            return super().reference(n, prec)


def _with_session(fn, ctx: harness.RunContext, *args):
    with mock.patch.object(field_training, "Session", Session):
        return fn(ctx, *args)


def run(ctx: harness.RunContext) -> harness.Outcome:
    out = _with_session(field_training.run, ctx)
    if out.layer_ctx is not None:
        out.layer_ctx["field"] = ctx.cell.config["field"]
    return out


def readings(ctx: harness.RunContext, control: bool) -> dict:
    """The numbers of one seed for the limits: the program's first steps
    against the reference's; with ``control`` also the control's."""
    return _with_session(field_training.readings, ctx, control)
