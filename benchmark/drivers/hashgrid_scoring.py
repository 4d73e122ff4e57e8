"""Traffic: a task's candidate pose grid through the port's scoring loop
with both task fields instant-ngp hash-grid fields, Dream2Real's own
scoring configuration (the engine's ``ngp.field`` overrides with
``field_type`` ``hashgrid``, as ``reconstruction.field_spec`` takes them).

``scoring_grid``'s set-up, window, trace, check and faults, with this
module's ``Session`` in its place:

- both fields' leaves drawn from the seed as the configuration's
  ``weights`` says: each table uniform in +-1 (features of order one; the
  program's +-1e-4 initialisation would make the field a constant fog), the
  MLPs uniform in +-sqrt(6 / fan_in) at bf16 values;
- the configuration's ``field.grid`` made the program's ``HashGridConfig``;
- the traced run's render timed alone with the field packed as the crop
  path packs it (``combined.pack_crop``, H2's layout on the card; a program
  without it renders through ``render_rays``);
- the check's reference ``reference/hashgrid_scoring.py``, whose crop march
  also counts the samples the first traced clip group's rays need.

A traced run hands the per-layer readers the configuration's field and
those counts under ``hash_needed`` and ``hash_live``.
"""

from __future__ import annotations

import math
from unittest import mock

from benchmark import harness, scene
from benchmark.drivers import scoring_grid
from benchmark.reference import hashgrid_scoring as ref_hs
from benchmark.reference.precision import REFERENCE, Precision

FAULTS = scoring_grid.FAULTS
plant = scoring_grid.plant


def field_specs(torch, cfg: dict) -> list:
    """The hash-grid field's leaves as the port names them, (in, out)
    layout: the table (L, T, F) uniform in +-1, the bias-free density and
    colour layers uniform in +-sqrt(6 / fan_in)."""
    g = cfg["grid"]
    L, F = g["n_levels"], g["n_features"]
    specs = [("table", (L, 1 << g["log2_hashmap_size"], F), "uniform", 1.0, torch.float32)]
    dims = [L * F] + [cfg["hidden_dim"]] * (cfg["n_density_layers"] - 1) + \
        [1 + cfg["geo_feat_dim"]]
    cdims = [cfg["geo_feat_dim"] + cfg["sh_degree"] ** 2] + \
        [cfg["color_width"]] * (cfg["n_color_layers"] - 1) + [3]
    for prefix, ds in (("sigma_w", dims), ("color_w", cdims)):
        for i in range(len(ds) - 1):
            specs.append((f"{prefix}{i}", (ds[i], ds[i + 1]), "uniform", math.sqrt(6.0 / ds[i]),
                          torch.float32))
    return specs


def field_weights(torch, gen, cfg: dict, device) -> dict:
    """The leaves from one uniform draw; the layers held at bf16-exact
    float32 values (the field rounds its weights to bf16 at every use), the
    table in float32 as the field keeps it."""
    w = scene.draw(torch, gen, field_specs(torch, cfg), device)
    return {k: v if k == "table" else v.to(torch.bfloat16).to(torch.float32)
            for k, v in w.items()}


def _pack_crop(field, settings, device):
    """The crop path's layout of the field, or None where the program has
    no crop kernel for it (the plain render then)."""
    from dream2real_tpu_torch.nerf import combined

    pack = getattr(combined, "pack_crop", None)
    return None if pack is None else pack(field, settings, device)


class Session(scoring_grid.Session):
    def __init__(self, ctx: harness.RunContext):
        with mock.patch.object(scene, "field_weights", field_weights):
            super().__init__(ctx)

    def _build_program(self, eng: dict) -> None:
        from dream2real_tpu_torch.nerf.hashgrid import HashGridConfig

        fcfg = self.fcfg
        self.fcfg = dict(fcfg, grid=HashGridConfig(**fcfg["grid"]))
        try:
            super()._build_program(eng)
        finally:
            self.fcfg = fcfg

    def layer_spans(self, groups: int) -> dict:
        from dream2real_tpu_torch.nerf import march_kernel

        r = self.renderer
        with mock.patch.object(march_kernel, "pack_params",
                               lambda f: _pack_crop(f, r.crop_settings, self.dev)):
            return super().layer_spans(groups)

    def reference(self, idx, prec: Precision) -> dict:
        poses = self.torch.as_tensor(self.poses[idx], device=self.dev)
        return ref_hs.forward(self.reference_inputs(), poses, prec)

    def first_group_samples(self) -> tuple[int, int]:
        """The samples the first traced clip group's rays need, and its live
        rays, counted by the reference's crop march."""
        torch = self.torch
        inp = self.reference_inputs()
        fg = ref_hs.Field({k: v.float() for k, v in self.fg_w.items()}, self.fcfg, REFERENCE)
        needed = live = 0
        for i in self.scored[0][0][: self.cb]:
            o, d = ref_hs.scoring.pose_rays(inp["T_WO_1"],
                                            torch.as_tensor(self.poses[i], device=self.dev),
                                            inp["T_WC"], inp["dirs_cam"])
            _, _, _, n, lv = ref_hs.march_box(fg, o, d, self.obj_aabb, self.crop_d, count=True)
            needed, live = needed + n, live + lv
        return needed, live


def _with_session(fn, ctx: harness.RunContext, *args):
    with mock.patch.object(scoring_grid, "Session", Session):
        return fn(ctx, *args)


def run(ctx: harness.RunContext) -> harness.Outcome:
    out = _with_session(scoring_grid.run, ctx)
    if out.layer_ctx is not None:
        lc = out.layer_ctx
        lc["field"] = ctx.cell.config["field"]
        lc["hash_needed"], lc["hash_live"] = lc.pop("k1_needed"), lc.pop("k1_live")
    return out


def readings(ctx: harness.RunContext, control: bool) -> dict:
    """The numbers of one seed for the limits: one block of the cell's size
    scored, its sample compared with the reference; with ``control`` also
    the control's."""
    return _with_session(scoring_grid.readings, ctx, control)
