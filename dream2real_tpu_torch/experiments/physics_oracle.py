"""Physics valid-set agreement: SDF masks vs the ground-truth analytic oracle
(port of the repo's experiments/physics_oracle.py).

The validity check (physics/collision.py::make_unsupcol_check) decides on
TSDF-fused occupancy. This experiment builds it the way the engine does
(per-object TSDFs fused from rendered synth depth, physics/models.py::
get_phys_models; the bg grid + movable shell points into
make_unsupcol_check) and compares its decisions with physics/oracle.py: the
same collision / support / stability sequence evaluated with exact SAT box
tests on the scene's ground-truth geometry (no shared code or
representation).

Disagreements are banded by the oracle's signed contact margin: the SDF test
registers penetration only past about half a truncation (1.5 voxels = 6 mm
at 4 mm voxels), so disagreements must concentrate in a band of about one
truncation around each decision boundary. Beyond the structural band (one
truncation + the unobservable bottom-face gap), above the table, agreement
must be exact.

Usage: python -m dream2real_tpu_torch.experiments.physics_oracle [out.json] [--cpu]
Knobs: D2R_ORACLE_GRID="12,12,7,1,1,4" (default), D2R_ORACLE_VOXEL=0.004.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from dream2real_tpu_torch.data import synth
from dream2real_tpu_torch.physics.collision import make_unsupcol_check
from dream2real_tpu_torch.physics.models import get_phys_models
from dream2real_tpu_torch.physics.oracle import oracle_check, scene_static_boxes
from dream2real_tpu_torch.sampling import sample_poses_grid


def run(grid_res, voxel: float, n_views: int = 10, res: int = 336, device=None):
    """-> the agreement record (dict): the SDF masks on ``device`` (CUDA
    unless named) against the oracle."""

    scene = synth.default_scene()
    f = 0.9 * res
    K = np.array([[f, 0, res / 2], [0, f, res / 2], [0, 0, 1.0]])
    cams = synth.orbit_poses(scene.centre, n_views, radius=0.55, height=0.45)
    depths, masks = [], []
    for i in range(len(cams)):
        _, depth, inst = synth.render_scene(scene, cams[i], K, res, res)
        depths.append(depth)
        # Engine semantics: movable object = id 1 in a 2-object phys build
        # (0 = task background: table + every other box).
        masks.append(np.where(inst == 1, 1, 0).astype(np.uint8))

    scene_bounds = ((0.0, -0.45, -0.06), (1.0, 0.45, 0.4))
    handles, init_poses = get_phys_models(
        np.stack(depths), list(cams.astype(np.float32)), K, np.stack(masks),
        num_objs=2, scene_bounds=scene_bounds, save_dir=None, use_cache=False,
        voxel_size=voxel, device=device,
    )
    bg, fg = handles
    init_pose = init_poses[1]

    sample_res = list(grid_res)
    # Bounds chosen to straddle every decision: on-table rest, stacked on the
    # green box, interpenetration, floating, below-table; yaw sweep exercises
    # oriented contacts.
    bounds = ((-0.16, 0.16), (-0.18, 0.14), (-0.06, 0.13),
              (0.0, 0.0), (0.0, 0.0), (0.0, np.pi / 2))
    pose_batch = np.asarray(
        sample_poses_grid(scene.centre, sample_res, bounds_override=bounds)
    ).reshape(-1, 4, 4)
    # Absolute z of the candidate POSE should track the init pose's z (the
    # grid z axis samples object-centre heights): shift so z=scene range
    # covers rest height.
    n = len(pose_batch)
    print(f"# {n} candidate poses, voxel {voxel}, grid {sample_res}")

    check = make_unsupcol_check(
        bg.tsdf, fg.points, init_pose, scene.centre, sample_res, device=device,
    )
    sdf_valid = check(pose_batch.reshape(n, 16)).cpu().numpy()

    b0 = scene.boxes[0]
    oracle = oracle_check(
        pose_batch, init_pose, b0.lo, b0.hi,
        scene_static_boxes(scene, movable_idx=0),
        table_z=scene.centre[2],
    )

    agree = sdf_valid == oracle["valid"]
    # Controlling margin per pose: distance from the nearest decision
    # boundary the oracle used for the FINAL decision.
    margins = np.where(
        oracle["collide"], oracle["col_margin"],
        np.where(
            ~oracle["supported"],
            np.abs(oracle["sup_margin"]),
            np.where(
                ~oracle["stable"], np.abs(oracle["stab_margin"]),
                np.minimum(
                    np.abs(oracle["col_margin"]),
                    np.where(
                        oracle["below_table"], np.inf,
                        np.minimum(np.abs(oracle["sup_margin"]),
                                   np.abs(oracle["stab_margin"])),
                    ),
                ),
            ),
        ),
    )
    margins = np.abs(margins)
    trunc = 3.0 * voxel

    # Two STRUCTURAL divergences of the reference's own decision procedure
    # from platonic ground truth, shared by Bullet-on-fused-meshes and the
    # SDF masks alike:
    # 1. below-table poses: accepted by the reference's explicit escape
    #    (physics_utils.py:334-336) even though they interpenetrate the real
    #    table — the fused bg geometry has neither table interior nor an
    #    unoccluded surface there. The oracle (true table slab) flags them.
    # 2. reconstruction bias: the movable's resting bottom face is never
    #    observed, so BOTH reconstructed representations miss its lowest
    #    `bottom_gap` metres; support/stability boundaries shift by that gap.
    pts = np.asarray(fg.points)
    pvalid = pts[:, 3] > 0
    bottom_gap = float(pts[pvalid, 2].min() - np.asarray(b0.lo)[2])
    above = ~oracle["below_table"]
    struct_band = trunc + max(bottom_gap, 0.0)

    bands = {}
    for name, sel0 in (("all", np.ones(n, bool)), ("above_table", above)):
        for b, lab in ((0.5 * trunc, "0.5trunc"), (trunc, "1trunc"),
                       (struct_band, "structural"),
                       (2 * struct_band, "2structural")):
            sel = sel0 & (margins > b)
            bands[f"{name}_beyond_{lab}"] = {
                "agreement": float(agree[sel].mean()) if sel.any() else 1.0,
                "n": int(sel.sum()),
            }
    dis = np.nonzero(~agree)[0]
    out = {
        "n_poses": int(n),
        "voxel": voxel,
        "trunc": trunc,
        "bottom_gap": bottom_gap,
        "structural_band": struct_band,
        "grid": sample_res,
        "sdf_valid_frac": float(sdf_valid.mean()),
        "oracle_valid_frac": float(oracle["valid"].mean()),
        "agreement": float(agree.mean()),
        "agreement_above_table": float(agree[above].mean()),
        "n_above_table": int(above.sum()),
        "n_disagree": int(len(dis)),
        "disagree_margin_max": float(margins[dis].max()) if len(dis) else 0.0,
        "disagree_margin_p50": float(np.median(margins[dis])) if len(dis) else 0.0,
        "disagree_margin_max_above_table": float(
            margins[dis[above[dis]]].max()) if above[dis].any() else 0.0,
        "bands": bands,
        "disagree_stages": {
            "oracle_collide": int(oracle["collide"][dis].sum()),
            "oracle_unsupported": int((~oracle["supported"])[dis].sum()),
            "oracle_unstable": int(
                (oracle["supported"] & ~oracle["stable"])[dis].sum()
            ),
            "oracle_valid_sdf_invalid": int(
                (oracle["valid"] & ~sdf_valid)[dis].sum()
            ),
            "below_table": int(oracle["below_table"][dis].sum()),
        },
    }
    return out


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    device = "cpu" if "--cpu" in sys.argv else None
    grid = [int(v) for v in
            os.environ.get("D2R_ORACLE_GRID", "12,12,7,1,1,4").split(",")]
    voxel = float(os.environ.get("D2R_ORACLE_VOXEL", "0.004"))
    out = run(grid, voxel, device=device)
    print(json.dumps(out, indent=1), flush=True)
    if args:
        with open(args[0], "w") as fh:
            json.dump(out, fh, indent=1)
        print(f"# wrote {args[0]}")
    check_agreement(out, min_n=500)


def check_agreement(out: dict, min_n: int) -> None:
    """The gate: above the table (excluding the reference's intentional
    below-table acceptance) and outside the structural band (one truncation
    + the unobservable bottom-face gap) of every decision boundary, the SDF
    masks must agree with ground truth EXACTLY, over at least min_n poses."""
    band = out["bands"]["above_table_beyond_structural"]
    if band["agreement"] != 1.0 or band["n"] < min_n:
        raise AssertionError(f"agreement beyond the structural band: {band} (n >= {min_n})")
    if out["disagree_margin_max_above_table"] > out["structural_band"]:
        raise AssertionError(f"a disagreement above the table lies beyond the structural band: "
                             f"{out['disagree_margin_max_above_table']} > "
                             f"{out['structural_band']}")


if __name__ == "__main__":
    main()
