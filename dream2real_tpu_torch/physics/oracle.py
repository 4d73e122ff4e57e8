"""Independent host-side oracle for the pose-validity checks (a copy of
dream2real_tpu/physics/oracle.py: numpy only).

The production validity masks (physics/collision.py) test SDF occupancy of
TSDF-fused geometry — reconstruction plus a voxel-banded collision test. This
module re-implements the SAME decision sequence (reference
vision_3d/physics_utils.py:308-370: collision -> drop-support -> stability,
with the below-table escape on the UNlowered absolute pose z) against the
GROUND-TRUTH analytic geometry of a synth scene (data/synth.py boxes +
table plane), in pure numpy, with no shared code or representation:

- the movable object is its exact oriented box (OBB) under the candidate
  transform pose @ inv(init_pose);
- the static world is the other boxes (AABBs) plus the table modelled as a
  thin slab below plane_z;
- collision is a separating-axis (SAT) OBB-vs-AABB test, Bullet's
  penetration semantics (contact at distance 0 is NOT a collision).

Besides boolean decisions it returns signed MARGINS (penetration depth > 0,
separation < 0) per stage, so agreement with the SDF masks can be banded by
distance from the decision boundary: the SDF test only registers ~half a
truncation (1.5 voxels) of penetration, so disagreements must concentrate
within a |margin| <~ truncation band around zero.

Used by experiments/physics_oracle.py (agreement rates by band).
"""

from __future__ import annotations

import numpy as np

GRAVITY_DIRECTION = np.array([0.0, 0.0, -1.0])


def obb_aabb_margin(centers, rots, half_obb, box_lo, box_hi):
    """Signed SAT margin of N oriented boxes vs one axis-aligned box.

    centers (N, 3), rots (N, 3, 3) world-from-obb, half_obb (3,),
    box_lo/hi (3,). Returns (N,) float: > 0 = penetration depth (the minimum
    translation distance over the tested axes), < 0 = separation (a lower
    bound: the largest gap over separating axes). Exact for the overlap
    DECISION (SAT over the full 15-axis set is exact for convex boxes).
    """
    centers = np.asarray(centers, np.float64)
    rots = np.asarray(rots, np.float64)
    e = np.asarray(half_obb, np.float64)
    b_c = (np.asarray(box_lo, np.float64) + np.asarray(box_hi, np.float64)) / 2
    b_h = (np.asarray(box_hi, np.float64) - np.asarray(box_lo, np.float64)) / 2
    d = centers - b_c  # (N, 3)

    axes = []  # list of (N, 3) candidate separating axes
    n = centers.shape[0]
    eye = np.eye(3)
    for i in range(3):  # AABB face axes
        axes.append(np.broadcast_to(eye[i], (n, 3)))
    for j in range(3):  # OBB face axes
        axes.append(rots[:, :, j])
    for i in range(3):  # edge-edge cross products
        for j in range(3):
            axes.append(np.cross(np.broadcast_to(eye[i], (n, 3)), rots[:, :, j]))

    min_overlap = np.full(n, np.inf)
    max_gap = np.full(n, -np.inf)
    separated = np.zeros(n, bool)
    for L in axes:
        norm = np.linalg.norm(L, axis=1)
        ok = norm > 1e-9  # degenerate cross products carry no constraint
        Ln = L / np.where(ok, norm, 1.0)[:, None]
        proj = np.abs(np.einsum("ni,ni->n", d, Ln))
        r_a = np.abs(Ln) @ b_h
        # r_obb along Ln: sum_j e_j |Ln . R_j|
        r_b = np.abs(np.einsum("ni,nij->nj", Ln, rots)) @ e
        overlap = r_a + r_b - proj
        overlap = np.where(ok, overlap, np.inf)
        sep_here = overlap < 0
        separated |= sep_here
        min_overlap = np.minimum(min_overlap, overlap)
        max_gap = np.maximum(max_gap, np.where(sep_here, -overlap, -np.inf))
    return np.where(separated, -np.where(np.isfinite(max_gap), max_gap, 0.0), min_overlap)


def scene_static_boxes(scene, movable_idx: int, table_extent=0.8,
                       table_thickness: float = 0.05):
    """Static-world AABBs for a synth scene: every non-movable box plus the
    table plane as a thin slab [plane_z - thickness, plane_z] around the
    scene centre."""
    boxes = []
    for i, b in enumerate(scene.boxes):
        if i != movable_idx:
            boxes.append((np.asarray(b.lo), np.asarray(b.hi)))
    cx, cy = scene.centre[0], scene.centre[1]
    boxes.append((
        np.array([cx - table_extent, cy - table_extent,
                  scene.plane_z - table_thickness]),
        np.array([cx + table_extent, cy + table_extent, scene.plane_z]),
    ))
    return boxes


def oracle_check(
    pose_batch: np.ndarray,      # (N, 4, 4) candidate world poses
    init_pose: np.ndarray,       # (4, 4) movable init pose (phys-model frame)
    movable_lo, movable_hi,      # GT movable box bounds at its scene pose
    static_boxes,                # list of (lo, hi) AABBs (world)
    table_z: float,              # scene_centre[2] (reference below_table ref)
    unsup_thresh: float = 0.02,
    stability_check: bool = True,
):
    """Reference-semantics validity decisions on ground-truth geometry.

    Returns dict of (N,) arrays: collide, supported, stable, valid (bool) and
    col_margin / sup_margin / stab_margin (float, signed penetration depth of
    the controlling contact — the distance this pose sits from flipping that
    stage's decision).
    """
    poses = np.asarray(pose_batch, np.float64).reshape(-1, 4, 4)
    n = len(poses)
    tf = poses @ np.linalg.inv(np.asarray(init_pose, np.float64))
    lo = np.asarray(movable_lo, np.float64)
    hi = np.asarray(movable_hi, np.float64)
    c0 = (lo + hi) / 2
    half = (hi - lo) / 2

    def world_margin(extra_t):
        """Max SAT margin of the (transformed + translated) movable over all
        static boxes — the controlling contact."""
        centers = np.einsum("nij,j->ni", tf[:, :3, :3], c0) + tf[:, :3, 3] + extra_t
        rots = tf[:, :3, :3]
        m = np.full(n, -np.inf)
        for blo, bhi in static_boxes:
            m = np.maximum(m, obb_aabb_margin(centers, rots, half, blo, bhi))
        return m

    zero = np.zeros(3)
    col_margin = world_margin(zero)
    collide = col_margin > 0

    low_t = unsup_thresh * GRAVITY_DIRECTION
    sup_margin = world_margin(low_t)
    below_table = poses[:, 2, 3] < table_z  # UNlowered z (physics_utils:334-336)
    supported = below_table | (sup_margin > 0)

    stab_margin = np.full(n, np.inf)
    if stability_check:
        for v in ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0)):
            pert = low_t + 0.04 * np.asarray(v, np.float64)
            stab_margin = np.minimum(stab_margin, world_margin(pert))
    stable = below_table | (stab_margin > 0)

    valid = ~collide & supported & stable
    return {
        "collide": collide, "supported": supported, "stable": stable,
        "valid": valid, "below_table": below_table,
        "col_margin": col_margin, "sup_margin": sup_margin,
        "stab_margin": stab_margin,
    }
