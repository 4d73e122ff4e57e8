"""Batched pose-validity checks on the device: collision, support, stability,
dedup, regrasp (port of dream2real_tpu/physics/collision.py).

The reference runs PyBullet one pose at a time (hot loop #3 of its pipeline);
here every test is an array op over a whole chunk of poses. The movable
object is a fixed-size point set (its TSDF shell); the static world is the
background TSDF's solid voxels, sampled trilinearly:

- duplicate-orientation dedup over the first ``sampled_oris_per_pos`` block,
  repeated across positions;
- regrasp gate: the object's z axis must face +z or -y within 0.9 cos
  (embodied runs only);
- collision: at the candidate pose the movable must NOT hit the world;
- support: lowered by ``unsup_thresh`` (2 cm) it MUST hit something, or the
  pose is below table level (tested on the UN-lowered z, as the reference);
- stability: all four 4 cm lateral shifts of the lowered pose must still hit.

One device. Arithmetic is elementwise f32 in a fixed order (the pose products
too, written out rather than left to a GEMM), so that the card and the CPU
give the same bits; a constant divisor is applied as a multiplication by its
f32 reciprocal, as XLA compiles the JAX package's division by a constant.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from dream2real_tpu_torch.device import F32, resolve_device
from dream2real_tpu_torch.ops.se3 import pose_inverse
from dream2real_tpu_torch.physics.tsdf import TSDFGrid

GRAVITY_DIRECTION = np.array([0.0, 0.0, -1.0])
# The four lateral shifts of the stability test (metres, along x and y).
STABILITY_SHIFT = 0.04


def _recip(v: float) -> np.float32:
    return np.float32(1.0) / np.float32(v)


def _trilinear(occ_flat, dims, origin, inv_voxel, x, y, z) -> torch.Tensor:
    """Trilinear sample of a flattened (X*Y*Z,) grid at world points given by
    their coordinates x, y, z (one shape). Out-of-grid -> 0. One corner at a
    time, gathered through one linear index."""
    X, Y, Z = dims
    g = [(x - origin[0]) * inv_voxel, (y - origin[1]) * inv_voxel,
         (z - origin[2]) * inv_voxel]
    g0 = [torch.floor(a) for a in g]
    frac = [a - a0 for a, a0 in zip(g, g0)]
    inside = None
    for a, n in zip(g, dims):
        ok = (a >= 0) & (a <= n - 1)
        inside = ok if inside is None else inside & ok
    del g

    def idx(a0, o, n):
        return torch.clamp(a0 + o, 0, n - 1).to(torch.int32)

    c = None
    for ox in (0, 1):
        wx = frac[0] if ox else 1.0 - frac[0]
        ix = idx(g0[0], ox, X)
        for oy in (0, 1):
            wy = frac[1] if oy else 1.0 - frac[1]
            ixy = (ix * Y + idx(g0[1], oy, Y)) * Z
            for oz in (0, 1):
                wz = frac[2] if oz else 1.0 - frac[2]
                term = occ_flat[ixy + idx(g0[2], oz, Z)] * wx * wy * wz
                c = term if c is None else c + term
    return torch.where(inside, c, 0.0)


def sample_occupancy(grid_occ, origin, voxel_size, points) -> torch.Tensor:
    """Trilinear-sample a float occupancy grid at world points.

    grid_occ: (X, Y, Z) float tensor; origin (3,); points: (..., 3) on the
    grid's device. Out-of-grid -> 0.
    """
    dev = grid_occ.device
    origin = torch.as_tensor(origin, dtype=F32, device=dev)
    points = torch.as_tensor(points, dtype=F32, device=dev)
    inv = torch.tensor(_recip(voxel_size), device=dev)
    return _trilinear(grid_occ.reshape(-1), tuple(grid_occ.shape), origin, inv,
                      points[..., 0], points[..., 1], points[..., 2])


def orientation_dedup_mask(pose_batch: torch.Tensor, sampled_oris_per_pos: int,
                           atol: float = 0.01) -> torch.Tensor:
    """(N, 4, 4) -> (N,) bool, True = keep: drops a rotation of the first
    per-position block that repeats an earlier one within atol, and repeats
    the block's mask over the positions."""
    n = pose_batch.shape[0]
    o = sampled_oris_per_pos
    first = pose_batch[:o, :3, :3]
    diff = (first[:, None] - first[None, :]).abs().amax(dim=(-1, -2))  # (o, o)
    close = diff <= atol
    lower = torch.tril(torch.ones((o, o), dtype=torch.bool, device=pose_batch.device),
                       diagonal=-1)
    keep_block = ~torch.any(close & lower, dim=1)
    return keep_block.repeat(n // o)


def regrasp_mask(pose_batch: torch.Tensor, sampled_oris_per_pos: int) -> torch.Tensor:
    """Orientation gate for embodied runs: the object z axis must face +z or
    -y within cos > 0.9. (N, 4, 4) -> (N,) bool."""
    n = pose_batch.shape[0]
    o = sampled_oris_per_pos
    z_axis = pose_batch[:o, :3, 2]
    up = z_axis[:, 2] > 0.9
    neg_y = -z_axis[:, 1] > 0.9
    return (up | neg_y).repeat(n // o)


def _compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(C, 4, 4) @ (4, 4), each entry summed over k = 0..3 in order."""
    out = A[:, :, 0, None] * B[0]
    for k in range(1, 4):
        out = out + A[:, :, k, None] * B[k]
    return out


class UnsupColCheck:
    """check(pose_batch (N, 16)) -> (N,) bool on the check's device.

    The geometric tests run over chunks of ``D2R_PHYS_CHUNK`` (default 16384)
    poses, after compaction to the dedup / regrasp survivors. Unlike the JAX
    package the last chunk is not padded with identity poses: shapes need
    not be static here. After a call, ``last_survivors`` and ``last_chunks``
    say how many poses reached the geometric tests and in how many chunks.
    """

    def __init__(self, bg_grid: TSDFGrid, movable_points, movable_init_pose, scene_centre,
                 sample_res, unsup_thresh: float, disallow_regrasp: bool,
                 stability_check: bool, occ_thresh: float, tsdf_occ_thresh: float, device):
        dev = self.device = device
        grid = bg_grid.to(dev)
        self.occ = grid.occupancy(tsdf_occ_thresh).to(F32).reshape(-1)
        self.dims = tuple(grid.tsdf.shape)
        self.origin = grid.origin.to(F32)
        self.inv_voxel = torch.tensor(_recip(grid.voxel_size), device=dev)
        pts = torch.as_tensor(np.asarray(movable_points, np.float32), device=dev)
        self.pts = pts[:, 0], pts[:, 1], pts[:, 2]
        self.pt_valid = pts[:, 3] > 0
        self.init_inv = pose_inverse(
            torch.as_tensor(np.asarray(movable_init_pose, np.float32), device=dev))
        # A pose's z is f32: compare it with the f32 table height.
        self.table_z = float(np.float32(scene_centre[2]))
        self.oris_per_pos = int(sample_res[3] * sample_res[4] * sample_res[5])
        self.lower = float(np.float32(unsup_thresh) * np.float32(-GRAVITY_DIRECTION[2]))
        self.disallow_regrasp = disallow_regrasp
        self.stability_check = stability_check
        self.occ_thresh = occ_thresh
        self.last_survivors = self.last_chunks = 0

    def _sample(self, x, y, z) -> torch.Tensor:
        s = _trilinear(self.occ, self.dims, self.origin, self.inv_voxel, x, y, z)
        return torch.where(self.pt_valid, s, 0.0)

    def _test_points(self, poses: torch.Tensor):
        """The point sets of each test, in order: the pose, the lowered pose,
        then (with the stability check) its four lateral shifts; each a
        triple of (C, M) coordinates."""
        tf = _compose(poses, self.init_inv)
        px, py, pz = self.pts
        pw = [tf[:, i, 0, None] * px + tf[:, i, 1, None] * py + tf[:, i, 2, None] * pz
              + tf[:, i, 3, None] for i in range(3)]
        yield pw
        x, y, z = pw[0], pw[1], pw[2] - self.lower
        yield x, y, z
        if self.stability_check:
            d = STABILITY_SHIFT
            yield x + d, y, z
            yield x - d, y, z
            yield x, y + d, z
            yield x, y - d, z

    def geom(self, poses: torch.Tensor) -> torch.Tensor:
        """Collision / support / stability over one chunk (C, 4, 4) -> (C,)."""
        tests = self._test_points(poses)
        valid = ~torch.any(self._sample(*next(tests)) > self.occ_thresh, dim=-1)
        below_table = poses[:, 2, 3] < self.table_z
        valid &= below_table | torch.any(self._sample(*next(tests)) > self.occ_thresh, dim=-1)
        if self.stability_check:
            stable = torch.ones_like(valid)
            for pts in tests:
                stable &= torch.any(self._sample(*pts) > self.occ_thresh, dim=-1)
            valid &= below_table | stable
        return valid

    def samples(self, pose_batch) -> torch.Tensor:
        """The sampled occupancy of every test point of every pose:
        (tests, N, M), where ties at ``occ_thresh`` can be read."""
        poses = torch.as_tensor(np.asarray(pose_batch, np.float32), device=self.device)
        return torch.stack([self._sample(*pts) for pts in
                            self._test_points(poses.reshape(-1, 4, 4))])

    def __call__(self, pose_batch) -> torch.Tensor:
        poses = torch.as_tensor(pose_batch, dtype=F32).to(self.device).reshape(-1, 4, 4)
        n = poses.shape[0]
        valid = orientation_dedup_mask(poses, self.oris_per_pos)
        if self.disallow_regrasp:
            valid &= regrasp_mask(poses, self.oris_per_pos)

        # Shelf-scale grids (2.2M poses) cannot run the point tests in one
        # launch, so the geometric check streams fixed-size chunks of the
        # dedup / regrasp survivors and scatters their results back.
        chunk = max(int(os.environ.get("D2R_PHYS_CHUNK", "16384")), 1)
        keep_idx = torch.nonzero(valid).squeeze(1)
        k = int(keep_idx.numel())
        self.last_survivors, self.last_chunks = k, -(-k // chunk)
        if k == 0:
            return valid
        if n <= chunk and k == n:
            return self.geom(poses) & valid  # small all-live batch: one launch
        survivors = poses[keep_idx]
        geo = torch.cat([self.geom(survivors[s : s + chunk]) for s in range(0, k, chunk)])
        out = valid.clone()
        out[keep_idx] = geo
        return out


def make_unsupcol_check(
    bg_grid: TSDFGrid,
    movable_points: np.ndarray,  # (M, 4) world pts at init pose + valid flag
    movable_init_pose: np.ndarray,  # (4, 4)
    scene_centre,
    sample_res,
    unsup_thresh: float = 0.02,
    disallow_regrasp: bool = False,
    stability_check: bool = True,
    occ_thresh: float = 0.5,
    tsdf_occ_thresh: float = -0.5,
    pose_sharding=None,
    device=None,
) -> UnsupColCheck:
    """Build the batched validity check on ``device`` (CUDA unless the
    caller names another; the grid moves there). Returns
    check(pose_batch (N, 16)) -> (N,) bool.

    tsdf_occ_thresh: voxels count as solid only when the TSDF is this far
    BEHIND the surface (in truncation units). Surface voxels (tsdf ~ 0) must
    not read as solid, else an object resting ON the table registers as
    colliding (Bullet's pairwise_collision fires on penetration, not
    contact).
    """
    if pose_sharding is not None:
        raise NotImplementedError(
            "pose_sharding: the port's validity check runs on one device")
    return UnsupColCheck(bg_grid, movable_points, movable_init_pose, scene_centre, sample_res,
                         unsup_thresh, disallow_regrasp, stability_check, occ_thresh,
                         tsdf_occ_thresh, resolve_device(device))
