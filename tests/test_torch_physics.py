"""The port's physics layer against the JAX package's, on the CPU.

Mirrors tests/test_physics.py: the synth scene of its ``fused_scene`` fixture
(96 x 128, 10 views, 1 cm voxels) and seeded numpy inputs go through each
JAX function and its port counterpart. Tolerances:

- erode / dilate, dedup, regrasp, marching tets, cluster pruning, the OBJ
  round trip, the oracle's decisions: identical;
- distort_coords 1e-6; sample_occupancy 1e-6; the oracle's margins 1e-12;
- fuse_tsdf: weights identical except at a shown tie (the voxel's f64
  projection within TIE_PX pixels of an image edge or of a half pixel, or its
  sdf within TIE_SDF of the truncation band's edge, in some frame), the tsdf
  within 1e-5 where observed, occupancy identical;
- validity masks identical (every difference would have to be a shown tie:
  a sampled value within 1e-5 of occ_thresh; none occurs here);
- get_phys_models: the same artifact files, init poses within 1e-6, npz keys
  and dtypes identical and their contents within the fusion tolerances;
  caches replay across the packages with identical handles.
"""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dream2real_tpu import cfg as jcfg
from dream2real_tpu import scene_model as jscene
from dream2real_tpu.data import synth as jsynth
from dream2real_tpu.ops import cameras as jcam
from dream2real_tpu.ops import image as jimage
from dream2real_tpu.ops.se3 import euler_angles_to_matrix, make_pose
from dream2real_tpu.physics import collision as jcol
from dream2real_tpu.physics import mesh as jmesh
from dream2real_tpu.physics import models as jmodels
from dream2real_tpu.physics import oracle as joracle
from dream2real_tpu.physics import poisson as jpoisson
from dream2real_tpu.physics import tsdf as jtsdf
from dream2real_tpu.registration import estimate_normals as j_estimate_normals
from dream2real_tpu.sampling import sample_poses_grid as j_sample_poses_grid
from dream2real_tpu_torch import cfg as tcfg
from dream2real_tpu_torch import scene_model as tscene
from dream2real_tpu_torch.bridge import phys_model_from_arrays
from dream2real_tpu_torch.device import to_numpy
from dream2real_tpu_torch.ops import cameras as tcam
from dream2real_tpu_torch.ops import image as timage
from dream2real_tpu_torch.physics import collision as tcol
from dream2real_tpu_torch.physics import mesh as tmesh
from dream2real_tpu_torch.physics import models as tmodels
from dream2real_tpu_torch.physics import oracle as toracle
from dream2real_tpu_torch.physics import poisson as tpoisson
from dream2real_tpu_torch.physics import tsdf as ttsdf
from dream2real_tpu_torch.registration import estimate_normals as t_estimate_normals
from dream2real_tpu_torch.utils.profiling import StageTimer

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
BOUNDS = ((0.2, -0.35, -0.05), (0.85, 0.35, 0.3))
SHELL_BOUNDS = ((0.2, -0.35, 0.0), (0.85, 0.35, 0.3))
TIE_PX = 1e-4
TIE_SDF = 1e-4
with open(os.path.join(ROOT, "configs", "synth_demo_distort.json")) as _f:
    _cam = json.load(_f)["camera"]
DIST = np.array([_cam[k] for k in ("k1", "k2", "p1", "p2", "k3", "k4")], np.float32)


@pytest.fixture(scope="module")
def scene():
    sc = jsynth.default_scene()
    h, w = 96, 128
    f = 0.8 * w
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]])
    poses = jsynth.orbit_poses(sc.centre, 10, radius=0.55, height=0.5)
    depths, insts = [], []
    for p in poses:
        _, depth, inst = jsynth.render_scene(sc, p, K, h, w)
        depths.append(depth)
        insts.append(inst)
    return {"scene": sc, "depths": np.stack(depths), "insts": np.stack(insts),
            "poses": poses.astype(np.float32), "K": K}


def _fuse_both(d, mask, erosion, distortion=None, bounds=BOUNDS):
    gj = jtsdf.fuse_tsdf(jnp.asarray(d["depths"]), jnp.asarray(mask), jnp.asarray(d["poses"]),
                         jnp.asarray(d["K"]), bounds, voxel_size=0.01,
                         erosion_kernel=erosion, distortion=distortion)
    gt = ttsdf.fuse_tsdf(d["depths"], mask, d["poses"], d["K"], bounds, voxel_size=0.01,
                         erosion_kernel=erosion, distortion=distortion, device=CPU)
    return gj, gt


@pytest.fixture(scope="module")
def grids(scene):
    """JAX-fused bg / fg grids (erosion 1), the movable's shell points and
    init pose, as tests/test_physics.py builds them."""
    bg = _fuse_both(scene, scene["insts"] != 1, 1)[0]
    fg = _fuse_both(scene, scene["insts"] == 1, 1)[0]
    pts = jtsdf.occupied_points(fg, 256, mode="shell", bounds=SHELL_BOUNDS)
    init_pose = np.eye(4, dtype=np.float32)
    init_pose[:3, 3] = jtsdf.grid_centroid(fg)
    bg_t = phys_model_from_arrays(bg.tsdf, bg.weight, bg.origin, bg.voxel_size, None,
                                  device=CPU).tsdf
    return {"bg": bg, "bg_t": bg_t, "fg": fg, "pts": pts, "init_pose": init_pose}


# ------------------------------------------------------------------ image ops
@pytest.mark.parametrize("dtype", ["float32", "bool", "int32"])
@pytest.mark.parametrize("k", [1, 3, 8, 15, 20])
def test_erode_dilate_match_jax(k, dtype):
    rng = np.random.default_rng(k)
    x = rng.uniform(0, 1, (2, 37, 45))
    x = {"float32": x.astype(np.float32), "bool": x > 0.3,
         "int32": (x * 1000).astype(np.int32) - 500}[dtype]
    for jf, tf in ((jimage.erode, timage.erode), (jimage.dilate, timage.dilate)):
        want = np.asarray(jf(jnp.asarray(x), k))
        got = tf(torch.from_numpy(x), k).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_erode_even_kernel_sits_one_pixel_from_cv2():
    """One zero pixel at row 10, k = 8: the JAX package's erode (and the
    port's) zero rows 6-13, cv2's rows 7-14 (it anchors at k // 2)."""
    cv2 = pytest.importorskip("cv2")
    m = np.ones((24, 24), np.float32)
    m[10, 12] = 0
    rows = lambda a: sorted(set(np.nonzero(a == 0)[0]))  # noqa: E731
    got = timage.erode(torch.from_numpy(m), 8).numpy()
    assert rows(got) == list(range(6, 14)) == rows(np.asarray(jimage.erode(jnp.asarray(m), 8)))
    assert rows(cv2.erode(m, np.ones((8, 8), np.uint8))) == list(range(7, 15))
    # Odd kernels: the three agree.
    np.testing.assert_array_equal(timage.erode(torch.from_numpy(m), 15).numpy(),
                                  cv2.erode(m, np.ones((15, 15), np.uint8)))


def test_distortion_helpers_match_jax():
    assert tcam.normalize_distortion(None) is None
    assert tcam.normalize_distortion(np.zeros(6)) is None
    np.testing.assert_array_equal(tcam.normalize_distortion(DIST),
                                  jcam.normalize_distortion(DIST))
    rng = np.random.default_rng(0)
    x, y = rng.uniform(-0.8, 0.8, (2, 500)).astype(np.float32)
    xj, yj = jcam.distort_coords(jnp.asarray(x), jnp.asarray(y), jnp.asarray(DIST))
    xt, yt = tcam.distort_coords(torch.from_numpy(x), torch.from_numpy(y),
                                 torch.from_numpy(DIST))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-6)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-6)


# -------------------------------------------------------------------- fusion
def _fusion_ties(d, voxels, erosion, distortion, bounds=BOUNDS, voxel=0.01):
    """For each voxel index (V, 3): True if, in some frame, its projection
    (f64) lies within TIE_PX of an image edge or of a half pixel, or its sdf
    within TIE_SDF of -1, i.e. where an f32 rounding can flip the frame's
    vote."""
    origin, _ = ttsdf.grid_coords(bounds, voxel)
    p = origin.astype(np.float64) + voxels * voxel
    h, w = d["depths"].shape[1:]
    K = d["K"]
    masks = np.asarray(jimage.erode(jnp.asarray((d["mask"]).astype(np.float32)), erosion)) > 0.5 \
        if erosion > 1 else d["mask"]
    tie = np.zeros(len(voxels), bool)
    for i, T in enumerate(d["poses"].astype(np.float64)):
        Ti = np.linalg.inv(T)
        c = p @ Ti[:3, :3].T + Ti[:3, 3]
        xn, yn = c[:, 0] / c[:, 2], c[:, 1] / c[:, 2]
        if distortion is not None:
            xn, yn = tcam.distort_coords(xn, yn, distortion.astype(np.float64))
        u, v = xn * K[0, 0] + K[0, 2], yn * K[1, 1] + K[1, 2]
        near = lambda a, b: np.abs(a - b) < TIE_PX  # noqa: E731
        tie |= near(u, 0) | near(u, w - 1) | near(v, 0) | near(v, h - 1)
        tie |= near(np.abs(u - np.floor(u)), 0.5) | near(np.abs(v - np.floor(v)), 0.5)
        ui = np.clip(np.round(u), 0, w - 1).astype(int)
        vi = np.clip(np.round(v), 0, h - 1).astype(int)
        dep = np.where(masks[i][vi, ui], d["depths"][i][vi, ui], 0.0)
        tie |= (dep > 0) & (np.abs((dep - c[:, 2]) / (3 * voxel) + 1) < TIE_SDF)
    return tie


@pytest.mark.parametrize("distorted", [False, True], ids=["pinhole", "distorted"])
@pytest.mark.parametrize("erosion", [1, 8])
@pytest.mark.parametrize("obj", ["fg", "bg"])
def test_fuse_tsdf_matches_jax(scene, obj, erosion, distorted):
    mask = scene["insts"] == 1 if obj == "fg" else scene["insts"] != 1
    dist = DIST if distorted else None
    gj, gt = _fuse_both(scene, mask, erosion, dist)
    wj, wt = np.asarray(gj.weight), gt.weight.numpy()
    sj, st = np.asarray(gj.tsdf), gt.tsdf.numpy()
    assert gt.tsdf.dtype == torch.float32 and gt.shape == gj.shape
    np.testing.assert_array_equal(gt.origin.numpy(), np.asarray(gj.origin))
    assert gt.voxel_size == gj.voxel_size
    # A voxel whose weight differs, or whose observed tsdf is more than 1e-5
    # apart (another pixel read after a half-pixel tie), must be a shown tie.
    differ = np.argwhere((wj != wt) | ((wj > 0) & (np.abs(sj - st) > 1e-5)))
    ties = _fusion_ties({**scene, "mask": mask}, differ, erosion, dist)
    rest = wj > 0
    rest[tuple(differ.T)] = False
    print(f"{obj} erosion {erosion} {'distorted' if distorted else 'pinhole'}: "
          f"{int((wj != wt).sum())} weights differ, {len(differ)} voxels beyond the "
          f"tolerances, {int(ties.sum())} of them shown ties; elsewhere max |tsdf| gap "
          f"{np.abs(sj - st)[rest].max():.2e}")
    assert ties.all(), differ[~ties]
    assert len(differ) <= 4, "ties are rare: a systematic gap is not a tie"
    for thresh in (0.0, -0.5):
        occ_j = np.asarray(gj.occupancy(thresh))
        occ_t = gt.occupancy(thresh).numpy()
        np.testing.assert_array_equal(occ_t, occ_j)


def test_occupied_points_and_centroid_match_jax(scene):
    gj, gt = _fuse_both(scene, scene["insts"] == 1, 1)
    np.testing.assert_allclose(ttsdf.grid_centroid(gt), jtsdf.grid_centroid(gj), atol=1e-9)
    for kw in (dict(max_points=512), dict(max_points=64, mode="shell", bounds=SHELL_BOUNDS),
               dict(max_points=4096, thresh=-0.5)):
        np.testing.assert_array_equal(ttsdf.occupied_points(gt, **kw),
                                      jtsdf.occupied_points(gj, **kw))


# ---------------------------------------------------------------------- mesh
def _sphere_arrays(r=0.1, voxel=0.01):
    n = 32
    origin = np.array([-0.16, -0.16, -0.16], np.float32) + voxel / 2
    xs = origin[0] + voxel * np.arange(n)
    g = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), axis=-1)
    tsdf = np.clip((np.linalg.norm(g, axis=-1) - r) / (3 * voxel), -1, 1).astype(np.float32)
    return tsdf, np.ones((n, n, n), np.float32), origin, voxel


def _both_grids(tsdf, weight, origin, voxel):
    return (jtsdf.TSDFGrid(jnp.asarray(tsdf), jnp.asarray(weight), jnp.asarray(origin), voxel),
            phys_model_from_arrays(tsdf, weight, origin, voxel, None, device=CPU).tsdf)


def test_marching_tets_sphere_matches_jax():
    gj, gt = _both_grids(*_sphere_arrays())
    vj, fj = jmesh.extract_mesh(gj)
    vt, ft = tmesh.extract_mesh(gt)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft, fj)
    assert len(vt) > 100
    np.testing.assert_allclose(np.linalg.norm(vt, axis=1).mean(), 0.1, atol=0.005)
    np.testing.assert_array_equal(tmesh.mesh_center(vt), jmesh.mesh_center(vj))
    for a, b in zip(tmesh.largest_cluster(vt, ft), jmesh.largest_cluster(vj, fj)):
        np.testing.assert_array_equal(a, b)


def test_mesh_cluster_pruning_and_obj_roundtrip_match_jax(tmp_path):
    tsdf, weight, origin, voxel = _sphere_arrays()
    tsdf[2:4, 2:4, 2:4] = -0.5
    tsdf[1:5, 1:5, 1:5] = np.minimum(tsdf[1:5, 1:5, 1:5], 0.9)
    gj, gt = _both_grids(tsdf, weight, origin, voxel)
    vt, ft = tmesh.extract_mesh(gt)
    v2, f2 = tmesh.remove_small_clusters(vt, ft, keep_ratio=0.02)
    jv2, jf2 = jmesh.remove_small_clusters(*jmesh.extract_mesh(gj), keep_ratio=0.02)
    assert len(f2) < len(ft)
    np.testing.assert_array_equal(f2, jf2)
    np.testing.assert_array_equal(v2, jv2)
    crop = ((-0.05, -0.2, -0.2), (0.2, 0.2, 0.2))
    for a, b in zip(tmesh.crop_mesh(v2, f2, crop), jmesh.crop_mesh(jv2, jf2, crop)):
        np.testing.assert_array_equal(a, b)
    pt, pj = str(tmp_path / "t.obj"), str(tmp_path / "j.obj")
    tmesh.save_obj(pt, v2, f2)
    jmesh.save_obj(pj, jv2, jf2)
    assert open(pt).read() == open(pj).read()
    for a, b in zip(tmesh.load_obj(pt), jmesh.load_obj(pj)):
        np.testing.assert_array_equal(a, b)


# -------------------------------------------------------------------- checks
def test_sample_occupancy_matches_jax():
    occ = np.zeros((4, 4, 4), np.float32)
    occ[2, 2, 2] = 1.0
    q = np.array([[2.0, 2.0, 2.0], [2.5, 2.0, 2.0], [-5.0, 0.0, 0.0]], np.float32)
    got = tcol.sample_occupancy(torch.from_numpy(occ), np.zeros(3), 1.0, q).numpy()
    np.testing.assert_allclose(got, [1.0, 0.5, 0.0], atol=1e-6)
    rng = np.random.default_rng(3)
    grid = (rng.uniform(size=(7, 9, 5)) > 0.5).astype(np.float32)
    origin = np.array([0.1, -0.2, 0.05], np.float32)
    pts = rng.uniform(-0.05, 0.12, (2000, 3)).astype(np.float32) + origin
    want = np.asarray(jcol.sample_occupancy(jnp.asarray(grid), jnp.asarray(origin), 0.01,
                                            jnp.asarray(pts)))
    got = tcol.sample_occupancy(torch.from_numpy(grid), origin, 0.01, pts).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert 0 < (want > 0).mean() < 1


def test_orientation_dedup_and_regrasp_match_jax():
    eulers = np.array([[0, 0, 0], [0, 0, 1e-5], [0, 0, np.pi / 2], [0, 0, np.pi]])
    R = euler_angles_to_matrix(jnp.asarray(eulers))
    poses = make_pose(R, jnp.zeros((4, 3)))
    batch = np.array(jnp.concatenate([poses, poses.at[:, 2, 3].add(0.1)], axis=0))
    keep = tcol.orientation_dedup_mask(torch.from_numpy(batch), 4).numpy()
    np.testing.assert_array_equal(keep, [1, 0, 1, 1, 1, 0, 1, 1])
    np.testing.assert_array_equal(keep, np.asarray(jcol.orientation_dedup_mask(batch, 4)))
    rng = np.random.default_rng(1)
    e2 = rng.uniform(-np.pi, np.pi, (64, 3))
    e2[:3] = [[0, 0, 0], [np.pi, 0, 0], [np.pi / 2, 0, 0]]
    p2 = np.array(make_pose(euler_angles_to_matrix(jnp.asarray(e2)), jnp.zeros((64, 3))))
    rk = tcol.regrasp_mask(torch.from_numpy(p2), 64).numpy()
    np.testing.assert_array_equal(rk, np.asarray(jcol.regrasp_mask(jnp.asarray(p2), 64)))
    np.testing.assert_array_equal(rk[:3], [1, 0, 1])
    assert 0 < rk.sum() < 64


def _checks(g, sample_res, **kw):
    cj = jcol.make_unsupcol_check(g["bg"], g["pts"], g["init_pose"], jsynth.default_scene()
                                  .centre, sample_res, **kw)
    ct = tcol.make_unsupcol_check(g["bg_t"], g["pts"], g["init_pose"], jsynth.default_scene()
                                  .centre, sample_res, device=CPU, **kw)
    return cj, ct


def _masks_match(cj, ct, batch, occ_thresh=0.5):
    """Both masks; every difference must be a shown tie (none occurs on
    these grids)."""
    mj = np.asarray(cj(jnp.asarray(batch)))
    mt = ct(batch).numpy()
    differ = np.nonzero(mj != mt)[0]
    if len(differ):
        s = ct.samples(batch[differ]).numpy()
        gap = np.abs(s - occ_thresh).min(axis=(0, 2))
        raise AssertionError(f"{len(differ)} masks differ from JAX's; nearest sampled value "
                             f"to the threshold {gap}")
    return mt


def test_unsupcol_check_semantics_match_jax(grids):
    g = grids
    c = g["init_pose"][:3, 3]

    def pose_at(x, y, z):
        p = np.eye(4, dtype=np.float32)
        p[:3, 3] = [x, y, z]
        return p

    poses = np.stack([
        g["init_pose"],                      # 0: at rest on table -> valid
        pose_at(c[0], c[1], c[2] + 0.15),    # 1: floating -> unsupported
        pose_at(0.615, 0.115, c[2]),         # 2: inside the green box -> collision
        pose_at(c[0] + 0.2, c[1], c[2]),     # 3: elsewhere on the table -> valid
        pose_at(0.615, 0.115, c[2] + 0.06),  # 4: on the green box's lid -> valid
        pose_at(c[0], c[1], c[2] + 0.15),
        pose_at(c[0], c[1], c[2] + 0.15),
        pose_at(c[0], c[1], c[2] + 0.15),
    ]).reshape(8, 16)
    cj, ct = _checks(g, [8, 1, 1, 1, 1, 1], stability_check=False)
    valid = _masks_match(cj, ct, poses)
    np.testing.assert_array_equal(valid[:5], [1, 0, 0, 1, 1])
    assert valid.dtype == bool


def _batch48(init_pose):
    rng = np.random.default_rng(0)
    c = init_pose[:3, 3]
    t = c[None] + np.concatenate(
        [rng.uniform(-0.2, 0.2, (24, 2)), rng.uniform(-0.02, 0.15, (24, 1))], 1
    ).astype(np.float32)
    R = euler_angles_to_matrix(jnp.tile(jnp.asarray([[0, 0, 0], [0, 0, 1e-6]]), (24, 1)))
    return np.asarray(make_pose(R, jnp.asarray(np.repeat(t, 2, axis=0)))).reshape(-1, 16)


def test_unsupcol_check_chunked_matches_single_launch_and_jax(grids, monkeypatch):
    batch = _batch48(grids["init_pose"])
    cj, ct = _checks(grids, [24, 1, 1, 2, 1, 1])
    monkeypatch.setenv("D2R_PHYS_CHUNK", "7")  # << survivors (24): 4 chunks
    chunked = _masks_match(cj, ct, batch)
    assert (ct.last_survivors, ct.last_chunks) == (24, 4)
    monkeypatch.setenv("D2R_PHYS_CHUNK", "32768")
    single = _masks_match(cj, ct, batch)
    assert ct.last_chunks == 1
    np.testing.assert_array_equal(chunked, single)
    np.testing.assert_array_equal(ct.geom(torch.from_numpy(batch[::2].reshape(-1, 4, 4))
                                          ).numpy(), single[::2])
    assert chunked[1::2].sum() == 0, "duplicated orientations must dedup"
    assert 0 < chunked.sum() < len(batch), "batch must exercise both outcomes"


@pytest.mark.parametrize("opts", [{}, {"disallow_regrasp": True}, {"stability_check": False}],
                         ids=["default", "regrasp", "no_stability"])
def test_unsupcol_check_on_sampled_grids_matches_jax(grids, opts, monkeypatch):
    sc = jsynth.default_scene()
    monkeypatch.setenv("D2R_PHYS_CHUNK", "500")
    for sample_res, kw in (
        ([12, 12, 7, 1, 1, 1], dict(scene_type=3)),
        ([6, 6, 4, 2, 2, 3], dict(bounds_override=((-0.2, 0.2), (-0.2, 0.2), (-0.05, 0.15),
                                                   (0, np.pi / 2), (0, np.pi / 2), (0, np.pi)))),
    ):
        batch = np.asarray(j_sample_poses_grid(sc.centre, sample_res, **kw))
        cj, ct = _checks(grids, sample_res, **opts)
        valid = _masks_match(cj, ct, batch)
        assert 0 < valid.sum() < len(valid)


def test_check_samples_read_the_tests_points(grids):
    """``samples`` gives each test's sampled values: the collision test's
    maximum decides the collision verdict."""
    batch = _batch48(grids["init_pose"])[::2]
    _, ct = _checks(grids, [24, 1, 1, 1, 1, 1])
    s = ct.samples(batch)
    assert s.shape == (6, 24, 256)
    poses = torch.from_numpy(batch.reshape(-1, 4, 4))
    collide = (s[0] > 0.5).any(-1)
    valid = ct.geom(poses)
    assert not (valid & collide).any()


def test_physics_entry_points_need_a_device(grids):
    """CUDA by default: without a GPU each entry point raises unless given
    device='cpu'; the check refuses a pose sharding."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default is valid here")
    g = grids
    sc = jsynth.default_scene()
    z = np.zeros((1, 8, 8), np.float32)
    calls = [
        lambda: ttsdf.fuse_tsdf(z, z > 0, np.eye(4)[None], np.eye(3), BOUNDS),
        lambda: tmodels.get_phys_models(z, [np.eye(4)], np.eye(3), z.astype(int), 1, BOUNDS,
                                        use_cache=False),
        lambda: tcol.make_unsupcol_check(g["bg_t"], g["pts"], g["init_pose"], sc.centre,
                                         [1] * 6),
        lambda: tscene.TaskModel.create_lazy_phys_mods(
            _SceneModel(z, z.astype(int)), _Obj, BOUNDS, None),
        lambda: phys_model_from_arrays(z, z, np.zeros(3), 0.01, None),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    with pytest.raises(NotImplementedError, match="one device"):
        tcol.make_unsupcol_check(g["bg_t"], g["pts"], g["init_pose"], sc.centre, [1] * 6,
                                 pose_sharding=object(), device=CPU)


# ------------------------------------------------------------------- poisson
def test_outliers_and_normals_match_jax():
    rng = np.random.default_rng(0)
    dense = rng.uniform(0, 0.05, (500, 3)).astype(np.float32)
    pts = np.concatenate([dense, np.array([[1.0, 1.0, 1.0], [-0.8, 0.3, 2.0]], np.float32)])
    inl = tpoisson.remove_statistical_outliers(pts)
    np.testing.assert_array_equal(inl, jpoisson.remove_statistical_outliers(pts))
    assert not inl[-1] and not inl[-2] and inl[:500].mean() > 0.9
    np.testing.assert_array_equal(t_estimate_normals(dense, camera_location=(0, 0, 1)),
                                  j_estimate_normals(dense, camera_location=(0, 0, 1)))
    views = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (500, 1))
    np.testing.assert_array_equal(tpoisson.oriented_normals(dense, views),
                                  jpoisson.oriented_normals(dense, views))
    assert tpoisson.remove_statistical_outliers(np.zeros((0, 3), np.float32)).shape == (0,)


def test_poisson_indicator_and_mesh_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    dirs = rng.normal(size=(4000, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    centre = np.array([0.5, 0.0, 0.1], np.float32)
    pts = (centre + 0.06 * dirs).astype(np.float32)
    gj = jpoisson.poisson_indicator(pts, dirs.astype(np.float32))
    gt = tpoisson.poisson_indicator(pts, dirs.astype(np.float32), device=CPU)
    np.testing.assert_array_equal(gt.tsdf.numpy(), np.asarray(gj.tsdf))
    np.testing.assert_array_equal(gt.weight.numpy(), np.asarray(gj.weight))
    np.testing.assert_array_equal(gt.origin.numpy(), np.asarray(gj.origin))
    assert gt.voxel_size == gj.voxel_size
    inside = tcol.sample_occupancy(gt.tsdf, gt.origin, gt.voxel_size, centre[None]).numpy()
    assert inside[0] < 0
    for a, b in zip(tpoisson.poisson_mesh(gt, pts), jpoisson.poisson_mesh(gj, pts)):
        np.testing.assert_array_equal(a, b)
    tpoisson.write_pcd(str(tmp_path / "t.pcd"), pts[:10])
    jpoisson.write_pcd(str(tmp_path / "j.pcd"), pts[:10])
    assert open(tmp_path / "t.pcd").read() == open(tmp_path / "j.pcd").read()


# -------------------------------------------------------------- phys models
ARTIFACTS = ("mesh_concave_{i}.obj", "mesh_{i}.obj", "init_pose_{i}.txt", "tsdf_{i}.npz")


def _build(pkg, d, save_dir, use_cache=False, **kw):
    masks = np.where(d["insts"] == 1, 1, 0)
    if pkg == "jax":
        return jmodels.get_phys_models(
            jnp.asarray(d["depths"]), list(d["poses"]), d["K"], masks, num_objs=2,
            scene_bounds=BOUNDS, save_dir=save_dir, use_cache=use_cache, **kw)
    return tmodels.get_phys_models(
        d["depths"], list(d["poses"]), d["K"], masks, num_objs=2, scene_bounds=BOUNDS,
        save_dir=save_dir, use_cache=use_cache, device=CPU, **kw)


def _fuse_bounds(voxel):
    z_pad = 3.0 * voxel + 0.02 + voxel  # physics/models.py's z-padded floor
    return [[BOUNDS[0][0], BOUNDS[0][1], BOUNDS[0][2] - z_pad], list(BOUNDS[1])]


def _tsdf_object_matches(d, zt, zj, pose_t, pose_j, i, max_points, voxel=0.01):
    """The port's fused object i (npz zt, init pose pose_t) against the JAX
    package's (zj, pose_j): weights identical except at shown ties, the
    observed tsdf within 1e-5 elsewhere; then init pose (1e-6) and points
    (identical) equal, or, where a tie moved the grid, equal to what the
    port's own mesh and point pipeline gives on the JAX grid: the gap is the
    tie's, not the pipeline's."""
    mask = np.where(d["insts"] == 1, 1, 0) == i
    wj, wt, sj, st = zj["weight"], zt["weight"], zj["tsdf"], zt["tsdf"]
    differ = np.argwhere((wj != wt) | ((wj > 0) & (np.abs(sj - st) > 1e-5)))
    ties = _fusion_ties({**d, "mask": mask}, differ, 20 if i == 0 else 8, None,
                        bounds=_fuse_bounds(voxel), voxel=voxel)
    assert ties.all() and len(differ) <= 4, differ[~ties]
    if not len(differ):
        np.testing.assert_allclose(pose_t, pose_j, atol=1e-6)
        np.testing.assert_array_equal(zt["points"], zj["points"])
        return
    grid_j = phys_model_from_arrays(sj, wj, zj["origin"], zj["voxel_size"], None,
                                    device=CPU).tsdf
    _, _, pose_jt, pts_jt = tmodels.grid_artifacts(grid_j, BOUNDS,
                                                   max_points if i else 4 * max_points)
    np.testing.assert_allclose(pose_jt, pose_j, atol=1e-6)
    np.testing.assert_array_equal(pts_jt, zj["points"])


def _npz_match(dir_t, dir_j, i):
    """Same keys, dtypes and shapes; -> both archives."""
    zt, zj = np.load(os.path.join(dir_t, f"tsdf_{i}.npz")), np.load(
        os.path.join(dir_j, f"tsdf_{i}.npz"))
    assert sorted(zt.files) == sorted(zj.files)
    for key in zj.files:
        assert zt[key].dtype == zj[key].dtype and zt[key].shape == zj[key].shape, key
    np.testing.assert_array_equal(zt["origin"], zj["origin"])
    assert zt["voxel_size"] == zj["voxel_size"]
    return zt, zj


@pytest.mark.parametrize("path", ["tsdf", "pcd"])
def test_get_phys_models_matches_jax_and_caches_replay_across(scene, tmp_path, path):
    kw = (dict(voxel_size=0.01, max_points=256) if path == "tsdf"
          else dict(use_phys_tsdf=False, max_points=512, pcd_mask_erosion=3))
    dir_j, dir_t = str(tmp_path / "jax"), str(tmp_path / "torch")
    hj, pj = _build("jax", scene, dir_j, **kw)
    ht, pt = _build("torch", scene, dir_t, **kw)
    assert set(os.listdir(dir_t)) == set(os.listdir(dir_j))
    names = ARTIFACTS + (("obj_{i}.pcd",) if path == "pcd" else ())
    assert set(os.listdir(dir_t)) == {n.format(i=i) for n in names for i in range(2)}
    for i in range(2):
        zt, zj = _npz_match(dir_t, dir_j, i)
        if path == "tsdf":
            _tsdf_object_matches(scene, zt, zj, pt[i], pj[i], i, kw["max_points"])
        else:  # host numpy end to end: identical
            np.testing.assert_array_equal(pt[i], pj[i])
            for key in zj.files:
                np.testing.assert_array_equal(zt[key], zj[key], err_msg=key)
            assert (open(os.path.join(dir_t, f"obj_{i}.pcd")).read()
                    == open(os.path.join(dir_j, f"obj_{i}.pcd")).read())
        assert isinstance(ht[i].tsdf.tsdf, torch.Tensor) and ht[i].points.dtype == np.float32
    assert ht[1].mesh_path == os.path.join(dir_t, "mesh_1.obj") and os.fspath(ht[1]) == str(ht[1])
    assert set(tmodels.LAST_BUILD_INFO["stage_s"]) >= {"mesh", "save"}

    # Each package replays the other's cache with identical handles.
    rj, rpj = _build("jax", scene, dir_t, use_cache=True, **kw)
    rt, rpt = _build("torch", scene, dir_j, use_cache=True, **kw)
    assert set(tmodels.LAST_BUILD_INFO["stage_s"]) == {"cache"}
    for ours, ours_p, theirs, theirs_p in ((rt, rpt, hj, pj), (rj, rpj, ht, pt)):
        for a, ia, b, ib in zip(ours, ours_p, theirs, theirs_p):
            np.testing.assert_array_equal(ia, ib)
            assert os.path.basename(a.mesh_path) == os.path.basename(b.mesh_path)
            for key in ("tsdf", "weight", "origin"):
                np.testing.assert_array_equal(to_numpy(getattr(a.tsdf, key)),
                                              to_numpy(getattr(b.tsdf, key)))
            np.testing.assert_array_equal(a.points, b.points)
            assert a.tsdf.voxel_size == b.tsdf.voxel_size


class _Obj:
    mask_idx = 1


class _SceneModel:
    def __init__(self, depths, masks, poses=None, K=None):
        self.depths, self.masks = depths, masks
        self.opt_cam_poses = list(poses) if poses is not None else [np.eye(4)] * len(depths)
        self.intrinsics = K if K is not None else np.eye(3)
        self.distortion = None


def test_create_lazy_phys_mods_matches_jax(scene, tmp_path):
    sm = _SceneModel(scene["depths"], scene["insts"], scene["poses"], scene["K"])
    hj, pj = jscene.TaskModel.create_lazy_phys_mods(sm, _Obj, BOUNDS, str(tmp_path / "j"),
                                                    voxel_size=0.01)
    ht, pt = tscene.TaskModel.create_lazy_phys_mods(sm, _Obj, BOUNDS, str(tmp_path / "t"),
                                                    voxel_size=0.01, device=CPU)
    for i in range(2):
        zt, zj = _npz_match(str(tmp_path / "t"), str(tmp_path / "j"), i)
        _tsdf_object_matches(scene, zt, zj, pt[i], pj[i], i, 4096)
        assert os.path.basename(ht[i].mesh_path) == os.path.basename(hj[i].mesh_path)
    # The movable's models feed the check; its verdicts match the JAX one's.
    batch = np.asarray(j_sample_poses_grid(scene["scene"].centre, [8, 8, 3, 1, 1, 1],
                                           scene_type=3))
    cj = jcol.make_unsupcol_check(hj[0].tsdf, hj[1].points, pj[1], scene["scene"].centre,
                                  [8, 8, 3, 1, 1, 1])
    ct = tcol.make_unsupcol_check(ht[0].tsdf, ht[1].points, pt[1], scene["scene"].centre,
                                  [8, 8, 3, 1, 1, 1], device=CPU)
    _masks_match(cj, ct, batch)


def test_scene_model_objects():
    obj = tscene.ObjectModel("box", None, "m.obj", np.eye(4), None, 1)
    obj.update_pose(2 * np.eye(4))
    assert obj.pose[0, 0] == 2 and obj.tsdf is None and obj.collision_points is None
    sm = tscene.SceneModel((0.5, 0, 0), [obj], obj, None, None, None, None,
                           np.array([[0, 1], [1, 1]]), None, 3)
    tm = tscene.TaskModel("put", "goal", ["norm"], sm, obj, tscene.ObjectModel(
        "__task_bground__", "field", None, np.eye(4), None, None), None, False)
    np.testing.assert_array_equal(tm.movable_masks, [[True, False], [False, False]])
    tm.free_visual_models()
    assert tm.task_bground_obj.vis_model is None
    # The point-cloud visual models: the movable's pixels of one view.
    rgbs = np.full((1, 20, 20, 3), 90, np.uint8)
    depths = np.full((1, 20, 20), 0.5, np.float32)
    masks = np.zeros((1, 20, 20), np.int64)
    masks[0, 2:19, 2:19] = 1
    sm2 = tscene.SceneModel((0.5, 0, 0), [obj], obj, rgbs, depths, [np.eye(4)],
                            np.array([[20.0, 0, 10], [0, 20.0, 10], [0, 0, 1]]), masks,
                            [[-1, -1, 0], [1, 1, 1]], 3)
    pcd = tscene.TaskModel.create_movable_vis_model(sm2, obj, None, None, use_vis_pcds=True,
                                                    pcds_type=0)
    assert pcd.points.shape == (9, 3) and (pcd.colors == 90).all()
    o2 = tscene.ObjectModel2D("a", None, None, (1, 2), None)
    assert o2.pos == (1, 2)


# -------------------------------------------------------------------- oracle
def test_oracle_matches_jax():
    rng = np.random.default_rng(0)
    n = 300
    c = rng.uniform(-1.5, 1.5, (n, 3))
    eul = rng.uniform(-np.pi, np.pi, (n, 3))
    R = np.asarray(euler_angles_to_matrix(jnp.asarray(eul, jnp.float32)), np.float64)
    args = (c, R, (0.3, 0.2, 0.1), (-0.5, -0.4, -0.3), (0.5, 0.4, 0.3))
    np.testing.assert_allclose(toracle.obb_aabb_margin(*args), joracle.obb_aabb_margin(*args),
                               atol=1e-12)
    sc = jsynth.default_scene()
    boxes = toracle.scene_static_boxes(sc, movable_idx=0)
    for (a, b), (ja, jb) in zip(boxes, joracle.scene_static_boxes(sc, movable_idx=0)):
        np.testing.assert_array_equal(a, ja)
        np.testing.assert_array_equal(b, jb)
    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, :3, :3] = R
    poses[:, :3, 3] = np.asarray(sc.centre) + rng.uniform(-0.2, 0.2, (n, 3))
    init = np.eye(4)
    init[:3, 3] = [0.46, -0.08, 0.05]
    b0 = sc.boxes[0]
    got = toracle.oracle_check(poses, init, b0.lo, b0.hi, boxes, sc.centre[2])
    want = joracle.oracle_check(poses, init, b0.lo, b0.hi, boxes, sc.centre[2])
    for key in want:
        if want[key].dtype == bool:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        else:
            np.testing.assert_allclose(got[key], want[key], atol=1e-12, err_msg=key)
    assert 0 < got["valid"].sum() < n


def test_physics_oracle_experiment_matches_jax():
    """The port's experiments/physics_oracle.run against the repo's script at
    a small size: the same decisions, so the same agreement record."""
    from dream2real_tpu_torch.experiments import physics_oracle as tpo

    sys.path.insert(0, os.path.join(ROOT, "experiments"))
    try:
        import physics_oracle as jpo
    finally:
        sys.path.remove(os.path.join(ROOT, "experiments"))
    args = ([6, 6, 4, 1, 1, 2], 0.008)
    got = tpo.run(*args, n_views=6, res=112, device=CPU)
    want = jpo.run(*args, n_views=6, res=112)
    for key in ("n_poses", "sdf_valid_frac", "oracle_valid_frac", "agreement", "n_disagree",
                "disagree_stages", "bands"):
        assert got[key] == want[key], key
    np.testing.assert_allclose(got["bottom_gap"], want["bottom_gap"], atol=1e-6)
    tpo.check_agreement(got, min_n=1)


# ----------------------------------------------------------- cfg, profiling
@pytest.mark.parametrize("flags", [(cp, ph, vi, sg, ca) for cp in (0, 1) for ph in (0, 1)
                                   for vi in (0, 1) for sg in (0, 1) for ca in (0, 1)][::3])
def test_validate_cache_flags_matches_jax(flags):
    class C:
        pass

    cfg = C()
    (cfg.use_cache_cam_poses, cfg.use_cache_phys, cfg.use_cache_vis, cfg.use_cache_segs,
     cfg.use_cache_captions) = map(bool, flags)
    outcomes = []
    for fn in (jcfg.validate_cache_flags, tcfg.validate_cache_flags):
        try:
            fn(cfg)
            outcomes.append(None)
        except AssertionError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]


def test_stage_timer_accumulates():
    t = StageTimer()
    for _ in range(2):
        with t.stage("a"):
            pass
    with pytest.raises(ValueError):
        with t.stage("b"):
            raise ValueError
    assert set(t.stages) == {"a", "b"} and all(v >= 0 for v in t.stages.values())
    assert t.report().splitlines()[-1].startswith("total: ")
