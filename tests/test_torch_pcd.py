"""The point-cloud ablation path against the JAX package's, on the CPU.

- ``get_vis_pcds``: both ``pcds_type`` values give identical points and
  colours on a synth scan, and the ``obj_vis_{i}.npz`` caches replay across
  the packages.
- ``PointCloudRenderer.render`` (the batched splat, here on the CPU) and the
  port's plain per-pose loop against the JAX renderer, on random clouds and
  on a synth scan's clouds, with and without ``hide_movable``:
  pixel-identical except shown ties. A differing pixel is a tie when the
  JAX colour there belongs to a point that reaches the pixel with the same
  write key as the port's writer up to an equal depth (the reference's
  quicksort orders equal depths arbitrarily, the port's sort is stable), or
  when a projection of either lies within 1e-9 px of a half pixel
  (``pcd/renderer.py::shown_ties``, which ``chip_smoke.py`` also uses).
- A chunk of poses stays within the device budget whatever the cloud's size.
"""

import types

import numpy as np
import pytest
import torch

from dream2real_tpu.pcd import renderer as jren
from dream2real_tpu.pcd import visual_model as jvm
from dream2real_tpu_torch.data import synth
from dream2real_tpu_torch.pcd import renderer as tren
from dream2real_tpu_torch.pcd import visual_model as tvm
from dream2real_tpu_torch.sampling import sample_poses_grid

torch.set_num_threads(2)
H, W, VIEWS = 180, 320, 4
CENTRE = [0.5, 0.0, 0.05]


@pytest.fixture(scope="module")
def scan():
    scene = synth.default_scene()
    f = 0.9 * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]])
    poses = synth.orbit_poses(scene.centre, VIEWS)
    views = [synth.render_scene(scene, p, K, H, W) for p in poses]
    return dict(rgbs=np.stack([v[0] for v in views]), depths=np.stack([v[1] for v in views]),
                masks=np.stack([v[2] for v in views]).astype(np.int64), poses=poses, K=K,
                bounds=[[0.2, -0.35, 0.0], [0.85, 0.35, 0.35]])


def _pcds(mod, scan, pcds_type, **kw):
    return mod.get_vis_pcds(scan["rgbs"], scan["depths"], scan["poses"], scan["K"],
                            scan["masks"], 4, scan["bounds"], pcds_type=pcds_type,
                            use_cache=False, **kw)


@pytest.mark.parametrize("pcds_type", [0, 1])
def test_get_vis_pcds_matches_jax(scan, pcds_type):
    j, t = _pcds(jvm, scan, pcds_type), _pcds(tvm, scan, pcds_type)
    assert sum(len(p.points) for p in t) > 1000
    for a, b in zip(j, t):
        assert b.points.dtype == np.float32 and b.colors.dtype == np.uint8
        np.testing.assert_array_equal(b.points, a.points)
        np.testing.assert_array_equal(b.colors, a.colors)


def test_pcd_caches_replay_across_packages(scan, tmp_path):
    for write, read in ((jvm, tvm), (tvm, jvm)):
        d = str(tmp_path / write.__name__.split(".")[0])
        made = _pcds(write, scan, 1, save_dir=d)
        again = read.get_vis_pcds(None, None, None, None, None, 4, None, save_dir=d,
                                  use_cache=True)
        for a, b in zip(made, again):
            np.testing.assert_array_equal(a.points, b.points)
            np.testing.assert_array_equal(a.colors, b.colors)


def _task(mod, bg_pts, bg_cols, mv_pts, mv_cols, old_pose):
    ns = types.SimpleNamespace
    return ns(task_bground_obj=ns(vis_model=mod.PointCloud(bg_pts, bg_cols)),
              movable_obj=ns(vis_model=mod.PointCloud(mv_pts, mv_cols), pose=old_pose))


def _camera():
    T = synth.look_at_pose(np.array([0.5, -0.45, 0.55]), np.array(CENTRE))
    return T, jren.INTRINSICS_CLIP_VIEW


def _check(task_j, task_t, poses, hide):
    T_WC, K = _camera()
    got = tren.PointCloudRenderer(device="cpu").render(T_WC, poses, task_t, hide_movable=hide)
    plain = tren.PointCloudRenderer(device="cpu").render_plain(T_WC, poses, task_t,
                                                               hide_movable=hide)
    want = jren.PointCloudRenderer().render(T_WC, poses, task_j, hide_movable=hide)
    assert len(got) == len(want) == len(poses)
    bg = task_t.task_bground_obj.vis_model
    mv = task_t.movable_obj.vis_model
    n_diff = n_tie = 0
    for i, (g, pl, w) in enumerate(zip(got, plain, want)):
        assert g.shape == (336, 336, 3) and g.dtype == np.uint8
        np.testing.assert_array_equal(pl, w)  # the plain version is the reference's loop
        if hide:
            pts, cols, tf = bg.points, bg.colors, np.eye(4)
        else:
            tf = poses[i] @ np.linalg.inv(task_t.movable_obj.pose)
            moved = mv.transformed(tf)
            pts = np.concatenate([bg.points, moved.points])
            cols = np.concatenate([bg.colors, moved.colors])
        if not np.array_equal(g, w):
            dev = torch.device("cpu")
            mv_pts = torch.zeros((0, 3)) if hide else torch.as_tensor(mv.points)
            mv_cols = torch.zeros((0, 3), dtype=torch.uint8) if hide else torch.as_tensor(
                mv.colors)
            _, winner = tren.splat_batch(
                torch.as_tensor(bg.points), torch.as_tensor(bg.colors), mv_pts, mv_cols,
                torch.as_tensor(tf[None], device=dev), T_WC, K, return_winner=True)
            d, t = tren.shown_ties(g, w, winner[0].numpy(), pts, cols, T_WC, K)
            n_diff, n_tie = n_diff + d, n_tie + t
    assert n_tie == n_diff, f"{n_diff - n_tie} of {n_diff} differing pixels are not ties"
    return n_diff


def _random_task(rng, dup_share=0.0):
    bg = (rng.random((20000, 3)) * [0.6, 0.6, 0.1] + [0.2, -0.3, 0.0]).astype(np.float32)
    bg_c = rng.integers(0, 256, (20000, 3)).astype(np.uint8)
    if dup_share:  # repeated points of other colours: exact depth ties
        k = int(len(bg) * dup_share)
        bg = np.concatenate([bg, bg[:k]])
        bg_c = np.concatenate([bg_c, rng.integers(0, 256, (k, 3)).astype(np.uint8)])
    mv = (rng.random((3000, 3)) * 0.05 + [0.5, 0.0, 0.05]).astype(np.float32)
    mv_c = rng.integers(0, 256, (3000, 3)).astype(np.uint8)
    old = np.eye(4)
    old[:3, 3] = [0.5, 0.0, 0.05]
    return [_task(m, bg, bg_c, mv, mv_c, old) for m in (jvm, tvm)]


@pytest.mark.parametrize("hide", [False, True])
@pytest.mark.parametrize("dup_share", [0.0, 0.05])
def test_splat_random_clouds_match_jax(hide, dup_share):
    task_j, task_t = _random_task(np.random.default_rng(0), dup_share)
    poses = sample_poses_grid(CENTRE, [3, 3, 2, 1, 1, 2], scene_type=3).reshape(-1, 4, 4)
    _check(task_j, task_t, poses, hide)


@pytest.mark.parametrize("pcds_type", [0, 1])
def test_render_synth_clouds_matches_jax(scan, pcds_type):
    pcds = _pcds(tvm, scan, pcds_type)
    bg = tvm.PointCloud(np.concatenate([pcds[0].points, pcds[2].points, pcds[3].points]),
                        np.concatenate([pcds[0].colors, pcds[2].colors, pcds[3].colors]))
    old = np.eye(4)
    old[:3, 3] = pcds[1].points.mean(axis=0)
    task_j, task_t = (_task(m, bg.points, bg.colors, pcds[1].points, pcds[1].colors, old)
                      for m in (jvm, tvm))
    poses = sample_poses_grid(CENTRE, [4, 4, 1, 1, 1, 1], scene_type=3).reshape(-1, 4, 4)
    for hide in (False, True):
        _check(task_j, task_t, poses, hide)


def test_splat_chunks_agree(monkeypatch):
    """A chunk of one pose at a time gives what one chunk of all gives."""
    _, task_t = _random_task(np.random.default_rng(1))
    T_WC, _ = _camera()
    poses = sample_poses_grid(CENTRE, [2, 3, 1, 1, 1, 1], scene_type=3).reshape(-1, 4, 4)
    renderer = tren.PointCloudRenderer(device="cpu")
    all_ = renderer.render(T_WC, poses, task_t)
    assert renderer._chunk(23000) >= len(poses)
    monkeypatch.setitem(tren.CHUNK_BYTES, "cpu", 1)
    assert renderer._chunk(23000) == 1
    one = renderer.render(T_WC, poses, task_t)
    for a, b in zip(one, all_):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_points", [0, 9, 2006, 60000])
def test_splat_chunk_within_budget(n_points):
    """The chunk counts each pose's pixels as well as its points, so even
    an empty cloud gets a chunk whose buffers fit the budget."""
    for dev in ("cpu", "cuda"):
        renderer = tren.PointCloudRenderer(device="cpu")
        renderer.device = torch.device(dev)  # the sizing only, nothing runs there
        chunk = renderer._chunk(n_points)
        per_pose = n_points * tren.BYTES_PER_POINT + tren.CLIP_RES ** 2 * tren.BYTES_PER_PIXEL
        assert 1 <= chunk and chunk * per_pose <= tren.CHUNK_BYTES[dev]
        assert (chunk + 1) * per_pose > tren.CHUNK_BYTES[dev]
    assert tren.PointCloudRenderer(device="cpu")._chunk(0) < 1000
