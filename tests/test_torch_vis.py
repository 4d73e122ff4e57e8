"""The port's vis exports against the JAX package's, on the CPU.

- Cost volume and multiverse: ``matplotlib.pyplot.subplots`` is replaced by
  a recorder, and what the JAX ``export_cost_volume`` / ``export_multiverse``
  pass to ``pcolormesh``, ``plot`` and ``scatter`` is held against the
  port's computed layers exactly (f64, 1e-12). The port's 256-entry viridis
  table equals matplotlib's. The PNGs decode; every-zero scores write none.
- Viewer: the HTML is byte-identical.
- ``seg_overlay`` is identical and ``visimg``'s file decodes to PIL's pixels.
"""

import os

import matplotlib
import numpy as np
import pytest
import torch
from matplotlib import _cm_listed
from PIL import Image

from dream2real_tpu.vis import cost_volume as jcv
from dream2real_tpu.vis import utils as jutils
from dream2real_tpu.vis import viewer as jviewer
from dream2real_tpu_torch.sampling import sample_poses_grid
from dream2real_tpu_torch.utils.png import read_png
from dream2real_tpu_torch.vis import cost_volume as tcv
from dream2real_tpu_torch.vis import utils as tutils
from dream2real_tpu_torch.vis import viewer as tviewer

torch.set_num_threads(2)
matplotlib.use("Agg")
TOL = 1e-12


class _Axes:
    """Records the drawing calls the JAX exports make."""

    def __init__(self, calls):
        self.calls = calls

    def __getattr__(self, name):
        def record(*args, **kwargs):
            self.calls.append((name, args, kwargs))
            return None
        return record


class _Fig:
    def __init__(self, calls):
        self.calls = calls

    def colorbar(self, *a, **k):
        pass

    def savefig(self, path, **k):
        self.calls.append(("savefig", (path,), k))


@pytest.fixture
def recorder(monkeypatch):
    import matplotlib.pyplot as plt

    calls = []
    monkeypatch.setattr(plt, "subplots", lambda *a, **k: (_Fig(calls), _Axes(calls)))
    monkeypatch.setattr(plt, "close", lambda *a, **k: None)
    return calls


def _grid(res, rng, zero_share=0.3):
    batch = sample_poses_grid([0.5, 0.0, 0.05], res, scene_type=3).reshape(-1, 16)
    scores = rng.uniform(0.1, 0.4, len(batch))
    scores[rng.random(len(batch)) < zero_share] = 0
    return batch, scores


def test_viridis_table_is_matplotlibs():
    np.testing.assert_array_equal(tcv.VIRIDIS, np.asarray(_cm_listed._viridis_data))
    np.testing.assert_array_equal(tcv.VIRIDIS, matplotlib.colormaps["viridis"].colors)


@pytest.mark.parametrize("res,exp,seed", [
    ([8, 6, 2, 1, 1, 1], True, 0), ([5, 7, 1, 1, 1, 4], False, 1), ([20, 20, 2, 1, 1, 1], True, 2),
])
def test_cost_volume_layers_match_jax(recorder, tmp_path, res, exp, seed):
    batch, scores = _grid(res, np.random.default_rng(seed))
    jcv.export_cost_volume(scores, res, batch, str(tmp_path / "j.png"), exp=exp)
    layers = tcv.export_cost_volume(scores, res, batch, str(tmp_path / "t.png"), exp=exp)
    (_, (xs, ys, vol_t), kw), = [c for c in recorder if c[0] == "pcolormesh"]
    (_, (bx, by, marker), _), = [c for c in recorder if c[0] == "plot"]
    assert kw["cmap"] == "viridis" and marker == "r*"
    np.testing.assert_allclose(layers["xs"], xs, rtol=0, atol=TOL)
    np.testing.assert_allclose(layers["ys"], ys, rtol=0, atol=TOL)
    np.testing.assert_allclose(layers["vol"].T, vol_t, rtol=0, atol=TOL)
    ix, iy = layers["best"]
    assert (layers["xs"][ix], layers["ys"][iy]) == (bx, by)
    img = read_png(str(tmp_path / "t.png"))
    assert img.shape == (660, 660, 3) and img.dtype == np.uint8


@pytest.mark.parametrize("four_cols,with_bg,stride", [(True, True, 7), (False, False, 3),
                                                       (True, False, 1)])
def test_multiverse_layers_match_jax(recorder, tmp_path, four_cols, with_bg, stride):
    rng = np.random.default_rng(3)
    res = [6, 6, 2, 1, 1, 1]
    batch, scores = _grid(res, rng)
    pts = rng.uniform(-0.03, 0.03, (900, 3)) + [0.5, 0.0, 0.05]
    bg = rng.uniform(0, 1, (500, 3))
    if four_cols:
        pts = np.c_[pts, rng.random(900) > 0.2]
        bg = np.c_[bg, rng.random(500) > 0.5]
    init = np.eye(4)
    init[:3, 3] = [0.5, 0.0, 0.05]
    kw = dict(stride=stride, bground_points=bg if with_bg else None)
    jcv.export_multiverse(scores, batch, pts, init, str(tmp_path / "j.png"), **kw)
    layers = tcv.export_multiverse(scores, batch, pts, init, str(tmp_path / "t.png"), **kw)
    drawn = [c for c in recorder if c[0] == "scatter"]
    want = ([(layers["background"], 0.4)] if with_bg else []) + layers["ghosts"]
    assert len(drawn) == len(want) and len(layers["ghosts"]) > 0
    for (_, (x, y), k), (pts_t, alpha) in zip(drawn, want):
        np.testing.assert_allclose(pts_t[:, 0], x, rtol=0, atol=TOL)
        np.testing.assert_allclose(pts_t[:, 1], y, rtol=0, atol=TOL)
        assert abs(k["alpha"] - alpha) <= TOL
    img = read_png(str(tmp_path / "t.png"))
    assert img.shape == (770, 770, 3) and (img != 255).any()


def test_zero_scores_write_nothing(recorder, tmp_path):
    batch, _ = _grid([4, 4, 1, 1, 1, 1], np.random.default_rng(0))
    zeros = np.zeros(len(batch))
    pts = np.ones((10, 4))
    assert tcv.export_cost_volume(zeros, [4, 4, 1, 1, 1, 1], batch, str(tmp_path / "a.png")) is None
    assert tcv.export_multiverse(zeros, batch, pts, np.eye(4), str(tmp_path / "b.png")) is None
    jcv.export_cost_volume(zeros, [4, 4, 1, 1, 1, 1], batch, str(tmp_path / "c.png"))
    assert os.listdir(tmp_path) == [] and recorder == []


def test_cost_volume_picture_marks_the_best_cell(tmp_path):
    """The best cell is drawn in the top colour with the red star on it."""
    res = [4, 4, 1, 1, 1, 1]
    batch, _ = _grid(res, np.random.default_rng(0))
    scores = np.full(len(batch), 0.1)
    scores[5] = 0.3  # cell (1, 1)
    layers = tcv.cost_volume_layers(scores, res, batch)
    img = tcv.draw_cost_volume(layers)
    assert layers["best"] == (1, 1)
    red = np.argwhere(np.all(img == [255, 0, 0], axis=-1))
    top = np.all(img == np.rint(tcv.VIRIDIS[255] * 255), axis=-1)
    cy, cx = red.mean(axis=0)
    assert len(red) > 50 and top[int(cy) - 20:int(cy) + 20, int(cx) - 20:int(cx) + 20].any()


@pytest.mark.parametrize("big", [False, True])
def test_viewer_html_is_byte_identical(tmp_path, big):
    rng = np.random.default_rng(4)
    n_pts = 70_000 if big else 300
    n_faces = 25_000 if big else 40
    points = [
        (rng.normal(size=(n_pts, 3)), rng.integers(0, 256, (n_pts, 3)), "movable"),
        (rng.normal(size=(200, 3)), rng.random((200, 3)), "float colours"),
        (rng.normal(size=(50, 3)), None, "no colours"),
    ]
    verts = rng.normal(size=(n_faces, 3)).astype(np.float32)
    faces = rng.integers(0, n_faces, (n_faces, 3))
    meshes = [(verts, faces, "#44cc88", "mesh_concave_0")]
    T = np.eye(4)
    T[:3, 3] = rng.normal(size=3)
    frames = [(T, "goal"), (np.eye(4), "cam0")]
    kw = dict(points=points, meshes=meshes, frames=frames, title="dream2real_tpu — t")
    jviewer.export_scene_html(str(tmp_path / "j" / "viewer.html"), **kw)
    tviewer.export_scene_html(str(tmp_path / "t" / "viewer.html"), **kw)
    a = (tmp_path / "j" / "viewer.html").read_bytes()
    assert a == (tmp_path / "t" / "viewer.html").read_bytes()


def test_seg_overlay_and_visimg(tmp_path):
    rng = np.random.default_rng(5)
    rgb = rng.integers(0, 256, (30, 40, 3)).astype(np.uint8)
    mask = rng.choice([0, 1, 2, 7, 13, 255], (30, 40))
    np.testing.assert_array_equal(tutils.pastel_colors, jutils.pastel_colors)
    np.testing.assert_array_equal(tutils.seg_overlay(rgb, mask, 0.3),
                                  jutils.seg_overlay(rgb, mask, 0.3))
    for img in (rgb, rng.random((30, 40, 3)), rng.random((30, 40)) * 3.0):
        a, b = str(tmp_path / "j.png"), str(tmp_path / "t.png")
        np.testing.assert_array_equal(tutils.visimg(img, b), jutils.visimg(img, a))
        np.testing.assert_array_equal(read_png(b), np.asarray(Image.open(a)))
