"""The grid scorer of the port against the JAX package's: CombinedRenderer,
ClipScorer, _fused_score and optimise_pose_grid on the same scene, the same
(bridged) parameters and the same seeded inputs.

The scene is tests/test_fused_scoring.py's: the synthetic tabletop at 64^2, a
48 x 3 field trained once in JAX (module-scoped) and carried over by the
bridge, a tiny CLIP. Tolerances: scores rtol 2e-2, renders >= 99.5% of pixels
within 2 levels, fused vs unfused scores 0.02, pose scores through fixed
logits 1e-6.
"""

import hashlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dream2real_tpu import scoring as jscoring
from dream2real_tpu.clip import model as jclip
from dream2real_tpu.clip.scorer import ClipScorer as JClipScorer
from dream2real_tpu.nerf import combined as jcombined
from dream2real_tpu.nerf.model import NGPConfig as JNGPConfig
from dream2real_tpu.nerf.render import RenderSettings as JSettings
from dream2real_tpu.nerf import trainer as jtrainer
from dream2real_tpu.ops import cameras as jcam
from dream2real_tpu_torch import scoring as tscoring
from dream2real_tpu_torch.bridge import clip_from_jax, field_from_jax
from dream2real_tpu_torch.clip.model import CLIPConfig
from dream2real_tpu_torch.clip.scorer import ClipScorer, build_captions, reduce_logits
from dream2real_tpu_torch.data import synth
from dream2real_tpu_torch.nerf.combined import CombinedRenderer
from dream2real_tpu_torch.nerf.model import NGPConfig
from dream2real_tpu_torch.nerf.render import RenderSettings
from dream2real_tpu_torch.sampling import sample_poses_grid
from dream2real_tpu_torch.utils.png import read_png, write_png

torch.set_num_threads(2)

RES = 64
FIELD_KW = dict(field_type="mlp", mlp_width=48, mlp_depth=3, skip_layer=2, posenc_deg=5,
                geo_feat_dim=7, aabb_min=(0.0, -0.6, -0.1), aabb_max=(1.1, 0.6, 0.9))
SETTINGS_KW = dict(n_coarse=16, n_fine=16, near=0.05, far=2.0)
CLIP_KW = dict(eot_id=127, image_size=RES, patch_size=16, vision_width=32, vision_layers=2,
               vision_heads=4, vocab_size=128, context_length=16, text_width=32, text_layers=2,
               text_heads=4, projection_dim=24)
# A CLIP seed whose goal / norm logit ratio is well conditioned on this scene
# (the norm logit stays far from zero), as in tests/test_torch_slice.py.
CLIP_SEED = 7


class _TaskCaptions:
    goal_caption = "a red box on the green box"
    norm_captions = ["a red box and a green box"]


def _tok(texts, ctx=16):
    ids = np.zeros((len(texts), ctx), np.int32)
    for r, t in enumerate(texts):
        toks = [1]
        for wd in t.split():
            toks.append(2 + int(hashlib.md5(wd.encode()).hexdigest(), 16) % 124)
        toks = toks[: ctx - 1] + [127]
        ids[r, : len(toks)] = toks
    return ids


@pytest.fixture(scope="module")
def scene():
    """The trained scene in both packages, and the JAX package's results."""
    sc = synth.default_scene()
    f = 0.9 * RES
    K = np.array([[f, 0, RES / 2], [0, f, RES / 2], [0, 0, 1.0]])
    cams = synth.orbit_poses(sc.centre, 6, radius=0.5, height=0.4)
    rgba, depths = [], []
    for cam in cams:
        rgb, depth, inst = synth.render_scene(sc, cam, K, RES, RES)
        a = np.where(inst == 1, 255, 0).astype(np.uint8)
        rgba.append(np.concatenate([rgb, a[..., None]], -1))
        depths.append(depth)
    rgba = jnp.asarray(np.stack(rgba))
    jcfg = JNGPConfig(**FIELD_KW)
    tc = jtrainer.TrainConfig(n_steps=150, batch_rays=512, poll_steps=75,
                              dynamic_time_extension=False)
    jsettings = JSettings(**SETTINGS_KW)
    dirs = jcam.pixel_dirs(RES, RES, jnp.asarray(K))
    state = jtrainer.init_train_state(jcfg, tc, n_images=len(cams))
    fgp = jnp.asarray(np.argwhere(np.asarray(rgba[..., 3]) > 127).astype(np.int32))
    chunk = jtrainer.make_train_chunk(jcfg, tc, jsettings, rgba,
                                      jnp.asarray(cams.astype(np.float32)), dirs,
                                      depths=jnp.asarray(np.stack(depths)), fg_pixels=fgp)
    state, _ = jtrainer.train_with_governor(chunk, state, tc)
    jfield = state["params"]["field"]

    b0 = sc.boxes[0]
    obj_aabb = (tuple(np.asarray(b0.lo) - 0.03), tuple(np.asarray(b0.hi) + 0.03))
    T_WO_1 = np.eye(4, dtype=np.float32)
    T_WO_1[:3, 3] = (np.asarray(b0.lo) + np.asarray(b0.hi)) / 2
    jrenderer = jcombined.CombinedRenderer(
        jfield, jcfg, jfield, jcfg, settings=jsettings, res=RES, intrinsics=K, row_chunk=16,
        obj_aabb=obj_aabb, fg_crop=40)
    jccfg = jclip.CLIPConfig(**CLIP_KW)
    cparams = jclip.init_clip_params(jax.random.PRNGKey(CLIP_SEED), jccfg)
    jscorer = JClipScorer(cparams, jccfg, batch_size=4)

    field = field_from_jax({k: np.asarray(v) for k, v in jfield.items()}, NGPConfig(**FIELD_KW),
                           device="cpu")
    renderer = CombinedRenderer(
        field, field, settings=RenderSettings(**SETTINGS_KW), res=RES, intrinsics=K,
        row_chunk=16, obj_aabb=obj_aabb, fg_crop=40, device="cpu")
    clip = clip_from_jax(jax.tree_util.tree_map(np.asarray, cparams), CLIPConfig(**CLIP_KW),
                         device="cpu")
    scorer = ClipScorer(clip, batch_size=4)

    poses = np.tile(T_WO_1[None], (8, 1, 1)).astype(np.float32)
    poses[:, 0, 3] += np.linspace(-0.05, 0.15, 8)
    cam0, depth0 = cams[:1].astype(np.float32), np.stack(depths[:1])
    tm = _TaskCaptions()
    jfused = jscoring._fused_score(jrenderer, jscorer, _tok, tm, poses, cam0, depth0, None,
                                   T_WO_1, use_templates=False)
    jrenders = jrenderer.render(poses, cam0, [0], depths_gt=depth0, movable_masks=None,
                                T_WO_1=T_WO_1, save=False)
    return dict(renderer=renderer, scorer=scorer, poses=poses, cam0=cam0, depth0=depth0,
                T_WO_1=T_WO_1, tm=tm, jfused=np.asarray(jfused), jrenders=np.asarray(jrenders),
                jrenderer=jrenderer, jscorer=jscorer, K=K, obj_aabb=obj_aabb)


def _fused(s, poses=None, **kw):
    return tscoring._fused_score(
        s["renderer"], s["scorer"], _tok, s["tm"], s["poses"] if poses is None else poses,
        s["cam0"], s["depth0"], None, s["T_WO_1"], use_templates=False, **kw)


def test_combined_renderer_matches_reference(scene, capsys):
    r = scene["renderer"]
    renders = r.render(scene["poses"], scene["cam0"], [0], depths_gt=scene["depth0"],
                       movable_masks=None, T_WO_1=scene["T_WO_1"], save=False)
    want = scene["jrenders"]
    assert renders.shape == want.shape == (8, RES, RES, 3) and renders.dtype == np.uint8
    diff = np.abs(renders.astype(int) - want.astype(int)).max(axis=-1)
    with capsys.disabled():
        print(f"\nrenders: {(diff <= 2).mean():.5f} of pixels within 2 levels (allowed >= 0.995), "
              f"worst {diff.max()}")
    assert (diff <= 2).mean() >= 0.995
    assert (renders != renders[:1]).any()  # the candidates render differently
    # The last dispatch is padded with identity poses, whose crop windows fall
    # far from the object; their renders are dropped and nothing raises.
    r.poses_per_dispatch = 3
    try:
        chunked = r.render(scene["poses"], scene["cam0"], [0], depths_gt=scene["depth0"],
                           movable_masks=None, T_WO_1=scene["T_WO_1"], save=False)
    finally:
        r.poses_per_dispatch = 64
    np.testing.assert_array_equal(chunked, renders)


def test_render_background_depth_rule(scene):
    """alpha -> 1; with a scan's depth and a movable mask, the masked pixels
    go to 100 (the reference's rule), else the field's own depth."""
    r, jr = scene["renderer"], scene["jrenderer"]
    depth = scene["depth0"][0]
    mask = np.ones_like(depth)
    mask[20:30, 25:40] = 0
    bg = r.render_background(scene["cam0"][0], depth, mask)
    jbg = jr.render_background(jnp.asarray(scene["cam0"][0]), depth, mask)
    assert float(bg.alpha.min()) == 1.0
    np.testing.assert_allclose(bg.depth.numpy(), np.asarray(jbg.depth), atol=1e-5)
    assert (bg.depth.numpy() == 100.0).sum() == (np.asarray(jbg.depth) == 100.0).sum() > 0
    own = r.render_background(scene["cam0"][0])
    assert float(own.depth.max()) < 100.0 and own.depth.shape == (RES, RES)


def test_fused_score_matches_reference_and_unfused(scene, capsys):
    fused = _fused(scene)
    want = scene["jfused"]
    assert fused.shape == want.shape == (8,) and np.std(fused) > 1e-4
    with capsys.disabled():
        print(f"\nfused scores: max relative difference to the reference "
              f"{np.abs(fused / want - 1).max():.3e} (allowed 2e-2)")
    np.testing.assert_allclose(fused, want, rtol=2e-2, atol=0)
    info = dict(tscoring.LAST_RUN_INFO)
    assert info["n_poses"] == 8 and info["mesh_devices"] == 1 and info["clip_batch"] == 4
    assert info["slab"] == 256 and info["n_slabs"] == 1 and info["peak_pending_mb"] == 0.0
    assert {"dispatch_s", "drain_s"} <= set(info)

    r = scene["renderer"]
    renders = r.render(scene["poses"], scene["cam0"], [0], depths_gt=scene["depth0"],
                       movable_masks=None, T_WO_1=scene["T_WO_1"], save=False)
    unfused = scene["scorer"].score(renders, scene["tm"].goal_caption, scene["tm"].norm_captions,
                                    _tok, use_templates=False)
    np.testing.assert_allclose(fused, unfused, rtol=0.02, atol=0.02)
    junfused = scene["jscorer"].score(renders, scene["tm"].goal_caption,
                                      scene["tm"].norm_captions, _tok, use_templates=False)
    np.testing.assert_allclose(unfused, np.asarray(junfused), rtol=2e-2, atol=0)


def test_fused_score_saves_renders_and_slabs_bit_identical(scene, tmp_path, monkeypatch):
    r = scene["renderer"]
    plain = _fused(scene)
    r.out_render_path = str(tmp_path / "cb_render")
    try:
        saved = _fused(scene, save_renders=True)
        np.testing.assert_array_equal(saved, plain)  # bit-identical with and without saving
        files = sorted(os.listdir(r.out_render_path))
        assert files == [f"cb_rgb_{i:04d}.png" for i in range(8)]  # the reference's names
        renders = r.render(scene["poses"], scene["cam0"], [0], depths_gt=scene["depth0"],
                           movable_masks=None, T_WO_1=scene["T_WO_1"], save=False)
        for i in (0, 7):
            got = np.asarray(Image.open(tmp_path / "cb_render" / f"cb_rgb_{i:04d}.png"))
            np.testing.assert_array_equal(got, renders[i])
        np.testing.assert_array_equal(read_png(str(tmp_path / "cb_render" / "cb_rgb_0003.png")),
                                      renders[3])

        # Several slabs under a zero pending-bytes cap: every slab drains
        # before the next dispatch, the last one is partial (10 poses, slab
        # 4 -> 4, 4, 2 with padding to the clip batch).
        poses10 = np.tile(scene["T_WO_1"][None], (10, 1, 1)).astype(np.float32)
        poses10[:, 0, 3] += np.linspace(-0.05, 0.15, 10)
        r.out_render_path = str(tmp_path / "cb_one")
        one = _fused(scene, poses10, save_renders=True)
        assert tscoring.LAST_RUN_INFO["n_slabs"] == 1
        monkeypatch.setenv("D2R_RENDER_PENDING_MB", "0")
        monkeypatch.setenv("D2R_SCORE_SLAB", "4")
        monkeypatch.setenv("D2R_WRITER_THREADS", "2")
        r.out_render_path = str(tmp_path / "cb_slab4")
        slabbed = _fused(scene, poses10, save_renders=True)
        assert tscoring.LAST_RUN_INFO["n_slabs"] == 3 and tscoring.LAST_RUN_INFO["slab"] == 4
        np.testing.assert_array_equal(slabbed, one)
        # The same slabs without saving: one concatenated score fetch.
        np.testing.assert_array_equal(_fused(scene, poses10), one)
        for d in ("cb_one", "cb_slab4"):
            assert sorted(os.listdir(tmp_path / d)) == [f"cb_rgb_{i:04d}.png" for i in range(10)]
        np.testing.assert_array_equal(read_png(str(tmp_path / "cb_slab4" / "cb_rgb_0009.png")),
                                      read_png(str(tmp_path / "cb_one" / "cb_rgb_0009.png")))
    finally:
        r.out_render_path = None


def test_fused_score_takes_a_prefetch(scene):
    """The prefetch dictionary's contract: text embeddings and a score
    function built for this renderer, scorer and caption set are reused."""
    from dream2real_tpu_torch.parallel.imagine import make_imagine_and_score

    r, sc, tm = scene["renderer"], scene["scorer"], scene["tm"]
    captions = build_captions(tm.goal_caption, tm.norm_captions, False)
    calls = []
    inner = make_imagine_and_score(
        r.fg.cfg, sc.cfg, r.settings, r.dirs_cam, n_norm_captions=1, clip_batch=4,
        obj_aabb=r.obj_aabb, fg_crop=r.fg_crop, crop_settings=r.crop_settings,
        intrinsics=r.intrinsics, row_chunk=r.row_chunk, device="cpu")

    def score_fn(*a):
        calls.append(1)
        return inner(*a)

    prefetch = dict(score_fn=score_fn, renderer=r, clip_scorer=sc, captions=captions,
                    score_fn_key=(1, False, 4, False, 1), txt=sc.text_embeddings(_tok(captions)))
    np.testing.assert_array_equal(_fused(scene, prefetch=prefetch), _fused(scene))
    assert calls == [1]
    _fused(scene, prefetch=dict(prefetch, captions=["other"]))  # a stale prefetch is not used
    assert calls == [1]


# ------------------------------------------------ optimise_pose_grid, fixed logits


class _FakeScorer:
    """Gives fixed per-render logits, reduced as ClipScorer.score reduces."""

    def __init__(self, all_logits, jax_side):
        self.all_logits, self.jax_side = np.asarray(all_logits, np.float32), jax_side

    def score(self, renders, goal_caption, norm_captions, tokenizer, use_templates=False):
        n_norm = 0 if norm_captions is None else len(norm_captions)
        assert len(renders) == len(self.all_logits)
        if self.jax_side:
            from dream2real_tpu.clip.scorer import reduce_logits as jreduce

            return np.asarray(jreduce(jnp.asarray(self.all_logits), n_norm, use_templates))
        return reduce_logits(torch.from_numpy(self.all_logits), n_norm, use_templates).numpy()


class _FakeRenderer:
    def render(self, valid_poses, render_poses, render_cam_pose_idx, depths_gt=None,
               movable_masks=None, T_WO_1=None, save=True):
        return np.full((len(valid_poses), 8, 8, 3), 128, np.uint8)


class _Obj:
    pose = np.eye(4, dtype=np.float32)


class _SceneModel:
    def __init__(self, centre, cams=None):
        self.scene_centre = centre
        self.opt_cam_poses = [np.eye(4, dtype=np.float32)] if cams is None else cams


class _TaskModel:
    def __init__(self, centre, norm_captions, cams=None):
        self.scene_model = _SceneModel(centre, cams)
        self.goal_caption = "a red box on a green box"
        self.norm_captions = norm_captions
        self.movable_obj = _Obj()
        self.movable_masks = np.ones((1, 8, 8), bool)
        self.freed = False

    def free_visual_models(self):
        self.freed = True


CASES = [
    ([6, 5, 1, 1, 1, 1], False, 0, True),
    ([6, 5, 1, 1, 1, 1], False, 2, True),
    ([6, 5, 1, 1, 1, 1], True, 0, False),
    ([5, 4, 1, 1, 1, 1], True, 2, True),
    ([4, 3, 2, 1, 1, 3], False, 2, True),
    ([3, 3, 2, 2, 1, 2], True, 1, True),
]


@pytest.mark.parametrize("sample_res,use_templates,n_norm,smoothing", CASES)
def test_optimise_pose_grid_matches_reference(tmp_path, sample_res, use_templates, n_norm,
                                              smoothing, capsys):
    centre = [0.5, 0.0, 0.035]
    scene_type = 0 if sample_res[3] * sample_res[4] * sample_res[5] == 1 else 1
    n = int(np.prod(sample_res))
    is_valid = (np.arange(n) % 3) != 1
    norm_captions = None if n_norm == 0 else [f"norm caption {i}" for i in range(n_norm)]
    n_captions = len(build_captions("g", norm_captions, use_templates))
    rng = np.random.default_rng(n + n_norm)
    all_logits = rng.uniform(10.0, 30.0, size=(int(is_valid.sum()), n_captions))

    outs = []
    for mod, jax_side, sub in ((jscoring, True, "jax"), (tscoring, False, "torch")):
        d = tmp_path / sub
        d.mkdir()
        tm = _TaskModel(centre, norm_captions)
        best, batch, scores = mod.optimise_pose_grid(
            _FakeRenderer(), None, [0], tm, str(d), sample_res=sample_res,
            phys_check=lambda poses: is_valid, use_templates=use_templates,
            scene_type=scene_type, smoothing=smoothing,
            clip_scorer=_FakeScorer(all_logits, jax_side), tokenizer=None)
        assert tm.freed and (d / "best_render.png").exists()
        outs.append((best, batch, scores, dict(mod.LAST_RUN_INFO)))
    (jb, jbatch, jsc, jinfo), (tb_, tbatch, tsc, tinfo) = outs
    with capsys.disabled():
        print(f"\npose scores {sample_res}: max |port - reference| {np.abs(tsc - jsc).max():.3e} "
              f"(allowed rtol 1e-6 + atol 1e-6)")
    np.testing.assert_array_equal(tbatch, jbatch)
    np.testing.assert_allclose(tsc, jsc, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tb_, jb)
    assert tinfo["best_idx"] == jinfo["best_idx"] == int(np.argmax(tsc))
    np.testing.assert_allclose(tinfo["raw_scores"], jinfo["raw_scores"], rtol=1e-6)
    np.testing.assert_allclose(tinfo["smoothed_scores"], jinfo["smoothed_scores"], rtol=1e-6,
                               atol=1e-6)
    assert set(tinfo["stage_s"]) == set(jinfo["stage_s"])
    np.testing.assert_array_equal(read_png(str(tmp_path / "torch" / "best_render.png")),
                                  np.full((8, 8, 3), 128, np.uint8))


@pytest.mark.parametrize("seed", [0, 3])
def test_physics_only_picks_the_same_pose(tmp_path, seed):
    def phys_check(batch):
        v = np.zeros(9, bool)
        v[[2, 4, 7]] = True
        return v

    outs = []
    for mod in (jscoring, tscoring):
        best, batch, scores = mod.optimise_pose_grid(
            renderer=None, depths_gt=None, render_cam_pose_idx=[0],
            task_model=_TaskModel([0.5, 0.0, 0.035], ["n"]), data_dir=str(tmp_path),
            sample_res=[3, 3, 1, 1, 1, 1], phys_check=phys_check, physics_only=True,
            scene_type=3, seed=seed)
        outs.append((best, batch, scores))
    np.testing.assert_array_equal(outs[1][0], outs[0][0])
    np.testing.assert_array_equal(outs[1][1], outs[0][1])
    np.testing.assert_array_equal(outs[1][2], np.ones(9, np.float32))
    with pytest.raises(Exception, match="No poses passed"):
        tscoring.optimise_pose_grid(
            renderer=None, depths_gt=None, render_cam_pose_idx=[0],
            task_model=_TaskModel([0.5, 0.0, 0.035], ["n"]), data_dir=str(tmp_path),
            sample_res=[3, 3, 1, 1, 1, 1], phys_check=lambda b: np.zeros(9, bool), scene_type=3)


def test_cached_render_replay_matches_reference(tmp_path):
    """use_cache_renders replays a run's artifacts: pose_scores.txt picks
    the valid poses, cb_render/ (written by the port's PNG writer, read back
    with PIL by both packages) is scored again by CLIP."""
    d = str(tmp_path)
    sample_res = [4, 4, 1, 1, 1, 1]
    rng = np.random.default_rng(5)
    old_scores = np.zeros(16)
    valid = [1, 5, 9, 13]
    old_scores[valid] = rng.uniform(0.5, 1.0, len(valid))
    np.savetxt(os.path.join(d, "pose_scores.txt"), old_scores)
    os.makedirs(os.path.join(d, "cb_render"))
    for i in range(len(valid)):
        write_png(os.path.join(d, "cb_render", f"cb_rgb_{i:04d}.png"),
                  rng.integers(0, 255, (32, 32, 3), dtype=np.uint8))
    kw = dict(CLIP_KW, image_size=32, patch_size=8, vision_layers=1, text_layers=1,
              projection_dim=16)
    jccfg = jclip.CLIPConfig(**kw)
    cparams = jclip.init_clip_params(jax.random.PRNGKey(0), jccfg)
    jscorer = JClipScorer(cparams, jccfg, batch_size=4)
    scorer = ClipScorer(clip_from_jax(jax.tree_util.tree_map(np.asarray, cparams),
                                      CLIPConfig(**kw), device="cpu"), batch_size=4)
    args = dict(renderer=None, depths_gt=None, render_cam_pose_idx=[0], data_dir=d,
                sample_res=sample_res, use_cache_renders=True, smoothing=False, tokenizer=_tok,
                scene_type=3)
    # No normalising caption: the score is the goal logit itself, which is
    # well conditioned on random towers where a logit ratio is not.
    jbest, _, jsc = jscoring.optimise_pose_grid(
        task_model=_TaskModel([0.5, 0.0, 0.035], None), clip_scorer=jscorer, **args)
    tm = _TaskModel([0.5, 0.0, 0.035], None)
    best, batch, sc = tscoring.optimise_pose_grid(task_model=tm, clip_scorer=scorer, **args)
    assert best.shape == (4, 4) and batch.shape == (16, 16) and tm.freed
    assert (sc[old_scores == 0] == 0).all() and (sc[valid] != 0).all()
    np.testing.assert_allclose(sc, jsc, rtol=2e-2, atol=0.05)  # tests/test_torch_clip.py's logits
    np.testing.assert_array_equal(best, jbest)
    assert os.path.exists(os.path.join(d, "best_render.png"))
    # A render count that does not match the scores raises, as the reference.
    write_png(os.path.join(d, "cb_render", "cb_rgb_0099.png"), np.zeros((32, 32, 3), np.uint8))
    with pytest.raises(AssertionError):
        tscoring.optimise_pose_grid(task_model=tm, clip_scorer=scorer, **args)


def test_crop_guard_grows_the_window(scene, tmp_path):
    """A crop window smaller than a candidate's projected extent grows to
    the size the reference's guard computes, before anything renders."""
    r, jr = scene["renderer"], scene["jrenderer"]
    centre = [float(c) for c in scene["T_WO_1"][:3, 3]]
    tm = _TaskModel(centre, ["n"], cams=[scene["cam0"][0]])
    tm.movable_obj = type("O", (), {"pose": scene["T_WO_1"]})()
    grid = sample_poses_grid(centre, [2, 2, 1, 1, 1, 1], scene_type=3)
    need = jr.crop_required(scene["T_WO_1"], scene["cam0"], grid)
    assert r.crop_required(scene["T_WO_1"], scene["cam0"], grid) == need
    r.fg_crop = 16
    assert need > 16
    try:
        best, _, scores = tscoring.optimise_pose_grid(
            r, scene["depth0"], [0], tm, str(tmp_path), sample_res=[2, 2, 1, 1, 1, 1],
            scene_type=3, smoothing=False, save_renders=False,
            clip_scorer=_FakeScorer(np.arange(8.0).reshape(4, 2) + 1.0, False), tokenizer=None)
        assert r.fg_crop == need
        assert best.shape == (4, 4) and (scores != 0).all()
        assert read_png(str(tmp_path / "best_render.png")).shape == (RES, RES, 3)
    finally:
        r.fg_crop = 40


def test_optimise_pose_grid_fused_end_to_end(scene, tmp_path):
    """The fused branch through optimise_pose_grid, with and without cb_render/:
    the same raw scores bit for bit, the artifacts on disk, and
    best_render.png the winning pose's render."""
    r = scene["renderer"]
    centre = [float(c) for c in scene["T_WO_1"][:3, 3]]
    runs = {}
    for save in (False, True):
        d = tmp_path / f"save_{save}"
        d.mkdir()
        r.out_render_path = str(d / "cb_render")
        tm = _TaskModel(centre, scene["tm"].norm_captions, cams=[scene["cam0"][0]])
        tm.goal_caption = scene["tm"].goal_caption
        tm.movable_obj = type("O", (), {"pose": scene["T_WO_1"]})()
        try:
            best, batch, scores = tscoring.optimise_pose_grid(
                r, scene["depth0"], [0], tm, str(d), sample_res=[3, 2, 1, 1, 1, 1], scene_type=3,
                clip_scorer=scene["scorer"], tokenizer=_tok, save_renders=save,
                phys_check=lambda p: np.arange(6) != 4)
        finally:
            r.out_render_path = None
        runs[save] = (best, scores, dict(tscoring.LAST_RUN_INFO), d)
    (b0, s0, i0, d0), (b1, s1, i1, d1) = runs[False], runs[True]
    np.testing.assert_array_equal(i0["raw_scores"], i1["raw_scores"])
    np.testing.assert_array_equal(s0, s1)
    np.testing.assert_array_equal(b0, b1)
    assert i0["raw_scores"][4] == 0 and (np.delete(i0["raw_scores"], 4) != 0).all()
    assert not (d0 / "cb_render").exists()
    assert sorted(os.listdir(d1 / "cb_render")) == [f"cb_rgb_{i:04d}.png" for i in range(5)]
    # best_render.png is the saved render of the winning pose.
    valid = [i for i in range(6) if i != 4]
    win = valid.index(i1["best_idx"])
    np.testing.assert_array_equal(read_png(str(d1 / "best_render.png")),
                                  read_png(str(d1 / "cb_render" / f"cb_rgb_{win:04d}.png")))
    np.testing.assert_array_equal(read_png(str(d0 / "best_render.png")),
                                  read_png(str(d1 / "best_render.png")))
