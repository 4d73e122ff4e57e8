"""The imagine-and-score slice as a whole: make_imagine_and_score of both
packages on bridged parameters (flagship field, so the JAX side runs the
interpret-mode march kernel; tiny CLIP), same background, text embeddings
and poses. Plus snapshot interchange between the packages."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dream2real_tpu.clip import model as jclip
from dream2real_tpu.nerf import snapshot as jsnap
from dream2real_tpu.nerf import combined as jcombined
from dream2real_tpu.nerf.combined import BackgroundView as JBackground
from dream2real_tpu.nerf.model import NGPConfig as JNGPConfig, init_ngp_params
from dream2real_tpu.nerf.render import RenderSettings as JSettings, render_image as jrender_image
from dream2real_tpu.ops import cameras as jcam
from dream2real_tpu.parallel.imagine import make_imagine_and_score as jmake
from dream2real_tpu.smoothing import spatially_smooth_heatmap as jsmooth
from dream2real_tpu_torch.bridge import clip_from_jax, field_from_jax, field_from_snapshot
from dream2real_tpu_torch.clip.model import CLIPConfig
from dream2real_tpu_torch.clip.tokenizer import hash_tokenize
from dream2real_tpu_torch.data import synth
from dream2real_tpu_torch.nerf import combined as tcombined
from dream2real_tpu_torch.nerf import snapshot as tsnap
from dream2real_tpu_torch.nerf.combined import BackgroundView
from dream2real_tpu_torch.nerf.model import NGPConfig
from dream2real_tpu_torch.nerf.render import RenderSettings, render_image
from dream2real_tpu_torch.ops import cameras as tcam
from dream2real_tpu_torch.parallel.imagine import make_imagine_and_score
from dream2real_tpu_torch.sampling import sample_poses_grid
from dream2real_tpu_torch.smoothing import spatially_smooth_heatmap

torch.set_num_threads(1)

RES, CROP, CLIP_BATCH = 32, 16, 4
SAMPLE_RES = (4, 2, 1, 1, 1, 1)
AABB = dict(aabb_min=(0.0, -0.6, -0.1), aabb_max=(1.1, 0.6, 0.9))
CLIP_KW = dict(image_size=RES, patch_size=8, vision_width=32, vision_layers=2, vision_heads=4,
               text_width=32, text_layers=2, text_heads=4, projection_dim=16)
BG = dict(n_coarse=16, n_fine=16, near=0.05, far=2.0)


@pytest.fixture(scope="module")
def slice_run():
    scene = synth.default_scene()
    f = 0.9 * RES
    K = np.array([[f, 0, RES / 2], [0, f, RES / 2], [0, 0, 1.0]])
    T_WC = synth.orbit_poses(scene.centre, 16, radius=0.5, height=0.4)[0].astype(np.float32)
    T_WO = np.eye(4, dtype=np.float32)
    T_WO[:3, 3] = scene.centre
    b0 = scene.boxes[0]
    obj_aabb = (tuple(np.asarray(b0.lo) - 0.03), tuple(np.asarray(b0.hi) + 0.03))
    poses = sample_poses_grid(scene.centre, SAMPLE_RES, scene_type=3).reshape(-1, 4, 4)

    jcfg, cfg = JNGPConfig(**AABB), NGPConfig(**AABB)
    jparams = init_ngp_params(jax.random.PRNGKey(0), jcfg)
    field = field_from_jax({k: np.asarray(v) for k, v in jparams.items()}, cfg, device="cpu")
    jccfg = jclip.CLIPConfig(**CLIP_KW)
    # A CLIP seed whose goal / mean(norm) score ratio is well conditioned
    # (mean norm logit far from zero) and whose smoothed winner is clear;
    # on random towers the ratio amplifies any logit difference wherever
    # the mean norm logit nears zero.
    cparams = jclip.init_clip_params(jax.random.PRNGKey(6), jccfg)
    clip = clip_from_jax(jax.tree_util.tree_map(np.asarray, cparams), CLIPConfig(**CLIP_KW),
                         device="cpu")

    # Background: both packages render it; the JAX one feeds both loops.
    jdirs = jcam.pixel_dirs(RES, RES, jnp.asarray(K))
    tdirs = tcam.pixel_dirs(RES, RES, K, device="cpu")
    jbg = jrender_image(jparams, jcfg, jnp.asarray(T_WC), jdirs, JSettings(**BG), row_chunk=8)
    tbg = render_image(field, torch.from_numpy(T_WC), tdirs, RenderSettings(**BG), row_chunk=8)
    # As CombinedRenderer.render_background with a GT depth and movable mask:
    # opaque alpha, depth from the scene with the movable object pushed to 100.
    _, gt_depth, inst = synth.render_scene(scene, T_WC, K, RES, RES)
    bg_np = {"rgb": np.asarray(jbg["rgb"]), "alpha": np.ones((RES, RES), np.float32),
             "depth": np.where(inst == 1, 100.0, gt_depth).astype(np.float32)}

    ids = hash_tokenize(["a red box on the green box", "a red box", "a green box"])
    txt = np.array(jclip.encode_text(cparams, jccfg, jnp.asarray(ids)))

    common = dict(n_norm_captions=2, clip_batch=CLIP_BATCH, obj_aabb=obj_aabb, fg_crop=CROP,
                  intrinsics=K, return_renders=True)
    jfn = jmake(jcfg, jccfg, JSettings(**BG), jdirs, **common)
    js, jr = jfn(jparams, cparams, jnp.asarray(T_WO), jnp.asarray(T_WC),
                 JBackground(**{k: jnp.asarray(v) for k, v in bg_np.items()}),
                 jnp.asarray(txt), jnp.asarray(poses))
    tfn = make_imagine_and_score(cfg, CLIPConfig(**CLIP_KW), RenderSettings(**BG), tdirs,
                                 device="cpu", **common)
    ts, tr = tfn(field, clip, T_WO, T_WC,
                 BackgroundView(**{k: torch.tensor(v) for k, v in bg_np.items()}), txt, poses)
    return dict(jbg=jbg, tbg=tbg, js=np.asarray(js), jr=np.asarray(jr), ts=ts.numpy(),
                tr=tr.numpy())


def test_background_render_parity(slice_run):
    """render_image with importance resampling (n_fine > 0). Alpha agrees
    to 1e-3. On this random, high-frequency field the resampled positions
    move with f32 summation order in the CDF, so single pixels of rgb and
    depth differ by up to 0.04; their mean differences stay below 2e-3
    (measured 8.2e-4 and 7.7e-4)."""
    t, j = slice_run["tbg"], slice_run["jbg"]
    np.testing.assert_allclose(t["alpha"].numpy(), np.asarray(j["alpha"]), atol=1e-3, rtol=0)
    for k in ("rgb", "depth"):
        assert np.abs(t[k].numpy() - np.asarray(j[k])).mean() < 2e-3, k


def test_slice_scores_match(slice_run):
    js, ts = slice_run["js"], slice_run["ts"]
    assert ts.shape == js.shape == (8,)
    assert np.isfinite(ts).all() and np.std(js) > 0
    np.testing.assert_allclose(ts, js, rtol=2e-2, atol=0)


def test_slice_renders_match(slice_run):
    jr, tr = slice_run["jr"].astype(int), slice_run["tr"].astype(int)
    assert tr.shape == jr.shape == (8, RES, RES, 3) and slice_run["tr"].dtype == np.uint8
    diff = np.abs(tr - jr).max(axis=-1)
    assert (diff <= 2).mean() >= 0.995, diff.max()
    assert (jr != jr[0:1]).any()  # the candidate poses render differently


def test_slice_smoothed_argmax_equal(slice_run):
    js, ts = slice_run["js"], slice_run["ts"]
    jsm = np.asarray(jsmooth(jnp.asarray(js), SAMPLE_RES))
    tsm = spatially_smooth_heatmap(torch.from_numpy(ts), SAMPLE_RES).numpy()
    top2 = np.sort(jsm)[-2:]
    # The winner leads by more than twice the largest smoothed-score
    # difference between the packages, so the equal argmax follows from the
    # parity and is not a coin toss (measured lead 6.9e-3, difference 2.7e-3).
    assert top2[1] - top2[0] > 2 * np.abs(tsm - jsm).max()
    assert int(tsm.argmax()) == int(jsm.argmax())


def test_snapshot_interchange(tmp_path):
    cfg = JNGPConfig(**AABB)
    params = init_ngp_params(jax.random.PRNGKey(3), cfg)
    settings = {"n_coarse": 24, "n_fine": 8, "near": 0.1, "far": 1.5,
                "min_transmittance": 1e-3, "compute_dtype": "bfloat16"}
    path = os.path.join(tmp_path, "fg_base.ingp")
    jsnap.save_snapshot(path, {"field": params}, cfg, extra={"settings": settings})
    field, st = field_from_snapshot(jsnap.snapshot_path(path), device="cpu")
    assert tuple(field.cfg) == tuple(NGPConfig(**AABB))
    assert st == RenderSettings(24, 8, 0.1, 1.5, 1e-3, "bfloat16")
    for k, v in params.items():
        np.testing.assert_array_equal(getattr(field, k).numpy(), np.asarray(v))
    # And back: a snapshot the port writes loads in the reference.
    path2 = os.path.join(tmp_path, "fg_port.ingp")
    tsnap.save_snapshot(path2, field, field.cfg, extra={"settings": settings})
    back, cfg2, extra = jsnap.load_snapshot(jsnap.snapshot_path(path2))
    assert cfg2 == cfg and extra["settings"] == settings
    for k, v in params.items():
        np.testing.assert_array_equal(np.asarray(back["field"][k]), np.asarray(v))


def test_crop_guards_parity():
    """crop_window (device), crop_extents and required_crop (host) agree
    with the reference over a 6-DoF candidate batch from two views."""
    scene = synth.default_scene()
    K = np.array([[302.4, 0, 168.0], [0, 302.4, 168.0], [0, 0, 1.0]])
    views = synth.orbit_poses(scene.centre, 4, radius=0.5, height=0.4)[:2]
    T_WO = np.eye(4)
    T_WO[:3, 3] = scene.centre
    b0 = scene.boxes[0]
    obj = (tuple(np.asarray(b0.lo) - 0.03), tuple(np.asarray(b0.hi) + 0.03))
    bounds = ((-0.1, 0.1), (-0.1, 0.1), (0.0, 0.05), (0.0, 0.0), (0.0, 0.0), (-1.5, 1.5))
    poses = sample_poses_grid(scene.centre, (3, 3, 2, 1, 1, 3), bounds_override=bounds)
    poses = poses.reshape(-1, 4, 4)
    for T_WC in views:
        np.testing.assert_allclose(
            np.stack(tcombined.crop_extents(obj, K, 336, T_WO, T_WC, poses)),
            np.stack(jcombined.crop_extents(obj, K, 336, T_WO, T_WC, poses)), rtol=1e-12)
        T_WC_2 = tcombined.convert_virtual_pose(
            torch.tensor(T_WO, dtype=torch.float32), torch.tensor(poses),
            torch.tensor(T_WC, dtype=torch.float32))
        tv, tu = tcombined.crop_window(T_WC_2, obj, K, 336, 128)
        for i in range(len(poses)):
            jv, ju = jcombined.crop_window(jnp.asarray(np.asarray(T_WC_2[i])), obj,
                                           jnp.asarray(K), 336, 128)
            assert (int(tv[i]), int(tu[i])) == (int(jv), int(ju))
    assert tcombined.required_crop(obj, K, 336, T_WO, views, poses) == \
        jcombined.required_crop(obj, K, 336, T_WO, views, poses)
