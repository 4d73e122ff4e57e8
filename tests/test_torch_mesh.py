"""Multi-device paths of the port against one device and against the JAX
package on its 8 virtual CPU devices (tests/conftest.py). The port's mesh
here is eight shards that all name the CPU (``data_mesh(devices=[cpu] * 8)``),
so the splits, gathers and reductions are those of eight cards:

- ``parallel/mesh.py``'s decisions (``auto_mesh``, ``score_mesh_for``,
  ``data_mesh``, the scoring slab) as the JAX module makes them;
- ``make_imagine_and_score`` on 8 shards: scores and renders bit-identical
  to ``mesh=None``, and within the single-device tolerance of
  tests/test_torch_slice.py (rtol 2e-2) of JAX's ``data_mesh(8)`` program;
- ``_fused_score`` under the auto mesh: ``mesh_devices``, scores and PNGs
  against ``D2R_MESH=0``;
- ``make_train_chunk(ray_sharding=...)``: the plain path within
  tests/test_parallel_imagine.py's tolerances of one device, the kernel
  path (plain versions of K5-K7) finite and updating, a one-shard mesh
  bit-identical to the unsharded step;
- ``make_unsupcol_check`` on 8 shards: masks identical to one device and to
  JAX's sharded check;
- ``build_vis_model``'s ``LAST_TRAIN_INFO`` equal to JAX's.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dream2real_tpu import reconstruction as jrecon
from dream2real_tpu import scoring as jscoring
from dream2real_tpu.clip import model as jclip
from dream2real_tpu.nerf.combined import BackgroundView as JBackground
from dream2real_tpu.nerf.model import NGPConfig as JNGPConfig, init_ngp_params
from dream2real_tpu.nerf.render import RenderSettings as JSettings
from dream2real_tpu.ops import cameras as jcam
from dream2real_tpu.ops.se3 import euler_angles_to_matrix, make_pose
from dream2real_tpu.parallel import imagine as jimagine
from dream2real_tpu.parallel import mesh as jmesh
from dream2real_tpu.physics import collision as jcol
from dream2real_tpu.physics import tsdf as jtsdf
from dream2real_tpu_torch import reconstruction as trecon
from dream2real_tpu_torch import scoring as tscoring
from dream2real_tpu_torch.bridge import clip_from_jax, field_from_jax, phys_model_from_arrays
from dream2real_tpu_torch.clip.model import CLIPConfig
from dream2real_tpu_torch.clip.scorer import ClipScorer
from dream2real_tpu_torch.nerf import trainer as ttrainer
from dream2real_tpu_torch.nerf.combined import BackgroundView, CombinedRenderer
from dream2real_tpu_torch.nerf.model import NGPConfig
from dream2real_tpu_torch.nerf.render import RenderSettings
from dream2real_tpu_torch.ops import cameras as tcam
from dream2real_tpu_torch.parallel import imagine as timagine
from dream2real_tpu_torch.parallel import mesh as tmesh
from dream2real_tpu_torch.physics import collision as tcol
from dream2real_tpu_torch.utils.png import read_png

torch.set_num_threads(2)

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_FIELD = dict(mlp_width=32, mlp_depth=3, skip_layer=2, posenc_deg=4, geo_feat_dim=7,
                  aabb_min=(0.0, -0.6, -0.1), aabb_max=(1.1, 0.6, 0.9))


def cpu_mesh(n=8):
    return tmesh.data_mesh(devices=[CPU] * n)


# ------------------------------------------------------------------ mesh.py
def test_auto_mesh_follows_d2r_mesh_and_the_device_count(monkeypatch):
    """As JAX's: None under D2R_MESH=0 (re-read every call), None with at
    most one device, else the cached mesh over every device, rebuilt when
    the count changes. The CUDA count is faked; streams are not made."""
    monkeypatch.setenv("D2R_MESH", "0")
    assert jmesh.auto_mesh() is None and tmesh.auto_mesh() is None
    monkeypatch.delenv("D2R_MESH")
    jm = jmesh.auto_mesh()
    assert jm is not None and jm.size == len(jax.devices()) == 8
    count = {"n": 8}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count["n"])
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: ("stream", device))
    monkeypatch.setattr(tmesh, "_AUTO_MESH", None)
    tm = tmesh.auto_mesh()
    assert tm.size == jm.size and jm.axis_names == (tmesh.DATA_AXIS,)
    assert tm.devices == tuple(torch.device("cuda", i) for i in range(8))
    assert tmesh.auto_mesh() is tm  # cached
    count["n"] = 4
    assert tmesh.auto_mesh().size == 4
    count["n"] = 1
    assert tmesh.auto_mesh() is None
    monkeypatch.setenv("D2R_MESH", "0")
    count["n"] = 8
    assert tmesh.auto_mesh() is None


def test_no_auto_mesh_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    assert tmesh.auto_mesh() is None


@pytest.mark.parametrize("size", [2, 4, 8])
@pytest.mark.parametrize("clip_batch", [1, 2, 32])
def test_score_mesh_and_slab_decisions_match_jax(size, clip_batch, monkeypatch):
    """score_mesh_for and _slab_spec over a table of pose counts, with and
    without D2R_SCORE_SLAB."""
    jm, tm = jmesh.data_mesh(size), cpu_mesh(size)
    monkeypatch.setattr(jmesh, "auto_mesh", lambda: jm)
    monkeypatch.setattr(tmesh, "auto_mesh", lambda: tm)
    q = size * clip_batch
    for n in (1, q, 2 * q - 1, 2 * q, 2 * q + 1, 10 * q + 3, 70000):
        want = jmesh.score_mesh_for(n, clip_batch)
        got = tmesh.score_mesh_for(n, clip_batch)
        assert (got is None) == (want is None), (n, clip_batch, size)
        assert got is None or got.size == want.size
        for slab_env in (None, "0", "100", "1000"):
            if slab_env is None:
                monkeypatch.delenv("D2R_SCORE_SLAB", raising=False)
            else:
                monkeypatch.setenv("D2R_SCORE_SLAB", slab_env)
            jmesh_, jslab, jq = jscoring._slab_spec(clip_batch, n)
            tmesh_, tslab, tq = tscoring._slab_spec(clip_batch, n, CPU)
            assert (tslab, tq) == (jslab, jq), (n, slab_env)
            assert (tmesh_ is None) == (jmesh_ is None)
    # A mesh that does not lead from the run's device is not taken.
    assert tmesh.leads(tm, torch.device("meta")) is None and tmesh.leads(tm, CPU) is tm


def test_data_mesh_raises_with_too_few_devices():
    with pytest.raises(RuntimeError, match="need 9"):
        jmesh.data_mesh(9)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match=f"need {have + 1} CUDA devices, have {have}"):
        tmesh.data_mesh(have + 1)
    m = tmesh.data_mesh(devices=["cpu"] * 3)
    assert m.size == 3 and m.devices == (CPU,) * 3 and m.distinct() == (CPU,)
    s = tmesh.pose_sharding(m)
    assert s.mesh is m and s.axis == tmesh.DATA_AXIS and tmesh.replicated(m).axis is None
    assert tmesh.shard_bounds(10, 4) == [(0, 3), (3, 6), (6, 8), (8, 10)]
    assert [len(p) for p in torch.arange(10).tensor_split(4)] == [3, 3, 2, 2]


# --------------------------------------------------------- imagine-and-score
def _tiny_stack(res=32):
    """tests/test_parallel_imagine.py's stack in both packages."""
    key = jax.random.PRNGKey(0)
    jcfg = JNGPConfig(**TINY_FIELD)
    jparams = init_ngp_params(key, jcfg)
    clip_kw = dict(image_size=res, patch_size=8, vision_width=32, vision_layers=2,
                   vision_heads=4, text_width=32, text_layers=2, text_heads=4,
                   projection_dim=16)
    jccfg = jclip.CLIPConfig(**clip_kw)
    cparams = jclip.init_clip_params(key, jccfg)
    f = 0.9 * res
    K = np.array([[f, 0, res / 2], [0, f, res / 2], [0, 0, 1.0]])
    T_WC = np.array([[1, 0, 0, 0.5], [0, -1, 0, 0.0], [0, 0, -1, 0.6], [0, 0, 0, 1]],
                    np.float32)
    T_WO = np.eye(4, dtype=np.float32)
    T_WO[:3, 3] = [0.5, 0.0, 0.05]
    txt = np.random.default_rng(1).normal(size=(2, 16)).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32)[None], (16, 1, 1))
    poses[:, 0, 3] = np.linspace(0.4, 0.6, 16)
    poses[:, 2, 3] = 0.05
    bg = dict(rgb=np.zeros((res, res, 3), np.float32), alpha=np.ones((res, res), np.float32),
              depth=np.full((res, res), 1.0, np.float32))
    return dict(
        res=res, K=K, T_WC=T_WC, T_WO=T_WO, txt=txt, poses=poses, bg=bg,
        jcfg=jcfg, jparams=jparams, jccfg=jccfg, cparams=cparams,
        field=field_from_jax({k: np.asarray(v) for k, v in jparams.items()},
                             NGPConfig(**TINY_FIELD), device="cpu"),
        ccfg=CLIPConfig(**clip_kw),
        clip=clip_from_jax(jax.tree_util.tree_map(np.asarray, cparams), CLIPConfig(**clip_kw),
                           device="cpu"),
        settings=dict(n_coarse=8, n_fine=8, near=0.05, far=2.0),
    )


@pytest.fixture(scope="module")
def stack():
    return _tiny_stack()


def test_imagine_on_8_shards_is_single_device_bit_for_bit_and_near_jax(stack):
    s = stack
    kw = dict(n_norm_captions=1, use_templates=False, clip_batch=2, return_renders=True)
    tdirs = tcam.pixel_dirs(s["res"], s["res"], s["K"], device="cpu")
    args = (s["field"], s["clip"], s["T_WO"], s["T_WC"],
            BackgroundView(**{k: torch.tensor(v) for k, v in s["bg"].items()}), s["txt"],
            s["poses"])
    single = timagine.make_imagine_and_score(s["field"].cfg, s["ccfg"],
                                             RenderSettings(**s["settings"]), tdirs,
                                             device="cpu", **kw)
    sharded = timagine.make_imagine_and_score(s["field"].cfg, s["ccfg"],
                                              RenderSettings(**s["settings"]), tdirs,
                                              mesh=cpu_mesh(), **kw)
    s1, r1 = single(*args)
    s8, r8 = sharded(*args)
    assert s8.shape == (16,) and r8.shape == (16, s["res"], s["res"], 3)
    assert torch.equal(s8, s1) and torch.equal(r8, r1)
    assert np.std(s1.numpy()) > 0
    with pytest.raises(ValueError, match="8 shards"):
        sharded(*args[:-1], s["poses"][:8])

    jdirs = jcam.pixel_dirs(s["res"], s["res"], jnp.asarray(s["K"]))
    jfn = jimagine.make_imagine_and_score(s["jcfg"], s["jccfg"], JSettings(**s["settings"]),
                                          jdirs, mesh=jmesh.data_mesh(8), **kw)
    js, jr = jfn(s["jparams"], s["cparams"], jnp.asarray(s["T_WO"]), jnp.asarray(s["T_WC"]),
                 JBackground(**{k: jnp.asarray(v) for k, v in s["bg"].items()}),
                 jnp.asarray(s["txt"]), jnp.asarray(s["poses"]))
    np.testing.assert_allclose(s8.numpy(), np.asarray(js), rtol=2e-2, atol=0)
    diff = np.abs(r8.numpy().astype(int) - np.asarray(jr).astype(int)).max(axis=-1)
    assert (diff <= 2).mean() >= 0.995, diff.max()


# ----------------------------------------------------------- the slab driver
class _TaskCaptions:
    goal_caption = "a red box on the green box"
    norm_captions = ["a red box and a green box"]


def _tok(texts, ctx=16):
    import hashlib

    ids = np.zeros((len(texts), ctx), np.int32)
    for r, t in enumerate(texts):
        toks = [1]
        for wd in t.split():
            toks.append(2 + int(hashlib.md5(wd.encode()).hexdigest(), 16) % 124)
        toks = toks[: ctx - 1] + [127]
        ids[r, : len(toks)] = toks
    return ids


@pytest.mark.parametrize("n_poses,batch", [(40, 2), (72, 4)], ids=["40_cb2", "72_padded_96"])
def test_fused_score_on_the_auto_mesh_matches_one_device(n_poses, batch, tmp_path, monkeypatch):
    """tests/test_fused_scoring.py's mesh cases through the port's driver:
    the auto mesh (patched to 8 CPU shards) is taken, every dispatch pads to
    8 * clip_batch, and scores and PNGs equal the D2R_MESH=0 run's."""
    res = 48
    f = 0.9 * res
    K = np.array([[f, 0, res / 2], [0, f, res / 2], [0, 0, 1.0]])
    field = field_from_jax({k: np.asarray(v) for k, v in
                            init_ngp_params(jax.random.PRNGKey(0), JNGPConfig(**TINY_FIELD)).items()},
                           NGPConfig(**TINY_FIELD), device="cpu")
    renderer = CombinedRenderer(field, field, settings=RenderSettings(n_coarse=8, n_fine=8,
                                                                      near=0.05, far=2.0),
                                res=res, intrinsics=K, row_chunk=16,
                                obj_aabb=((0.35, -0.1, 0.0), (0.65, 0.1, 0.15)), fg_crop=24,
                                device="cpu")
    clip_kw = dict(eot_id=127, image_size=res, patch_size=16, vision_width=32, vision_layers=2,
                   vision_heads=4, vocab_size=128, context_length=16, text_width=32,
                   text_layers=2, text_heads=4, projection_dim=24)
    clip = clip_from_jax(jax.tree_util.tree_map(np.asarray, jclip.init_clip_params(
        jax.random.PRNGKey(7), jclip.CLIPConfig(**clip_kw))), CLIPConfig(**clip_kw),
        device="cpu")
    scorer = ClipScorer(clip, batch_size=batch)
    T_WO_1 = np.eye(4, dtype=np.float32)
    T_WO_1[:3, 3] = [0.5, 0.0, 0.05]
    cam = np.array([[1, 0, 0, 0.5], [0, -1, 0, 0.0], [0, 0, -1, 0.7], [0, 0, 0, 1]], np.float32)
    poses = np.tile(T_WO_1[None], (n_poses, 1, 1))
    poses[:, 0, 3] += np.linspace(-0.08, 0.12, n_poses)
    poses[:, 2, 3] += np.linspace(0.0, 0.04, n_poses)
    mesh = cpu_mesh()

    def run(tag, mesh_env):
        monkeypatch.setenv("D2R_MESH", mesh_env)
        if mesh_env == "0":
            monkeypatch.setattr(tmesh, "auto_mesh", lambda: None)
        else:
            monkeypatch.setattr(tmesh, "auto_mesh", lambda: mesh)
        renderer.out_render_path = str(tmp_path / tag)
        out = tscoring._fused_score(renderer, scorer, _tok, _TaskCaptions(), poses, cam[None],
                                    None, None, T_WO_1, use_templates=False, save_renders=True)
        return out, dict(tscoring.LAST_RUN_INFO)

    single, info1 = run("one", "0")
    sharded, info8 = run("mesh", "1")
    assert info1["mesh_devices"] == 1 and info8["mesh_devices"] == 8
    assert info8["n_poses"] == n_poses and info8["clip_batch"] == batch
    assert info8["slab"] % (8 * batch) == 0
    np.testing.assert_array_equal(sharded, single)
    assert np.std(single) > 0
    names = [f"cb_rgb_{i:04d}.png" for i in range(n_poses)]
    assert sorted(os.listdir(tmp_path / "mesh")) == names == sorted(os.listdir(tmp_path / "one"))
    for name in names:
        np.testing.assert_array_equal(read_png(str(tmp_path / "mesh" / name)),
                                      read_png(str(tmp_path / "one" / name)))


# ------------------------------------------------------------------ training
def _train_setup(n_img, flagship):
    h = w = 16
    f = 0.9 * w
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]])
    rng = np.random.default_rng(0)
    images = torch.as_tensor(rng.integers(0, 255, (n_img, h, w, 4), dtype=np.uint8))
    poses = torch.eye(4).repeat(n_img, 1, 1)
    dirs = tcam.pixel_dirs(h, w, K, device="cpu")
    cfg = NGPConfig(aabb_min=TINY_FIELD["aabb_min"], aabb_max=TINY_FIELD["aabb_max"]) \
        if flagship else NGPConfig(**TINY_FIELD)
    return cfg, images, poses, dirs, K


def test_sharded_plain_train_chunk_matches_single(monkeypatch):
    """tests/test_parallel_imagine.py:103 for the port: 2 steps of the plain
    path, 64 rays over 8 shards, against one device."""
    monkeypatch.setenv("D2R_PALLAS_TRAIN", "0")
    cfg, images, poses, dirs, _ = _train_setup(4, flagship=False)
    tc = ttrainer.TrainConfig(n_steps=2, batch_rays=64, poll_steps=2,
                              optimize_extrinsics=False, dynamic_time_extension=False)
    settings = RenderSettings(n_coarse=4, n_fine=4, near=0.05, far=2.0)
    depths = torch.full((4, 16, 16), 0.5)
    common = dict(depths=depths)
    results = []
    for sharding in (None, tmesh.pose_sharding(cpu_mesh())):
        chunk = ttrainer.make_train_chunk(cfg, tc, settings, images, poses, dirs,
                                          ray_sharding=sharding, **common)
        state = ttrainer.init_train_state(cfg, tc, 4, device="cpu")
        state, loss = chunk(state)
        results.append((loss, state["field"].trunk_w0.detach().numpy().copy()))
    (l1, w1), (l8, w8) = results
    np.testing.assert_allclose(l8, l1, rtol=1e-4)
    np.testing.assert_allclose(w8, w1, atol=2e-5, rtol=1e-4)


def test_sharded_kernel_train_chunk_runs_and_updates(monkeypatch):
    """tests/test_parallel_imagine.py:147 for the port: the kernel path (K5-K7's
    plain versions here) on 8 shards makes a finite loss and moves the
    field; its loss is the unsharded step's (same rays, same draws)."""
    monkeypatch.setenv("D2R_PALLAS_TRAIN", "1")
    cfg, images, poses, dirs, _ = _train_setup(2, flagship=True)
    assert ttrainer.use_train_kernel(cfg)
    tc = ttrainer.TrainConfig(n_steps=1, batch_rays=64, poll_steps=1,
                              optimize_extrinsics=False, dynamic_time_extension=False)
    settings = RenderSettings(n_coarse=8, n_fine=8, near=0.05, far=2.0)
    losses = []
    for sharding in (None, tmesh.pose_sharding(cpu_mesh())):
        chunk = ttrainer.make_train_chunk(cfg, tc, settings, images, poses, dirs,
                                          ray_sharding=sharding)
        s0 = ttrainer.init_train_state(cfg, tc, 2, device="cpu")
        w0 = s0["field"].trunk_w0.detach().clone()
        s1, loss = chunk(s0)
        assert np.isfinite(loss)
        assert not torch.allclose(s1["field"].trunk_w0.detach(), w0)
        losses.append(loss)
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)


@pytest.mark.parametrize("path", ["plain", "kernel"])
def test_one_shard_mesh_is_the_unsharded_step_bit_for_bit(path, monkeypatch):
    monkeypatch.setenv("D2R_PALLAS_TRAIN", "1" if path == "kernel" else "0")
    cfg, images, poses, dirs, _ = _train_setup(3, flagship=path == "kernel")
    tc = ttrainer.TrainConfig(n_steps=2, batch_rays=32, poll_steps=2, optimize_extrinsics=True,
                              ext_start_step=1, dynamic_time_extension=False)
    settings = RenderSettings(n_coarse=8, n_fine=8, near=0.05, far=2.0)
    fg = torch.tensor([[0, 3, 4], [1, 8, 8], [2, 15, 0]])
    out = []
    for sharding in (None, tmesh.pose_sharding(cpu_mesh(1))):
        chunk = ttrainer.make_train_chunk(cfg, tc, settings, images, poses, dirs,
                                          depths=torch.full((3, 16, 16), 0.7),
                                          ray_sharding=sharding, fg_pixels=fg)
        state, loss = chunk(ttrainer.init_train_state(cfg, tc, 3, device="cpu"))
        out.append((loss, [p.detach().clone() for p in state["field"].parameters()],
                    state["ext_rot"].detach().clone(), state["generator"].get_state()))
    (l1, p1, e1, g1), (l2, p2, e2, g2) = out
    assert l1 == l2
    assert all(torch.equal(a, b) for a, b in zip(p1, p2))
    assert torch.equal(e1, e2) and e1.abs().sum() > 0
    assert torch.equal(g1, g2)


def test_sharded_step_refuses_a_batch_that_does_not_divide():
    cfg, images, poses, dirs, _ = _train_setup(2, flagship=False)
    tc = ttrainer.TrainConfig(batch_rays=60)
    with pytest.raises(ValueError, match="does not divide"):
        ttrainer.make_train_chunk(cfg, tc, RenderSettings(), images, poses, dirs,
                                  ray_sharding=tmesh.pose_sharding(cpu_mesh()))


# ------------------------------------------------------------------- physics
def _table_grids():
    """A table: solid below z = 0.02 over x, y in [0, 0.4), in both
    packages; a 4 cm box of 64 points as the movable object."""
    voxel = 0.01
    origin = np.array([0.005, 0.005, -0.095], np.float32)
    z = origin[2] + voxel * np.arange(24)
    tsdf = np.clip((z - 0.02) / (3 * voxel), -1, 1).astype(np.float32)
    tsdf = np.broadcast_to(tsdf, (40, 40, 24)).copy()
    weight = np.ones_like(tsdf)
    g = np.linspace(-0.02, 0.02, 4)
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    pts = np.concatenate([pts + [0.2, 0.2, 0.04], np.ones((64, 1))], 1).astype(np.float32)
    pts[::9, 3] = 0.0  # some points are not valid
    init = np.eye(4, dtype=np.float32)
    init[:3, 3] = [0.2, 0.2, 0.04]
    jg = jtsdf.TSDFGrid(jnp.asarray(tsdf), jnp.asarray(weight), jnp.asarray(origin), voxel)
    tg = phys_model_from_arrays(tsdf, weight, origin, voxel, None, device="cpu").tsdf
    return jg, tg, pts, init


def test_sharded_check_masks_equal_one_device_and_jax(monkeypatch):
    jg, tg, pts, init = _table_grids()
    rng = np.random.default_rng(0)
    n_pos, oris = 30, 4
    e = np.zeros((oris, 3))
    e[:, 2] = [0, 1e-6, np.pi / 2, np.pi]  # one orientation repeats: dedup
    R = np.asarray(euler_angles_to_matrix(jnp.asarray(e)))
    t = np.concatenate([rng.uniform(-0.05, 0.45, (n_pos, 2)), rng.uniform(0.0, 0.1, (n_pos, 1))], 1)
    batch = np.asarray(make_pose(jnp.asarray(np.tile(R, (n_pos, 1, 1))),
                                 jnp.asarray(np.repeat(t, oris, 0).astype(np.float32))))
    batch = batch.reshape(-1, 16).astype(np.float32)
    sample_res = [n_pos, 1, 1, oris, 1, 1]
    centre = (0.2, 0.2, 0.02)
    jc = jcol.make_unsupcol_check(jg, pts, init, centre, sample_res)  # the 8 virtual devices
    assert jmesh.auto_mesh().size == 8
    want = np.asarray(jc(jnp.asarray(batch)))
    single = tcol.make_unsupcol_check(tg, pts, init, centre, sample_res, device="cpu")
    sharded = tcol.make_unsupcol_check(tg, pts, init, centre, sample_res, device="cpu",
                                       pose_sharding=tmesh.pose_sharding(cpu_mesh()))
    assert single.mesh is None and sharded.mesh.size == 8
    for chunk in ("5", "16384"):
        monkeypatch.setenv("D2R_PHYS_CHUNK", chunk)
        m1, m8 = single(batch).numpy(), sharded(batch).numpy()
        np.testing.assert_array_equal(m8, m1)
        np.testing.assert_array_equal(m8, want)
    assert sharded.last_chunks == 1
    monkeypatch.setenv("D2R_PHYS_CHUNK", "5")  # rounds up to 8: 90 survivors in 12 chunks
    sharded(batch)
    assert (sharded.last_survivors, sharded.last_chunks) == (90, 12)
    assert 0 < want.sum() < len(want) / 2
    # The auto mesh is the default when it leads from the check's device.
    mesh = cpu_mesh(4)
    monkeypatch.setattr(tmesh, "auto_mesh", lambda: mesh)
    auto = tcol.make_unsupcol_check(tg, pts, init, centre, sample_res, device="cpu")
    assert auto.mesh is mesh
    np.testing.assert_array_equal(auto(batch).numpy(), want)


# ------------------------------------------------------------- build_vis_model
class _Stop(Exception):
    pass


@pytest.mark.parametrize("scale", [None, "1"], ids=["same_batch", "batch_scaled"])
def test_build_vis_model_train_info_matches_jax(scale, tmp_path, monkeypatch):
    """Both builds stop at make_train_chunk: LAST_TRAIN_INFO as JAX fills it
    on its 8 devices, the port's under the auto mesh patched to 8 CPU
    shards; the ray sharding goes to make_train_chunk."""
    from dream2real_tpu.cfg import Config as JConfig
    from dream2real_tpu_torch.cfg import Config
    from dream2real_tpu_torch.data.synth import write_dataset

    data = str(tmp_path / "scan")
    write_dataset(data, n_views=3, h=18, w=32)
    raw = json.load(open(os.path.join(ROOT, "configs", "synth_demo.json")))
    raw["camera"].update(fx=28.8, fy=28.8, cx=16.0, cy=9.0, w=32, h=18)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(raw))
    if scale is None:
        monkeypatch.delenv("D2R_TRAIN_BATCH_SCALE_MESH", raising=False)
    else:
        monkeypatch.setenv("D2R_TRAIN_BATCH_SCALE_MESH", scale)
    seen = {}

    def stop(tag):
        def capture(*a, **k):
            seen[tag] = k.get("ray_sharding")
            raise _Stop
        return capture

    monkeypatch.setattr(jrecon, "make_train_chunk", stop("jax"))
    monkeypatch.setattr(trecon, "make_train_chunk", stop("port"))
    mesh = cpu_mesh()
    monkeypatch.setattr(tmesh, "auto_mesh", lambda: mesh)
    over = dict(n_steps=4, batch_rays=64, poll_steps=2)
    with pytest.raises(_Stop):
        jrecon.build_vis_model(JConfig(str(cfg_path), data), dynamic_time_extension=False,
                               train_overrides=over)
    want = dict(jrecon.LAST_TRAIN_INFO)
    with pytest.raises(_Stop):
        trecon.build_vis_model(Config(str(cfg_path), data), dynamic_time_extension=False,
                               device="cpu", train_overrides=over)
    assert trecon.LAST_TRAIN_INFO == want
    assert want == {"mesh_devices": 8, "batch_rays": 64 * (8 if scale else 1)}
    assert seen["port"].mesh is mesh and seen["jax"].mesh.size == 8
