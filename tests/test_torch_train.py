"""Field training in the port against the JAX package: the repaired field
(trunc_exp's gradient, trainable parameters), the training randomness, the
SE(3) and colour helpers, the optimizer, the governor, one full training
loss and its gradients on an injected batch, a short training run, and a
build_vis_model snapshot that the JAX package loads. Also the step's
shared device constants, and on a card (marked ``cuda``) the step's CUDA
graph against the eager step, bit for bit; a machine without JAX runs only
those cases:
    python -m pytest --noconftest -m cuda tests/test_torch_train.py
"""

import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch

try:  # the JAX package's side of the parity tests
    import jax
    import jax.numpy as jnp
    import optax

    from dream2real_tpu.nerf import trainer as jtrainer
    from dream2real_tpu.nerf.model import NGPConfig as JNGPConfig, init_ngp_params
    from dream2real_tpu.nerf.render import RenderSettings as JSettings
except ImportError:
    jax = None
from dream2real_tpu_torch.bridge import field_from_jax, field_to_numpy
from dream2real_tpu_torch.device import F32, f32_constant
from dream2real_tpu_torch.nerf import model as tmodel, train_kernel as ttk
from dream2real_tpu_torch.nerf import trainer as ttrainer
from dream2real_tpu_torch.nerf.model import NGPConfig, NGPField, trunc_exp
from dream2real_tpu_torch.nerf.render import RenderSettings, ray_aabb, render_rays, sample_pdf

torch.set_num_threads(1)

AABB = dict(aabb_min=(0.0, -0.6, -0.5), aabb_max=(1.1, 0.6, 0.9))


def test_trunc_exp_gradient_matches_jax():
    from dream2real_tpu.nerf.model import trunc_exp as jtrunc_exp

    xs = np.array([-20.0, 0.0, 20.0], np.float32)
    x = torch.tensor(xs, requires_grad=True)
    trunc_exp(x).sum().backward()
    ref = jax.vmap(jax.grad(jtrunc_exp))(jnp.asarray(xs))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref), rtol=1e-6)
    assert float(x.grad[0]) > 0.0 and float(x.grad[2]) > 0.0  # y * dx beyond the clamp


def test_field_is_trainable_and_serving_runs_without_a_graph():
    field = NGPField(NGPConfig(mlp_width=16, mlp_depth=3, skip_layer=2), device="cpu")
    assert all(p.requires_grad for p in field.parameters())
    o = torch.tensor([[0.0, 0.0, -3.0]])
    d = torch.tensor([[0.1, 0.0, 1.0]])
    st = RenderSettings(n_coarse=8, n_fine=8)
    assert render_rays(field, o, d, st)["rgb"].requires_grad
    with torch.inference_mode():
        assert not render_rays(field, o, d, st)["rgb"].requires_grad


def test_render_jitter_from_a_generator():
    """Without a generator: midpoints (rendering); with one: each coarse
    sample inside its stratum, reproducible from the seed, and the fine
    draws at the inverse CDF of uniform quantiles from the same generator."""
    field = NGPField(NGPConfig(mlp_width=16, mlp_depth=3, skip_layer=2, **AABB), device="cpu")
    rng = np.random.default_rng(0)
    o = torch.tensor(rng.uniform([0.2, -0.3, -1.2], [0.9, 0.3, -0.8], (64, 3)),
                     dtype=torch.float32)
    d = torch.tensor(rng.uniform([0.2, -0.4, -0.2], [0.9, 0.4, 0.6], (64, 3)),
                     dtype=torch.float32) - o
    d = d / d[:, 2:3]
    st = RenderSettings(n_coarse=8, n_fine=0, near=0.05, far=2.0)
    with torch.no_grad():
        mid = render_rays(field, o, d, st)["ts"]
        a = render_rays(field, o, d, st, generator=torch.Generator().manual_seed(1))["ts"]
        b = render_rays(field, o, d, st, generator=torch.Generator().manual_seed(1))["ts"]
        c = render_rays(field, o, d, st, generator=torch.Generator().manual_seed(2))["ts"]
    assert torch.equal(a, b) and not torch.equal(a, c)
    half = (mid[:, 1:2] - mid[:, 0:1]) / 2
    assert bool(((a - mid).abs() <= half * (1 + 1e-5)).all())
    ts = torch.sort(torch.rand(16, 8, generator=torch.Generator().manual_seed(3)), dim=1).values
    w = torch.rand(16, 8, generator=torch.Generator().manual_seed(4))
    got = sample_pdf(ts, w, 12, torch.Generator().manual_seed(5))
    u = torch.rand(16, 12, generator=torch.Generator().manual_seed(5))
    cdf = torch.cumsum((w + 1e-5) / (w + 1e-5).sum(1, keepdim=True), 1)
    edges = torch.cat([ts[:, :1], 0.5 * (ts[:, 1:] + ts[:, :-1]), ts[:, -1:]], 1)
    cdf0 = torch.cat([torch.zeros(16, 1), cdf], 1)
    want = np.stack([np.interp(u[i].numpy(), cdf0[i].numpy(), edges[i].numpy()) for i in range(16)])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_so3_exp_value_and_gradient_at_zero_match_jax():
    from dream2real_tpu.ops.se3 import so3_exp as jso3
    from dream2real_tpu_torch.ops.se3 import so3_exp

    w = np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32) * 0.7
    w[0] = 0.0
    np.testing.assert_allclose(so3_exp(torch.tensor(w)).numpy(), np.asarray(jso3(jnp.asarray(w))),
                               atol=1e-6)
    wt = torch.zeros(3, requires_grad=True)
    probe = np.arange(9, dtype=np.float32).reshape(3, 3)
    (so3_exp(wt) * torch.tensor(probe)).sum().backward()
    ref = jax.grad(lambda v: jnp.sum(jso3(v) * probe))(jnp.zeros(3))
    assert np.isfinite(wt.grad.numpy()).all()
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(ref), atol=1e-6)


def test_srgb_to_linear_matches_jax():
    from dream2real_tpu.ops.image import srgb_to_linear as jsrgb
    from dream2real_tpu_torch.ops.image import srgb_to_linear

    x = np.linspace(-0.1, 1.1, 241, dtype=np.float32)
    np.testing.assert_allclose(srgb_to_linear(torch.tensor(x)).numpy(),
                               np.asarray(jsrgb(jnp.asarray(x))), rtol=1e-6, atol=1e-7)


SMALL = dict(mlp_width=16, mlp_depth=3, skip_layer=2, color_width=8, **AABB)


def test_optimizer_matches_optax():
    """Three steps from identical gradients: the field's decayed-weights Adam
    on the cosine schedule and the extrinsics' Adam, within 1e-6 relative."""
    jcfg = JNGPConfig(**SMALL)
    tc_kw = dict(n_steps=10, lr=1e-2, weight_decay=1e-3, optimize_extrinsics=True)
    params = {"field": init_ngp_params(jax.random.PRNGKey(0), jcfg),
              "ext_rot": jnp.zeros((2, 3)), "ext_trans": jnp.zeros((2, 3))}
    tx = jtrainer._make_optimizer(jtrainer.TrainConfig(**tc_kw))
    opt = tx.init(params)
    tc = ttrainer.TrainConfig(**tc_kw)
    state = ttrainer.init_train_state(NGPConfig(**SMALL), tc, n_images=2, device="cpu")
    with torch.no_grad():
        for k, p in state["field"].named_parameters():
            p.copy_(torch.tensor(np.asarray(params["field"][k])))
    rng = np.random.default_rng(1)
    for step in range(3):
        grads = jax.tree_util.tree_map(
            lambda v: rng.standard_normal(v.shape).astype(np.float32), params)
        updates, opt = tx.update(grads, opt, params)
        params = optax.apply_updates(params, updates)
        for k, p in state["field"].named_parameters():
            p.grad = torch.tensor(grads["field"][k])
        state["ext_rot"].grad = torch.tensor(grads["ext_rot"])
        state["ext_trans"].grad = torch.tensor(grads["ext_trans"])
        for group in state["opt_field"].param_groups:
            group["lr"] = ttrainer.cosine_lr(tc, step)
        state["opt_field"].step()
        state["opt_ext"].step()
    for k, p in state["field"].named_parameters():
        ref = np.asarray(params["field"][k])
        np.testing.assert_allclose(p.detach().numpy(), ref, rtol=1e-6,
                                   atol=1e-6 * np.abs(ref).max())
    for k in ("ext_rot", "ext_trans"):
        np.testing.assert_allclose(state[k].detach().numpy(), np.asarray(params[k]), rtol=1e-6,
                                   atol=1e-9)


@pytest.mark.parametrize("case", [
    dict(losses=[1e-2] * 20),                                        # extends to the cap
    dict(losses=[1e-2] * 20, dynamic_time_extension=False),          # stops at n_steps
    dict(losses=[1e-2, 1e-3] + [1e-5] * 30, stable_polls_thresh=3),  # converges early
    dict(losses=[1e-2] * 4 + [1e-4] * 40, stable_polls_thresh=6),    # converges after extending
    dict(losses=[1e-2] * 60, max_infinity_steps=2000),               # hits the cap
])
def test_governor_decisions_match_jax(case):
    case = dict(case)
    losses = case.pop("losses")
    kw = dict(n_steps=500, poll_steps=100, **case)

    def run(governor, tc):
        it = iter(losses)

        def chunk(state):
            return {"step": state["step"] + tc.poll_steps}, next(it, losses[-1])

        state, seen = governor(chunk, {"step": 0}, tc)
        return int(state["step"]), seen

    want = run(jtrainer.train_with_governor, jtrainer.TrainConfig(**kw))
    got = run(ttrainer.train_with_governor, ttrainer.TrainConfig(**kw))
    assert got == want


def _scene(n_img=3, h=12, w=16, seed=0):
    rng = np.random.default_rng(seed)
    rgba = rng.integers(0, 256, (n_img, h, w, 4)).astype(np.uint8)
    rgba[..., 3] = np.where(rng.uniform(size=(n_img, h, w)) < 0.4, 255, 0)
    depths = rng.uniform(0.5, 1.4, (n_img, h, w)).astype(np.float32)
    depths[:, :2] = 0.0  # invalid depth rows
    from dream2real_tpu_torch.data import synth

    poses = synth.orbit_poses((0.55, 0.0, 0.2), n_img, radius=0.6, height=0.5).astype(np.float32)
    K = np.array([[14.0, 0, w / 2], [0, 14.0, h / 2], [0, 0, 1.0]])
    return rgba, depths, poses, K


@pytest.mark.parametrize("optimize_extrinsics", [False, True])
def test_training_loss_and_grads_match_jax(optimize_extrinsics):
    """The full training loss (random-background sRGB Huber, depth Huber on
    solid pixels, free-space carving with stop-gradient geometry, the gated
    extrinsics and the one-hot pose pick) on one injected batch, through the
    kernels' plain versions, against jax.grad of the same loss built from the
    reference's public functions (Pallas in interpret mode)."""
    from dream2real_tpu.nerf.model import density_fn as jdensity_fn
    from dream2real_tpu.nerf.train_kernel import render_rays_train as jrender_rays_train
    from dream2real_tpu.ops import cameras as jcameras
    from dream2real_tpu.ops.image import linear_to_srgb as jl2s, srgb_to_linear as js2l
    from dream2real_tpu_torch.ops import cameras

    rgba, depths, poses, K = _scene()
    n_img, h, w = rgba.shape[:3]
    st = dict(n_coarse=8, n_fine=8, near=0.05, far=2.0)
    tc = ttrainer.TrainConfig(batch_rays=128, freespace_samples=4, ext_start_step=0,
                              optimize_extrinsics=optimize_extrinsics)
    cfg = NGPConfig(aabb_min=(0.0, -0.6, -0.1), aabb_max=(1.1, 0.6, 0.9))
    jcfg = JNGPConfig(aabb_min=cfg.aabb_min, aabb_max=cfg.aabb_max)
    jparams = init_ngp_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(3)
    ext_rot = (0.01 * rng.standard_normal((n_img, 3))).astype(np.float32)
    ext_trans = (0.01 * rng.standard_normal((n_img, 3))).astype(np.float32)
    fg = np.argwhere(rgba[..., 3] > 127)
    B = tc.batch_rays
    batch = (rng.integers(0, n_img, B), rng.integers(0, h, B), rng.integers(0, w, B),
             rng.uniform(size=(B, 3)).astype(np.float32),
             rng.uniform(size=(B, 4)).astype(np.float32))

    state = ttrainer.init_train_state(cfg, tc, n_img, device="cpu")
    with torch.no_grad():
        for k, p in state["field"].named_parameters():
            p.copy_(torch.tensor(np.asarray(jparams[k])))
        state["ext_rot"].copy_(torch.tensor(ext_rot))
        state["ext_trans"].copy_(torch.tensor(ext_trans))
    chunk = ttrainer.make_train_chunk(
        cfg, tc, RenderSettings(**st), torch.tensor(rgba), torch.tensor(poses),
        cameras.pixel_dirs(h, w, K, device="cpu"), depths=torch.tensor(depths),
        fg_pixels=torch.tensor(fg))
    loss, task = chunk.loss_fn(state, tuple(torch.tensor(x) for x in batch), None)
    loss.backward()

    dirs_cam = jcameras.pixel_dirs(h, w, jnp.asarray(K))
    img_idx, py, px, bg, u_free = (jnp.asarray(x) for x in batch)

    def jloss(p):
        target = jnp.asarray(rgba)[img_idx, py, px].astype(jnp.float32) / 255.0
        target_rgb, target_a = js2l(target[:, :3]), target[:, 3]
        if optimize_extrinsics:
            ps = jtrainer.optimized_poses(p, jnp.asarray(poses))
            T = jnp.einsum("bn,nij->bij", jax.nn.one_hot(img_idx, n_img), ps,
                           precision=jax.lax.Precision.HIGHEST)
        else:
            T = jnp.asarray(poses)[img_idx]
        dirs = jnp.einsum("bij,bj->bi", T[:, :3, :3], dirs_cam[py, px])
        origins = T[:, :3, 3]
        out = jrender_rays_train(p["field"], jcfg, origins, dirs, JSettings(**st), None,
                                 block_rays=128, need_ray_grads=optimize_extrinsics)
        pred = out["rgb"] + bg * (1.0 - out["alpha"][:, None])
        tgt = target_rgb * target_a[:, None] + bg * (1.0 - target_a[:, None])
        err = jl2s(jnp.clip(pred, 0.0, 1.0)) - jl2s(tgt)
        l_task = jnp.mean(optax.huber_loss(err, delta=0.1)) * 2.0
        gt_d = jnp.asarray(depths)[img_idx, py, px]
        d_err = jnp.where((gt_d > 0) & (target_a > 0.5), out["depth"] - gt_d, 0.0)
        l_task = l_task + tc.depth_weight * jnp.mean(optax.huber_loss(d_err, delta=0.05))
        o_sg, d_sg = jax.lax.stop_gradient(origins), jax.lax.stop_gradient(dirs)
        t_hi = jnp.maximum(gt_d * 0.9, st["near"])
        t_free = st["near"] + u_free * (t_hi - st["near"])[:, None]
        pos_f = o_sg[:, None, :] + d_sg[:, None, :] * t_free[..., None]
        sigma_f, _ = jdensity_fn(p["field"], pos_f, jcfg)
        dt = (t_hi - st["near"]) / 4 * jnp.linalg.norm(d_sg, axis=-1)
        occ = 1.0 - jnp.exp(-sigma_f * dt[:, None])
        l = l_task + tc.freespace_weight * jnp.mean(occ * (gt_d > 0)[:, None])
        return l, l_task

    jp = {"field": jparams, "ext_rot": jnp.asarray(ext_rot), "ext_trans": jnp.asarray(ext_trans)}
    (jl, jtask), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=2e-3)
    np.testing.assert_allclose(float(task), float(jtask), rtol=2e-3)
    for k, p in state["field"].named_parameters():
        a, b = np.asarray(jg["field"][k]).ravel(), p.grad.numpy().ravel()
        cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))
        assert cos > 0.99, (k, cos)
        np.testing.assert_allclose(b, a, atol=8e-2 * max(np.abs(a).max(), 1e-9), rtol=0,
                                   err_msg=k)
    if optimize_extrinsics:
        for k in ("ext_rot", "ext_trans"):
            a, b = np.asarray(jg[k]).ravel(), state[k].grad.numpy().ravel()
            assert float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b))) > 0.95, k
    else:
        assert state["ext_rot"].grad is None


@pytest.mark.parametrize("pallas_train", ["1", "0"])
def test_short_training_run_loss_falls(pallas_train, monkeypatch):
    """Twenty steps of the flagship field on a tiny synthetic scene, through
    the kernels' plain versions and (D2R_PALLAS_TRAIN=0) through the plain
    autograd render: finite, and the loss falls."""
    from dream2real_tpu_torch.data import synth
    from dream2real_tpu_torch.ops import cameras

    monkeypatch.setenv("D2R_PALLAS_TRAIN", pallas_train)
    assert ttrainer.use_train_kernel(NGPConfig()) == (pallas_train == "1")

    scene = synth.default_scene()
    h = w = 16
    K = np.array([[14.4, 0, 8.0], [0, 14.4, 8.0], [0, 0, 1.0]])
    poses = synth.orbit_poses(scene.centre, 4, radius=0.5, height=0.4)
    rgbs, depths = zip(*[synth.render_scene(scene, p, K, h, w)[:2] for p in poses])
    rgba = np.concatenate([np.stack(rgbs), np.full((4, h, w, 1), 255, np.uint8)], axis=-1)
    cfg = NGPConfig(aabb_min=(0.0, -0.6, -0.1), aabb_max=(1.1, 0.6, 0.9))
    tc = ttrainer.TrainConfig(n_steps=20, batch_rays=256, poll_steps=5,
                              dynamic_time_extension=False)
    state = ttrainer.init_train_state(cfg, tc, 4, device="cpu")
    chunk = ttrainer.make_train_chunk(
        cfg, tc, RenderSettings(n_coarse=8, n_fine=8, near=0.05, far=2.0), torch.tensor(rgba),
        torch.tensor(poses, dtype=torch.float32), cameras.pixel_dirs(h, w, K, device="cpu"),
        depths=torch.tensor(np.stack(depths)))
    state, losses = ttrainer.train_with_governor(chunk, state, tc)
    assert state["step"] == 20 and len(losses) == 4
    assert np.isfinite(losses).all() and losses[-1] < 0.8 * losses[0], losses


def test_build_vis_model_snapshot_loads_in_jax(tmp_path, monkeypatch):
    """build_vis_model on a tiny on-disk scan (the port's synthetic dataset
    writer) writes a snapshot, with its settings header, that the JAX
    package loads, and the fg/bg pose exports."""
    from dream2real_tpu.reconstruction import NGPModel as JNGPModel
    from dream2real_tpu_torch.cfg import Config
    from dream2real_tpu_torch.data.synth import write_dataset
    from dream2real_tpu_torch.reconstruction import build_vis_model

    data = str(tmp_path / "scan")
    write_dataset(data, n_views=3, h=18, w=32)
    raw = json.load(open(os.path.join(os.path.dirname(__file__), "..", "configs",
                                      "synth_demo.json")))
    raw["camera"].update(fx=28.8, fy=28.8, cx=16.0, cy=9.0, w=32, h=18)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(raw))
    monkeypatch.setenv("D2R_TRAIN_SAMPLING", "8,8")
    cfg = Config(str(cfg_path), data)
    model, opt_poses = build_vis_model(
        cfg, dynamic_time_extension=False, device="cpu",
        train_overrides=dict(n_steps=4, batch_rays=64, poll_steps=2))
    assert opt_poses is None
    assert os.path.exists(os.path.join(data, "opt_cam_poses.npy"))
    assert os.path.exists(os.path.join(data, "fg_transforms.json"))
    jm = JNGPModel.load(cfg.save_snapshot_path)
    assert jm.settings.n_coarse == 8 and jm.settings.n_fine == 8
    assert jm.settings.near == cfg.near_distance and jm.settings.far == cfg.max_depth
    assert tuple(jm.cfg.aabb_min) == tuple(model.cfg.aabb_min)
    ours = field_to_numpy(model.field)
    assert set(ours) == set(jm.params)
    for k, v in ours.items():
        np.testing.assert_array_equal(np.asarray(jm.params[k]), v)
    back = field_from_jax(ours, model.cfg, device="cpu")
    for k, p in back.named_parameters():
        assert torch.equal(p, getattr(model.field, k)), k


# The benchmark's fg field box: corners no float32 holds exactly.
BOX = NGPConfig(aabb_min=(0.05, -0.55, -0.15), aabb_max=(1.15, 1.55, 1.35))


def test_f32_constant_is_made_once_from_the_float32_values():
    vals = (0.05, -0.55, -0.15)
    a = f32_constant(vals, "cpu")
    assert a.dtype == F32 and torch.equal(a, torch.tensor(vals, dtype=F32))
    assert f32_constant(list(vals), torch.device("cpu")) is a
    assert f32_constant(np.asarray(vals), "cpu") is a
    zero, neg = f32_constant((0.0,), "cpu"), f32_constant((-0.0,), "cpu")
    assert zero is not neg and math.copysign(1.0, float(neg)) < 0


def test_constants_first_made_in_inference_mode_serve_autograd():
    """A render under ``torch.inference_mode`` may make a constant first;
    training then saves it for backward."""
    with torch.inference_mode():
        freqs = tmodel.posenc_freqs(3, "cpu")
        lo = f32_constant((0.25, -0.75, 0.125), "cpu")
    x = torch.ones(3, requires_grad=True)
    (x * freqs * lo).sum().backward()
    assert not freqs.is_inference() and not lo.is_inference()
    assert torch.equal(x.grad, freqs * lo)


@pytest.mark.parametrize("name", ["field_box", "density_aabb", "ray_aabb", "posenc_freqs"])
def test_step_constants_hold_the_per_call_values_and_are_cached(name):
    """Each constant of the training step equals what its per-call
    construction made, bit for bit, and a second call returns the same
    tensor."""
    def per_call():
        if name == "field_box":
            return torch.tensor(tuple(BOX.aabb_min) + tuple(BOX.aabb_max), dtype=F32)
        if name == "posenc_freqs":
            return torch.tensor(2.0, dtype=F32) ** torch.arange(10, dtype=F32) * \
                torch.tensor(math.pi, dtype=F32)
        return torch.cat([torch.as_tensor(BOX.aabb_min, dtype=F32),
                          torch.as_tensor(BOX.aabb_max, dtype=F32)])

    def cached():
        if name == "field_box":
            return ttk.field_box(BOX, "cpu")
        if name == "posenc_freqs":
            return tmodel.posenc_freqs(10, "cpu")
        if name == "density_aabb":
            return tmodel._aabb(BOX, "cpu")
        return tuple(f32_constant(b, "cpu") for b in (BOX.aabb_min, BOX.aabb_max))

    first, again = cached(), cached()
    flat = torch.cat(first) if isinstance(first, tuple) else first
    assert flat.dtype == F32 and torch.equal(flat, per_call())
    assert all(a is b for a, b in zip(first, again)) if isinstance(first, tuple) \
        else first is again
    if name == "ray_aabb":  # the slab test on the cached corners, as it was per call
        rng = np.random.default_rng(0)
        o = torch.tensor(rng.uniform(-1, 2, (64, 3)), dtype=F32)
        d = torch.tensor(rng.uniform(-1, 1, (64, 3)), dtype=F32)
        lo, hi = per_call()[:3], per_call()[3:]
        safe = torch.where(d.abs() < 1e-9, torch.full_like(d, 1e-9), d)
        want = (torch.minimum((lo - o) / safe, (hi - o) / safe).amax(-1),
                torch.maximum((lo - o) / safe, (hi - o) / safe).amin(-1))
        got = ray_aabb(o, d, BOX.aabb_min, BOX.aabb_max)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("optimize_extrinsics", [False, True], ids=["fg_task", "extrinsics"])
def test_graph_step_is_the_eager_step_bit_for_bit(optimize_extrinsics, monkeypatch):
    """The fg-task chunk on the card's graph path against the same chunk
    through a one-device mesh (the eager step, bit for bit the unsharded
    one), from one seed: 5 chunks of one step, taken in turn from two chunk
    functions of the state (each with its own graph and gradients), then a
    chunk of 3. The task losses, Adam's first moments, the parameters, the
    extrinsics and the generator come out identical, and every step of the
    graph path is a replay. With ``optimize_extrinsics`` the gate opens at
    step 3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the step's graph and K5-K7")
    from torch.profiler import ProfilerActivity, profile

    from dream2real_tpu_torch.ops import cameras
    from dream2real_tpu_torch.parallel import mesh as tmesh
    from dream2real_tpu_torch.utils import profiling

    monkeypatch.setenv("D2R_PALLAS_TRAIN", "1")
    dev = torch.device("cuda", 0)
    rgba, depths, poses, K = _scene(n_img=4, h=36, w=48, seed=5)
    n_img, h, w = rgba.shape[:3]
    cfg = NGPConfig(aabb_min=(0.0, -0.6, -0.1), aabb_max=(1.1, 0.6, 0.9))
    assert ttrainer.use_train_kernel(cfg)
    data = dict(images_rgba=torch.as_tensor(rgba, device=dev),
                init_poses=torch.as_tensor(poses, device=dev),
                dirs_cam=cameras.pixel_dirs(h, w, K, device=dev),
                depths=torch.as_tensor(depths, device=dev),
                fg_pixels=torch.as_tensor(np.argwhere(rgba[..., 3] > 127), device=dev))
    settings = RenderSettings(n_coarse=32, n_fine=32, near=0.05, far=2.0)
    runs = []
    for sharding in (None, tmesh.pose_sharding(tmesh.data_mesh(1))):
        tc = ttrainer.TrainConfig(n_steps=40, batch_rays=1024, poll_steps=1, seed=2**31 + 7,
                                  optimize_extrinsics=optimize_extrinsics, ext_start_step=3)
        chunks = [ttrainer.make_train_chunk(cfg, tc, settings, ray_sharding=sharding, **data)
                  for _ in range(2)]
        state = ttrainer.init_train_state(cfg, tc, n_img, device=dev)
        profiling.reset()
        losses = []
        with profile(activities=[ProfilerActivity.CPU]):
            for k, poll in enumerate((1, 1, 1, 1, 1, 3)):
                tc.poll_steps = poll
                state, loss = chunks[k % 2](state)
                losses.append(loss)
        torch.cuda.synchronize()
        opt = state["opt_field"]
        runs.append({
            "losses": losses, "step": state["step"], "counters": profiling.counters(),
            "params": [p.detach().clone() for p in state["field"].parameters()],
            "exp_avg": [opt.state[p]["exp_avg"].clone() for p in state["field"].parameters()],
            "ext": [state[k].detach().clone() for k in ("ext_rot", "ext_trans")],
            "generator": state["generator"].get_state()})
    graph, eager = runs
    assert graph["step"] == eager["step"] == 8
    assert graph["counters"] == {"train.steps": 8, "train.graph_steps": 8}
    assert eager["counters"] == {"train.steps": 8}
    assert all(math.isfinite(x) for x in graph["losses"])
    assert graph["losses"] == eager["losses"]
    for key in ("params", "exp_avg", "ext"):
        assert all(torch.equal(a, b) for a, b in zip(graph[key], eager[key])), key
    assert torch.equal(graph["generator"], eager["generator"])
    moved = float(graph["ext"][0].abs().sum())
    assert moved > 0 if optimize_extrinsics else moved == 0
