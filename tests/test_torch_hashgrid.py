"""The hash-grid encoding and field against the JAX package's, on the CPU.

- ``hash_encode`` at the JAX tests' TINY_GRID (two dense levels, two hashed)
  and at one hashed level of the default table size (2^19 entries, 2048
  per side): forward to 1e-6, the table's gradient against ``jax.grad`` to
  1e-5 relative. The level resolutions and the dense / hash choice equal
  the reference's at both sizes and the defaults.
- The hash-grid field on bridged parameters, with the table drawn from
  Uniform(+-1) so that the encoding, h0 and the geo features are O(1) (a
  fresh +-1e-4 table makes every sigma about 1 and hides the density
  layers): ``density_fn`` (sigma to 1e-6 relative, the geo features to one
  bf16 step of their scale) and ``render_rays`` (rgb, alpha and depth to
  1e-5). A zeroed table or swapped density layers fail both comparisons. A
  snapshot the JAX package writes loads in the port and back, and the
  kernels' gates stay shut for this field type.
- The field trains through plain autograd: a few steps on the CPU lower the
  loss, and every parameter, the table included, gets a finite gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dream2real_tpu.nerf import hashgrid as jhg
from dream2real_tpu.nerf import model as jmodel
from dream2real_tpu.nerf.render import RenderSettings as JSettings
from dream2real_tpu.nerf.render import render_rays as jrender
from dream2real_tpu.nerf.snapshot import load_snapshot as jload
from dream2real_tpu.nerf.snapshot import save_snapshot as jsave
from dream2real_tpu_torch.bridge import field_from_jax, field_from_snapshot, field_to_numpy
from dream2real_tpu_torch.nerf import hashgrid as thg
from dream2real_tpu_torch.nerf import march_kernel, model as tmodel, train_kernel
from dream2real_tpu_torch.nerf.render import RenderSettings, render_rays
from dream2real_tpu_torch.nerf.snapshot import save_snapshot

torch.set_num_threads(2)
TINY = dict(n_levels=4, n_features=2, log2_hashmap_size=12, base_resolution=4, max_resolution=32)
ONE_FULL = dict(n_levels=1, n_features=2, log2_hashmap_size=19, base_resolution=2048,
                max_resolution=2048)
FWD_TOL, GRAD_RTOL = 1e-6, 1e-5


@pytest.mark.parametrize("grid", [TINY, ONE_FULL, {}], ids=["tiny", "one_full_level", "default"])
def test_level_layout_matches_jax(grid):
    j, t = jhg.HashGridConfig(**grid), thg.HashGridConfig(**grid)
    np.testing.assert_array_equal(t.level_resolutions(), j.level_resolutions())
    np.testing.assert_array_equal(t.level_is_dense(), j.level_is_dense())
    assert (t.table_size, t.out_dim, t.per_level_scale) == (j.table_size, j.out_dim,
                                                            j.per_level_scale)
    assert tmodel.HashGridConfig is thg.HashGridConfig  # still importable from the model


@pytest.mark.parametrize("grid", [TINY, ONE_FULL], ids=["tiny", "one_full_level"])
def test_hash_encode_and_gradient_match_jax(grid):
    rng = np.random.default_rng(0)
    jcfg, tcfg = jhg.HashGridConfig(**grid), thg.HashGridConfig(**grid)
    table = np.asarray(jhg.init_hash_table(jax.random.PRNGKey(1), jcfg))
    n = 4096
    pos = rng.uniform(-0.05, 1.05, (n, 3)).astype(np.float32)  # some clamped
    pos[:8] = np.array([[0, 0, 0], [1, 1, 1], [0.5, 0.25, 0.75], [1, 0, 1]] * 2, np.float32)
    cot = rng.standard_normal((n, jcfg.out_dim)).astype(np.float32)

    want = np.asarray(jhg.hash_encode(jnp.asarray(pos), jnp.asarray(table), jcfg))
    g_want = np.asarray(jax.grad(lambda t: (jhg.hash_encode(jnp.asarray(pos), t, jcfg)
                                            * cot).sum())(jnp.asarray(table)))
    tt = torch.tensor(table, requires_grad=True)
    got = thg.hash_encode(torch.tensor(pos).reshape(64, 64, 3), tt, tcfg)
    assert got.shape == (64, 64, tcfg.out_dim)
    (got.reshape(n, -1) * torch.tensor(cot)).sum().backward()
    assert np.abs(got.detach().numpy().reshape(n, -1) - want).max() <= FWD_TOL
    g = tt.grad.numpy()
    assert np.abs(g - g_want).max() <= GRAD_RTOL * np.abs(g_want).max()
    assert np.count_nonzero(g_want) > 1000


def test_init_hash_table_range():
    t = thg.init_hash_table(thg.HashGridConfig(**TINY), torch.Generator().manual_seed(0))
    assert t.shape == (4, 4096, 2) and t.dtype == torch.float32
    assert float(t.abs().max()) <= 1e-4 and float(t.std()) > 4e-5


def _cfgs(**kw):
    common = dict(field_type="hashgrid", hidden_dim=16, geo_feat_dim=7,
                  aabb_min=(0.0, 0.0, 0.0), aabb_max=(1.0, 1.0, 1.0), **kw)
    return (jmodel.NGPConfig(grid=jhg.HashGridConfig(**TINY), **common),
            tmodel.NGPConfig(grid=thg.HashGridConfig(**TINY), **common))


# sigma: exp of the same bf16 h0 in both, an f32 ulp or so apart. The geo
# features: one bf16 step (2^-8) of their largest value. render_rays: f32
# compositing of those.
SIGMA_RTOL, GEO_STEP, RENDER_ATOL = 1e-6, 2.0 ** -8, 1e-5


@pytest.fixture(scope="module")
def bridged():
    jcfg, tcfg = _cfgs()
    params = jax.tree_util.tree_map(np.asarray, jmodel.init_ngp_params(jax.random.PRNGKey(0),
                                                                         jcfg))
    params["table"] = np.random.default_rng(3).uniform(
        -1, 1, params["table"].shape).astype(np.float32)
    return jcfg, params, field_from_jax(params, tcfg, device="cpu")


def test_field_layout(bridged):
    _, params, field = bridged
    assert list(dict(field.named_parameters())) == ["table", "sigma_w0", "sigma_w1",
                                                    "color_w0", "color_w1", "color_w2"]
    for k, p in field.named_parameters():
        assert tuple(p.shape) == np.asarray(params[k]).shape, k
    fresh = tmodel.init_ngp_params(field.cfg, torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        assert float(fresh.table.abs().max()) <= 1e-4
        assert float(fresh.sigma_w0.abs().max()) > 0.05


def _density_gaps(jcfg, params, field):
    """JAX's density_fn on ``params`` against the port's on ``field``: ->
    (sigma's largest relative gap, the geo features' largest gap, the
    reference's sigma and geo features)."""
    pos = np.random.default_rng(1).uniform(-0.1, 1.1, (2000, 3)).astype(np.float32)
    sj, gj = jmodel.density_fn(params, jnp.asarray(pos), jcfg)
    with torch.no_grad():
        st, gt = tmodel.density_fn(field, torch.tensor(pos))
    sj, gj = np.asarray(sj), np.asarray(gj, np.float32)
    assert (st.numpy()[sj == 0] == 0).all() and (sj == 0).sum() > 100  # outside the box
    rel = np.abs(st.numpy() - sj) / np.maximum(sj, np.finfo(np.float32).tiny)
    return float(rel.max()), float(np.abs(gt.float().numpy() - gj).max()), sj, gj


def _render_gaps(jcfg, params, field):
    """render_rays of both packages: -> {output: largest absolute gap}."""
    rng = np.random.default_rng(2)
    o = np.tile([[-0.5, 0.5, 0.5]], (64, 1)).astype(np.float32)
    d = np.c_[np.ones(64), rng.uniform(-0.3, 0.3, (64, 2))].astype(np.float32)
    js, ts = JSettings(n_coarse=16, n_fine=16, far=3.0), RenderSettings(n_coarse=16, n_fine=16,
                                                                       far=3.0)
    want = jrender(params, jcfg, jnp.asarray(o), jnp.asarray(d), js)
    with torch.no_grad():
        got = render_rays(field, torch.tensor(o), torch.tensor(d), ts)
    return {k: float(np.abs(got[k].numpy() - np.asarray(want[k])).max())
            for k in ("rgb", "alpha", "depth")}


def test_density_fn_matches_jax(bridged):
    jcfg, params, field = bridged
    sigma_gap, geo_gap, sj, gj = _density_gaps(jcfg, params, field)
    inside = sj[sj > 0]
    assert inside.max() - inside.min() > 0.5 and np.abs(gj).max() > 1  # O(1), not ~0
    print(f"sigma {sigma_gap:.2e} relative (<= {SIGMA_RTOL}), geo {geo_gap:.2e} "
          f"(<= {GEO_STEP * np.abs(gj).max():.2e})")
    assert sigma_gap <= SIGMA_RTOL
    assert geo_gap <= GEO_STEP * np.abs(gj).max()


def test_render_rays_matches_jax(bridged):
    jcfg, params, field = bridged
    gaps = _render_gaps(jcfg, params, field)
    print(gaps, f"(<= {RENDER_ATOL})")
    assert max(gaps.values()) <= RENDER_ATOL, gaps


def _zero_table(p):
    p["table"] = np.zeros_like(p["table"])


def _swap_density_layers(p):
    p["sigma_w0"], p["sigma_w1"] = p["sigma_w1"].T.copy(), p["sigma_w0"].T.copy()


@pytest.mark.parametrize("fault", [_zero_table, _swap_density_layers],
                         ids=["zero_table", "swap_density_layers"])
def test_field_comparisons_catch_a_faulty_field(bridged, fault):
    """The tolerances above hold the hash-grid branch: a port field with a
    zeroed table or with its two density layers swapped fails both."""
    jcfg, params, _ = bridged
    bad = dict(params)
    fault(bad)
    field = field_from_jax(bad, _cfgs()[1], device="cpu")
    sigma_gap, geo_gap, _, gj = _density_gaps(jcfg, params, field)
    assert sigma_gap > SIGMA_RTOL and geo_gap > GEO_STEP * np.abs(gj).max()
    assert max(_render_gaps(jcfg, params, field).values()) > RENDER_ATOL


def test_snapshot_round_trip_across_packages(bridged, tmp_path):
    jcfg, params, field = bridged
    path = str(tmp_path / "fg_base.ingp")
    jsave(path, params, jcfg, extra={"note": "jax"})
    loaded, settings = field_from_snapshot(path, device="cpu")
    assert loaded.cfg == field.cfg and settings is None
    for k, v in field_to_numpy(loaded).items():
        np.testing.assert_array_equal(v, np.asarray(params[k]))
    back = str(tmp_path / "bg_base.ingp")
    save_snapshot(back, loaded, loaded.cfg)
    params2, cfg2, _ = jload(back)
    assert cfg2 == jcfg
    for k in params:
        np.testing.assert_array_equal(np.asarray(params2["field"][k]), np.asarray(params[k]))


def test_kernel_gates_stay_shut(bridged):
    _, _, field = bridged
    assert not march_kernel.supports(field.cfg, RenderSettings(n_fine=0))
    assert not train_kernel.supports_training(field.cfg)


def test_hashgrid_field_trains_through_autograd():
    from dream2real_tpu_torch.nerf.trainer import (TrainConfig, init_train_state,
                                                   make_train_chunk, use_train_kernel)
    from dream2real_tpu_torch.ops.cameras import pixel_dirs

    _, tcfg = _cfgs()
    assert not use_train_kernel(tcfg)
    h = w = 16
    K = np.array([[16.0, 0, 8], [0, 16.0, 8], [0, 0, 1]])
    poses = np.tile(np.eye(4), (2, 1, 1))
    poses[:, :3, 3] = [[0.5, 0.5, -0.8], [0.45, 0.5, -0.8]]
    img = np.zeros((2, h, w, 4), np.uint8)
    img[:, 4:12, 4:12] = [200, 60, 60, 255]
    tc = TrainConfig(n_steps=30, batch_rays=128, poll_steps=10, lr=1e-2)
    state = init_train_state(tcfg, tc, 2, device="cpu")
    chunk = make_train_chunk(tcfg, tc, RenderSettings(n_coarse=12, n_fine=12, far=3.0),
                             torch.tensor(img), torch.tensor(poses, dtype=torch.float32),
                             pixel_dirs(h, w, K, device="cpu"))
    losses = []
    for _ in range(3):
        state, loss = chunk(state)
        losses.append(loss)
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert state["step"] == 30
    for k, p in state["field"].named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), k
    assert float(state["field"].table.grad.abs().max()) > 0
