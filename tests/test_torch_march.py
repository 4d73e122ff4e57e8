"""K1 (fused march): the port's plain version against the JAX Pallas kernel
(interpret mode on the CPU) and against render_rays, on the same seeded
flagship field and rays."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dream2real_tpu.nerf import march_kernel as jmk
from dream2real_tpu.nerf import render as jrender
from dream2real_tpu.nerf.model import NGPConfig as JNGPConfig, init_ngp_params
from dream2real_tpu_torch.bridge import field_from_jax
from dream2real_tpu_torch.nerf import march_kernel as tmk
from dream2real_tpu_torch.nerf import render as trender
from dream2real_tpu_torch.nerf.model import NGPConfig

torch.set_num_threads(1)

AABB = dict(aabb_min=(0.0, -0.6, -0.5), aabb_max=(1.1, 0.6, 0.9))
JCFG = JNGPConfig(**AABB)
CFG = NGPConfig(**AABB)
ORIGIN = np.array([0.5, 0.0, -0.4], np.float32)
LO, HI = [0.3, -0.2, 0.0], [0.7, 0.2, 0.3]


def _settings(n, mod, **kw):
    return mod.RenderSettings(n_coarse=n, n_fine=0, near=0.05, far=2.0, **kw)


@pytest.fixture(scope="module")
def fields():
    params = init_ngp_params(jax.random.PRNGKey(0), JCFG)
    np_params = {k: np.asarray(v) for k, v in params.items()}
    return params, field_from_jax(np_params, CFG, device="cpu")


def _rays(R, lo, hi, seed):
    rng = np.random.default_rng(seed)
    targets = rng.uniform(lo, hi, size=(R, 3)).astype(np.float32)
    d = targets - ORIGIN
    return (d / d[:, 2:3]).astype(np.float32)


def _port(field, d, lo, hi, settings, early_exit=None, origin=ORIGIN):
    out = tmk.march_rays_fused(
        tmk.pack_params(field), CFG, torch.from_numpy(origin)[None],
        torch.from_numpy(d)[None], (lo, hi), settings, early_exit=early_exit,
    )
    return {k: v[0].numpy() for k, v in out.items()}


@pytest.mark.parametrize("R", [256, 300])
@pytest.mark.parametrize("S", [20, 32])
def test_march_plain_matches_pallas(fields, R, S):
    params, field = fields
    d = _rays(R, LO, HI, seed=R + S)
    ref = jmk.march_rays_fused(
        params, JCFG, jnp.asarray(ORIGIN), jnp.asarray(d), (jnp.asarray(LO), jnp.asarray(HI)),
        _settings(S, jrender), block_rays=128,
    )
    out = _port(field, d, LO, HI, _settings(S, trender))
    assert out["rgb"].shape == (R, 3)
    assert float(np.asarray(ref["alpha"]).max()) > 0.05  # the field is not empty here
    for k in ("alpha", "depth"):
        np.testing.assert_allclose(out[k], np.asarray(ref[k]), atol=1e-3, rtol=0)
    # rgb: the two f32 matmul libraries sum the colour head in different
    # orders, which flips the bf16 rounding of a few colour hidden units
    # (about 1e-4 of them); the worst measured effect is 1.07e-3 (S=20,
    # R=256). The encoding and trunk agree bit for bit.
    np.testing.assert_allclose(out["rgb"], np.asarray(ref["rgb"]), atol=1.5e-3, rtol=0)


def test_march_plain_matches_render_rays(fields):
    """Against the reference's unfused renderer, at its own 5e-3; the port's
    render_rays agrees with the reference's too."""
    params, field = fields
    R, S = 256, 32
    d = _rays(R, LO, [0.7, 0.2, 1.2], seed=3)  # march box pokes out of the field box
    hi = [0.7, 0.2, 1.2]
    ref = jrender.render_rays(
        params, JCFG, jnp.broadcast_to(jnp.asarray(ORIGIN), (R, 3)), jnp.asarray(d),
        _settings(S, jrender), march_aabb=(jnp.asarray(LO), jnp.asarray(hi)),
    )
    out = _port(field, d, LO, hi, _settings(S, trender))
    with torch.no_grad():
        plain = trender.render_rays(
            field, torch.from_numpy(ORIGIN).expand(R, 3), torch.from_numpy(d),
            _settings(S, trender), march_aabb=(LO, hi),
        )
    for k in ("rgb", "alpha", "depth"):
        np.testing.assert_allclose(out[k], np.asarray(ref[k]), atol=5e-3, rtol=0)
        np.testing.assert_allclose(plain[k].numpy(), np.asarray(ref[k]), atol=1e-3, rtol=0)


def test_march_miss_rays_exact_zero(fields):
    _, field = fields
    d = _rays(128, [5.0, 5.0, 1.0], [6.0, 6.0, 2.0], seed=5)
    out = _port(field, d, LO, HI, _settings(20, trender))
    for k in ("rgb", "alpha", "depth"):
        assert np.abs(out[k]).max() == 0.0


@pytest.mark.parametrize("min_t", [1e-4, 0.9])
def test_march_early_exit_bitexact(fields, min_t):
    _, field = fields
    d = np.concatenate([_rays(96, LO, HI, 1), _rays(32, [5.0, 5.0, 1.0], [6.0, 6.0, 2.0], 2)])
    st = _settings(32, trender, min_transmittance=min_t)
    base = _port(field, d, LO, HI, st, early_exit=False)
    fast = _port(field, d, LO, HI, st, early_exit=True)
    for k in ("rgb", "alpha", "depth"):
        np.testing.assert_array_equal(base[k], fast[k])


def test_march_pose_batch_independent(fields):
    """Two poses in one call give what each gives alone."""
    _, field = fields
    st = _settings(20, trender)
    origins = np.stack([ORIGIN, ORIGIN + np.float32([0.05, -0.03, 0.02])])
    d = np.stack([_rays(128, LO, HI, 11), _rays(128, LO, HI, 12)])
    both = tmk.march_rays_fused(tmk.pack_params(field), CFG, torch.from_numpy(origins),
                                torch.from_numpy(d), (LO, HI), st)
    for p in range(2):
        alone = _port(field, d[p], LO, HI, st, origin=origins[p])
        for k in ("rgb", "alpha", "depth"):
            np.testing.assert_array_equal(both[k][p].numpy(), alone[k])


@pytest.mark.parametrize("change", [
    {}, {"field_type": "hashgrid"}, {"mlp_width": 128}, {"posenc_deg": 8},
    {"skip_layer": 2}, {"geo_feat_dim": 7}, {"sh_degree": 3},
])
@pytest.mark.parametrize("n_fine", [0, 32])
def test_supports_gate_parity(change, n_fine):
    js = jrender.RenderSettings(n_coarse=32, n_fine=n_fine)
    ts = trender.RenderSettings(n_coarse=32, n_fine=n_fine)
    assert tmk.supports(CFG._replace(**change), ts) == jmk.supports(JCFG._replace(**change), js)
