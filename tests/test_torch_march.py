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
        tmk.pack_params(field), torch.from_numpy(origin)[None],
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
    both = tmk.march_rays_fused(tmk.pack_params(field), torch.from_numpy(origins),
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


def test_compaction_matches_nonzero(fields):
    """The device-side compaction (a prefix sum, no host sync) gives the live
    set torch.nonzero gives, in order, and the wrapper's results on it equal
    the plain version over the rays nonzero picks, scattered back."""
    _, field = fields
    st = _settings(20, trender)
    origins = torch.from_numpy(np.stack([ORIGIN, ORIGIN + np.float32([0.05, -0.03, 0.02])]))
    d = np.stack([_rays(96, LO, HI, 21), _rays(96, LO, HI, 22)])
    d[:, ::3] = _rays(64, [5.0, 5.0, 1.0], [6.0, 6.0, 2.0], 23).reshape(2, 32, 3)  # misses
    d = torch.from_numpy(d)
    t0, t1 = tmk.march_ranges(origins, d, (LO, HI), st)
    live, count = tmk.compact_live(t0, t1)
    want = torch.nonzero(t1 > t0).squeeze(1)
    assert live.dtype == count.dtype == torch.int32 and count.shape == (1,)
    assert int(count[0]) == want.numel() and 100 < want.numel() <= 128
    assert torch.equal(live[: int(count[0])].long(), want)
    packed = tmk.pack_params(field)
    box = torch.cat([packed.field_box, torch.tensor(LO), torch.tensor(HI)])
    got = tmk.march(origins, d, t0, t1, live, count, box, packed, 20, st.min_transmittance, True)
    ref = tmk.march_plain(origins[want // 96], d.reshape(-1, 3)[want], t0[want], t1[want], box,
                          packed.w, packed.b, 20, st.min_transmittance, True)
    for a, b in zip(got, ref):
        assert torch.equal(a[want], b)
        rest = torch.ones(a.shape[0], dtype=torch.bool)
        rest[want] = False
        assert not a[rest].any()


def test_compaction_empty_group_gives_zeros(fields):
    """A clip group with no live ray: count 0, and exact zeros out."""
    _, field = fields
    st = _settings(20, trender)
    d = torch.from_numpy(_rays(64, [5.0, 5.0, 1.0], [6.0, 6.0, 2.0], 9))[None]
    t0, t1 = tmk.march_ranges(torch.from_numpy(ORIGIN)[None], d, (LO, HI), st)
    live, count = tmk.compact_live(t0, t1)
    assert int(count[0]) == 0
    out = tmk.march_rays_fused(tmk.pack_params(field), torch.from_numpy(ORIGIN)[None], d,
                               (LO, HI), st)
    for k in ("rgb", "alpha", "depth"):
        assert out[k].shape[:2] == (1, 64) and not out[k].any()


@pytest.mark.parametrize("S,want", [(1, (1, 128, 1)), (3, (3, 42, 1)), (5, (5, 25, 1)),
                                    (20, (4, 32, 5)), (32, (4, 32, 8)), (33, (7, 18, 5)),
                                    (129, (4, 32, 33))])
def test_march_geometry(S, want):
    """K1's tiles: (samples a tile takes at a time, rays a tile, steps), at
    most 128 rows, the fewest idle rows, one block an SM at most one a tile."""
    geo = tmk.march_geometry(150_248, S, 132)
    spt, rpt, steps = want
    assert (geo["samples_per_tile"], geo["rays_per_tile"], geo["steps"]) == want
    assert rpt * spt <= tmk.TILE_ROWS and steps * spt >= S > (steps - 1) * spt
    assert geo["tiles"] == -(-150_248 // rpt) and geo["grid"] == 132
    assert tmk.march_geometry(5, S, 132)["grid"] == 1
    assert geo["smem_bytes"] <= 232_448 and geo["image_bytes"] == 544_768


def test_march_image_unswizzles_to_the_packed_weights(fields):
    """Every job of K1's wgmma image, unswizzled, is its K-tile of the packed
    matrices (zero past the matrix), in MARCH_JOBS order."""
    _, field = fields
    packed = tmk.pack_params(field)
    mats, _ = tmk._unpack(packed.w, packed.b)
    off = 0
    for name, k0, rows, n0, cols in tmk.MARCH_JOBS:
        job = packed.img[off : off + rows * cols].reshape(cols // 64, rows, 8, 8)
        off += rows * cols
        r = torch.arange(rows)[:, None]
        unit = (torch.arange(8)[None, :] ^ (r % 8))  # the 16-byte unit a column group sits in
        tile = job[:, r, unit].permute(1, 0, 2, 3).reshape(rows, cols)
        m = mats[name]
        want = torch.zeros(rows, cols, dtype=m.dtype)
        n = min(cols, m.shape[1] - n0)
        want[:, :n] = m[k0 : k0 + rows, n0 : n0 + n]
        assert torch.equal(tile, want), (name, k0, n0)
    assert off * 2 == tmk.IMAGE_BYTES


def test_march_plain_f64_witness(fields):
    """march_plain(dtype=torch.float64), the witness phase 3 of chip_smoke.py
    holds K1's flagged rays against: every operation in f64 with the same
    bf16 weights and activation roundings. On the random field it stays
    within K1's 5e-3 of the f32 plain version (1.4e-3 measured: a few bf16
    roundings of activations flip, as between K1 and the plain version), its
    outputs are f64, and the default stays the f32 version bit for bit."""
    _, field = fields
    st = _settings(20, trender)
    origins = torch.from_numpy(np.tile(ORIGIN, (256, 1)))
    d = torch.from_numpy(_rays(256, LO, HI, 31))
    t0, t1 = tmk.march_ranges(origins[:1], d[None], (LO, HI), st)
    packed = tmk.pack_params(field)
    box = torch.cat([packed.field_box, torch.tensor(LO), torch.tensor(HI)])
    args = (origins, d, t0, t1, box, packed.w, packed.b, 20, st.min_transmittance, True)
    f32 = tmk.march_plain(*args)
    explicit = tmk.march_plain(*args, dtype=torch.float32)
    f64 = tmk.march_plain(*args, dtype=torch.float64)
    for a, b, c in zip(f32, explicit, f64):
        assert a.dtype == torch.float32 and c.dtype == torch.float64
        assert torch.equal(a, b)
        assert float((a.double() - c).abs().max()) < 5e-3
    assert float(f64[1].max()) > 0.1  # the rays see density
