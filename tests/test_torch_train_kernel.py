"""K5-K8 (the fused training kernels): the port's plain versions against the
JAX Pallas kernels (interpret mode on the CPU) and jax.grad through the
Pallas backward, on the same seeded flagship field, rays and sample
positions. Tolerances are tests/test_train_kernel.py's. Each parity test
prints its measured error beside its tolerance (``pytest -s``); the worst
are recorded in PERF.md."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dream2real_tpu.nerf import train_kernel as jtk
from dream2real_tpu.nerf.model import NGPConfig as JNGPConfig, init_ngp_params
from dream2real_tpu.nerf.render import RenderSettings as JSettings, render_rays as jrender_rays
from dream2real_tpu_torch.bridge import field_from_jax
from dream2real_tpu_torch.nerf import train_kernel as ttk
from dream2real_tpu_torch.nerf.model import NGPConfig
from dream2real_tpu_torch.nerf.render import RenderSettings

torch.set_num_threads(1)

AABB = dict(aabb_min=(0.0, -0.6, -0.5), aabb_max=(1.1, 0.6, 0.9))
JCFG, CFG = JNGPConfig(**AABB), NGPConfig(**AABB)
MIN_T = 1e-4


@pytest.fixture(scope="module")
def fields():
    params = init_ngp_params(jax.random.PRNGKey(0), JCFG)
    field = field_from_jax({k: np.asarray(v) for k, v in params.items()}, CFG, device="cpu")
    w, b = ttk.pack_train_params(field.params())
    return params, field, w, b, ttk.field_box(CFG, "cpu")


def _rays(R, seed):
    """Rays from several cameras toward the box interior (per-ray origins),
    z-normalized, and sorted irregular sample positions (R, 16)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([0.2, -0.3, -1.2], [0.9, 0.3, -0.8], (R, 3)).astype(np.float32)
    d = rng.uniform([0.2, -0.4, -0.2], [0.9, 0.4, 0.6], (R, 3)).astype(np.float32) - o
    d = (d / d[:, 2:3]).astype(np.float32)
    ts = (0.3 + 1.3 * np.sort(rng.uniform(size=(R, 16)), axis=1)).astype(np.float32)
    probes = (rng.standard_normal((R, 3)).astype(np.float32),
              rng.standard_normal(R).astype(np.float32),
              (0.1 * rng.standard_normal(R)).astype(np.float32))
    return o, d, ts, probes


def _t(*xs):
    return [torch.tensor(np.asarray(x)) for x in xs]


def _cos(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def _report(what, measured, allowed):
    print(f"\n{what}: measured {measured}, allowed {allowed}")


@pytest.mark.parametrize("R", [256, 300])
def test_train_fwd_plain_matches_pallas(fields, R):
    """K6: worst measured 5.3e-4 (depth R 256, rgb R 300) against the 5e-3
    allowed."""
    params, _, w, b, box = fields
    o, d, ts, _ = _rays(R, seed=R)
    ref = jtk.render_train_fused(params, JCFG, jnp.asarray(o), jnp.asarray(d), jnp.asarray(ts),
                                 MIN_T, 128, None)
    out = ttk.train_fwd_plain(*_t(o, d, ts), box, w, b, MIN_T)
    assert float(np.asarray(ref["alpha"]).max()) > 0.05  # the field is not empty here
    errs = {k: float(np.abs(v.numpy() - np.asarray(ref[k])).max())
            for k, v in zip(("rgb", "alpha", "depth"), out)}
    _report(f"K6 plain vs Pallas, R {R}, max abs", errs, 5e-3)
    for k, v in zip(("rgb", "alpha", "depth"), out):
        np.testing.assert_allclose(v.numpy(), np.asarray(ref[k]), atol=5e-3, rtol=0)


@pytest.fixture(scope="module")
def grads(fields):
    """jax.grad through the Pallas backward and K7's plain version, with
    and without ray gradients, on the same probes of the outputs."""
    params, _, w, b, box = fields
    o, d, ts, probes = _rays(256, seed=5)

    def loss(p, oo, dd):
        out = jtk.render_train_fused(p, JCFG, oo, dd, jnp.asarray(ts), MIN_T, 128, None)
        return (jnp.sum(out["rgb"] * probes[0]) + jnp.sum(out["alpha"] * probes[1])
                + jnp.sum(out["depth"] * probes[2]))

    g_ref, go_ref, gd_ref = jax.grad(loss, argnums=(0, 1, 2))(
        params, jnp.asarray(o), jnp.asarray(d))
    C, A, D = ttk.train_fwd_plain(*_t(o, d, ts), box, w, b, MIN_T)
    cot = _t(*probes)
    full = ttk.train_bwd_plain(*_t(o, d, ts), box, w, b, MIN_T, *cot, C, A, D, True)
    slim = ttk.train_bwd_plain(*_t(o, d, ts), box, w, b, MIN_T, *cot, C, A, D, False)
    return dict(ref=(g_ref, go_ref, gd_ref), full=full, slim=slim)


@pytest.mark.parametrize("name", ttk._PARAM_KEYS)
def test_train_bwd_plain_param_grads_match_pallas(grads, name):
    """K7's parameter gradients: worst measured 9.7e-4 x scale (trunk_w1) and
    least cosine 0.9999998 against 8e-2 x scale and 0.995 allowed."""
    a = np.asarray(grads["ref"][0][name])
    b = ttk.unpack_grads(grads["full"][0])[name].numpy()
    assert a.shape == b.shape
    scale = max(np.abs(a).max(), 1e-6)
    _report(f"K7 {name} grad vs jax.grad, max abs / scale and cosine",
            (float(np.abs(a - b).max() / scale), _cos(a, b)), (8e-2, 0.995))
    assert _cos(a, b) > 0.995
    np.testing.assert_allclose(b, a, atol=8e-2 * scale, rtol=0)


def test_train_bwd_plain_ray_grads_match_pallas(grads):
    """K7's origin / direction gradients drop the same terms as the
    reference's; measured cosine 0.9999998, norm ratio 0.99996."""
    _, go_ref, gd_ref = grads["ref"]
    _, go, gd = grads["full"]
    for ref, got in ((go_ref, go), (gd_ref, gd)):
        ref, got = np.asarray(ref), got.numpy()
        ratio = float(np.linalg.norm(got) / np.linalg.norm(ref))
        _report("K7 ray grad vs jax.grad, cosine and norm ratio", (_cos(ref, got), ratio),
                (0.95, "0.7-1.3"))
        assert _cos(ref, got) > 0.95 and 0.7 < ratio < 1.3


def test_need_ray_grads_false_param_grads_identical(grads):
    g_full, go_full, _ = grads["full"]
    g_slim, go_slim, gd_slim = grads["slim"]
    assert torch.equal(g_full, g_slim)
    assert float(go_full.abs().max()) > 0.0
    assert float(go_slim.abs().max()) == 0.0 and float(gd_slim.abs().max()) == 0.0


def test_render_train_fused_autograd(fields, grads):
    """The autograd Function (K6 forward, K7 backward) returns K7's
    gradients in the field's layout, zeros for ts and, without ray
    gradients, zeros for the rays."""
    _, field, _, _, _ = fields
    o, d, ts, probes = _rays(256, seed=5)
    o_t, d_t, ts_t = (x.requires_grad_(True) for x in _t(o, d, ts))
    for need in (True, False):
        field.zero_grad()
        out = ttk.render_train_fused(field, o_t, d_t, ts_t, MIN_T, need_ray_grads=need)
        loss = sum((out[k] * p).sum() for k, p in zip(("rgb", "alpha", "depth"), _t(*probes)))
        go, gd, gts = torch.autograd.grad(loss, [o_t, d_t, ts_t], retain_graph=True)
        loss.backward()
        want = ttk.unpack_grads(grads["full"][0])
        for k, p in field.named_parameters():
            assert torch.equal(p.grad, want[k]), k
        assert float(gts.abs().max()) == 0.0
        if need:
            assert torch.equal(go, grads["full"][1]) and torch.equal(gd, grads["full"][2])
        else:
            assert float(go.abs().max()) == 0.0 and float(gd.abs().max()) == 0.0
    field.zero_grad()


def _coarse_ts(o, d, nc):
    from dream2real_tpu.nerf.render import ray_aabb

    t0, t1 = ray_aabb(jnp.asarray(o), jnp.asarray(d), CFG.aabb_min, CFG.aabb_max)
    t0 = jnp.maximum(t0, 0.05)
    t1 = jnp.where(t1 > t0, jnp.minimum(t1, 2.0), t0 + 1e-3)
    return np.asarray(t0[:, None] + (t1 - t0)[:, None] * (jnp.arange(nc) + 0.5) / nc, np.float32)


@pytest.mark.parametrize("R", [200, 300])
def test_density_weights_plain_matches_pallas(fields, R):
    """K8: worst measured 8.2e-4 (R 300) against the 5e-3 allowed."""
    params, _, w, b, box = fields
    o, d, _, _ = _rays(R, seed=3)
    ts = _coarse_ts(o, d, 8)
    ref = jtk.density_weights_fused(params, JCFG, jnp.asarray(o), jnp.asarray(d),
                                    jnp.asarray(ts), MIN_T, block_rays=128)
    out = ttk.density_weights_plain(*_t(o, d, ts), box, w, b, MIN_T)
    _report(f"K8 plain vs Pallas, R {R}, max abs",
            float(np.abs(out.numpy() - np.asarray(ref)).max()), 5e-3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-3, rtol=0)


@pytest.mark.parametrize("mix", [0.25, 0.5])
def test_density_sample_plain_matches_pallas(fields, mix):
    """K5 on the same Exp(1) draws: positions within 2e-3 of the Pallas
    kernel's (worst measured 2.2e-4, mean 3.8e-7), sorted, inside the coarse
    range, and distributed over the coarse bins as the defensive mixture
    says (tests/test_train_kernel.py's bin-mass test)."""
    params, _, w, b, box = fields
    R, S_c, n_draw = 256, 8, 64
    o, d, _, _ = _rays(R, seed=31)
    ts_c = _coarse_ts(o, d, S_c)
    rng = np.random.default_rng(7)
    exp_draws = (-np.log(rng.uniform(1e-12, 1.0, (R, n_draw + 1)))).astype(np.float32)
    ref = np.asarray(jtk.density_sample_fused(
        params, JCFG, jnp.asarray(o), jnp.asarray(d), jnp.asarray(ts_c), jnp.asarray(exp_draws),
        n_fine=n_draw, min_transmittance=MIN_T, mix=mix, block_rays=128))
    ts_f = ttk.density_sample_plain(*_t(o, d, ts_c, exp_draws), box, w, b, n_draw, MIN_T,
                                    mix).numpy()
    diff = np.abs(ts_f - ref)
    _report(f"K5 plain vs Pallas, mix {mix}, max and mean abs",
            (float(diff.max()), float(diff.mean())), 2e-3)
    np.testing.assert_allclose(ts_f, ref, atol=2e-3, rtol=0)
    assert np.all(np.diff(ts_f, axis=1) >= -1e-6)
    assert np.all(ts_f >= ts_c[:, :1] - 1e-5) and np.all(ts_f <= ts_c[:, -1:] + 1e-5)

    wts = ttk.density_weights_plain(*_t(o, d, ts_c), box, w, b, MIN_T).numpy()
    w_def = wts + (mix / (1 - mix)) * wts.mean(axis=1, keepdims=True) + 1e-8
    p_ref = w_def / w_def.sum(axis=1, keepdims=True)
    mids = 0.5 * (ts_c[:, 1:] + ts_c[:, :-1])
    edges = np.concatenate([ts_c[:, :1], mids, ts_c[:, -1:]], axis=1)
    emp = np.zeros(S_c)
    for r in range(R):
        idx = np.clip(np.searchsorted(edges[r], ts_f[r]) - 1, 0, S_c - 1)
        emp += np.bincount(idx, minlength=S_c)
    np.testing.assert_allclose(emp / emp.sum(), p_ref.mean(axis=0), atol=0.03)


def test_render_rays_train_deterministic_matches_jax(fields):
    """Without a generator: K8 + sample_pdf midpoints + sorted union + K6,
    against the reference's render_rays (mean abs < 2e-2)."""
    params, field, _, _, _ = fields
    o, d, _, _ = _rays(256, seed=1)
    st = dict(n_coarse=8, n_fine=8, near=0.05, far=2.0)
    ref = jrender_rays(params, JCFG, jnp.asarray(o), jnp.asarray(d), JSettings(**st))
    with torch.no_grad():
        out = ttk.render_rays_train(field, *_t(o, d), RenderSettings(**st))
    for k in ("rgb", "alpha"):
        assert float(np.abs(out[k].numpy() - np.asarray(ref[k])).mean()) < 2e-2


def test_miss_rays_zero_output_and_grad(fields):
    _, field, _, _, _ = fields
    o = torch.tensor([[0.5, 0.0, 5.0]]).expand(128, 3).contiguous()
    d = torch.tensor([[0.0, 0.0, 1.0]]).expand(128, 3).contiguous()
    field.zero_grad()
    out = ttk.render_rays_train(field, o, d, RenderSettings(n_coarse=8, n_fine=8, far=2.0),
                                torch.Generator().manual_seed(0))
    for k in ("rgb", "alpha", "depth"):
        assert float(out[k].detach().abs().max()) == 0.0
    out["rgb"].sum().backward()
    for k, p in field.named_parameters():
        assert float(p.grad.abs().max()) == 0.0, k
    field.zero_grad()


@pytest.mark.parametrize("sampler, n_fine, generator", [
    ("1", 8, True), ("0", 8, True), ("1", 8, False), ("1", 0, True)])
def test_render_rays_train_packs_the_field_once(fields, monkeypatch, sampler, n_fine, generator):
    """One render_rays_train call, forward and backward, packs the field's
    weights once (looked up through the module, as tools/train_trajectory.py
    wraps it) for the sampler (K5, or K8 and sample_pdf), K6 and K7."""
    _, field, _, _, _ = fields
    o, d, _, _ = _rays(32, seed=4)
    st = RenderSettings(n_coarse=8, n_fine=n_fine, near=0.05, far=2.0)
    monkeypatch.setenv("D2R_FUSED_SAMPLER", sampler)
    pack, calls = ttk.pack_train_params, []

    def counted(p):
        calls.append(1)
        return pack(p)

    monkeypatch.setattr(ttk, "pack_train_params", counted)
    field.zero_grad()
    gen = torch.Generator().manual_seed(2) if generator else None
    out = ttk.render_rays_train(field, *_t(o, d), st, gen)
    (out["rgb"].sum() + out["alpha"].sum()).backward()
    assert len(calls) == 1
    assert float(out["alpha"].detach().max()) > 0.0
    for k, p in field.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), k
    field.zero_grad()


@pytest.mark.parametrize("change", [
    {}, {"field_type": "hashgrid"}, {"mlp_width": 128}, {"skip_layer": 2}, {"sh_degree": 3},
])
def test_supports_training_gate_parity(change):
    assert ttk.supports_training(CFG._replace(**change)) == jtk.supports_training(
        JCFG._replace(**change))


def _tile_rows(geo, n_rays, S):
    """The (ray, sample) of every tile row as csrc/train.cu's train_rows maps
    them (row r of a group's step is sample step * spt + r % spt of the
    group's ray r // spt): (groups, steps, TILE_ROWS, 2), -1 where a row
    holds no sample."""
    rpt, spt, steps = geo["rays_per_tile"], geo["samples_per_tile"], geo["steps"]
    g = torch.arange(geo["groups"])[:, None, None]
    step = torch.arange(steps)[None, :, None]
    r = torch.arange(ttk.TILE_ROWS)[None, None, :]
    lr, s = r // spt, step * spt + r % spt
    ray = g * rpt + lr
    ok = (lr < rpt) & (s < S) & (ray < n_rays)
    out = torch.stack(torch.broadcast_tensors(ray, s), dim=-1)
    return torch.where(ok[..., None], out, torch.full_like(out, -1))


@pytest.mark.parametrize("R, S", [(1, 1), (63, 33), (64, 64), (65, 65), (300, 128), (5, 200),
                                  (8191, 2), (8192, 64), (300, 17), (8192, 32), (300, 48),
                                  (2, 160)])
def test_train_geometry_tiles_every_row_once(R, S):
    """K5-K8's tiles (K5's and K8's shapes too: S 17, 32, 48, 160): every
    (ray, sample) row lands in exactly one tile row, a ray's rows stay in
    one group (whole rays share a tile, or one block walks a long ray's
    steps in order), and K7's scratch follows the chunk, not R."""
    geo = ttk.train_geometry(R, S, 132)
    rpt, spt = geo["rays_per_tile"], geo["samples_per_tile"]
    assert rpt * spt <= ttk.TILE_ROWS and geo["steps"] * spt >= S
    rows = _tile_rows(geo, R, S)  # (groups, steps, 128, 2)
    assert rows.shape == (geo["groups"], geo["steps"], ttk.TILE_ROWS, 2)
    flat = rows.reshape(-1, 2)
    kept = flat[flat[:, 0] >= 0]
    assert kept.shape[0] == R * S
    assert torch.unique(kept[:, 0] * S + kept[:, 1]).numel() == R * S
    group_of = torch.arange(geo["groups"])[:, None, None].expand(rows.shape[:3])
    ok = rows[..., 0] >= 0
    # A ray's rows all lie in one group, and within it in sample order.
    assert torch.equal(group_of[ok], rows[..., 0][ok] // rpt)
    order = rows[..., 1].clone()
    order[~ok] = -1
    for g in range(min(geo["groups"], 3)):
        for ray in range(rpt):
            s = order[g][rows[g][..., 0] == g * rpt + ray]
            assert torch.equal(s, torch.arange(s.numel()))
    assert geo["n_chunks"] * geo["chunk_groups"] >= geo["groups"]
    assert geo["scratch_bytes"] == (geo["chunk_groups"] * geo["steps"] * 2 * ttk.BLOCK_CHUNKS
                                    * ttk.CHUNK_BYTES)
    # The buffers stop growing with R once a chunk is full.
    full = 132 * rpt  # rays of a full chunk
    bigger = ttk.train_geometry(2 * full + R, S, 132)
    assert bigger["chunk_groups"] == 132
    assert geo["scratch_bytes"] <= bigger["scratch_bytes"] == ttk.train_geometry(
        7 * full + R, S, 132)["scratch_bytes"]


def _swizzled_job(img, off, rows, cols):
    """A job of the wgmma image back to its (rows, cols) matrix."""
    flat = img[off // 2: off // 2 + rows * cols]
    r = torch.arange(rows)[:, None]
    c = torch.arange(cols)[None, :]
    pos = (c // 64) * rows * 64 + r * 64 + (((c % 64) // 8) ^ (r % 8)) * 8 + c % 8
    return flat[pos]


@pytest.mark.parametrize("name", sorted({job[0] for job in ttk.WGMMA_JOBS}))
def test_wgmma_image_holds_every_job(fields, name):
    """The image K6 and K7 stream: each job of matrix `name` unswizzles to
    its K-tile of the packed matrix, zero past the matrix's columns, and the
    jobs of a matrix cover it once."""
    _, _, w, b, _ = fields
    img = ttk.wgmma_image(w)
    assert img.numel() * 2 == ttk.IMAGE_BYTES
    mats, _ = ttk._unpack(w, b)
    m = mats[name]
    seen = torch.zeros(m.shape, dtype=torch.int32)
    off = 0
    for jname, k0, rows, n0, cols, _ in ttk.WGMMA_JOBS:
        if jname == name:
            got = _swizzled_job(img, off, rows, cols)
            real = min(cols, m.shape[1] - n0)
            assert torch.equal(got[:, :real], m[k0:k0 + rows, n0:n0 + real])
            assert float(got[:, real:].float().abs().sum()) == 0.0
            seen[k0:k0 + rows, n0:n0 + real] += 1
        off += 2 * rows * cols
    assert off == ttk.IMAGE_BYTES
    assert int(seen.min()) == 1 and int(seen.max()) == 1
