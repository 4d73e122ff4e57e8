"""The CUDA kernels against their plain versions on the card, at ragged
shapes and at the main path's (chip_smoke.py's phase 2 times them there and
holds none of them). Marked `cuda`; without a GPU every test skips. Needs no
JAX, so on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch
from clip_witness import port_block, witness_block, witness_input

from dream2real_tpu_torch.nerf import march_kernel as mk
from dream2real_tpu_torch.nerf.model import NGPConfig, init_ngp_params
from dream2real_tpu_torch.nerf.render import RenderSettings, ray_aabb
from dream2real_tpu_torch.ops import attention as att

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _march_case(dev, n_rays, seed=0, miss=1 / 3):
    """A seeded flagship field's packed weights and two poses of n_rays crop
    rays each, `miss` of them aimed off the box; -> (packed, origins, dirs,
    march box (lo, hi), settings)."""
    cfg = NGPConfig(aabb_min=(0.0, -0.6, -0.5), aabb_max=(1.1, 0.6, 0.9))
    st = RenderSettings(n_coarse=20, n_fine=0, near=0.05, far=2.0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    packed = mk.pack_params(init_ngp_params(cfg, gen, device=dev))
    rng = np.random.default_rng(seed)
    origins = torch.tensor([[0.5, 0.0, -0.4], [0.45, 0.05, -0.35]], device=dev)
    tgt = rng.uniform([0.3, -0.2, 0.0], [0.7, 0.2, 0.3], size=(2, n_rays, 3))
    tgt[:, : int(n_rays * miss)] += 5.0
    d = torch.tensor(tgt, dtype=torch.float32, device=dev) - origins[:, None]
    d = d / d[..., 2:3]
    return packed, origins, d, ((0.3, -0.2, 0.0), (0.7, 0.2, 0.3)), st


@pytest.mark.parametrize("n_rays", [1, 31, 32, 33, 300, 1000, 16 * 128 * 128])
def test_march_kernel_matches_plain(dev, n_rays):
    """K1 at ragged live-ray counts around its 32-ray tiles, and at a clip
    group's rays (32 poses of 128^2 crop rays as two poses of 16 x 128^2),
    against its plain version on the same compacted rays (5e-3, the
    reference's march tolerance); early exit on and off bit for bit; misses
    exact zeros."""
    packed, origins, d, (lo, hi), st = _march_case(dev, n_rays, seed=n_rays)
    t0, t1 = mk.march_ranges(origins, d, (lo, hi), st)
    live, count = mk.compact_live(t0, t1)
    box = torch.cat([packed.field_box, torch.tensor(lo + hi, device=dev)])
    args = (origins, d, t0, t1, live, count, box, packed, 20, st.min_transmittance)
    before = mk.march.launches
    got = mk.march(*args, True)
    assert mk.march.launches == before + 1
    ref = mk.march_plain_live(*args, True)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=5e-3, rtol=0)
    for a, b in zip(got, mk.march(*args, False)):
        assert torch.equal(a, b)
    hit = t1 > t0
    assert int(count[0]) == int(hit.sum()) and not got[1][~hit].any()
    out = mk.march_rays_fused(packed, origins, d, (lo, hi), st)
    assert torch.equal(out["alpha"].reshape(-1), got[1])


def test_march_no_live_ray_launches_and_gives_zeros(dev):
    """A clip group whose rays all miss: one launch, exact zeros, no host
    branch (count 0 is read on the device)."""
    packed, origins, d, aabb, st = _march_case(dev, 64, miss=1.0)
    before = mk.march.launches
    out = mk.march_rays_fused(packed, origins, d, aabb, st)
    assert mk.march.launches == before + 1
    for k in ("rgb", "alpha", "depth"):
        assert not out[k].any()


@pytest.mark.parametrize("min_t", [1e-4, 0.5])
def test_march_early_exit_bitexact(dev, min_t):
    """The exact early exit: a tile stops once all its rays are below
    min_transmittance; D2R_MARCH_EARLY=0 gives the same bits."""
    packed, origins, d, aabb, st = _march_case(dev, 500, seed=3, miss=0.1)
    st = st._replace(min_transmittance=min_t)
    on = mk.march_rays_fused(packed, origins, d, aabb, st, early_exit=True)
    off = mk.march_rays_fused(packed, origins, d, aabb, st, early_exit=False)
    for k in ("rgb", "alpha", "depth"):
        assert torch.equal(on[k], off[k])


def test_crop_render_waits_on_the_host_nowhere(dev):
    """render_pose_cropped on a clip group, with its box and intrinsics on
    the device and the field packed: nothing waits for the device
    (torch.cuda.set_sync_debug_mode("error") raises on a synchronising call)."""
    from dream2real_tpu_torch.nerf import combined
    from dream2real_tpu_torch.ops import cameras

    cfg = NGPConfig(aabb_min=(0.0, -0.6, -0.5), aabb_max=(1.1, 0.6, 0.9))
    field = init_ngp_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    packed = mk.pack_params(field)
    st = RenderSettings(n_coarse=20, n_fine=0, near=0.05, far=2.0)
    lo, hi = (0.3, -0.2, 0.0), (0.7, 0.2, 0.3)
    res, crop = 112, 48
    K = torch.tensor([[0.9 * res, 0, res / 2], [0, 0.9 * res, res / 2], [0, 0, 1.0]], device=dev)
    dirs_cam = cameras.pixel_dirs(res, res, K.cpu().numpy(), device=dev)
    T_WO = torch.eye(4, device=dev)
    T_WO[:3, 3] = torch.tensor([0.5, 0.0, 0.15], device=dev)
    T_WC = torch.tensor([[1, 0, 0, 0.5], [0, -1, 0, 0.0], [0, 0, -1, 0.7], [0, 0, 0, 1.0]],
                        device=dev)
    poses = T_WO[None].repeat(8, 1, 1)
    poses[:, 0, 3] += torch.linspace(-0.05, 0.05, 8, device=dev)
    bg = combined.BackgroundView(rgb=torch.zeros(res, res, 3, device=dev),
                                 alpha=torch.ones(res, res, device=dev),
                                 depth=torch.full((res, res), 100.0, device=dev))
    bg_u8 = combined.background_only_image(bg)
    aabb = (torch.tensor(lo, device=dev), torch.tensor(hi, device=dev))
    args = (field, st, dirs_cam, K, aabb, crop, T_WO, T_WC, bg, bg_u8, poses)
    want = combined.render_pose_cropped(*args, packed=packed)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = combined.render_pose_cropped(*args, packed=packed)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got, want) and got.shape == (8, res, res, 3)


@pytest.mark.parametrize("B, T", [(2, 77), (32, 577)])
@pytest.mark.parametrize("maxsub", ["0", "1"])
def test_attention_kernels_match_plain(dev, maxsub, B, T, monkeypatch):
    """K2 (LayerNorm, qkv GEMM and attention) and K3 (attention on the
    projection layout) at a ragged shape and at a clip group's (B 32, T
    577, W 1024), and K4 at the text tower's (3 captions, 12 heads, 77
    tokens), in both softmax modes, at atol 0.02 / rtol 0.05 (the
    reference's attention tolerance)."""
    monkeypatch.setenv("D2R_ATTN_MAXSUB", maxsub)
    gen = torch.Generator(device=dev).manual_seed(1)
    W, H = 1024, 16
    x = (torch.randn(B, T, W, generator=gen, device=dev) * 2).to(torch.bfloat16)
    w = (torch.randn(W, 3 * W, generator=gen, device=dev) * W**-0.5).to(torch.bfloat16)
    bq = torch.randn(3 * W, generator=gen, device=dev) * 0.02
    g = torch.ones(W, device=dev)
    b = torch.zeros(W, device=dev)
    out = att.mha_ln_qkv(x, w, bq, g, b, H).float()
    ref = att.mha_ln_qkv_plain(x, w, bq, g, b, H, maxsub == "1").float()
    torch.testing.assert_close(out, ref, atol=0.02, rtol=0.05)
    g, b = 1 + 0.1 * torch.randn(W, generator=gen, device=dev), 0.1 * torch.randn(
        W, generator=gen, device=dev)
    torch.testing.assert_close(att.mha_ln_qkv(x, w, bq, g, b, H).float(),
                               att.mha_ln_qkv_plain(x, w, bq, g, b, H, maxsub == "1").float(),
                               atol=0.02, rtol=0.05)
    qkv = (torch.randn(B, T, 3 * W, generator=gen, device=dev) * 2).to(torch.bfloat16)
    torch.testing.assert_close(att.mha_qkv(qkv, H).float(),
                               att.mha_qkv_plain(qkv, H, maxsub == "1").float(),
                               atol=0.02, rtol=0.05)
    q = [torch.randn(3, 12, 77, 64, generator=gen, device=dev).to(torch.bfloat16)
         for _ in range(3)]
    torch.testing.assert_close(att.mha(*q, causal=True).float(),
                               att.mha_causal_plain(*q).float(), atol=0.02, rtol=0.05)


def test_wrappers_reject_bad_inputs(dev):
    bf = torch.bfloat16
    qkv = torch.zeros(2, 10, 3 * 96, dtype=bf, device=dev)
    with pytest.raises(ValueError):
        att.mha_qkv(qkv, 3)  # heads of 32: the kernel takes 64
    with pytest.raises(ValueError):
        att.mha_qkv(torch.zeros(2, 10, 3 * 64, device=dev), 1)  # f32, not bf16
    with pytest.raises(ValueError):  # a transposed view: not contiguous
        att.mha_qkv(torch.zeros(2, 3 * 64, 10, dtype=bf, device=dev).transpose(1, 2), 1)
    q = torch.zeros(2, 3, 10, 64, dtype=bf, device=dev)
    with pytest.raises(ValueError):
        att.mha(q, q[:, :, :9], q)  # k of another length
    with pytest.raises(ValueError):
        att.mha(q, q.cpu(), q)  # k on another device
    with pytest.raises(ValueError):
        att.mha(q[..., :32].contiguous(), q[..., :32].contiguous(), q[..., :32].contiguous())
    with pytest.raises(ValueError):
        att.head_attention(q.cpu(), q.cpu(), q.cpu(), "clamp")  # the bare launch needs the card
    x = torch.zeros(2, 10, 128, dtype=bf, device=dev)
    w, b3 = torch.zeros(128, 384, dtype=bf, device=dev), torch.zeros(384, device=dev)
    g = torch.ones(128, device=dev)
    with pytest.raises(ValueError):
        att.mha_ln_qkv(x, w, b3, g, g, 4)  # heads of 32
    with pytest.raises(ValueError):
        att.mha_ln_qkv(x, w, b3, g.to(bf), g, 2)  # ln_g in bf16
    with pytest.raises(ValueError):
        att.mha_ln_qkv(x, w.t().contiguous().t(), b3, g, g, 2)  # wqkv not contiguous
    with pytest.raises(ValueError):
        att.ln_qkv(x[..., :96].contiguous(), w[:96].contiguous(), b3, g[:96], g[:96])  # K % 64
    with pytest.raises(ValueError):
        att.proj_residual(x, w, b3, x)  # the residual is not (B, T, N)
    with pytest.raises(ValueError):
        att.proj_residual(x, w.float(), b3, torch.zeros(2, 10, 384, dtype=bf, device=dev))
    with pytest.raises(ValueError):
        att.linear_bias(x, w[:, :320].contiguous(), b3[:320])  # N % 128
    with pytest.raises(ValueError):
        att.linear_bias_gelu(x, w, b3.to(bf))  # the bias in bf16
    with pytest.raises(ValueError):
        att.linear_bias_then_resid(x, w, b3, x)  # the residual is not (B, T, N)
    # The LayerNorm row pass, alone and as a GEMM's prologue.
    with pytest.raises(ValueError):
        att.ln_rows(x.float(), g, g)  # f32 rows
    with pytest.raises(ValueError):
        att.ln_rows(x.transpose(0, 1), g, g)  # not contiguous
    with pytest.raises(ValueError):
        att.ln_rows(x[..., :100].contiguous(), g[:100], g[:100])  # K % 8
    with pytest.raises(ValueError):
        att.ln_rows(x, g.to(bf), g)  # ln_g in bf16
    w4 = torch.zeros(128, 512, dtype=bf, device=dev)
    b4 = torch.zeros(512, device=dev)
    with pytest.raises(ValueError):
        att.ln_fc1(x.float(), w4, b4, g, g)  # f32 rows
    with pytest.raises(ValueError):
        att.ln_fc1(x.transpose(0, 1), w4, b4, g, g)  # not contiguous
    with pytest.raises(ValueError):
        att.ln_fc1(x[..., :96].contiguous(), w4[:96].contiguous(), b4, g[:96], g[:96])  # K % 64
    with pytest.raises(ValueError):
        att.ln_fc1(x, w4[:, :320].contiguous(), b4[:320], g, g)  # N % 128
    with pytest.raises(ValueError):
        att._gemm(x, w, b3, None, "bias_then_resid", "ln_gemm", ln=(g, g))  # no residual


def test_split_and_fused_attention_paths_agree(dev, monkeypatch):
    """D2R_ATTN_FUSED_LN=0 (LayerNorm + qkv matmul + K3) and the default K2
    path give the same image embeddings at ViT-L width (3 blocks, 112^2)."""
    from dream2real_tpu_torch.clip import model as cm

    cfg = cm.CLIPConfig(image_size=112, vision_layers=3)
    clip = cm.init_clip_params(cfg, torch.Generator(device=dev).manual_seed(2), device=dev)
    u8 = torch.randint(0, 256, (4, 112, 112, 3), generator=torch.Generator(device=dev)
                       .manual_seed(3), device=dev, dtype=torch.uint8)
    px = cm.preprocess_images(u8, cfg)
    embs = {}
    for mode in ("1", "0"):
        monkeypatch.setenv("D2R_ATTN_FUSED_LN", mode)
        k2, k3 = att.mha_ln_qkv.launches, att.mha_qkv.launches
        with torch.inference_mode():
            embs[mode] = cm.encode_image(clip, px)
        assert att.mha_ln_qkv.launches - k2 == (2 if mode == "1" else 0)
        assert att.mha_qkv.launches - k3 == 2
    cos = torch.nn.functional.cosine_similarity(embs["1"], embs["0"], dim=-1)
    assert float(cos.min()) > 0.9995


def _train_inputs(dev, R, S, seed=0):
    """A seeded flagship field's packed weights and R rays from several
    cameras toward the box interior, with sorted, irregular ts (R, S)."""
    from dream2real_tpu_torch.nerf import train_kernel as tk

    cfg = NGPConfig(aabb_min=(0.0, -0.6, -0.5), aabb_max=(1.1, 0.6, 0.9))
    field = init_ngp_params(cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    w, b = tk.pack_train_params(field.params())
    rng = np.random.default_rng(seed)
    o = rng.uniform([0.2, -0.3, -1.2], [0.9, 0.3, -0.8], (R, 3))
    d = rng.uniform([0.2, -0.4, -0.2], [0.9, 0.4, 0.6], (R, 3)) - o
    d = d / d[:, 2:3]
    ts = 0.3 + 1.3 * np.sort(rng.uniform(size=(R, S)), axis=1)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev).contiguous()  # noqa: E731
    return field, f32(o), f32(d), f32(ts), tk.field_box(cfg, dev), w, b, rng


def _cos(a, b):
    a, b = a.double().ravel(), b.double().ravel()
    return float(a @ b / (a.norm() * b.norm() + 1e-30))


def test_train_kernels_match_plain(dev):
    """K5-K8 against their plain versions; 300 rays, not a multiple of the
    kernels' tiles."""
    from dream2real_tpu_torch.nerf import train_kernel as tk

    R, S = 300, 16
    _, o, d, ts, box, w, b, rng = _train_inputs(dev, R, S)
    before = (tk.train_fwd.launches, tk.train_bwd.launches, tk.density_weights.launches,
              tk.density_sample.launches)
    C, A, D = tk.train_fwd(o, d, ts, box, w, b, 1e-4)
    for got, ref in zip((C, A, D), tk.train_fwd_plain(o, d, ts, box, w, b, 1e-4)):
        torch.testing.assert_close(got, ref, atol=5e-3, rtol=0)
    assert float(A.max()) > 0.05
    torch.testing.assert_close(tk.density_weights(o, d, ts, box, w, b, 1e-4),
                               tk.density_weights_plain(o, d, ts, box, w, b, 1e-4),
                               atol=5e-3, rtol=0)
    exp_draws = torch.tensor(-np.log(rng.uniform(1e-12, 1.0, (R, 33))), dtype=torch.float32,
                             device=dev)
    got = tk.density_sample(o, d, ts, exp_draws, box, w, b, 32, 1e-4, 0.5)
    ref = tk.density_sample_plain(o, d, ts, exp_draws, box, w, b, 32, 1e-4, 0.5)
    torch.testing.assert_close(got, ref, atol=2e-3, rtol=0)
    assert float((got[:, 1:] - got[:, :-1]).min()) >= -1e-6
    assert bool((got >= ts[:, :1] - 1e-5).all()) and bool((got <= ts[:, -1:] + 1e-5).all())

    cot = [torch.tensor(rng.standard_normal(s), dtype=torch.float32, device=dev)
           for s in ((R, 3), (R,), (R,))]
    cot[2] = cot[2] * 0.1
    # Each backward takes its own forward's outputs, as in training.
    g_k, go_k, gd_k = tk.train_bwd(o, d, ts, box, w, b, 1e-4, *cot, C, A, D, True)
    g_p, go_p, gd_p = tk.train_bwd_plain(o, d, ts, box, w, b, 1e-4, *cot,
                                         *tk.train_fwd_plain(o, d, ts, box, w, b, 1e-4), True)
    for name, gk in tk.unpack_grads(g_k).items():
        gp = tk.unpack_grads(g_p)[name]
        scale = max(float(gp.abs().max()), 1e-6)
        assert _cos(gk, gp) > 0.995, name
        torch.testing.assert_close(gk, gp, atol=8e-2 * scale, rtol=0, msg=name)
    assert _cos(go_k, go_p) > 0.95 and _cos(gd_k, gd_p) > 0.95
    # Deterministic, and the ray-gradient chain leaves the parameter
    # gradients bit for bit as they are.
    g_slim, go_slim, gd_slim = tk.train_bwd(o, d, ts, box, w, b, 1e-4, *cot, C, A, D, False)
    assert torch.equal(g_slim, g_k)
    assert float(go_slim.abs().max()) == 0.0 and float(gd_slim.abs().max()) == 0.0
    assert torch.equal(tk.train_bwd(o, d, ts, box, w, b, 1e-4, *cot, C, A, D, True)[0], g_k)
    after = (tk.train_fwd.launches, tk.train_bwd.launches, tk.density_weights.launches,
             tk.density_sample.launches)
    assert [a - c for a, c in zip(after, before)] == [1, 3, 1, 1]


def _grads_close(g_k, g_p, what):
    """K7's parameter gradients against the plain version's: 8e-2 x scale
    and cosine > 0.995 (the reference's tolerance), per parameter."""
    from dream2real_tpu_torch.nerf import train_kernel as tk

    for name, gk in tk.unpack_grads(g_k).items():
        gp = tk.unpack_grads(g_p)[name]
        scale = float(gp.abs().max())
        if scale < 1e-6:  # no signal in this parameter for these rays
            assert float(gk.abs().max()) < 1e-5, (what, name)
            continue
        assert _cos(gk, gp) > 0.995, (what, name, _cos(gk, gp))
        torch.testing.assert_close(gk, gp, atol=8e-2 * scale, rtol=0, msg=f"{what} {name}")


@pytest.mark.parametrize("S", [1, 2, 33, 64, 65, 128])
@pytest.mark.parametrize("R", [1, 63, 64, 65, 8191, 8192])
def test_train_fwd_bwd_ragged(dev, R, S):
    """K6 and K7 against their plain versions where S does not fill the
    128-row tile and R does not fill the last tile or chunk, and at a
    training batch's 8192 rays; K7's parameter gradients bit-identical from
    call to call and with and without ray gradients."""
    from dream2real_tpu_torch.nerf import train_kernel as tk

    _, o, d, ts, box, w, b, rng = _train_inputs(dev, R, S, seed=R + S)
    C, A, D = tk.train_fwd(o, d, ts, box, w, b, 1e-4)
    ref = tk.train_fwd_plain(o, d, ts, box, w, b, 1e-4)
    for got, want in zip((C, A, D), ref):
        torch.testing.assert_close(got, want, atol=5e-3, rtol=0)
    cot = [torch.tensor(rng.standard_normal(s), dtype=torch.float32, device=dev)
           for s in ((R, 3), (R,), (R,))]
    g_k, go_k, gd_k = tk.train_bwd(o, d, ts, box, w, b, 1e-4, *cot, C, A, D, True)
    g_p, go_p, gd_p = tk.train_bwd_plain(o, d, ts, box, w, b, 1e-4, *cot, *ref, True)
    _grads_close(g_k, g_p, f"R {R} S {S}")
    if R * S >= 64:
        assert _cos(go_k, go_p) > 0.95 and _cos(gd_k, gd_p) > 0.95
    g_slim, go_slim, _ = tk.train_bwd(o, d, ts, box, w, b, 1e-4, *cot, C, A, D, False)
    assert torch.equal(g_slim, g_k) and float(go_slim.abs().max()) == 0.0
    assert torch.equal(tk.train_bwd(o, d, ts, box, w, b, 1e-4, *cot, C, A, D, True)[0], g_k)


@pytest.mark.parametrize("R, S", [(63, 64), (1, 33), (2, 40)])
def test_rays_past_the_end_add_zero(dev, R, S):
    """A ray with zero cotangents in a tile's last free place changes no
    gradient bit: rays past R (the tile's padding) add exactly zero too."""
    from dream2real_tpu_torch.nerf import train_kernel as tk

    _, o, d, ts, box, w, b, rng = _train_inputs(dev, R + 1, S, seed=7)
    geo, geo1 = tk.train_geometry(R, S, 132), tk.train_geometry(R + 1, S, 132)
    assert geo["groups"] == geo1["groups"]
    cot = [torch.tensor(rng.standard_normal(s), dtype=torch.float32, device=dev)
           for s in ((R + 1, 3), (R + 1,), (R + 1,))]
    for c in cot:
        c[R:] = 0.0
    out = tk.train_fwd(o, d, ts, box, w, b, 1e-4)
    g1, go1, _ = tk.train_bwd(o, d, ts, box, w, b, 1e-4, *cot, *out, True)
    g0, go0, _ = tk.train_bwd(o[:R].contiguous(), d[:R].contiguous(), ts[:R].contiguous(), box,
                              w, b, 1e-4, *(c[:R].contiguous() for c in cot),
                              *(x[:R].contiguous() for x in out), True)
    assert torch.equal(g0, g1)
    assert torch.equal(go0, go1[:R]) and float(go1[R:].abs().max()) == 0.0


def _sampler_inputs(dev, R, S, seed):
    """_train_inputs with every seventh ray (from the fourth) turned to miss
    the field's box: its samples all lie outside, so its weights are zero."""
    field, o, d, ts, box, w, b, rng = _train_inputs(dev, R, S, seed=seed)
    o[3::7] = torch.tensor([0.5, 0.0, 5.0], device=dev)
    d[3::7] = torch.tensor([0.0, 0.0, 1.0], device=dev)
    return o, d, ts, box, w, b, rng


def _k8_against_plain(o, d, ts, box, w, b, min_t):
    """K8 and its plain version, and where their transmittance cuts differ:
    a sample that one cuts (weight 0, though the sample has density) and the
    other keeps. Each such sample is shown a tie: the plain version's
    transmittance before it (its own trunk and scan, which do not depend on
    the cut) lies within 1% of min_t, where one rounding of the kernel's
    falls on the other side. -> (kernel, plain, the plain's uncut weights,
    flipped (R, S) bool)."""
    from dream2real_tpu_torch.nerf import train_kernel as tk

    got = tk.density_weights(o, d, ts, box, w, b, min_t)
    ref = tk.density_weights_plain(o, d, ts, box, w, b, min_t)
    uncut_k = tk.density_weights(o, d, ts, box, w, b, 0.0)
    uncut_p = tk.density_weights_plain(o, d, ts, box, w, b, 0.0)
    flips = ((got == 0.0) & (uncut_k != 0.0)) != ((ref == 0.0) & (uncut_p != 0.0))
    mats, biases = tk._unpack(w, b)
    geo = tk._Geom(o, d, box)
    dl = tk._deltas(ts)
    trans = torch.ones(ts.shape[0], dtype=torch.float32, device=ts.device)
    before = []
    for s in range(ts.shape[1]):
        enc, _, inside = geo.sample(ts[:, s])
        a = 1.0 - torch.exp(-tk._sigma(tk._trunk(enc, mats, biases)[4], inside) * dl[:, s] * geo.dn)
        before.append(trans)
        trans = trans * (1.0 - a + 1e-10)
    tie = (torch.stack(before, dim=1) - min_t).abs() <= 1e-2 * min_t
    assert bool(tie[flips].all()), "a cut that differs away from a tie"
    return got, ref, uncut_p, flips


@pytest.mark.parametrize("min_t", [1e-4, 0.5])
@pytest.mark.parametrize("S", [2, 17, 32, 48, 64, 160])
@pytest.mark.parametrize("R", [1, 300, 8192])
def test_density_weights_matches_plain_and_k6(dev, R, S, min_t):
    """K8 against its plain version (5e-3), with rays that miss the box, a
    transmittance cut that is reached (min_t 0.5) and S = 160 (two steps a
    ray); where the two cut differently (a shown tie, _k8_against_plain:
    under 0.5% of the samples) the kernel's weight is the plain version's
    uncut one. Bit-identical from call to call, one launch a call; and K6's
    alpha on the same inputs is the in-order f32 sum of K8's weights, bit
    for bit (the same trunk and scan on the same tiles)."""
    from dream2real_tpu_torch.nerf import train_kernel as tk

    o, d, ts, box, w, b, _ = _sampler_inputs(dev, R, S, seed=R + S)
    before = tk.density_weights.launches
    got, ref, uncut, flips = _k8_against_plain(o, d, ts, box, w, b, min_t)
    assert not bool((((got - ref).abs() > 5e-3) & ~flips).any()), float((got - ref).abs().max())
    assert not bool((((got - uncut).abs() > 5e-3) & flips & (got != 0.0)).any())
    assert int(flips.sum()) <= max(1.0, 5e-3 * flips.numel())
    assert torch.equal(tk.density_weights(o, d, ts, box, w, b, min_t), got)
    assert tk.density_weights.launches - before == 3
    if R > 3:
        assert float(got[3::7].abs().max()) == 0.0
    if min_t == 0.5 and R > 1 and S > 2:
        # The cut is reached before a ray's last sample: the weights before
        # it sum past 0.5 on some ray, whose later weights are then zero.
        assert float(ref[:, :-1].sum(dim=1).max()) > 0.5
    alpha = torch.zeros(R, dtype=torch.float32, device=dev)
    for s in range(S):
        alpha = alpha + got[:, s]
    assert torch.equal(tk.train_fwd(o, d, ts, box, w, b, min_t)[1], alpha)


@pytest.mark.parametrize("mix, min_t", [(0.25, 1e-4), (0.5, 1e-4), (0.5, 0.5)])
@pytest.mark.parametrize("S", [2, 17, 32, 48, 64])
@pytest.mark.parametrize("R", [1, 300, 8192])
def test_density_sample_matches_plain(dev, R, S, mix, min_t):
    """K5 against its plain version within 1e-2 of t (K8's 5e-3 on the
    coarse weights, carried through their CDF into a draw's position; the
    CPU tests hold the plain version to the Pallas kernel at 2e-3) on every
    ray whose coarse weights K8 and the plain version cut alike (the others,
    shown ties of the transmittance cut, under 2% of the rays), its draws
    sorted and inside the coarse range on every ray, with rays that miss the
    box and a cut that is reached; bit-identical from call to call, one
    launch a call. 64 draws a ray: at S = 32 a tile's 4 rays hold one draw a
    thread."""
    from dream2real_tpu_torch.nerf import train_kernel as tk

    o, d, ts, box, w, b, rng = _sampler_inputs(dev, R, S, seed=R + S + 1)
    n_draw = 64
    exps = torch.tensor(-np.log(rng.uniform(1e-12, 1.0, (R, n_draw + 1))), dtype=torch.float32,
                        device=dev)
    args = (o, d, ts, exps, box, w, b, n_draw, min_t, mix)
    before = tk.density_sample.launches
    got = tk.density_sample(*args)
    tied = _k8_against_plain(o, d, ts, box, w, b, min_t)[3].any(dim=1)
    assert int(tied.sum()) <= max(1.0, 2e-2 * R)
    torch.testing.assert_close(got[~tied], tk.density_sample_plain(*args)[~tied], atol=1e-2,
                               rtol=0)
    assert torch.equal(tk.density_sample(*args), got)
    assert tk.density_sample.launches - before == 2
    assert float((got[:, 1:] - got[:, :-1]).min()) >= -1e-6
    assert bool((got >= ts[:, :1] - 1e-5).all()) and bool((got <= ts[:, -1:] + 1e-5).all())


@pytest.mark.parametrize("R, S, n_draw", [(300, 2, 300), (65, 4, 2100), (3, 64, 5000)])
def test_density_sample_draws_in_windows(dev, R, S, n_draw):
    """K5 with more Exp(1) numbers a tile than its shared-memory window
    holds (64 rays x 301, 32 x 2101, 2 x 5001 against 8192): the draws are
    taken window by window, still against the plain version at 1e-2, sorted
    and inside the coarse range."""
    from dream2real_tpu_torch.nerf import train_kernel as tk

    o, d, ts, box, w, b, rng = _sampler_inputs(dev, R, S, seed=R + S + n_draw)
    exps = torch.tensor(-np.log(rng.uniform(1e-12, 1.0, (R, n_draw + 1))), dtype=torch.float32,
                        device=dev)
    args = (o, d, ts, exps, box, w, b, n_draw, 1e-4, 0.5)
    got = tk.density_sample(*args)
    torch.testing.assert_close(got, tk.density_sample_plain(*args), atol=1e-2, rtol=0)
    assert float((got[:, 1:] - got[:, :-1]).min()) >= -1e-6
    assert bool((got >= ts[:, :1] - 1e-5).all()) and bool((got <= ts[:, -1:] + 1e-5).all())


def test_render_rays_train_on_the_card(dev, monkeypatch):
    """The training renderer's autograd path launches K5, K6, K7 once each
    (K8 with D2R_FUSED_SAMPLER=0); miss rays give zeros."""
    from dream2real_tpu_torch.nerf import train_kernel as tk
    from dream2real_tpu_torch.nerf.render import RenderSettings

    field, o, d, _, _, _, _, _ = _train_inputs(dev, 256, 8, seed=1)
    o[:64] = torch.tensor([0.5, 0.0, 5.0], device=dev)
    d[:64] = torch.tensor([0.0, 0.0, 1.0], device=dev)
    st = RenderSettings(n_coarse=16, n_fine=16, near=0.05, far=2.0)
    for sampler, counts in (("1", (1, 1, 1, 0)), ("0", (0, 1, 1, 1))):
        monkeypatch.setenv("D2R_FUSED_SAMPLER", sampler)
        fns = (tk.density_sample, tk.train_fwd, tk.train_bwd, tk.density_weights)
        before = [f.launches for f in fns]
        gen = torch.Generator(device=dev).manual_seed(3)
        out = tk.render_rays_train(field, o, d, st, gen, need_ray_grads=False)
        (out["rgb"].sum() + out["alpha"].sum()).backward()
        assert tuple(f.launches - n for f, n in zip(fns, before)) == counts
        assert float(out["alpha"][:64].detach().abs().max()) == 0.0
        assert all(torch.isfinite(p.grad).all() for p in field.parameters())
        field.zero_grad()


def _close(got, ref, what):
    torch.testing.assert_close(got.float(), ref.float(), atol=0.02, rtol=0.05, msg=what)


@pytest.mark.parametrize("B, H, T", [(2, 3, 77), (2, 3, 128), (32, 16, 577)])
def test_bidirectional_and_bench_attention_match_plain(dev, B, H, T):
    """K9 and the attention bench's X1 variants and probes against their
    plain versions; T = 77 pads to 80 (three unmasked zero keys), 128 pads
    nothing, 577 (the scoring shape, B 32, H 16) pads to 584."""
    from dream2real_tpu_torch.experiments import bench_attention as ba

    gen = torch.Generator(device=dev).manual_seed(4)
    q, k, v = (torch.randn(B, H, T, 64, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    before = att.mha.launches
    _close(att.mha(q, k, v), att.mha_plain(q, k, v), "K9")
    assert att.mha.launches == before + 1
    for fn, nomax in ((ba.mha_v1_unrolled, False), (ba.mha_v3_pipelined, False),
                      (ba.mha_v2_nomax, True)):
        n = fn.launches
        _close(fn(q, k, v), ba.mha_x1_plain(q, k, v, nomax=nomax), fn.__name__)
        assert fn.launches == n + 1
    same = torch.equal(ba.mha_v1_unrolled(q, k, v), att.mha(q, k, v))
    assert same == (T % 8 == 0)  # the padded zero keys change X1's result
    for name in ba.PROBES:
        n = ba.probe.launches[name]
        got, ref = ba.probe(name)(q, k, v).float(), ba.probe_plain(name, q, k, v).float()
        assert ba.probe.launches[name] == n + 1
        if name == "matmul_only":  # unnormalised sums: relative to the largest output
            assert float((got - ref).abs().max()) <= 2e-2 * float(ref.abs().max())
        else:
            _close(got, ref, name)


@pytest.mark.parametrize("B, T", [(2, 77), (32, 577)])
def test_bench_projection_and_fused_blocks_match_plain(dev, B, T):
    """X2 (v8-v11), X4 (v12) and X3 (v13, with the hand-written out-projection
    GEMM) against their plain versions at ViT-L width, T = 77 and the
    scoring shape (B 32, T 577)."""
    from dream2real_tpu_torch.experiments import bench_attention as ba

    gen = torch.Generator(device=dev).manual_seed(5)
    W, H = 1024, 16
    qkv = (torch.randn(B, T, 3 * W, generator=gen, device=dev) * 2).to(torch.bfloat16)
    for kern, maxsub in ba.V8_KERNELS.items():
        n, n3 = ba.mha_v8_projlayout.launches[kern], att.mha_qkv.launches
        _close(ba.mha_v8_projlayout(qkv, H, kern), att.mha_qkv_plain(qkv, H, maxsub), kern)
        assert ba.mha_v8_projlayout.launches[kern] == n + 1 and att.mha_qkv.launches == n3 + 1
    x = (torch.randn(B, T, W, generator=gen, device=dev) * 2).to(torch.bfloat16)
    w = (torch.randn(W, 3 * W, generator=gen, device=dev) * W**-0.5).to(torch.bfloat16)
    wo = (torch.randn(W, W, generator=gen, device=dev) * W**-0.5).to(torch.bfloat16)
    bq = torch.randn(3 * W, generator=gen, device=dev) * 0.02
    bo = torch.randn(W, generator=gen, device=dev) * 0.02
    g = 1 + 0.1 * torch.randn(W, generator=gen, device=dev)
    b = 0.1 * torch.randn(W, generator=gen, device=dev)
    n12, n13, ng = ba.block_fused.launches, ba.block_fused_o.launches, att.proj_residual.launches
    _close(ba.block_fused(x, w, bq, g, b, H), att.mha_ln_qkv_plain(x, w, bq, g, b, H, False),
           "v12")
    got = ba.block_fused_o(x, w, bq, g, b, wo, bo, H).float()
    ref = ba.block_fused_o_plain(x, w, bq, g, b, wo, bo, H).float()
    assert float((got - ref).abs().max()) <= 2e-2 * float(ref.abs().max())  # the bench's maxrel
    assert (ba.block_fused.launches, ba.block_fused_o.launches, att.proj_residual.launches) == (
        n12 + 1, n13 + 1, ng + 1)
    # The GEMM alone on a ragged M (B * T = 154 or 18,464 rows, not a
    # multiple of 128).
    a = att.mha_ln_qkv(x, w, bq, g, b, H, maxsub=False)
    # Element by element within one bf16 step of the plain result; with a
    # zero residual the product is all of the result.
    for resid, atol in ((x, 2e-3), (torch.zeros_like(x), 5e-4)):
        got = att.proj_residual(a, wo, bo, resid).float()
        ref = att.proj_residual_plain(a, wo, bo, resid).float()
        assert float(((got - ref).abs() - 2**-7 * ref.abs()).max()) <= atol
    with pytest.raises(ValueError):
        att.proj_residual(a, wo[:, :100].contiguous(), bo[:100], x)  # N not a multiple of 128


def _as_projection(q, k, v):
    """Head-split (B, H, T, D) q, k, v -> the projection layout (B, T, 3HD)."""
    B, H, T, D = q.shape
    return torch.cat([t.permute(0, 2, 1, 3).reshape(B, T, H * D) for t in (q, k, v)],
                     dim=-1).contiguous()


@pytest.mark.parametrize("T", [1, 63, 64, 65, 127, 128, 129, 577, 584])
def test_attention_kernel_ragged_lengths(dev, T):
    """The wgmma attention kernel in modes clamp, maxsub, nomax and the three
    probes, in the projection and the head-split layout, at lengths around
    its 64-row warpgroups and 128-key tiles (B 2, H 16)."""
    from dream2real_tpu_torch.experiments import bench_attention as ba

    B, H, D = 2, 16, 64
    gen = torch.Generator(device=dev).manual_seed(10 + T)
    q, k, v = (torch.randn(B, H, T, D, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    qkv = _as_projection(q, k, v)
    _close(att.mha(q, k, v), att.mha_plain(q, k, v), "maxsub, head-split")
    _close(ba.mha_v2_nomax(q, k, v), ba.mha_x1_plain(q, k, v, nomax=True), "nomax, head-split")
    for maxsub in (False, True):
        ref = att.mha_qkv_plain(qkv, H, maxsub)
        _close(att.mha_qkv(qkv, H, maxsub), ref, f"projection, maxsub={maxsub}")
        mode = "maxsub" if maxsub else "clamp"
        got = att.head_attention(q, k, v, mode).permute(0, 2, 1, 3).reshape(B, T, H * D)
        _close(got, ref, f"{mode}, head-split")
    if T + (-T % 8) >= D:  # the fabricated probes give p[:, :64]
        for name in ba.PROBES:
            got, ref = ba.probe(name)(q, k, v).float(), ba.probe_plain(name, q, k, v).float()
            if name == "matmul_only":
                assert float((got - ref).abs().max()) <= 2e-2 * float(ref.abs().max())
            else:
                _close(got, ref, name)


@pytest.mark.parametrize("T", [1, 63, 64, 65, 127, 128, 129, 577, 584])
@pytest.mark.parametrize("mode", ["clamp", "maxsub", "nomax", "exact"])
def test_keys_past_T_weigh_exactly_zero(dev, T, mode):
    """Rows past T in a longer buffer (keys of 100, values of 1e4) leave no
    trace: the launch over the padded buffers' strides equals the launch on
    the unpadded tensors bit for bit."""
    from dream2real_tpu_torch import build

    B, H, D, extra = 2, 16, 64, 9
    gen = torch.Generator(device=dev).manual_seed(20 + T)
    q, k, v = (torch.randn(B, H, T, D, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    bufs = []
    for t, fill in ((q, 1.0), (k, 100.0), (v, 1e4)):
        buf = torch.full((B, H, T + extra, D), fill, dtype=torch.bfloat16, device=dev)
        buf[:, :, :T] = t
        bufs.append(buf)
    out = torch.empty_like(q)
    att._attention_launch(*(build.ptr(t) for t in bufs), out, B, H, T,
                          (H * (T + extra) * D, (T + extra) * D, D), (H * T * D, T * D, D),
                          D**-0.5, False, att.MODES[mode], dev)
    assert torch.equal(out, att.head_attention(q, k, v, mode))
    assert float(out.float().abs().max()) < 10.0


@pytest.mark.parametrize("M", [1, 32, 127, 128, 129, 4225, 18464])
def test_gemm_ragged_rows(dev, M):
    """The TMA + wgmma GEMM with the LN pass (K2's qkv projection) and with
    the bias + residual epilogue (X3's out-projection), with and without a
    residual, at ragged rows, the class token's 32, 4,225 (34 row tiles:
    272 tiles of 128 x 128 at N 1024, two waves on 132 SMs and a few more)
    and the scoring shape's 18,464 (145 row tiles, several a block at both
    widths), element by element within one bf16 step of the plain version
    (2^-7 |plain|) plus a slack: 5e-4 where the product is all of the result,
    2e-3 with a residual and behind the LN pass (whose row sums run in
    another order than torch's and move a bf16 rounding of an LN output now
    and then; all but 1 in 100,000 elements stay within 5e-4). The tower's
    three epilogues on the same rows (W x W), by the tolerance model of
    test_epilogue_gemms_match_plain."""
    W = 1024
    gen = torch.Generator(device=dev).manual_seed(30 + M % 97)
    x = (torch.randn(1, M, W, generator=gen, device=dev) * 2).to(torch.bfloat16)
    wqkv = (torch.randn(W, 3 * W, generator=gen, device=dev) * W**-0.5).to(torch.bfloat16)
    wo = (torch.randn(W, W, generator=gen, device=dev) * W**-0.5).to(torch.bfloat16)
    bq = torch.randn(3 * W, generator=gen, device=dev) * 0.02
    bo = torch.randn(W, generator=gen, device=dev) * 0.02
    g = 1 + 0.1 * torch.randn(W, generator=gen, device=dev)
    b = 0.1 * torch.randn(W, generator=gen, device=dev)

    def excess(got, ref):
        got, ref = got.float(), ref.float()
        return (got - ref).abs() - 2**-7 * ref.abs()

    n = att.ln_qkv.launches
    over = excess(att.ln_qkv(x, wqkv, bq, g, b), att.ln_qkv_plain(x, wqkv, bq, g, b))
    assert att.ln_qkv.launches == n + 1
    assert float(over.max()) <= 2e-3 and float((over > 5e-4).float().mean()) <= 1e-5
    for resid, atol in ((x, 2e-3), (torch.zeros_like(x), 5e-4)):
        over = excess(att.proj_residual(x, wo, bo, resid),
                      att.proj_residual_plain(x, wo, bo, resid))
        assert float(over.max()) <= atol
    layer = att.linear_bias_plain(x, wo, bo)
    slack = 2.0**-20 * (x.float().abs() @ wo.float().abs())
    for name, args, after in (
        ("linear_bias", (x, wo, bo), lambda c: c),
        ("linear_bias_gelu", (x, wo, bo),
         lambda c: c * torch.sigmoid(1.702 * c.float()).to(torch.bfloat16)),
        ("linear_bias_then_resid", (x, wo, bo, x), lambda c: x + c),
    ):
        got = getattr(att, name)(*args)
        assert float(after_excess(got, layer, after, slack).max()) <= 0.0, name


def after_excess(got: torch.Tensor, h: torch.Tensor, after, slack: torch.Tensor) -> torch.Tensor:
    """How far an epilogue's output `got` lies beyond one bf16 step (and
    `slack`) of after(c), c the plain layer output h (bf16) or one of its
    bf16 neighbours, whichever is nearest; <= 0 where held. `after` is what
    the epilogue does past the layer's rounding (QuickGELU, the residual
    add), which can turn one step of h into several of its own."""
    bits = h.view(torch.int16)
    best = None
    for c in (h, (bits + 1).view(torch.bfloat16),
              torch.where(h == 0, h, (bits - 1).view(torch.bfloat16))):
        g = after(c).float()
        e = (got.float() - g).abs() - 2**-7 * g.abs() - slack
        best = e if best is None else torch.minimum(best, e)
    return best


# The towers' widths: (K, N) of qkv, proj, fc1 and fc2 in the vision (W 1024)
# and text (W 768) towers.
TOWER_SHAPES = [(1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024), (768, 2304),
                (768, 768), (768, 3072), (3072, 768)]


@pytest.mark.parametrize("M", [1, 77, 128, 129, 342, 1409, 18464])
@pytest.mark.parametrize("K,N", TOWER_SHAPES)
def test_epilogue_gemms_match_plain(dev, K, N, M):
    """The tower's three GEMM epilogues at both towers' widths, on 3 x M
    rows (ragged; 1,026 and 4,227, whose 9 and 34 row tiles give N 4096 and
    N 1024 two waves of tiles and a few more on 132 SMs; three clip groups'
    18,464 each), each width's tile (256 or 128 columns) as the launcher
    picks it, element by element within one bf16 step of the plain version
    (2^-7 |plain|) plus 2^-20 of the element's sum of |products|: the
    tensor cores and cuBLAS's f32 GEMM each round the f32 sum in their own
    order, about 2^-23 of that sum apart (measured on the H100), which moves
    results near zero by more than their own bf16 step. Where the layer's
    bf16 output goes on through QuickGELU (fc1) or a residual add (fc2,
    proj), the result is held as that applied to the plain layer output or
    to one of its two bf16 neighbours (where the two sums round it the other
    way), within one step: the sigmoid and a nearly cancelling residual turn
    one step of the layer into several of the result."""
    gen = torch.Generator(device=dev).manual_seed(K + N + M)
    x = (torch.randn(3, M, K, generator=gen, device=dev)).to(torch.bfloat16)
    w = (torch.randn(K, N, generator=gen, device=dev) * K**-0.5).to(torch.bfloat16)
    b = torch.randn(N, generator=gen, device=dev) * 0.1
    r = (torch.randn(3, M, N, generator=gen, device=dev)).to(torch.bfloat16)
    layer = att.linear_bias_plain(x, w, b)
    slack = 2.0**-20 * (x.float().abs() @ w.float().abs())
    for name, args, after in (
        ("linear_bias", (x, w, b), lambda c: c),
        ("linear_bias_gelu", (x, w, b),
         lambda c: c * torch.sigmoid(1.702 * c.float()).to(torch.bfloat16)),
        ("linear_bias_then_resid", (x, w, b, r), lambda c: r + c),
    ):
        fn = getattr(att, name)
        n = fn.launches
        got = fn(*args)
        assert fn.launches == n + 1 and got.shape == (3, M, N)
        assert torch.equal(getattr(att, name + "_plain")(*args), after(layer))
        assert float(after_excess(got, layer, after, slack).max()) <= 0.0, name


@pytest.mark.parametrize("epilogue", list(att.EPILOGUES))
def test_gemm_repeats_bit_for_bit(dev, epilogue):
    """Each epilogue at 18,464 x 1,024 -> 4,096 (fc1's shape: 2,320 tiles,
    18 a block) gives the same bits call after call: no tile's sum depends
    on which block or when it ran. Widths off the K % 64 or N % 128 grid are
    refused."""
    gen = torch.Generator(device=dev).manual_seed(41)
    M, K, N = 18464, 1024, 4096
    x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn(K, N, generator=gen, device=dev) * K**-0.5).to(torch.bfloat16)
    b = torch.randn(N, generator=gen, device=dev) * 0.1
    r = torch.randn(M, N, generator=gen, device=dev).to(torch.bfloat16)
    resid = r if epilogue.endswith("resid") else None
    first = att._gemm(x, w, b, resid, epilogue, "repeat")
    for _ in range(3):
        assert torch.equal(att._gemm(x, w, b, resid, epilogue, "repeat"), first), epilogue
    for k_, n_ in ((K - 32, N), (K, N - 64)):
        with pytest.raises(ValueError):
            att._gemm(x[:, :k_].contiguous(), w[:k_, :n_].contiguous(), b[:n_], None, "bias",
                      "off-grid")


def test_quick_gelu_on_every_bf16_value(dev):
    """bias_gelu on W = 0 with the bias running through every bf16 value h,
    side by side and each alone among seven zeros: the kernel's QuickGELU (a
    reciprocal from the special-function unit, held to the IEEE division's
    bf16 rounding) is the plain version's h * bf16(sigmoid(1.702 h)) bit for
    bit, in the consumers' and the epilogue warps' halves of 256-wide tiles
    and in 128-wide tiles (the first 1,024 columns alone)."""
    h = torch.arange(-32768, 32768, dtype=torch.int32, device=dev).to(torch.int16)
    h = h.view(torch.bfloat16).float()
    alone = torch.zeros(8 * h.numel(), device=dev)
    alone[::8] = h
    x = torch.zeros(1, 64, dtype=torch.bfloat16, device=dev)
    for b in (h, alone, h[:1024].contiguous()):
        w = torch.zeros(64, b.numel(), dtype=torch.bfloat16, device=dev)
        got, want = att.linear_bias_gelu(x, w, b), att.linear_bias_gelu_plain(x, w, b)
        same = (got.view(torch.int16) == want.view(torch.int16)) | (got.isnan() & want.isnan())
        assert bool(same.all()), (b.numel(), int((~same).sum()))


def _ln_excess(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """How far the row pass's output lies beyond one bf16 step of the plain
    LayerNorm's (2^-7 |plain|) plus 2^-16; <= 0 where held. Its row sums run
    in another order than torch's, which moves a bf16 rounding now and then,
    and an output that nearly cancels to zero by more than its own step."""
    got, ref = got.float(), ref.float()
    return (got - ref).abs() - 2**-7 * ref.abs() - 2.0**-16


@pytest.mark.parametrize("M", [1, 77, 129, 18464])
@pytest.mark.parametrize("K", [64, 768, 1024, 4096])
def test_ln_rows_match_layer_norm(dev, K, M):
    """The row pass alone (ln_pre, ln_post, ln_final) against layer_norm
    within one bf16 step, on rows with a mean far from zero too."""
    gen = torch.Generator(device=dev).manual_seed(K + M)
    x = (torch.randn(M, K, generator=gen, device=dev) * 2 + 3).to(torch.bfloat16)
    g = 1 + 0.1 * torch.randn(K, generator=gen, device=dev)
    b = 0.1 * torch.randn(K, generator=gen, device=dev)
    n = att.ln_rows.launches
    got = att.ln_rows(x, g, b)
    assert att.ln_rows.launches == n + 1 and got.shape == x.shape
    assert float(_ln_excess(got, att.layer_norm(x, g, b)).max()) <= 0.0


@pytest.mark.parametrize("M", [1, 77, 129, 18464])
@pytest.mark.parametrize("K,N", TOWER_SHAPES)
def test_ln_gemm_matches_plain(dev, K, N, M):
    """The row pass as a GEMM's prologue under the tower's three epilogues
    (ln_qkv and ln_fc1 for bias and bias_gelu, the entry itself for
    bias_then_resid): bit for bit the GEMM on the row pass's own rows, and
    against linear_bias_*_plain(layer_norm(x)) by the tolerance model of
    test_epilogue_gemms_match_plain, its slack widened by twice what the
    rows' own differences from layer_norm's can move each sum (|xn - plain
    xn| @ |w|; twice, as QuickGELU's slope reaches 1.1)."""
    gen = torch.Generator(device=dev).manual_seed(K + N + M + 1)
    x = (torch.randn(3, M, K, generator=gen, device=dev) * 2).to(torch.bfloat16)
    w = (torch.randn(K, N, generator=gen, device=dev) * K**-0.5).to(torch.bfloat16)
    b = torch.randn(N, generator=gen, device=dev) * 0.1
    r = (torch.randn(3, M, N, generator=gen, device=dev)).to(torch.bfloat16)
    g = 1 + 0.1 * torch.randn(K, generator=gen, device=dev)
    beta = 0.1 * torch.randn(K, generator=gen, device=dev)
    xn, xn_plain = att.ln_rows(x, g, beta), att.layer_norm(x, g, beta)
    assert float(_ln_excess(xn, xn_plain).max()) <= 0.0
    layer = att.linear_bias_plain(xn_plain, w, b)
    wa = w.float().abs()
    slack = (2.0**-20 * (xn_plain.float().abs() @ wa)
             + 2 * (xn.float() - xn_plain.float()).abs() @ wa)
    for name, got, gemm, after in (
        ("ln_qkv", lambda: att.ln_qkv(x, w, b, g, beta), lambda: att.linear_bias(xn, w, b),
         lambda c: c),
        ("ln_fc1", lambda: att.ln_fc1(x, w, b, g, beta), lambda: att.linear_bias_gelu(xn, w, b),
         lambda c: c * torch.sigmoid(1.702 * c.float()).to(torch.bfloat16)),
        (None, lambda: att._gemm(x, w, b, r, "bias_then_resid", "ln_gemm", ln=(g, beta)),
         lambda: att.linear_bias_then_resid(xn, w, b, r), lambda c: r + c),
    ):
        n = getattr(att, name).launches if name else 0
        out = got()
        if name:
            assert getattr(att, name).launches == n + 1
        assert out.shape == (3, M, N) and torch.equal(out, gemm()), name
        assert float(after_excess(out, layer, after, slack).max()) <= 0.0, name


@pytest.mark.parametrize("causal,fused", [(False, "0"), (False, "1"), (True, "0")])
def test_tower_block_rounds_once_as_the_reference(dev, causal, fused, monkeypatch):
    """The double-rounding witness (witness_block) through a tower block on
    the card: bit for bit what the plain path gives on the CPU (where
    tests/test_torch_gemm.py holds it against the JAX package), one rounding
    at each biased layer. A layer that rounds its product to bf16 before
    adding the bias gives 1.25 and 1 where these give 1.2578125 and
    1 + 2^-7."""
    from dream2real_tpu_torch.clip import model as cm

    monkeypatch.setenv("D2R_ATTN_FUSED_LN", fused)
    p, x = witness_block(), witness_input()
    with torch.inference_mode():
        want = cm._block(torch.as_tensor(x).to(torch.bfloat16), port_block(p, "cpu"), 2,
                         causal=causal)
        got = cm._block(torch.as_tensor(x, device=dev).to(torch.bfloat16), port_block(p, dev),
                        2, causal=causal).cpu()
    assert float(want[0, 0, 3]) == 1.2578125 and float(want[0, 0, 5]) == 1 + 2**-7
    assert torch.equal(got, want), (got[0, 0, :6], want[0, 0, :6])


def test_last_block_rounds_once_as_the_reference(dev):
    """The double-rounding witness through the last vision block's path in
    encode_image (the class token's attention, out-projection and MLP, its
    LN1 and LN2 on the row pass) on the card: bit for bit the CPU's plain
    path, one rounding at each biased layer."""
    from dream2real_tpu_torch.clip import model as cm

    p, x = witness_block(), witness_input()

    def last_block(device):
        blk = port_block(p, device)
        x_ = torch.as_tensor(x, device=device).to(torch.bfloat16)
        cls = att.linear_bias_then_resid(cm._attn_cls(x_, blk, 2), blk.proj.w, blk.proj.b,
                                         x_[:, :1].contiguous())
        return cm._mlp_block(cls, blk).cpu()

    with torch.inference_mode():
        want, got = last_block("cpu"), last_block(dev)
    assert float(want[0, 0, 3]) == 1.2578125 and float(want[0, 0, 5]) == 1 + 2**-7
    assert torch.equal(got, want), (got[0, 0, :6], want[0, 0, :6])


def test_a_traced_image_tower_runs_every_layer_norm_on_the_row_pass(dev):
    """encode_image of 2 images at ViT-L/14@336 under a profiler counts 50
    LayerNorms on the row pass (ln_pre; LN1, through K2, and LN2 of blocks
    0-22; the last block's LN1 and LN2; ln_post) and none plain, and
    launches the wrappers that many times."""
    from torch.profiler import ProfilerActivity, profile

    from dream2real_tpu_torch.clip import model as cm
    from dream2real_tpu_torch.utils import profiling

    cfg = cm.CLIPConfig()
    clip = cm.init_clip_params(cfg, torch.Generator(device=dev).manual_seed(4), device=dev)
    px = torch.randn(2, 336, 336, 3, generator=torch.Generator(device=dev).manual_seed(5),
                     device=dev)
    wrappers = (att.ln_rows, att.ln_qkv, att.ln_fc1, att.linear_bias, att.linear_bias_gelu)
    before = [fn.launches for fn in wrappers]
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU]):
        profiling.reset()
        emb = cm.encode_image(clip, px)
        counted = profiling.counters()
    assert emb.shape == (2, cfg.projection_dim) and bool(torch.isfinite(emb).all())
    assert counted.get("clip.ln_rows") == 50 and "clip.ln_plain" not in counted
    assert [fn.launches - n for fn, n in zip(wrappers, before)] == [2, 24, 24, 0, 0]


@pytest.mark.parametrize("T", [1, 16, 77, 128, 129, 300])
def test_causal_attention_lengths(dev, T):
    """K4 (one launch; one tile of keys in registers for T <= 128, three
    passes past it) against its plain version at atol 0.02 / rtol 0.05."""
    gen = torch.Generator(device=dev).manual_seed(T)
    q, k, v = (torch.randn(3, 12, T, 64, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    n = att.mha.launches
    got = att.mha(q, k, v, causal=True).float()
    assert att.mha.launches == n + 1
    torch.testing.assert_close(got, att.mha_causal_plain(q, k, v).float(), atol=0.02, rtol=0.05)


def test_fused_score_on_the_card_saves_what_it_scores(dev, tmp_path, monkeypatch):
    """_fused_score on the card: the side-stream copies and the writer
    threads give the same scores and files as a run that saves nothing, for
    one slab and for several under a zero pending cap."""
    from dream2real_tpu_torch import scoring
    from dream2real_tpu_torch.clip import model as cm
    from dream2real_tpu_torch.clip.scorer import ClipScorer
    from dream2real_tpu_torch.clip.tokenizer import hash_tokenize
    from dream2real_tpu_torch.nerf.combined import CombinedRenderer
    from dream2real_tpu_torch.utils.png import read_png

    cfg = NGPConfig(aabb_min=(0.0, -0.6, -0.1), aabb_max=(1.1, 0.6, 0.9))
    field = init_ngp_params(cfg, torch.Generator(device=dev).manual_seed(6), device=dev)
    res = 112
    K = np.array([[0.9 * res, 0, res / 2], [0, 0.9 * res, res / 2], [0, 0, 1.0]])
    st = RenderSettings(n_coarse=8, n_fine=8, near=0.05, far=2.0)
    r = CombinedRenderer(field, field, settings=st, res=res, intrinsics=K, row_chunk=56,
                         obj_aabb=((0.35, -0.1, 0.0), (0.65, 0.1, 0.15)), fg_crop=48)
    ccfg = cm.CLIPConfig(image_size=res, vision_layers=2, text_layers=1)
    clip = cm.init_clip_params(ccfg, torch.Generator(device=dev).manual_seed(7), device=dev)
    scorer = ClipScorer(clip, batch_size=4)
    T_WO = np.eye(4, dtype=np.float32)
    T_WO[:3, 3] = [0.5, 0.0, 0.05]
    cam = np.array([[1, 0, 0, 0.5], [0, -1, 0, 0.0], [0, 0, -1, 0.7], [0, 0, 0, 1]], np.float32)
    poses = np.tile(T_WO[None], (10, 1, 1))
    poses[:, 0, 3] += np.linspace(-0.08, 0.12, 10)

    class TM:
        goal_caption, norm_captions = "a red box", None

    def run(**kw):
        return scoring._fused_score(r, scorer, hash_tokenize, TM, poses, cam[None], None, None,
                                    T_WO, False, **kw)

    plain = run()
    r.out_render_path = str(tmp_path / "one")
    np.testing.assert_array_equal(run(save_renders=True), plain)
    monkeypatch.setenv("D2R_SCORE_SLAB", "4")
    monkeypatch.setenv("D2R_RENDER_PENDING_MB", "0")
    r.out_render_path = str(tmp_path / "slabs")
    np.testing.assert_array_equal(run(save_renders=True), plain)
    assert scoring.LAST_RUN_INFO["n_slabs"] == 3
    renders = r.render(poses, cam[None], [0], T_WO_1=T_WO)
    for d in ("one", "slabs"):
        for i in (0, 9):
            np.testing.assert_array_equal(
                read_png(str(tmp_path / d / f"cb_rgb_{i:04d}.png")), renders[i])


# ------------------------------------------------------------------ H2


#: The encoding's two layouts of 32 features that H2 covers: the paper's
#: 16 levels of 2, and 8 of 4.
H2_LAYOUTS = pytest.mark.parametrize("layout", [(16, 2), (8, 4)], ids=["16x2", "8x4"])


def _hash_case(dev, n_rays, seed=0, miss=1 / 3, layout=(16, 2)):
    """An instant-ngp field at the published widths (HashGridConfig()'s
    2^19 entries from resolution 16 to 2048, `layout` levels x features,
    hidden 64, SH 4) with its table uniform in +-1 (features of order one;
    the program's +-1e-4 would make the field a constant fog) and two poses
    of n_rays crop rays, `miss` of them aimed off the box; -> (field,
    origins, dirs, march box (lo, hi), settings)."""
    from dream2real_tpu_torch.nerf.hashgrid import HashGridConfig

    grid = HashGridConfig(n_levels=layout[0], n_features=layout[1])
    cfg = NGPConfig(field_type="hashgrid", grid=grid, aabb_min=(0.0, -0.6, -0.5),
                    aabb_max=(1.1, 0.6, 0.9))
    st = RenderSettings(n_coarse=20, n_fine=0, near=0.05, far=2.0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    field = init_ngp_params(cfg, gen, device=dev)
    with torch.no_grad():
        field.table.uniform_(-1.0, 1.0, generator=gen)
    rng = np.random.default_rng(seed)
    origins = torch.tensor([[0.5, 0.0, -0.4], [0.45, 0.05, -0.35]], device=dev)
    tgt = rng.uniform([0.3, -0.2, 0.0], [0.7, 0.2, 0.3], size=(2, n_rays, 3))
    tgt[:, : int(n_rays * miss)] += 5.0
    d = torch.tensor(tgt, dtype=torch.float32, device=dev) - origins[:, None]
    d = d / d[..., 2:3]
    return field, origins, d, ((0.3, -0.2, 0.0), (0.7, 0.2, 0.3)), st


#: H2 against render_rays: the twin's MLPs are cuBLAS bf16 GEMMs and its
#: sums over samples torch reductions, both adding in other orders than
#: H2's tensor-core products and in-order sums, so a layer's output may round
#: to the neighbouring bf16 value now and then; a ray's rgb, alpha and depth
#: / far stay within H2_TOL (K1's march tolerance; 4.0e-4 the largest seen,
#: on a clip group's 903,168 rays), and all but H2_SHARE of the rays within
#: 1e-4 (5e-4 seen, on 2,000 rays).
H2_TOL, H2_SHARE = 5e-3, 2e-3


def hash_march_gaps(got: dict, want: dict, far: float) -> tuple[float, float]:
    """(the largest gap of rgb, alpha or depth / far, the share of rays
    with a gap over 1e-4) between two crop renders."""
    gaps = torch.stack([(got["rgb"] - want["rgb"]).abs().amax(-1),
                        (got["alpha"] - want["alpha"]).abs(),
                        (got["depth"] - want["depth"]).abs() / far]).amax(0)
    return float(gaps.max()), float((gaps > 1e-4).float().mean())


@H2_LAYOUTS
@pytest.mark.parametrize("n_rays", [1, 255, 256, 257, 1000, 16 * 168 * 168])
def test_hash_march_matches_render_rays(dev, n_rays, layout):
    """H2 at ragged live-ray counts around its 256-thread blocks and at a
    clip group's rays (32 poses of 168^2 crop rays as two poses of 16 x
    168^2), against its twin render_rays on the same rays, in both layouts
    of the encoding; misses exact zeros, one launch."""
    from dream2real_tpu_torch.nerf import hash_march as hm
    from dream2real_tpu_torch.nerf.render import render_rays

    field, origins, d, aabb, st = _hash_case(dev, n_rays, seed=n_rays, layout=layout)
    with torch.inference_mode():
        before = hm.hash_march.launches
        got = hm.march_rays_hash(hm.pack(field), origins, d, aabb, st)
        assert hm.hash_march.launches == before + 1
        want = render_rays(field, origins[:, None].expand(d.shape), d, st, march_aabb=aabb)
    worst, share = hash_march_gaps(got, want, st.far)
    print(f"H2 vs render_rays, {2 * n_rays} rays: worst {worst:.3e}, share over 1e-4 {share:.4f}")
    assert worst <= H2_TOL and share <= H2_SHARE
    t0, t1 = mk.march_ranges(origins, d, aabb, st)
    miss = ~(t1 > t0).reshape(d.shape[:2])
    assert not got["alpha"][miss].any() and not got["rgb"][miss].any()
    assert float(got["alpha"].max()) > 0.5  # the rays that hit see the field


@H2_LAYOUTS
@pytest.mark.parametrize("min_t", [1e-4, 0.5])
def test_hash_march_early_exit_bitexact(dev, min_t, layout):
    """The exact early exit (a ray stops under min_transmittance, a sample
    outside the boxes or of weight zero skips its MLPs) gives the bits of
    marching every sample."""
    from dream2real_tpu_torch.nerf import hash_march as hm

    field, origins, d, aabb, st = _hash_case(dev, 3000, seed=3, miss=0.1, layout=layout)
    st = st._replace(min_transmittance=min_t)
    packed = hm.pack(field)
    on = hm.march_rays_hash(packed, origins, d, aabb, st, early_exit=True)
    off = hm.march_rays_hash(packed, origins, d, aabb, st, early_exit=False)
    for k in ("rgb", "alpha", "depth"):
        assert torch.equal(on[k], off[k])


def test_hash_march_no_live_ray_launches_and_gives_zeros(dev):
    """A clip group whose rays all miss: one launch, exact zeros."""
    from dream2real_tpu_torch.nerf import hash_march as hm

    field, origins, d, aabb, st = _hash_case(dev, 64, miss=1.0)
    before = hm.hash_march.launches
    out = hm.march_rays_hash(hm.pack(field), origins, d, aabb, st)
    assert hm.hash_march.launches == before + 1
    for k in ("rgb", "alpha", "depth"):
        assert not out[k].any()


def test_hash_march_launches_on_every_card(dev):
    """H2 on each card in turn, after launches on the first: its
    shared-memory limit and grid are set once a card, so every card's
    launch runs and matches render_rays there."""
    from dream2real_tpu_torch.nerf import hash_march as hm
    from dream2real_tpu_torch.nerf.render import render_rays

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA devices")
    for layout in ((16, 2), (8, 4)):
        for i in list(range(n)) + [0]:
            di = torch.device("cuda", i)
            field, origins, d, aabb, st = _hash_case(di, 1000, seed=i, layout=layout)
            with torch.inference_mode():
                got = hm.march_rays_hash(hm.pack(field), origins, d, aabb, st)
                want = render_rays(field, origins[:, None].expand(d.shape), d, st,
                                   march_aabb=aabb)
            worst, share = hash_march_gaps(got, want, st.far)
            print(f"H2 on cuda:{i}, {layout}: worst {worst:.3e}, share over 1e-4 {share:.4f}")
            assert worst <= H2_TOL and share <= H2_SHARE
            assert got["rgb"].device == di and float(got["alpha"].max()) > 0.5


def test_hash_crop_render_runs_h2_once_and_waits_nowhere(dev):
    """render_pose_cropped with a hash-grid fg field on the card: one H2
    launch (the counter field.hash_march and its span under a profiler), no
    K1, and nothing that waits for the device."""
    from dream2real_tpu_torch.nerf import combined, hash_march as hm
    from dream2real_tpu_torch.ops import cameras
    from dream2real_tpu_torch.utils import profiling

    field, *_ = _hash_case(dev, 1)
    st = RenderSettings(n_coarse=20, n_fine=0, near=0.05, far=2.0)
    res, crop = 112, 48
    K = torch.tensor([[0.9 * res, 0, res / 2], [0, 0.9 * res, res / 2], [0, 0, 1.0]], device=dev)
    dirs_cam = cameras.pixel_dirs(res, res, K.cpu().numpy(), device=dev)
    T_WO = torch.eye(4, device=dev)
    T_WO[:3, 3] = torch.tensor([0.5, 0.0, 0.15], device=dev)
    T_WC = torch.tensor([[1, 0, 0, 0.5], [0, -1, 0, 0.0], [0, 0, -1, 0.7], [0, 0, 0, 1.0]],
                        device=dev)
    poses = T_WO[None].repeat(8, 1, 1)
    poses[:, 0, 3] += torch.linspace(-0.05, 0.05, 8, device=dev)
    bg = combined.BackgroundView(rgb=torch.zeros(res, res, 3, device=dev),
                                 alpha=torch.ones(res, res, device=dev),
                                 depth=torch.full((res, res), 100.0, device=dev))
    bg_u8 = combined.background_only_image(bg)
    aabb = (torch.tensor((0.3, -0.2, 0.0), device=dev), torch.tensor((0.7, 0.2, 0.3), device=dev))
    packed = combined.pack_crop(field, st, dev)
    assert isinstance(packed, hm.HashMarchParams)
    args = (field, st, dirs_cam, K, aabb, crop, T_WO, T_WC, bg, bg_u8, poses)
    with torch.inference_mode():
        want = combined.render_pose_cropped(*args, packed=packed)
        torch.cuda.synchronize()
        k1, h2 = mk.march.launches, hm.hash_march.launches
        profiling.reset()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = combined.render_pose_cropped(*args, packed=packed)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        counted = profiling.counters()
        assert torch.equal(got, want) and got.shape == (8, res, res, 3)
        assert (mk.march.launches, hm.hash_march.launches) == (k1, h2 + 1)
        assert counted.get("field.hash_march") == 1
        assert [s["name"] for s in profiling.spans()].count("field.hash_march") == 1


# The features H1 gives a fixed set of 2^16 points on a fixed table in +-1
# at HashGridConfig()'s widths (numpy's generator, seed 5), as sha256 of
# their bf16 bytes: H1 before its level arithmetic moved into hash.cuh.
H1_FEATURES_SHA256 = "957e230d1aa3e9581f0008c9120cdf35c3a22900c6f1b5f77b2de46c3f532560"


def test_h1_is_bit_for_bit_what_it_was(dev):
    """H1's forward after the move of its level arithmetic into hash.cuh,
    shared with H2: the same bits as before it."""
    import hashlib

    from dream2real_tpu_torch.nerf.hashgrid import HashGridConfig, hash_encode

    cfg = HashGridConfig()
    rng = np.random.default_rng(5)
    pos = torch.tensor(rng.uniform(-0.05, 1.05, (1 << 16, 3)), dtype=torch.float32, device=dev)
    table = torch.tensor(rng.uniform(-1.0, 1.0, (cfg.n_levels, cfg.table_size, cfg.n_features)),
                         dtype=torch.float32, device=dev)
    with torch.no_grad():
        got = hash_encode(pos, table, cfg)
    digest = hashlib.sha256(got.view(torch.int16).cpu().numpy().tobytes()).hexdigest()
    print(f"H1 features sha256 {digest}")
    assert digest == H1_FEATURES_SHA256
