"""The CUDA kernels against their plain versions on the card, at small
shapes (chip_smoke.py holds them at the main path's shapes). Marked `cuda`;
without a GPU every test skips. Needs no JAX, so on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

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


def test_march_kernel_matches_plain(dev):
    cfg = NGPConfig(aabb_min=(0.0, -0.6, -0.5), aabb_max=(1.1, 0.6, 0.9))
    st = RenderSettings(n_coarse=20, n_fine=0, near=0.05, far=2.0)
    gen = torch.Generator(device=dev).manual_seed(0)
    packed = mk.pack_params(init_ngp_params(cfg, gen, device=dev))
    rng = np.random.default_rng(0)
    origins = torch.tensor([[0.5, 0.0, -0.4], [0.45, 0.05, -0.35]], device=dev)
    # 300 rays a pose, not a multiple of the kernel's 128-ray tile; a third
    # of them miss the box.
    tgt = rng.uniform([0.3, -0.2, 0.0], [0.7, 0.2, 0.3], size=(2, 300, 3))
    tgt[:, 200:] += 5.0
    d = torch.tensor(tgt, dtype=torch.float32, device=dev) - origins[:, None]
    d = d / d[..., 2:3]
    lo, hi = (0.3, -0.2, 0.0), (0.7, 0.2, 0.3)
    # Every ray, misses included, as the kernel also takes them.
    t0, t1 = ray_aabb(origins[:, None], d, lo, hi)
    box = torch.tensor(cfg.aabb_min + cfg.aabb_max + lo + hi, device=dev)
    args = (origins[:, None].expand(d.shape).reshape(-1, 3).contiguous(),
            d.reshape(-1, 3).contiguous(), t0.clamp(min=st.near).reshape(-1).contiguous(),
            t1.clamp(max=st.far).reshape(-1).contiguous(), box, *packed, 20,
            st.min_transmittance)
    before = mk.march.launches
    got = mk.march(*args, True)
    assert mk.march.launches == before + 1
    ref = mk.march_plain(*args, True)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=5e-3, rtol=0)
    for a, b in zip(got, mk.march(*args, False)):
        assert torch.equal(a, b)
    # And through the caller-facing function, which launches the hits only.
    out = mk.march_rays_fused(packed, cfg, origins, d, (lo, hi), st)
    torch.testing.assert_close(out["alpha"][:, 200:], torch.zeros(2, 100, device=dev))


@pytest.mark.parametrize("maxsub", ["0", "1"])
def test_attention_kernels_match_plain(dev, maxsub, monkeypatch):
    monkeypatch.setenv("D2R_ATTN_MAXSUB", maxsub)
    gen = torch.Generator(device=dev).manual_seed(1)
    B, T, W, H = 2, 77, 1024, 16
    x = (torch.randn(B, T, W, generator=gen, device=dev) * 2).to(torch.bfloat16)
    w = (torch.randn(W, 3 * W, generator=gen, device=dev) * W**-0.5).to(torch.bfloat16)
    bq = torch.randn(3 * W, generator=gen, device=dev) * 0.02
    g = torch.ones(W, device=dev)
    b = torch.zeros(W, device=dev)
    out = att.mha_ln_qkv(x, w, bq, g, b, H).float()
    ref = att.mha_ln_qkv_plain(x, w, bq, g, b, H, maxsub == "1").float()
    torch.testing.assert_close(out, ref, atol=0.02, rtol=0.05)
    q = [torch.randn(3, 12, 77, 64, generator=gen, device=dev).to(torch.bfloat16)
         for _ in range(3)]
    torch.testing.assert_close(att.mha(*q, causal=True).float(),
                               att.mha_causal_plain(*q).float(), atol=0.02, rtol=0.05)


def test_wrappers_reject_bad_inputs(dev):
    qkv = torch.zeros(2, 10, 3 * 96, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        att.mha_qkv(qkv, 3)  # heads of 32: the kernel takes 64
    with pytest.raises(ValueError):
        att.mha_qkv(torch.zeros(2, 10, 3 * 64, device=dev), 1)  # f32, not bf16


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
