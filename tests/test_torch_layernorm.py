"""The towers' LayerNorms on the CPU (ops/attention.py's ``ln_rows``,
``ln_qkv``, ``ln_fc1``: on the card the row pass, alone or as the prologue
of a GEMM; tests/test_torch_cuda.py holds them there).

- A tower block on the split path (D2R_ATTN_FUSED_LN=0: LN1 alone, then the
  qkv GEMM) is the plain composition of its layers, each LayerNorm with its
  own gain and bias.
- Every LayerNorm a CPU tower runs counts as ``clip.ln_plain`` while a
  profiler runs, none as ``clip.ln_rows``.
"""

import pytest
import torch
from clip_witness import port_block, witness_block
from torch.profiler import ProfilerActivity, profile

from dream2real_tpu_torch.clip import model as cm
from dream2real_tpu_torch.ops import attention as att
from dream2real_tpu_torch.utils import profiling

torch.set_num_threads(1)

BF16 = torch.bfloat16


def _plain_block(x, blk, n_heads: int):
    """A bidirectional tower block spelled out in plain versions: LN1, qkv,
    attention, the out-projection and residual, LN2, fc1 + QuickGELU, fc2
    and residual."""
    qkv = att.linear_bias_plain(att.layer_norm(x, blk.ln1_g, blk.ln1_b), blk.qkv.w, blk.qkv.b)
    a = att.mha_qkv_plain(qkv, n_heads, False)
    x = att.linear_bias_then_resid_plain(a, blk.proj.w, blk.proj.b, x)
    h = att.linear_bias_gelu_plain(att.layer_norm(x, blk.ln2_g, blk.ln2_b), blk.fc1.w,
                                   blk.fc1.b)
    return att.linear_bias_then_resid_plain(h, blk.fc2.w, blk.fc2.b, x)


def _random_port_block(W: int, seed: int):
    """The witness block's layout with every parameter drawn at random."""
    gen = torch.Generator().manual_seed(seed)
    blk = port_block(witness_block(W), "cpu")
    with torch.no_grad():
        for name, p in blk.named_parameters():
            scale = p.shape[0] ** -0.5 if p.dim() == 2 else 0.1
            p.copy_(torch.randn(p.shape, generator=gen) * scale + (1.0 if name.endswith("_g")
                                                                   else 0.0))
    return blk


def test_a_cpu_block_on_the_split_path_is_its_plain_composition(monkeypatch):
    monkeypatch.setenv("D2R_ATTN_MAXSUB", "0")
    monkeypatch.setenv("D2R_ATTN_FUSED_LN", "0")
    W, H = 128, 2
    blk = _random_port_block(W, seed=5)
    x = (2 * torch.randn(2, 9, W, generator=torch.Generator().manual_seed(7))).to(BF16)
    assert torch.equal(cm._block(x, blk, H), _plain_block(x, blk, H))


TINY = cm.CLIPConfig(image_size=28, patch_size=14, vision_width=64, vision_layers=3,
                     vision_heads=1, vocab_size=128, context_length=8, text_width=64,
                     text_layers=2, text_heads=1, projection_dim=16, eot_id=127)


@pytest.mark.parametrize("tower,fused,want", [
    ("image", "1", 8),  # ln_pre, LN1 + LN2 in blocks 0-1, the last block's two, ln_post
    ("image", "0", 8),
    ("text", "1", 5),  # LN1 + LN2 in two blocks, ln_final
])
def test_every_layer_norm_of_a_cpu_tower_counts_as_plain(tower, fused, want, monkeypatch):
    monkeypatch.setenv("D2R_ATTN_FUSED_LN", fused)
    model = cm.init_clip_params(TINY, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    if tower == "image":
        run = lambda: cm.encode_image(model, torch.randn(2, 28, 28, 3, generator=gen))  # noqa: E731
    else:
        ids = torch.randint(0, 126, (2, 8), generator=gen)
        ids[:, 5] = TINY.eot_id
        run = lambda: cm.encode_text(model, ids)  # noqa: E731
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.reset()
        out = run()
    assert out.shape == (2, TINY.projection_dim)
    assert profiling.counters() == {"clip.ln_plain": want}
    profiling.reset()
    run()
    assert profiling.counters() == {}  # nothing counts without a profiler
