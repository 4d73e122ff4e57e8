"""CLIP dual-tower model (port of dream2real_tpu/clip/model.py).

Architecture of openai/clip-vit-large-patch14-336; ``CLIPConfig`` scales
down for tests. Parameters live in ``CLIPModel`` under the reference's key
names; matmul weights are stored in bf16 (the reference rounds them to bf16
at every use), biases, LayerNorm parameters and the two output projections
in f32. Numerics: bf16 matmul inputs with f32 accumulation, bf16 residual
stream, f32 LayerNorm and softmax, QuickGELU on the bf16-rounded fc1 output.
Every biased layer (qkv on the split path, the out-projection, fc1, fc2)
runs on the port's GEMM, whose epilogue adds the f32 bias to the f32
accumulator and rounds where the reference does (ops/attention.py's
``linear_bias*``); the patchify, which has no bias, is a bf16 matmul. Every
LayerNorm runs on the card's row pass: alone (``ln_rows``: ln_pre, ln_post,
ln_final, the split path's LN1) or as the prologue of the qkv GEMM
(``ln_qkv``: K2's LN1, the last vision block's, the text tower's) or of fc1
(``ln_fc1``); on the CPU these wrappers run the plain ``layer_norm``. While
a profiler runs each one counts as ``clip.ln_rows`` (on the card) or
``clip.ln_plain`` (on the CPU).
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from dream2real_tpu_torch.device import BF16, F32, dot_bf16, dot_exact, resolve_device
from dream2real_tpu_torch.ops.attention import (
    linear_bias,
    linear_bias_then_resid,
    ln_fc1,
    ln_qkv,
    ln_rows,
    mha,
    mha_ln_qkv,
    mha_qkv,
)
from dream2real_tpu_torch.utils.profiling import count


class CLIPConfig(NamedTuple):
    image_size: int = 336
    patch_size: int = 14
    vision_width: int = 1024
    vision_layers: int = 24
    vision_heads: int = 16
    vocab_size: int = 49408
    context_length: int = 77
    text_width: int = 768
    text_layers: int = 12
    text_heads: int = 12
    projection_dim: int = 768
    # HF pools the text state at the FIRST eos_token_id (49407, openai vocab).
    eot_id: int = 49407

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size


def _param(shape, dtype, device, fill=0.0) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, fill, dtype=dtype, device=device), requires_grad=False)


class Linear(nn.Module):
    """x @ w + b with w (in, out) bf16 and b (out,) f32."""

    def __init__(self, d_in: int, d_out: int, device):
        super().__init__()
        self.w = _param((d_in, d_out), BF16, device)
        self.b = _param((d_out,), F32, device)


class Block(nn.Module):
    def __init__(self, width: int, device, mlp_ratio: int = 4):
        super().__init__()
        self.ln1_g = _param((width,), F32, device, 1.0)
        self.ln1_b = _param((width,), F32, device)
        self.qkv = Linear(width, 3 * width, device)
        self.proj = Linear(width, width, device)
        self.ln2_g = _param((width,), F32, device, 1.0)
        self.ln2_b = _param((width,), F32, device)
        self.fc1 = Linear(width, mlp_ratio * width, device)
        self.fc2 = Linear(mlp_ratio * width, width, device)


class CLIPModel(nn.Module):
    """Both towers' parameters (reference keys: v_*, t_*, v_blk{i}, t_blk{i},
    logit_scale) plus the config."""

    def __init__(self, cfg: CLIPConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        W, Wt, P = cfg.vision_width, cfg.text_width, cfg.projection_dim
        n_patches = cfg.grid * cfg.grid
        self.v_patch_w = _param((cfg.patch_size, cfg.patch_size, 3, W), BF16, dev)
        self.v_class_emb = _param((W,), BF16, dev)
        self.v_pos_emb = _param((n_patches + 1, W), BF16, dev)
        self.v_ln_pre_g = _param((W,), F32, dev, 1.0)
        self.v_ln_pre_b = _param((W,), F32, dev)
        self.v_ln_post_g = _param((W,), F32, dev, 1.0)
        self.v_ln_post_b = _param((W,), F32, dev)
        self.v_proj = _param((W, P), F32, dev)
        self.t_tok_emb = _param((cfg.vocab_size, Wt), BF16, dev)
        self.t_pos_emb = _param((cfg.context_length, Wt), BF16, dev)
        self.t_ln_final_g = _param((Wt,), F32, dev, 1.0)
        self.t_ln_final_b = _param((Wt,), F32, dev)
        self.t_proj = _param((Wt, P), F32, dev)
        self.logit_scale = _param((), F32, dev, math.log(1 / 0.07))
        self.v_blk = nn.ModuleList(Block(W, dev) for _ in range(cfg.vision_layers))
        self.t_blk = nn.ModuleList(Block(Wt, dev) for _ in range(cfg.text_layers))


def init_clip_params(cfg: CLIPConfig, generator: torch.Generator, device=None) -> CLIPModel:
    """Random weights with the reference's distributions (normal, scaled as
    in its init_clip_params; unit LayerNorm gains, zero biases), drawn from
    ``generator`` on its own device."""
    model = CLIPModel(cfg, device)
    gdev = generator.device

    def normal(p: nn.Parameter, std: float):
        with torch.no_grad():
            p.copy_(torch.randn(p.shape, generator=generator, device=gdev) * std)

    W, Wt = cfg.vision_width, cfg.text_width
    normal(model.v_patch_w, 0.02)
    normal(model.v_class_emb, 0.02)
    normal(model.v_pos_emb, 0.02)
    normal(model.v_proj, W**-0.5)
    normal(model.t_tok_emb, 0.02)
    normal(model.t_pos_emb, 0.01)
    normal(model.t_proj, Wt**-0.5)
    for blk in list(model.v_blk) + list(model.t_blk):
        for lin in (blk.qkv, blk.proj, blk.fc1, blk.fc2):
            normal(lin.w, lin.w.shape[0] ** -0.5)
    return model


# ------------------------------------------------------------------ blocks


def _fused_ln_attn_mode() -> str:
    """D2R_ATTN_FUSED_LN: "1" (default) LN1 + qkv + attention as K2; "0"
    LN + qkv matmul + K3. "2" (a removed mode) means "1", as in the
    reference."""
    mode = os.environ.get("D2R_ATTN_FUSED_LN", "1")
    if mode == "2":
        return "1"
    if mode not in ("0", "1"):
        raise ValueError(f"D2R_ATTN_FUSED_LN={mode!r}: expected 0 or 1")
    return mode


def _heads(t: torch.Tensor, n_heads: int) -> torch.Tensor:
    B, T, W = t.shape
    return t.reshape(B, T, n_heads, W // n_heads).permute(0, 2, 1, 3).contiguous()


def _counted(x: torch.Tensor) -> None:
    """Count one LayerNorm of x: the row pass on the card, plain on the CPU."""
    count("clip.ln_rows" if x.is_cuda else "clip.ln_plain")


def _ln(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A LayerNorm with nothing fused after it."""
    _counted(x)
    return ln_rows(x, g, b)


def _mlp_block(x: torch.Tensor, blk: Block) -> torch.Tensor:
    """x + MLP(LN2(x)): fc1's output rounds to bf16 BEFORE QuickGELU
    (x * sigmoid(1.702 x)), fc2's before the residual add."""
    _counted(x)
    h = ln_fc1(x, blk.fc1.w, blk.fc1.b, blk.ln2_g, blk.ln2_b)
    return linear_bias_then_resid(h, blk.fc2.w, blk.fc2.b, x)


def _block(x: torch.Tensor, blk: Block, n_heads: int, causal: bool = False) -> torch.Tensor:
    """One block. Bidirectional: K2 (LN1, qkv, attention), or under
    D2R_ATTN_FUSED_LN=0 LN1, the qkv GEMM and K3 apart; causal (text tower):
    LN1 and qkv, then K4 on head-split q, k, v."""
    if causal:
        B, T, W = x.shape
        _counted(x)
        qkv = ln_qkv(x, blk.qkv.w, blk.qkv.b, blk.ln1_g, blk.ln1_b)
        q, k, v = (_heads(t, n_heads) for t in qkv.split(W, dim=-1))
        a = mha(q, k, v, causal=True).permute(0, 2, 1, 3).reshape(B, T, W)
    elif _fused_ln_attn_mode() == "1":
        _counted(x)  # K2's LN1
        a = mha_ln_qkv(x.to(BF16), blk.qkv.w, blk.qkv.b, blk.ln1_g, blk.ln1_b, n_heads)
    else:
        a = mha_qkv(linear_bias(_ln(x, blk.ln1_g, blk.ln1_b), blk.qkv.w, blk.qkv.b), n_heads)
    return _mlp_block(linear_bias_then_resid(a, blk.proj.w, blk.proj.b, x), blk)


def _attn_cls(x: torch.Tensor, blk: Block, n_heads: int) -> torch.Tensor:
    """Attention output of the CLS token only, before the out-projection,
    (B, T, W) -> (B, 1, W): k/v from every token, q from token 0. The
    (B, H, 1, T) logits are tiny; they run as plain f32 products of bf16
    values."""
    B, T, W = x.shape
    hd = W // n_heads
    _counted(x)
    qkv = ln_qkv(x, blk.qkv.w, blk.qkv.b, blk.ln1_g, blk.ln1_b)
    q, k, v = qkv.split(W, dim=-1)
    q, k, v = _heads(q[:, :1], n_heads), _heads(k, n_heads), _heads(v, n_heads)
    logits = dot_exact(q, k.transpose(-1, -2))
    w = torch.softmax(logits * hd**-0.5, dim=-1).to(BF16)
    return dot_exact(w, v).permute(0, 2, 1, 3).reshape(B, 1, W).to(BF16)


# ------------------------------------------------------------------ towers


def encode_image(model: CLIPModel, pixels: torch.Tensor) -> torch.Tensor:
    """pixels (B, H, W, 3) f32, CLIP-normalized -> (B, D) unnormalized
    embeddings (f32)."""
    cfg = model.cfg
    B = pixels.shape[0]
    g, ps, W = cfg.grid, cfg.patch_size, cfg.vision_width
    # Patchify as a matmul (a conv with stride == kernel == patch).
    x = pixels.reshape(B, g, ps, g, ps, 3).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(B, g * g, ps * ps * 3).to(BF16)
    x = dot_bf16(x, model.v_patch_w.reshape(ps * ps * 3, W))
    cls = model.v_class_emb.expand(B, 1, W)
    x = torch.cat([cls, x], dim=1) + model.v_pos_emb
    x = _ln(x, model.v_ln_pre_g, model.v_ln_pre_b)
    for i in range(cfg.vision_layers - 1):
        x = _block(x, model.v_blk[i], cfg.vision_heads)
    # Final block: only the CLS row feeds ln_post, so its attention query,
    # projection and MLP run for token 0 alone (the same math).
    blk = model.v_blk[cfg.vision_layers - 1]
    x_cls = linear_bias_then_resid(_attn_cls(x, blk, cfg.vision_heads), blk.proj.w, blk.proj.b,
                                   x[:, :1].contiguous())
    x_cls = _mlp_block(x_cls, blk)
    x = _ln(x_cls[:, 0], model.v_ln_post_g, model.v_ln_post_b)
    return x.to(F32) @ model.v_proj


def encode_text(model: CLIPModel, ids: torch.Tensor) -> torch.Tensor:
    """ids (B, T) int, padded to context_length -> (B, D) unnormalized
    embeddings (f32), pooled at the first EOT token."""
    cfg = model.cfg
    B, T = ids.shape
    ids = ids.to(device=model.t_tok_emb.device, dtype=torch.long)
    x = model.t_tok_emb[ids] + model.t_pos_emb[:T]
    for i in range(cfg.text_layers):
        x = _block(x, model.t_blk[i], cfg.text_heads, causal=True)
    x = _ln(x, model.t_ln_final_g, model.t_ln_final_b)
    eot = torch.argmax((ids == cfg.eot_id).to(torch.int32), dim=-1)
    x = x[torch.arange(B, device=ids.device), eot]
    return x.to(F32) @ model.t_proj


def logits_per_image(model: CLIPModel, img_emb: torch.Tensor, txt_emb: torch.Tensor):
    """(N, D), (M, D) -> (N, M) similarity logits, as HF CLIPModel."""
    ie = img_emb / torch.linalg.norm(img_emb, dim=-1, keepdim=True)
    te = txt_emb / torch.linalg.norm(txt_emb, dim=-1, keepdim=True)
    return torch.exp(model.logit_scale) * ie @ te.T


# CLIPProcessor normalization constants (HF CLIPImageProcessor defaults).
IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
_NORM: dict = {}


def preprocess_images(images_u8: torch.Tensor, cfg: CLIPConfig) -> torch.Tensor:
    """(B, H, W, 3) uint8 sRGB -> normalized f32 pixels for encode_image.
    Renders at the CLIP size only rescale and normalize; other sizes are
    center-cropped and cubic-resized first."""
    x = images_u8.to(F32) / 255.0
    if x.shape[1] != cfg.image_size or x.shape[2] != cfg.image_size:
        from dream2real_tpu_torch.ops.image import center_crop_square, resize_image

        x = torch.stack([
            resize_image(center_crop_square(im), (cfg.image_size, cfg.image_size)) for im in x
        ])
    consts = _NORM.get(x.device)
    if consts is None:  # once a device: a copy from the host waits for the device
        consts = _NORM[x.device] = (torch.as_tensor(IMAGE_MEAN, device=x.device),
                                    torch.as_tensor(IMAGE_STD, device=x.device))
    return (x - consts[0]) / consts[1]
