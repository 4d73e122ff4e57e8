"""CLIP dual-tower model (port of dream2real_tpu/clip/model.py).

Architecture of openai/clip-vit-large-patch14-336; ``CLIPConfig`` scales
down for tests. Parameters live in ``CLIPModel`` under the reference's key
names; matmul weights are stored in bf16 (the reference rounds them to bf16
at every use), biases, LayerNorm parameters and the two output projections
in f32. Numerics: bf16 matmul inputs with f32 accumulation, bf16 residual
stream, f32 LayerNorm and softmax, QuickGELU on the bf16-rounded fc1 output.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from dream2real_tpu_torch.device import BF16, F32, dot_exact, dot_f32, resolve_device
from dream2real_tpu_torch.ops.attention import layer_norm, mha, mha_ln_qkv, mha_qkv


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


def _linear_bf16(x: torch.Tensor, lin: Linear) -> torch.Tensor:
    return (dot_f32(x, lin.w) + lin.b).to(BF16)


def _heads(t: torch.Tensor, n_heads: int) -> torch.Tensor:
    B, T, W = t.shape
    return t.reshape(B, T, n_heads, W // n_heads).permute(0, 2, 1, 3).contiguous()


def _attn(x: torch.Tensor, blk: Block, n_heads: int, causal: bool) -> torch.Tensor:
    """LN'd x -> attention + out-projection (bf16). Bidirectional: K3 on the
    projection layout; causal (text tower): K4 on head-split q, k, v."""
    B, T, W = x.shape
    qkv = _linear_bf16(x, blk.qkv)
    if not causal:
        out = mha_qkv(qkv, n_heads)
    else:
        q, k, v = (_heads(t, n_heads) for t in qkv.split(W, dim=-1))
        out = mha(q, k, v, causal=True).permute(0, 2, 1, 3).reshape(B, T, W)
    return _linear_bf16(out, blk.proj)


def _mlp_block(x: torch.Tensor, blk: Block) -> torch.Tensor:
    # fc1 output rounds to bf16 BEFORE QuickGELU (x * sigmoid(1.702 x)).
    h = _linear_bf16(x, blk.fc1)
    h = h * torch.sigmoid(1.702 * h.to(F32)).to(BF16)
    return _linear_bf16(h, blk.fc2)


def _block(x: torch.Tensor, blk: Block, n_heads: int, causal: bool = False) -> torch.Tensor:
    if not causal and _fused_ln_attn_mode() == "1":
        a = mha_ln_qkv(x.to(BF16), blk.qkv.w, blk.qkv.b, blk.ln1_g, blk.ln1_b, n_heads)
        x = x + _linear_bf16(a, blk.proj)
    else:
        x = x + _attn(layer_norm(x, blk.ln1_g, blk.ln1_b), blk, n_heads, causal)
    return x + _mlp_block(layer_norm(x, blk.ln2_g, blk.ln2_b), blk)


def _attn_cls(x: torch.Tensor, blk: Block, n_heads: int) -> torch.Tensor:
    """Attention output of the CLS token only, (B, T, W) -> (B, 1, W): k/v
    from every token, q and the out-projection from token 0. The (B, H, 1, T)
    logits are tiny; they run as plain f32 products of bf16 values."""
    B, T, W = x.shape
    hd = W // n_heads
    qkv = _linear_bf16(layer_norm(x, blk.ln1_g, blk.ln1_b), blk.qkv)
    q, k, v = qkv.split(W, dim=-1)
    q, k, v = _heads(q[:, :1], n_heads), _heads(k, n_heads), _heads(v, n_heads)
    logits = dot_exact(q, k.transpose(-1, -2))
    w = torch.softmax(logits * hd**-0.5, dim=-1).to(BF16)
    out = dot_exact(w, v).permute(0, 2, 1, 3).reshape(B, 1, W).to(BF16)
    return _linear_bf16(out, blk.proj)


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
    x = dot_f32(x, model.v_patch_w.reshape(ps * ps * 3, W)).to(BF16)
    cls = model.v_class_emb.expand(B, 1, W)
    x = torch.cat([cls, x], dim=1) + model.v_pos_emb
    x = layer_norm(x, model.v_ln_pre_g, model.v_ln_pre_b)
    for i in range(cfg.vision_layers - 1):
        x = _block(x, model.v_blk[i], cfg.vision_heads)
    # Final block: only the CLS row feeds ln_post, so its attention query,
    # projection and MLP run for token 0 alone (the same math).
    blk = model.v_blk[cfg.vision_layers - 1]
    x_cls = x[:, :1] + _attn_cls(x, blk, cfg.vision_heads)
    x_cls = x_cls + _mlp_block(layer_norm(x_cls, blk.ln2_g, blk.ln2_b), blk)
    x = layer_norm(x_cls[:, 0], model.v_ln_post_g, model.v_ln_post_b)
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
    x = layer_norm(x, model.t_ln_final_g, model.t_ln_final_b)
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
    mean = torch.as_tensor(IMAGE_MEAN, device=x.device)
    std = torch.as_tensor(IMAGE_STD, device=x.device)
    return (x - mean) / std
