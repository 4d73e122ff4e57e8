"""CLIP's two towers, plainly (Radford et al., arXiv:2103.00020; the
openai/clip-vit-large-patch14-336 layout): pre-LayerNorm transformer
blocks, QuickGELU MLPs, the vision tower pooled at its class token, the text
tower at its first end token, cosine logits scaled by exp(logit_scale).

Rounding (``prec.rnd``) falls where the configuration's numerics put it: the
residual stream, each layer's output (bias added in float32 first), the
LayerNorms' outputs, the attention's scaled queries and probabilities (the
vision tower's softmax as exp(min(s, 70) - 70) over its row sum, the text
tower's causal softmax and the last vision block's class-token softmax
exact), QuickGELU's sigmoid. In the last vision block
only the class token goes on past attention (only it feeds ln_post): the
same numbers. Weights are a dict under the benchmark's names, matrices
(in, out)."""

from __future__ import annotations

import torch

from benchmark.reference.precision import F32, Precision

IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)
MASKED = -0.7 * float(torch.finfo(torch.float32).max)


def layer_norm(x, g, b, prec: Precision, eps: float = 1e-5):
    x = x.to(F32)
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return prec.rnd((x - mu) * torch.rsqrt(var + eps) * g.to(F32) + b.to(F32))


def linear(x, w, b, prec: Precision):
    """A biased layer: the product and the bias in float32, rounded once."""
    return prec.rnd(prec.mm(x, w) + b.to(F32))


def _attention(q, k, v, hd: int, causal: bool, prec: Precision):
    """q, k, v (B, H, Tq / T, hd) -> (B, H, Tq, hd)."""
    s = prec.mm(prec.rnd(q * hd ** -0.5), k.transpose(-1, -2))
    if causal:
        T = s.shape[-1]
        keep = torch.ones(T, T, dtype=torch.bool, device=s.device).tril()
        s = torch.where(keep, s, torch.full_like(s, MASKED))
        return prec.rnd(prec.mm(prec.rnd(torch.softmax(s, dim=-1)), v))
    p = prec.rnd(torch.exp(torch.clamp(s, max=70.0) - 70.0))
    return prec.rnd(prec.mm(p, v) / p.sum(-1, keepdim=True))


def _block(x, w, p: str, heads: int, causal: bool, prec: Precision, cls_only: bool = False):
    B, T, W = x.shape
    hd = W // heads
    qkv = linear(layer_norm(x, w[p + "ln1_g"], w[p + "ln1_b"], prec), w[p + "qkv.w"],
                 w[p + "qkv.b"], prec)

    def split(t):
        return t.reshape(B, -1, heads, hd).permute(0, 2, 1, 3)

    q, k, v = qkv.split(W, dim=-1)
    if cls_only:  # the class token's query alone, its softmax exact
        x = x[:, :1]
        s = prec.mm(split(q[:, :1]), split(k).transpose(-1, -2)) * hd ** -0.5
        a = prec.rnd(prec.mm(prec.rnd(torch.softmax(s, dim=-1)), split(v)))
    else:
        a = _attention(split(q), split(k), split(v), hd, causal, prec)
    a = a.permute(0, 2, 1, 3).reshape(B, -1, W)
    x = prec.rnd(x + linear(a, w[p + "proj.w"], w[p + "proj.b"], prec))
    h = linear(layer_norm(x, w[p + "ln2_g"], w[p + "ln2_b"], prec), w[p + "fc1.w"],
               w[p + "fc1.b"], prec)
    h = prec.rnd(h * prec.rnd(torch.sigmoid(1.702 * h)))
    return prec.rnd(x + linear(h, w[p + "fc2.w"], w[p + "fc2.b"], prec))


def preprocess(frames_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) u8 renders -> CLIP's normalised pixels, each render
    turned 90 degrees (rot90 over (H, W)), as the scorer feeds them."""
    x = torch.rot90(frames_u8, k=1, dims=(1, 2)).to(F32) / 255.0
    mean = torch.tensor(IMAGE_MEAN, dtype=F32, device=x.device)
    std = torch.tensor(IMAGE_STD, dtype=F32, device=x.device)
    return (x - mean) / std


def encode_image(w: dict, c: dict, pixels: torch.Tensor, prec: Precision) -> torch.Tensor:
    """pixels (B, S, S, 3) -> (B, P) image embeddings (not normalised)."""
    B = pixels.shape[0]
    ps, W = c["patch_size"], c["vision_width"]
    g = c["image_size"] // ps
    x = pixels.reshape(B, g, ps, g, ps, 3).permute(0, 1, 3, 2, 4, 5).reshape(B, g * g, -1)
    x = prec.rnd(prec.mm(x, w["v_patch_w"].reshape(ps * ps * 3, W)))
    x = torch.cat([w["v_class_emb"].to(F32).expand(B, 1, W), x], 1)
    x = prec.rnd(x + w["v_pos_emb"].to(F32))
    x = layer_norm(x, w["v_ln_pre_g"], w["v_ln_pre_b"], prec)
    L = c["vision_layers"]
    for i in range(L):
        x = _block(x, w, f"v_blk.{i}.", c["vision_heads"], False, prec, cls_only=i == L - 1)
    x = layer_norm(x[:, 0], w["v_ln_post_g"], w["v_ln_post_b"], prec)
    return prec.mm32(x, w["v_proj"])


def encode_text(w: dict, c: dict, ids: torch.Tensor, prec: Precision) -> torch.Tensor:
    """ids (B, T) -> (B, P) text embeddings, pooled at the first end id."""
    ids = ids.long()
    B, T = ids.shape
    x = prec.rnd(w["t_tok_emb"][ids].to(F32) + w["t_pos_emb"][:T].to(F32))
    for i in range(c["text_layers"]):
        x = _block(x, w, f"t_blk.{i}.", c["text_heads"], True, prec)
    x = layer_norm(x, w["t_ln_final_g"], w["t_ln_final_b"], prec)
    eot = torch.argmax((ids == c["eot_id"]).to(torch.int32), dim=-1)
    x = x[torch.arange(B, device=ids.device), eot]
    return prec.mm32(x, w["t_proj"])


def logits(w: dict, img: torch.Tensor, txt: torch.Tensor, prec: Precision) -> torch.Tensor:
    """(N, P), (M, P) embeddings -> (N, M) logits: the scaled cosines."""
    ie = img / torch.linalg.norm(img, dim=-1, keepdim=True)
    te = txt / torch.linalg.norm(txt, dim=-1, keepdim=True)
    return torch.exp(w["logit_scale"].to(F32)) * prec.mm32(ie, te.T)

