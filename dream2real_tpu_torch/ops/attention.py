"""CLIP attention kernels K2, K3, K4 (port of dream2real_tpu/ops/attention.py).

Each wrapper takes its plain PyTorch version for CPU tensors and launches
``csrc/attention.cu`` for CUDA tensors (or raises):

- ``mha_ln_qkv`` (K2): LN1 + qkv projection + bidirectional attention. On
  the card: the LN-fused qkv GEMM kernel, then the K3 attention kernel.
- ``mha_qkv`` (K3): attention on a projection-layout qkv (B, T, 3W).
- ``mha(causal=True)`` (K4): causal head-split attention, text tower.

Softmax: by default the constant clamp ``exp(min(s, 70) - 70)`` (shift-
invariant, identical to max-subtraction unless a logit exceeds 70);
``D2R_ATTN_MAXSUB=1`` restores exact max-subtraction. Padded/masked keys get
weight exactly 0. The heads are 64 wide on the card (CLIP ViT-L/14 and its
text tower).
"""

from __future__ import annotations

import ctypes
import os

import torch

from dream2real_tpu_torch import build
from dream2real_tpu_torch.device import BF16, F32, bf16_round, dot_exact

_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
_HD = 64  # head width the kernel is built for


def _maxsub() -> bool:
    return os.environ.get("D2R_ATTN_MAXSUB", "0") == "1"


def _check(name: str, t: torch.Tensor, dtype, shape, dev) -> None:
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous {dtype} tensor of shape {tuple(shape)} on {dev}, "
            f"got {tuple(t.shape)} {t.dtype} on {t.device}"
        )


def _attention_launch(q_ptr, k_ptr, v_ptr, out, B, H, T, strides, out_strides, scale,
                      causal: bool, mode: int, dev) -> None:
    lib = build.load("attention")
    fn = lib.d2r_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_long] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(q_ptr, k_ptr, v_ptr, build.ptr(out), B, H, T, *strides, *out_strides,
             float(scale), int(causal), mode, build.stream_ptr(dev))
    build.check(err, "attention")


# ---------------------------------------------------------------- K3


def mha_qkv_plain(qkv: torch.Tensor, n_heads: int, maxsub: bool) -> torch.Tensor:
    """Plain version of K3. qkv (B, T, 3W) bf16, heads packed [q | k | v]
    -> (B, T, W) bf16."""
    B, T, W3 = qkv.shape
    W = W3 // 3
    hd = W // n_heads

    def heads(t):
        return t.reshape(B, T, n_heads, hd).permute(0, 2, 1, 3)

    x = qkv.to(F32)
    q = heads(bf16_round(x[..., :W] * hd**-0.5))
    k, v = heads(x[..., W : 2 * W]), heads(x[..., 2 * W :])
    s = dot_exact(q, k.transpose(-1, -2))
    if maxsub:
        p = bf16_round(torch.exp(s - s.amax(dim=-1, keepdim=True)))
    else:
        p = bf16_round(torch.exp(torch.clamp(s, max=70.0) - 70.0))
    o = dot_exact(p, v) / p.sum(dim=-1, keepdim=True)
    return o.to(BF16).permute(0, 2, 1, 3).reshape(B, T, W)


def mha_qkv(qkv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """K3 wrapper: bidirectional attention on projection-layout qkv
    (B, T, 3W) bf16 -> (B, T, W) bf16; scaling by hd**-0.5 inside."""
    maxsub = _maxsub()
    if not qkv.is_cuda:
        return mha_qkv_plain(qkv, n_heads, maxsub)
    B, T, W3 = qkv.shape
    W = W3 // 3
    if W3 % 3 or W != n_heads * _HD:
        raise ValueError(f"mha_qkv: the kernel takes heads of {_HD}; got qkv {tuple(qkv.shape)}, "
                         f"{n_heads} heads")
    _check("mha_qkv: qkv", qkv, BF16, (B, T, W3), qkv.device)
    out = torch.empty(B, T, W, dtype=BF16, device=qkv.device)
    base, step = qkv.data_ptr(), qkv.element_size() * W
    _attention_launch(
        ctypes.c_void_p(base), ctypes.c_void_p(base + step), ctypes.c_void_p(base + 2 * step),
        out, B, n_heads, T, (T * W3, _HD, W3), (T * W, _HD, W), _HD**-0.5, False,
        1 if maxsub else 0, qkv.device,
    )
    mha_qkv.launches += 1
    return out


mha_qkv.launches = 0


# ---------------------------------------------------------------- K2


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float = 1e-5):
    """LayerNorm in f32, result in x's dtype (the reference's _ln)."""
    x32 = x.to(F32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps) * g + b).to(x.dtype)


def mha_ln_qkv_plain(x, wqkv, bqkv, ln_g, ln_b, n_heads: int, maxsub: bool) -> torch.Tensor:
    """Plain version of K2: LN1 (f32) -> bf16, xn @ Wqkv + b -> bf16, then
    K3's attention."""
    xn = layer_norm(x.to(BF16), ln_g.to(F32), ln_b.to(F32))
    qkv = (dot_exact(xn, wqkv) + bqkv.to(F32)).to(BF16)
    return mha_qkv_plain(qkv, n_heads, maxsub)


def mha_ln_qkv(x, wqkv, bqkv, ln_g, ln_b, n_heads: int) -> torch.Tensor:
    """K2 wrapper. x (B, T, W) bf16 residual stream; wqkv (W, 3W) bf16;
    bqkv (3W,), ln_g/ln_b (W,) f32. -> (B, T, W) bf16 attention output
    before the out-projection."""
    if not x.is_cuda:
        return mha_ln_qkv_plain(x, wqkv, bqkv, ln_g, ln_b, n_heads, _maxsub())
    B, T, W = x.shape
    dev = x.device
    if W != n_heads * _HD or W % 32 or (3 * W) % 128:
        raise ValueError(f"mha_ln_qkv: unsupported width {W} / {n_heads} heads")
    _check("mha_ln_qkv: x", x, BF16, (B, T, W), dev)
    _check("mha_ln_qkv: wqkv", wqkv, BF16, (W, 3 * W), dev)
    _check("mha_ln_qkv: bqkv", bqkv, F32, (3 * W,), dev)
    _check("mha_ln_qkv: ln_g", ln_g, F32, (W,), dev)
    _check("mha_ln_qkv: ln_b", ln_b, F32, (W,), dev)
    M = B * T
    qkv = torch.empty(B, T, 3 * W, dtype=BF16, device=dev)
    stats = torch.empty(2, M, dtype=F32, device=dev)
    fn = build.load("attention").d2r_ln_qkv
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float] + [
        ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    err = fn(build.ptr(x), build.ptr(ln_g), build.ptr(ln_b), build.ptr(wqkv), build.ptr(bqkv),
             M, W, 3 * W, 1e-5, build.ptr(stats[0]), build.ptr(stats[1]), build.ptr(qkv),
             build.stream_ptr(dev))
    build.check(err, "ln_qkv")
    mha_ln_qkv.launches += 1
    return mha_qkv(qkv, n_heads)


mha_ln_qkv.launches = 0


# ---------------------------------------------------------------- K4


def mha_causal_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: (B, H, T, D) bf16 -> (B, H, T, D) bf16. q scaled
    by D**-0.5 in bf16, masked logits -0.7*f32max, exact f32 softmax,
    weights rounded to bf16 before PV."""
    T, D = q.shape[-2], q.shape[-1]
    qs = bf16_round(q.to(F32) * D**-0.5)
    s = dot_exact(qs, k.to(F32).transpose(-1, -2))
    causal = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    s = torch.where(causal, s, torch.full_like(s, _MASK_VALUE))
    p = bf16_round(torch.softmax(s, dim=-1))
    return dot_exact(p, v.to(F32)).to(BF16)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False) -> torch.Tensor:
    """Multi-head attention, (B, H, T, D) -> (B, H, T, D); scaling inside.
    The port has the causal kernel (K4, text tower); the bidirectional
    head-split kernel (K9) belongs to a later slice."""
    if not causal:
        raise NotImplementedError("mha(causal=False) (K9) is not ported yet")
    if not q.is_cuda:
        return mha_causal_plain(q, k, v)
    B, H, T, D = q.shape
    if D != _HD:
        raise ValueError(f"mha: the kernel takes heads of {_HD}, got {D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(f"mha: {name}", t, BF16, (B, H, T, D), q.device)
    out = torch.empty_like(q)
    strides = (H * T * D, T * D, D)
    _attention_launch(build.ptr(q), build.ptr(k), build.ptr(v), out, B, H, T, strides, strides,
                      D**-0.5, True, 2, q.device)
    mha.launches += 1
    return out


mha.launches = 0
