"""CLIP attention kernels K2, K3, K4, K9 (port of
dream2real_tpu/ops/attention.py).

Each wrapper takes its plain PyTorch version for CPU tensors and launches
``csrc/attention.cu`` for CUDA tensors (or raises):

- ``mha_ln_qkv`` (K2): LN1 + qkv projection + bidirectional attention. On
  the card: ``ln_qkv`` (an LN pass that writes bf16(LN(x)), then the TMA +
  wgmma GEMM with the bias epilogue), then the K3 attention kernel.
- ``ln_rows``, ``ln_qkv``, ``ln_fc1`` (L1): every LayerNorm of both CLIP
  towers on the card, the row pass ``ln_rows`` alone (ln_pre, ln_post,
  ln_final) or as the prologue of the qkv GEMM (bias epilogue) or of fc1
  (bias + QuickGELU); ``layer_norm`` is their plain version.
- ``mha_qkv`` (K3): attention on a projection-layout qkv (B, T, 3W).
- ``mha(causal=True)`` (K4): causal head-split attention, text tower.
- ``mha(causal=False)`` (K9): bidirectional head-split attention with exact
  max-subtraction, the attention kernel addressed through head-split
  strides.
- ``head_attention``: the head-split launch in any softmax or probe mode,
  and ``proj_residual``: the out-projection GEMM with its bias + residual
  epilogue, rounded once; both serve the attention bench
  (``experiments/bench_attention.py``).
- ``linear_bias``, ``linear_bias_gelu``, ``linear_bias_then_resid``: the
  biased layers of both CLIP towers on the same GEMM, its f32 accumulators
  handed to an epilogue that rounds at the reference's places (qkv on the
  split path; fc1 with QuickGELU; the out-projection and fc2 with the
  residual add).

The attention kernel (every mode but ``exact``) works on blocks of 128 query
rows, two warpgroups of 64, against key tiles of 128 that TMA brings into a
ring in shared memory; scores and weights stay in registers between its two
wgmma products. ``launch_geometry`` is where its
grid, ring depth and shared memory are decided; the C launch function takes
them from there. K4 is a kernel of its own: for T <= 128 one tile of keys,
its scores and exact softmax in registers (mma.sync).

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
# Modes of the attention kernel (csrc/attention.cu).
MODES = {"clamp": 0, "maxsub": 1, "exact": 2, "nomax": 3, "probe_exp": 4, "probe_softmax": 5,
         "probe_matmul": 6}


def _maxsub() -> bool:
    return os.environ.get("D2R_ATTN_MAXSUB", "0") == "1"


def _check(name: str, t: torch.Tensor, dtype, shape, dev) -> None:
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous {dtype} tensor of shape {tuple(shape)} on {dev}, "
            f"got {tuple(t.shape)} {t.dtype} on {t.device}"
        )


# The attention kernel's tiles: query rows a block, keys a tile, bytes of one
# 128 x 64 bf16 tile (Q, K or V), and the most dynamic shared memory a block
# can ask for on an H100. Two blocks of a 3-stage ring fit one SM (228 KB less
# 1 KB a block) with 1,920 bytes to spare.
Q_ROWS, KEY_TILE, TILE_BYTES = 128, 128, 128 * 64 * 2
STAGES, BARRIER_BYTES = 3, 64  # the ring of K / V tiles and its full / empty barriers
SMEM_LIMIT = 232_448
# K4's kernel: 64 query rows a block, key tiles of 128, and its shared tiles
# (Q 64, K and V 128 rows of 72 bf16).
EXACT_Q_ROWS, EXACT_KEYS, EXACT_SMEM = 64, 128, (64 + 2 * 128) * 72 * 2


def launch_geometry(T: int, mode: int) -> dict:
    """Grid, ring depth and dynamic shared memory of an attention launch over
    T tokens in ``mode`` (a value of ``MODES``). ``grid_x`` blocks of
    ``q_rows`` query rows cover T; ``n_key_tiles`` tiles of ``key_tile`` keys
    cover T; the ring holds ``stages`` stages of one K and one V tile (a pass
    for the row max doubles the tile loads, ``n_jobs``); ``smem_bytes`` is
    the Q tile, the ring and its barriers. The exact mode (K4) has no
    ring; its key tiles are taken once for T <= 128 (one tile) and three
    times (row max, row sum, output) past it."""
    if T < 1:
        raise ValueError(f"attention needs at least one token, got T = {T}")
    if mode == MODES["exact"]:
        n_kt = -(-T // EXACT_KEYS)
        return {"q_rows": EXACT_Q_ROWS, "key_tile": EXACT_KEYS, "grid_x": -(-T // EXACT_Q_ROWS),
                "n_key_tiles": n_kt, "n_jobs": 1 if n_kt == 1 else 3 * n_kt, "stages": 0,
                "smem_bytes": EXACT_SMEM}
    n_kt = -(-T // KEY_TILE)
    n_jobs = 2 * n_kt if mode in (MODES["maxsub"], MODES["probe_softmax"]) else n_kt
    return {"q_rows": Q_ROWS, "key_tile": KEY_TILE, "grid_x": -(-T // Q_ROWS),
            "n_key_tiles": n_kt, "n_jobs": n_jobs, "stages": STAGES,
            "smem_bytes": TILE_BYTES + STAGES * 2 * TILE_BYTES + BARRIER_BYTES}


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
_ARGTYPES = {
    "d2r_attention": [_P] * 4 + [_I] * 3 + [_L] * 6 + [ctypes.c_float] + [_I] * 5 + [_P],
    "d2r_ln_rows": [_P] * 3 + [_I] * 2 + [ctypes.c_float] + [_P] * 2,
    "d2r_ln_gemm": [_P] * 6 + [_I] * 3 + [ctypes.c_float, _I] + [_P] * 3,
    "d2r_gemm": [_P] * 4 + [_I] * 4 + [_P] * 2,
}
_FNS: dict = {}


def _fn(name: str):
    """The launch function ``name`` of csrc/attention.cu, typed once."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(build.load("attention"), name)
        fn.argtypes, fn.restype = _ARGTYPES[name], ctypes.c_int
        _FNS[name] = fn
    return fn


def _attention_launch(q_ptr, k_ptr, v_ptr, out, B, H, T, strides, out_strides, scale,
                      causal: bool, mode: int, dev) -> None:
    geo = launch_geometry(T, mode)
    err = _fn("d2r_attention")(
        q_ptr, k_ptr, v_ptr, build.ptr(out), B, H, T, *strides, *out_strides, float(scale),
        int(causal), mode, geo["grid_x"], geo["stages"], geo["smem_bytes"], build.stream_ptr(dev))
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


def mha_qkv(qkv: torch.Tensor, n_heads: int, maxsub: bool | None = None) -> torch.Tensor:
    """K3 wrapper: bidirectional attention on projection-layout qkv
    (B, T, 3W) bf16 -> (B, T, W) bf16; scaling by hd**-0.5 inside. ``maxsub``
    None takes D2R_ATTN_MAXSUB; the attention bench names its mode."""
    if maxsub is None:
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


def _ln_params(who: str, g: torch.Tensor, b: torch.Tensor, K: int, dev) -> None:
    _check(f"{who}: ln_g", g, F32, (K,), dev)
    _check(f"{who}: ln_b", b, F32, (K,), dev)


def ln_rows(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A LayerNorm as one pass over the rows: x (..., K) bf16, g and b (K,)
    f32 -> bf16(LN(x)), the statistics in f32 and two-pass, each product
    rounded on its own as ``layer_norm`` rounds it (the row sums run in
    another order than torch's, so an output may lie one bf16 step from
    it). K % 8 == 0."""
    if not x.is_cuda:
        return layer_norm(x, g, b)
    K, dev = x.shape[-1], x.device
    if K % 8:
        raise ValueError(f"ln_rows: unsupported width {K}")
    _check("ln_rows: x", x, BF16, tuple(x.shape), dev)
    _ln_params("ln_rows", g, b, K, dev)
    out = torch.empty_like(x)
    err = _fn("d2r_ln_rows")(build.ptr(x), build.ptr(g), build.ptr(b), x.numel() // K, K, 1e-5,
                             build.ptr(out), build.stream_ptr(dev))
    build.check(err, "ln_rows")
    ln_rows.launches += 1
    return out


ln_rows.launches = 0


def mha_ln_qkv_plain(x, wqkv, bqkv, ln_g, ln_b, n_heads: int, maxsub: bool) -> torch.Tensor:
    """Plain version of K2: LN1 (f32) -> bf16, xn @ Wqkv + b -> bf16, then
    K3's attention."""
    xn = layer_norm(x.to(BF16), ln_g.to(F32), ln_b.to(F32))
    qkv = (dot_exact(xn, wqkv) + bqkv.to(F32)).to(BF16)
    return mha_qkv_plain(qkv, n_heads, maxsub)


def ln_qkv_plain(x, wqkv, bqkv, ln_g, ln_b) -> torch.Tensor:
    """Plain version of K2's first half: bf16(bf16(LN1(x)) @ Wqkv + b)."""
    xn = layer_norm(x.to(BF16), ln_g.to(F32), ln_b.to(F32))
    return (dot_exact(xn, wqkv) + bqkv.to(F32)).to(BF16)


def ln_qkv(x, wqkv, bqkv, ln_g, ln_b) -> torch.Tensor:
    """LN1 and the qkv projection (K2's first half; the split paths' qkv):
    x (..., W) bf16 -> qkv (..., N) bf16 = bf16(bf16(LN1(x)) @ wqkv + bqkv).
    On the card the row pass, then the GEMM with the bias epilogue. W % 64 ==
    0 and N % 128 == 0."""
    if not x.is_cuda:
        return ln_qkv_plain(x, wqkv, bqkv, ln_g, ln_b)
    out = _gemm(x, wqkv, bqkv, None, "bias", "ln_qkv", ln=(ln_g, ln_b))
    ln_qkv.launches += 1
    return out


ln_qkv.launches = 0


def ln_fc1_plain(x, w, b, ln_g, ln_b) -> torch.Tensor:
    """Plain version of ``ln_fc1``: fc1 and QuickGELU of bf16(LN2(x)), as
    ``linear_bias_gelu_plain`` rounds them."""
    return linear_bias_gelu_plain(layer_norm(x.to(BF16), ln_g.to(F32), ln_b.to(F32)), w, b)


def ln_fc1(x, w, b, ln_g, ln_b) -> torch.Tensor:
    """LN2, fc1 and QuickGELU of the towers' MLP: x (..., W) bf16, w (W, F)
    bf16, b (F,) f32 -> (..., F) bf16. On the card the row pass, then the
    GEMM with the bias + QuickGELU epilogue. W % 64 == 0 and F % 128 == 0."""
    if not x.is_cuda:
        return ln_fc1_plain(x, w, b, ln_g, ln_b)
    out = _gemm(x, w, b, None, "bias_gelu", "ln_fc1", ln=(ln_g, ln_b))
    ln_fc1.launches += 1
    return out


ln_fc1.launches = 0


def mha_ln_qkv(x, wqkv, bqkv, ln_g, ln_b, n_heads: int,
               maxsub: bool | None = None) -> torch.Tensor:
    """K2 wrapper. x (B, T, W) bf16 residual stream; wqkv (W, 3W) bf16;
    bqkv (3W,), ln_g/ln_b (W,) f32. -> (B, T, W) bf16 attention output
    before the out-projection. ``maxsub`` as in ``mha_qkv``."""
    if maxsub is None:
        maxsub = _maxsub()
    if not x.is_cuda:
        return mha_ln_qkv_plain(x, wqkv, bqkv, ln_g, ln_b, n_heads, maxsub)
    W = x.shape[-1]
    if x.dim() != 3 or W != n_heads * _HD or tuple(wqkv.shape) != (W, 3 * W):
        raise ValueError(f"mha_ln_qkv: unsupported width {W} / {n_heads} heads")
    qkv = ln_qkv(x, wqkv, bqkv, ln_g, ln_b)
    mha_ln_qkv.launches += 1
    return mha_qkv(qkv, n_heads, maxsub)


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


def mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version of K9: (B, H, T, D) bf16 -> the same. q scaled by
    D**-0.5 in bf16, p = bf16(exp(s - rowmax)), the row sum taken over the
    rounded p and 1/l applied to the f32 output before the bf16 cast."""
    D = q.shape[-1]
    qs = bf16_round(q.to(F32) * D**-0.5)
    s = dot_exact(qs, k.to(F32).transpose(-1, -2))
    p = bf16_round(torch.exp(s - s.amax(dim=-1, keepdim=True)))
    return (dot_exact(p, v.to(F32)) / p.sum(dim=-1, keepdim=True)).to(BF16)


def head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mode: str,
                   causal: bool = False) -> torch.Tensor:
    """Launch the attention kernel on head-split (B, H, T, D) bf16 CUDA
    tensors in one of ``MODES``; q is scaled by D**-0.5 as it is loaded. No
    plain version behind it: the callers (``mha`` and the attention bench's
    wrappers) hold theirs and count their launches."""
    if not q.is_cuda:
        raise ValueError("head_attention launches the CUDA kernel; it takes CUDA tensors")
    B, H, T, D = q.shape
    if D != _HD:
        raise ValueError(f"mha: the kernel takes heads of {_HD}, got {D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(f"mha: {name}", t, BF16, (B, H, T, D), q.device)
    out = torch.empty_like(q)
    strides = (H * T * D, T * D, D)
    _attention_launch(build.ptr(q), build.ptr(k), build.ptr(v), out, B, H, T, strides, strides,
                      D**-0.5, causal, MODES[mode], q.device)
    return out


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False) -> torch.Tensor:
    """Multi-head attention, (B, H, T, D) -> (B, H, T, D); scaling inside.
    Causal: K4 (text tower, exact softmax). Bidirectional: K9
    (max-subtraction, 1/l on the output). The reference pads the keys to a
    multiple of 128 and masks the padding; the kernel bounds its key loop at
    T instead, which gives the padded keys the same zero weight."""
    if not q.is_cuda:
        return mha_causal_plain(q, k, v) if causal else mha_plain(q, k, v)
    out = head_attention(q, k, v, "exact" if causal else "maxsub", causal)
    mha.launches += 1
    return out


mha.launches = 0


# ------------------------------------- the GEMM with f32 epilogues (X3, towers)

# Epilogues of csrc/attention.cu's GEMM (GemmEpi), on y = a @ W + b in f32.
EPILOGUES = {"bias": 0, "bias_resid": 1, "bias_gelu": 2, "bias_then_resid": 3}


def _gemm(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor, resid, epilogue: str,
          who: str, ln=None) -> torch.Tensor:
    """a (..., K) bf16 @ w (K, N) bf16 + b (N,) f32 through ``epilogue`` on
    the card -> (..., N) bf16; resid (..., N) bf16 for the residual
    epilogues. With ``ln``, a LayerNorm's gain and bias ((K,) f32), the row
    pass first writes bf16(LN(a)) once and the GEMM reads it in a's place.
    K % 64 == 0 and N % 128 == 0."""
    K, N = a.shape[-1], w.shape[-1]
    dev = a.device
    if K % 64 or N % 128:
        raise ValueError(f"{who}: unsupported widths {K} -> {N}")
    lead = tuple(a.shape[:-1])
    _check(f"{who}: a", a, BF16, (*lead, K), dev)
    _check(f"{who}: w", w, BF16, (K, N), dev)
    _check(f"{who}: b", b, F32, (N,), dev)
    if (resid is not None) != epilogue.endswith("resid"):
        raise ValueError(f"{who}: the {epilogue} epilogue and the residual given disagree")
    if resid is not None:
        _check(f"{who}: resid", resid, BF16, (*lead, N), dev)
    out = torch.empty(*lead, N, dtype=BF16, device=dev)
    args = (build.ptr(w), build.ptr(b), None if resid is None else build.ptr(resid),
            a.numel() // K, K, N)
    if ln is None:
        err = _fn("d2r_gemm")(build.ptr(a), *args, EPILOGUES[epilogue], build.ptr(out),
                              build.stream_ptr(dev))
    else:
        _ln_params(who, *ln, K, dev)
        xn = torch.empty_like(a)
        err = _fn("d2r_ln_gemm")(build.ptr(a), build.ptr(ln[0]), build.ptr(ln[1]), *args, 1e-5,
                                 EPILOGUES[epilogue], build.ptr(xn), build.ptr(out),
                                 build.stream_ptr(dev))
    build.check(err, f"gemm ({epilogue})")
    return out


def proj_residual_plain(a: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor,
                        x: torch.Tensor) -> torch.Tensor:
    """bf16(f32(x) + (a @ wo + bo)): the product and bias in f32, one
    rounding at the end."""
    return (x.to(F32) + (dot_exact(a, wo) + bo.to(F32))).to(BF16)


def proj_residual(a: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """The out-projection, bias and residual of the bench's fused block
    (v13) as one hand-written GEMM: a (B, T, W) bf16 attention output, wo
    (W, W) bf16, bo (W,) f32, x (B, T, W) bf16 residual stream ->
    bf16(x + a @ wo + bo), (B, T, W)."""
    if not a.is_cuda:
        return proj_residual_plain(a, wo, bo, x)
    out = _gemm(a, wo, bo, x, "bias_resid", "proj_residual")
    proj_residual.launches += 1
    return out


proj_residual.launches = 0


def linear_bias_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16(x @ w + b), the product and the bias in f32 (the reference's
    (jnp.dot(..., preferred_element_type=f32) + b).astype(bf16))."""
    return (dot_exact(x, w) + b.to(F32)).to(BF16)


def linear_bias(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A biased layer of the towers: x (..., K) bf16, w (K, N) bf16, b (N,)
    f32 -> bf16(x @ w + b), rounded once."""
    if not x.is_cuda:
        return linear_bias_plain(x, w, b)
    out = _gemm(x, w, b, None, "bias", "linear_bias")
    linear_bias.launches += 1
    return out


linear_bias.launches = 0


def linear_bias_gelu_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fc1 and QuickGELU as the reference's _mlp_block: h = bf16(x @ w + b),
    then h * bf16(sigmoid(1.702 h)) with the sigmoid in f32, in bf16."""
    h = linear_bias_plain(x, w, b)
    return h * torch.sigmoid(1.702 * h.to(F32)).to(BF16)


def linear_bias_gelu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fc1 + QuickGELU of the towers as one GEMM: x (..., K) bf16 -> (..., N)
    bf16, rounded where ``linear_bias_gelu_plain`` rounds."""
    if not x.is_cuda:
        return linear_bias_gelu_plain(x, w, b)
    out = _gemm(x, w, b, None, "bias_gelu", "linear_bias_gelu")
    linear_bias_gelu.launches += 1
    return out


linear_bias_gelu.launches = 0


def linear_bias_then_resid_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                                 resid: torch.Tensor) -> torch.Tensor:
    """resid + bf16(x @ w + b) in bf16: the layer rounds first, then the
    residual add rounds (the reference's x + (a @ W + b).astype(bf16))."""
    return resid + linear_bias_plain(x, w, b)


def linear_bias_then_resid(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           resid: torch.Tensor) -> torch.Tensor:
    """The towers' out-projection or fc2 and the residual add as one GEMM:
    x (..., K) bf16, resid (..., N) bf16 -> bf16(resid + bf16(x @ w + b))."""
    if not x.is_cuda:
        return linear_bias_then_resid_plain(x, w, b, resid)
    out = _gemm(x, w, b, resid, "bias_then_resid", "linear_bias_then_resid")
    linear_bias_then_resid.launches += 1
    return out


linear_bias_then_resid.launches = 0
