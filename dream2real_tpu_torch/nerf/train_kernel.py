"""Fused NeRF training kernels K5-K8 (port of dream2real_tpu/nerf/train_kernel.py).

Four wrappers, each launching its kernel from ``csrc/train.cu`` on CUDA
tensors and running its plain PyTorch version (``*_plain``, same arguments,
same results) on CPU tensors:

- ``density_sample`` (K5): coarse density pass over jittered samples, then
  ``n_draw`` SORTED inverse-CDF draws from a defensive-mixture proposal
  (``w + mix/(1-mix) * mean(w) + 1e-8``), the order-statistics trick on
  pre-drawn Exp(1) numbers. Stop-gradient.
- ``train_fwd`` (K6): per-ray origins, arbitrary sorted ``ts``; the full
  field and the front-to-back composite -> rgb, alpha, depth.
- ``train_bwd`` (K7): recompute-forward backward, the composite closed in one
  forward pass, ``dL/da_s = m T g - (G_total - P_s) / (1 - a_s + eps)``; the
  13 weight gradients, and origin/dir gradients of the geometric path only
  when asked (``d ts = 0``; the ``|d|``, SH and ts paths are dropped on
  purpose: CLAUDE.md's extrinsics note and
  experiments/results/extr_grad_ab.json).
- ``density_weights`` (K8): forward-only coarse composite weights (R, S).

``render_train_fused`` ties K6 and K7 into one ``torch.autograd.Function``
and ``render_rays_train`` is the training renderer (the reference's
function of the same name).

Weights are packed by ``pack_train_params``: every matrix (K x N) row-major
for ``x @ W`` in bf16, the transposes the backward multiplies by beside
them, f32 biases; the plain versions read that layout. The kernels stream
``wgmma_image``'s (the same matrices cut into the K-tiles their wgmma
products take, swizzled as shared memory holds them; K5 and K8 read its
first 32 jobs, the density trunk), and ``train_geometry`` is where their
tiles of (ray, sample) rows, K7's chunks of rays and its buffers are
decided. ``render_rays_train`` packs once and builds the image once a call,
for the sampler, K6 and K7 alike. Gradients come back in ``G_LAYOUT`` (the
forward matrices' layout, f32) and ``unpack_grads`` maps them to the
field's (in, out) parameters as the reference's ``_train_bwd`` does.

Numerics follow the reference: bf16 matmul inputs with f32 accumulation,
bf16 rounding between layers (h4 included), f32 trunc_exp / sigmoid /
composite; the encoding angle, encoded position and world position are
single-rounding fused multiply-adds (the plain versions emulate them in f64).
"""

from __future__ import annotations

import ctypes
import os

import torch

from dream2real_tpu_torch import build
from dream2real_tpu_torch.device import BF16, F32, bf16_round, dot_exact, f32_constant
from dream2real_tpu_torch.nerf.march_kernel import _fma, image_index, supports
from dream2real_tpu_torch.nerf.model import NGPConfig, NGPField, posenc_freqs, sh_encode_deg4
from dream2real_tpu_torch.nerf.render import RenderSettings, ray_aabb, sample_pdf
from dream2real_tpu_torch.parallel.mesh import uniform

# Packed bf16 matrices, (K x N) row-major, in csrc/train.cu's order: the
# forward ones, then the transposes the backward multiplies by.
W_LAYOUT = (
    ("w0", 64, 256),     # enc (63 + zero) -> h0
    ("w1", 256, 256),
    ("w2", 256, 256),
    ("w3", 320, 256),    # [enc 64 | h2 256] -> h3
    ("w4", 256, 16),     # h3 -> [sigma | geo 15]
    ("cw0", 32, 64),     # [sigma (zero row) | geo 15 | sh 16] -> c0
    ("cw1", 64, 64),
    ("cw2", 64, 16),     # -> rgb logits (3 used)
    ("w4t", 16, 256),
    ("w3t", 256, 320),
    ("w2t", 256, 256),
    ("w1t", 256, 256),
    ("w0t", 256, 64),
    ("cw2t", 16, 64),
    ("cw1t", 64, 64),
    ("cw0t", 64, 16),    # the [sigma | geo 15] columns of cw0^T
)
B_LAYOUT = (("b0", 256), ("b1", 256), ("b2", 256), ("b3", 256), ("b4", 16))
# f32 gradients, in the forward matrices' layout, then the biases.
G_LAYOUT = tuple((n, k, c) for n, k, c in W_LAYOUT[:8]) + tuple((n, 1, c) for n, c in B_LAYOUT)
N_W = sum(k * n for _, k, n in W_LAYOUT)
N_B = sum(n for _, n in B_LAYOUT)
N_G = sum(k * n for _, k, n in G_LAYOUT)

# K6 / K7 (csrc/train.cu, train_rows): the weight jobs in the order the
# products take them, each (matrix, first row, rows, first column, columns,
# ray gradients only): a K-tile of one layer, 128 or 64 columns wide, columns
# past the matrix zero. wgmma_image lays them out one after another, each as
# 64-column chunks of (rows x 128 bytes), 128-byte swizzled.
_K256 = range(0, 256, 64)
WGMMA_JOBS = (
    *(("w0", 0, 64, n0, 128, False) for n0 in (0, 128)),
    *((m, k0, 64, n0, 128, False) for m in ("w1", "w2") for n0 in (0, 128) for k0 in _K256),
    *(("w3", k0, 64, n0, 128, False) for n0 in (0, 128) for k0 in range(0, 320, 64)),
    *(("w4", k0, 64, 0, 64, False) for k0 in _K256),
    ("cw0", 0, 32, 0, 64, False), ("cw1", 0, 64, 0, 64, False), ("cw2", 0, 64, 0, 64, False),
    ("cw2t", 0, 16, 0, 64, False), ("cw1t", 0, 64, 0, 64, False), ("cw0t", 0, 64, 0, 64, False),
    *(("w4t", 0, 16, n0, 128, False) for n0 in (0, 128)),
    *(("w3t", k0, 64, 0, 64, True) for k0 in _K256),
    *(("w3t", k0, 64, 64 + n0, 128, False) for n0 in (0, 128) for k0 in _K256),
    *((m, k0, 64, n0, 128, False) for m in ("w2t", "w1t") for n0 in (0, 128) for k0 in _K256),
    *(("w0t", k0, 64, 0, 64, True) for k0 in _K256),
)
IMAGE_BYTES = sum(2 * rows * cols for _, _, rows, _, cols, _ in WGMMA_JOBS)
# K7's scratch: per 64-row block (one warpgroup's rows of a tile), 64-row x
# 64-column bf16 chunks, 128-byte swizzled: the activations, then the deltas.
SCRATCH_CHUNKS = (("enc", 1), ("h0", 4), ("h1", 4), ("h2", 4), ("h3", 4), ("cin", 1), ("c0", 1),
                  ("c1", 1), ("dc2", 1), ("dc1", 1), ("dc0", 1), ("dh4", 1), ("dh3", 4),
                  ("dh2", 4), ("dh1", 4), ("dh0", 4))
CHUNK_BYTES = 64 * 64 * 2
BLOCK_CHUNKS = sum(n for _, n in SCRATCH_CHUNKS)
N_BIAS = N_G - sum(k * n for _, k, n in W_LAYOUT[:8])  # one bias row: b0 .. b4
TILE_ROWS = 128  # rows of a tile: two warpgroups of 64


def train_geometry(n_rays: int, S: int, n_sm: int) -> dict:
    """Tiles, chunks and buffers of K5-K8 (the C launch functions check the
    first three). Rows are (ray, sample) pairs; a tile of ``TILE_ROWS``
    holds ``rays_per_tile`` whole rays of S samples, or, for S > 128, one
    ray's next 128 samples, walked in ``steps`` tiles by one block. A group
    is a tile's rays; K6 runs one block a group, K5 and K8 one block an SM
    (at most ``groups``) striding over the groups, K7 ``chunk_groups``
    groups (a tile per SM: the largest chunk one wave runs) at a time, each
    chunk's row pass then its weight-gradient products, over ``parts`` row
    ranges. The scratch, bias rows and part sums are sized by the chunk, not
    by ``n_rays``."""
    if S < 1:
        raise ValueError(f"the training kernels need at least one sample a ray, got {S}")
    if S <= TILE_ROWS:
        rpt, spt, steps = TILE_ROWS // S, S, 1
    else:
        rpt, spt, steps = 1, TILE_ROWS, -(-S // TILE_ROWS)
    groups = -(-n_rays // rpt)
    chunk_groups = max(1, min(groups, n_sm))
    parts = max(1, n_sm // 8)
    return {"rays_per_tile": rpt, "samples_per_tile": spt, "steps": steps, "groups": groups,
            "chunk_groups": chunk_groups, "n_chunks": -(-groups // chunk_groups), "parts": parts,
            "scratch_bytes": chunk_groups * steps * 2 * BLOCK_CHUNKS * CHUNK_BYTES,
            "bias_rows": chunk_groups * steps, "part_floats": parts * N_G}


_IMAGE_INDEX: dict = {}


def wgmma_image(w: torch.Tensor) -> torch.Tensor:
    """Packed bf16 weights (W_LAYOUT) -> the weight image K6 and K7 stream:
    WGMMA_JOBS one after another, IMAGE_BYTES in all."""
    idx = _IMAGE_INDEX.get(w.device)
    if idx is None:
        idx = _IMAGE_INDEX[w.device] = image_index(W_LAYOUT, WGMMA_JOBS).to(w.device)
    return torch.cat([w, w.new_zeros(1)])[idx]


def supports_training(cfg: NGPConfig) -> bool:
    """The kernels cover the flagship mlp field only (the march kernel's
    conditions, minus its n_fine gate)."""
    return supports(cfg, RenderSettings(n_fine=0))


def _split(flat: torch.Tensor, layout) -> dict[str, torch.Tensor]:
    out, off = {}, 0
    for name, k, n in layout:
        out[name] = flat[off : off + k * n].reshape(k, n)
        off += k * n
    return out


def _unpack(w: torch.Tensor, b: torch.Tensor):
    biases = _split(b, [(n, 1, c) for n, c in B_LAYOUT])
    return _split(w, W_LAYOUT), {n: v[0] for n, v in biases.items()}


@torch.no_grad()
def pack_train_params(p: dict[str, torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
    """Field parameters ({key: (in, out) tensor}) -> (w bf16 (N_W,), b f32 (N_B,))."""
    dev = p["trunk_w0"].device

    def zeros(*shape):
        return torch.zeros(shape, dtype=F32, device=dev)

    w3, cw0 = p["trunk_w3"], p["color_w0"]  # (319, 256) rows [h2 | enc]; (31, 64) [geo | sh]
    mats = {
        "w0": torch.cat([p["trunk_w0"], zeros(1, 256)]),
        "w1": p["trunk_w1"],
        "w2": p["trunk_w2"],
        "w3": torch.cat([w3[256:], zeros(1, 256), w3[:256]]),
        "w4": p["trunk_w4"],
        "cw0": torch.cat([zeros(1, 64), cw0]),
        "cw1": p["color_w1"],
        "cw2": torch.cat([p["color_w2"], zeros(64, 13)], dim=1),
    }
    for name in ("w4", "w3", "w2", "w1", "w0", "cw2", "cw1"):
        mats[name + "t"] = mats[name].t()
    mats["cw0t"] = mats["cw0"].t()[:, :16]
    for name, k, n in W_LAYOUT:
        assert mats[name].shape == (k, n), (name, mats[name].shape)
    w = torch.cat([mats[name].reshape(-1) for name, _, _ in W_LAYOUT]).to(BF16)
    b = torch.cat([p[f"trunk_b{i}"].reshape(-1) for i in range(5)]).to(F32)
    return w.contiguous(), b.contiguous()


def unpack_grads(g: torch.Tensor) -> dict[str, torch.Tensor]:
    """Flat G_LAYOUT gradients -> the field's (in, out) parameter gradients."""
    m = _split(g, G_LAYOUT)
    return {
        "trunk_w0": m["w0"][:63],
        "trunk_b0": m["b0"][0],
        "trunk_w1": m["w1"],
        "trunk_b1": m["b1"][0],
        "trunk_w2": m["w2"],
        "trunk_b2": m["b2"][0],
        "trunk_w3": torch.cat([m["w3"][64:], m["w3"][:63]]),
        "trunk_b3": m["b3"][0],
        "trunk_w4": m["w4"],
        "trunk_b4": m["b4"][0],
        "color_w0": m["cw0"][1:],
        "color_w1": m["cw1"],
        "color_w2": m["cw2"][:, :3],
    }


def field_box(cfg: NGPConfig, device) -> torch.Tensor:
    """(6,) f32 [aabb_min | aabb_max], the kernels' box argument (a shared
    constant: ``device.f32_constant``)."""
    return f32_constant(tuple(cfg.aabb_min) + tuple(cfg.aabb_max), device)


# ------------------------------------------------------------ plain versions
class _Geom:
    """Per-ray constants of the affine encoding: ang_s = A + B t_s."""

    def __init__(self, origins, dirs, box):
        n = dirs.shape[0]
        self.o, self.d = origins, dirs
        self.lo, self.hi = box[:3], box[3:]
        self.scale = 2.0 / (self.hi - self.lo)
        self.a3 = _fma(origins, self.scale, -2.0 * self.lo / (self.hi - self.lo) - 1.0)
        self.b3 = dirs * self.scale
        self.freqs = posenc_freqs(10, dirs.device)
        self.A = (self.a3[:, None, :] * self.freqs[None, :, None]).reshape(n, 30)
        self.B = (self.b3[:, None, :] * self.freqs[None, :, None]).reshape(n, 30)
        self.dn = torch.sqrt((dirs * dirs).sum(dim=-1))
        self.sh = bf16_round(sh_encode_deg4(dirs / self.dn[:, None]))
        self.zero = torch.zeros(n, 1, dtype=F32, device=dirs.device)

    def sample(self, t):
        """-> (enc (n, 64) bf16-rounded, angles (n, 30), inside (n,))."""
        ang = _fma(self.B, t[:, None], self.A)
        p2 = _fma(self.b3, t[:, None], self.a3)
        enc = bf16_round(torch.cat([p2, torch.sin(ang), torch.cos(ang), self.zero], dim=1))
        pos = _fma(self.d, t[:, None], self.o)
        inside = ((pos >= self.lo) & (pos <= self.hi)).all(dim=1)
        return enc, ang, inside


def _deltas(ts):
    return torch.cat([ts[:, 1:] - ts[:, :-1], torch.full_like(ts[:, :1], 1e2)], dim=1)


def _trunk(enc, mats, biases):
    """-> (h0, h1, h2, h3, h4), each bf16-rounded f32 (n, C)."""
    h0 = bf16_round(torch.relu(dot_exact(enc, mats["w0"]) + biases["b0"]))
    h1 = bf16_round(torch.relu(dot_exact(h0, mats["w1"]) + biases["b1"]))
    h2 = bf16_round(torch.relu(dot_exact(h1, mats["w2"]) + biases["b2"]))
    h3 = bf16_round(torch.relu(dot_exact(torch.cat([enc, h2], 1), mats["w3"]) + biases["b3"]))
    h4 = bf16_round(dot_exact(h3, mats["w4"]) + biases["b4"])
    return h0, h1, h2, h3, h4


def _colour(h4, sh, mats):
    """-> (rgb (n, 3), cin, c0, c1)."""
    cin = torch.cat([h4, sh], 1)  # [sigma | geo 15 | sh 16]; cw0's sigma row is zero
    c0 = bf16_round(torch.relu(dot_exact(cin, mats["cw0"])))
    c1 = bf16_round(torch.relu(dot_exact(c0, mats["cw1"])))
    return torch.sigmoid(dot_exact(c1, mats["cw2"])[:, :3]), cin, c0, c1


def _sigma(h4, inside):
    sigma = torch.exp(torch.clamp(h4[:, 0], -15.0, 15.0))
    return torch.where(inside, sigma, torch.zeros_like(sigma))


def _coarse_weights(origins, dirs, ts, box, w, b, min_transmittance):
    mats, biases = _unpack(w, b)
    geo = _Geom(origins, dirs, box)
    dl = _deltas(ts)
    trans = torch.ones(dirs.shape[0], dtype=F32, device=dirs.device)
    cols = []
    for s in range(ts.shape[1]):
        enc, _, inside = geo.sample(ts[:, s])
        sigma = _sigma(_trunk(enc, mats, biases)[4], inside)
        a = 1.0 - torch.exp(-sigma * dl[:, s] * geo.dn)
        cols.append(torch.where(trans < min_transmittance, torch.zeros_like(a), a * trans))
        trans = trans * (1.0 - a + 1e-10)
    return torch.stack(cols, dim=1)


@torch.no_grad()
def density_weights_plain(origins, dirs, ts, box, w, b, min_transmittance: float):
    """Plain version of K8. origins, dirs (R, 3); ts (R, S) sorted; box (6,)
    [lo | hi]; packed w, b -> composite weights (R, S) f32."""
    return _coarse_weights(origins, dirs, ts, box, w, b, min_transmittance)


@torch.no_grad()
def density_sample_plain(origins, dirs, ts_c, exp_draws, box, w, b, n_draw: int,
                         min_transmittance: float, mix: float):
    """Plain version of K5. ts_c (R, nc) sorted coarse positions; exp_draws
    (R, n_draw + 1) iid Exp(1) -> (R, n_draw) sorted positions in
    [ts_c[:, 0], ts_c[:, -1]]."""
    nc = ts_c.shape[1]
    wts = _coarse_weights(origins, dirs, ts_c, box, w, b, min_transmittance)
    w_mean = wts.sum(dim=1, keepdim=True) / nc
    w_def = wts + (mix / (1.0 - mix)) * w_mean + 1e-8
    cdf = torch.cumsum(w_def / w_def.sum(dim=1, keepdim=True), dim=1)
    cdf_lo = torch.cat([torch.zeros_like(cdf[:, :1]), cdf[:, :-1]], dim=1)
    mids = 0.5 * (ts_c[:, 1:] + ts_c[:, :-1])
    bin_lo = torch.cat([ts_c[:, :1], mids], dim=1)
    bin_hi = torch.cat([mids, ts_c[:, -1:]], dim=1)
    u = torch.cumsum(exp_draws[:, :n_draw], dim=1) / exp_draws.sum(dim=1, keepdim=True)
    # The bin with cdf_lo <= u < cdf (the first whose cdf exceeds u); u at
    # or past the last cdf clamps into the last bin.
    k = (cdf[:, None, :] <= u[:, :, None]).sum(dim=-1).clamp(max=nc - 1)
    lo, hi = bin_lo.gather(1, k), bin_hi.gather(1, k)
    clo, chi = cdf_lo.gather(1, k), cdf.gather(1, k)
    denom = torch.where(chi - clo < 1e-8, torch.ones_like(chi), chi - clo)
    return lo + (u - clo) / denom * (hi - lo)


@torch.no_grad()
def train_fwd_plain(origins, dirs, ts, box, w, b, min_transmittance: float):
    """Plain version of K6. -> rgb (R, 3) premultiplied linear, alpha (R,),
    depth (R,), f32."""
    mats, biases = _unpack(w, b)
    geo = _Geom(origins, dirs, box)
    dl = _deltas(ts)
    n = dirs.shape[0]
    trans = torch.ones(n, dtype=F32, device=dirs.device)
    acc_rgb = torch.zeros(n, 3, dtype=F32, device=dirs.device)
    acc_a = torch.zeros(n, dtype=F32, device=dirs.device)
    acc_d = torch.zeros(n, dtype=F32, device=dirs.device)
    for s in range(ts.shape[1]):
        enc, _, inside = geo.sample(ts[:, s])
        h4 = _trunk(enc, mats, biases)[4]
        rgb = _colour(h4, geo.sh, mats)[0]
        a = 1.0 - torch.exp(-_sigma(h4, inside) * dl[:, s] * geo.dn)
        wgt = torch.where(trans < min_transmittance, torch.zeros_like(a), a * trans)
        acc_rgb = acc_rgb + wgt[:, None] * rgb
        acc_a = acc_a + wgt
        acc_d = acc_d + wgt * ts[:, s]
        trans = trans * (1.0 - a + 1e-10)
    return acc_rgb, acc_a, acc_d


def _masked(act, delta):
    return torch.where(act > 0.0, delta, torch.zeros_like(delta))


@torch.no_grad()
def train_bwd_plain(origins, dirs, ts, box, w, b, min_transmittance: float,
                    dC, dA, dD, C, A_out, D, ray_grads: bool):
    """Plain version of K7: K7's own recompute-and-closed-form backward (not
    autograd through the forward, which would keep the |d|, SH and ts paths).
    dC (R, 3), dA (R,), dD (R,) cotangents of K6's outputs C, A_out, D.
    -> (grads (N_G,) f32 in G_LAYOUT, d origins (R, 3), d dirs (R, 3)); the
    ray gradients are zeros unless ray_grads."""
    mats, biases = _unpack(w, b)
    geo = _Geom(origins, dirs, box)
    dl = _deltas(ts)
    n = dirs.shape[0]
    dev = dirs.device
    G = {name: torch.zeros(k, c, dtype=F32, device=dev) for name, k, c in G_LAYOUT}
    d_o = torch.zeros(n, 3, dtype=F32, device=dev)
    d_d = torch.zeros(n, 3, dtype=F32, device=dev)
    g_total = (dC * C).sum(dim=1) + dA * A_out + dD * D
    trans = torch.ones(n, dtype=F32, device=dev)
    P = torch.zeros(n, dtype=F32, device=dev)
    for s in range(ts.shape[1]):
        t = ts[:, s]
        enc, ang, inside = geo.sample(t)
        h0, h1, h2, h3, h4 = _trunk(enc, mats, biases)
        rgb, cin, c0, c1 = _colour(h4, geo.sh, mats)
        sigma = _sigma(h4, inside)
        a = 1.0 - torch.exp(-sigma * dl[:, s] * geo.dn)
        m = (trans >= min_transmittance).to(F32)
        wgt = m * a * trans
        g = (dC * rgb).sum(dim=1) + dA + dD * t
        P = P + wgt * g
        U = g_total - P
        one_m_a = 1.0 - a
        ratio = one_m_a / torch.clamp(one_m_a, min=1e-10)
        dsigma = dl[:, s] * geo.dn * (m * trans * g * one_m_a - U * ratio)
        dx_sigma = dsigma * sigma  # trunc_exp's gradient is y * dx

        dc2 = torch.zeros(n, 16, dtype=F32, device=dev)
        dc2[:, :3] = wgt[:, None] * dC * rgb * (1.0 - rgb)
        dc2 = bf16_round(dc2)
        G["cw2"] += dot_exact(c1.t(), dc2)
        dc1 = bf16_round(_masked(c1, dot_exact(dc2, mats["cw2t"])))
        G["cw1"] += dot_exact(c0.t(), dc1)
        dc0 = bf16_round(_masked(c0, dot_exact(dc1, mats["cw1t"])))
        G["cw0"] += dot_exact(cin.t(), dc0)
        dcin = dot_exact(dc0, mats["cw0t"])  # (n, 16): column 0 unused

        dh4f = torch.cat([dx_sigma[:, None], dcin[:, 1:16]], dim=1)
        dh4 = bf16_round(dh4f)
        G["w4"] += dot_exact(h3.t(), dh4)
        G["b4"] += dh4f.sum(dim=0)
        dh3 = _masked(h3, dot_exact(dh4, mats["w4t"]))
        G["b3"] += dh3.sum(dim=0)
        dh3 = bf16_round(dh3)
        G["w3"] += dot_exact(torch.cat([enc, h2], 1).t(), dh3)
        dhcat = dot_exact(dh3, mats["w3t"])  # (n, 320): [enc 64 | h2 256]
        dh2 = _masked(h2, dhcat[:, 64:])
        G["b2"] += dh2.sum(dim=0)
        dh2 = bf16_round(dh2)
        G["w2"] += dot_exact(h1.t(), dh2)
        dh1 = _masked(h1, dot_exact(dh2, mats["w2t"]))
        G["b1"] += dh1.sum(dim=0)
        dh1 = bf16_round(dh1)
        G["w1"] += dot_exact(h0.t(), dh1)
        dh0 = _masked(h0, dot_exact(dh1, mats["w1t"]))
        G["b0"] += dh0.sum(dim=0)
        dh0 = bf16_round(dh0)
        G["w0"] += dot_exact(enc.t(), dh0)
        trans = trans * (1.0 - a + 1e-10)
        if not ray_grads:
            continue
        # enc columns [p2 3 | sin 30 | cos 30 | 0]; the bf16 cast is treated
        # as the identity.
        denc = dot_exact(dh0, mats["w0t"]) + dhcat[:, :64]
        dang = denc[:, 3:33] * torch.cos(ang) - denc[:, 33:63] * torch.sin(ang)
        dp2 = denc[:, 0:3]
        for j in range(10):
            dp2 = dp2 + geo.freqs[j] * dang[:, 3 * j : 3 * j + 3]
        dpos = dp2 * geo.scale
        d_o = d_o + dpos
        d_d = d_d + dpos * t[:, None]
    flat = torch.cat([G[name].reshape(-1) for name, _, _ in G_LAYOUT])
    return flat, d_o, d_d


# ------------------------------------------------------------------ wrappers
def _check(name, tensors):
    for arg, t, dtype, shape in tensors:
        if (t.device != tensors[0][1].device or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"{name}: {arg} must be a contiguous {dtype} tensor of shape {shape} on "
                f"{tensors[0][1].device}, got {tuple(t.shape)} {t.dtype} on {t.device}")


def _ray_args(name, origins, dirs, ts, box, w, b, extra=(), n_w=N_W):
    n, S = ts.shape
    _check(name, [
        ("dirs", dirs, F32, (n, 3)), ("origins", origins, F32, (n, 3)), ("ts", ts, F32, (n, S)),
        ("box", box, F32, (6,)), ("w", w, BF16, (n_w,)), ("b", b, F32, (N_B,)), *extra])
    return n, S


def _fn(symbol, argtypes):
    fn = getattr(build.load("train"), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _image(w):
    """Packed w -> the training kernels' weight image (``wgmma_image``),
    checked against the size the C side streams."""
    if _fn("d2r_train_image_bytes", [])() != IMAGE_BYTES:
        raise RuntimeError("csrc/train.cu and WGMMA_JOBS disagree on the weight image")
    return wgmma_image(w)


def _density_launch(name, origins, dirs, ts, box, img, b, extra=()):
    """K5's or K8's arguments checked, and their rows: (n, S, train_geometry's
    rays_per_tile, samples_per_tile and steps, blocks: one an SM at most)."""
    n, S = _ray_args(name, origins, dirs, ts, box, img, b, extra, n_w=IMAGE_BYTES // 2)
    n_sm = _sm_count(dirs.device)
    geo = train_geometry(n, S, n_sm)
    return (n, S, geo["rays_per_tile"], geo["samples_per_tile"], geo["steps"],
            min(geo["groups"], n_sm))


def density_weights(origins, dirs, ts, box, w, b, min_transmittance: float):
    """K8 wrapper: same arguments and result as ``density_weights_plain``."""
    if not dirs.is_cuda:
        return density_weights_plain(origins, dirs, ts, box, w, b, min_transmittance)
    _ray_args("density_weights", origins, dirs, ts, box, w, b)
    return _density_weights_launch(origins, dirs, ts, box, _image(w), b, min_transmittance)


def _density_weights_launch(origins, dirs, ts, box, img, b, min_transmittance: float):
    """K8 on the weight image ``img`` (``_image``; its first 32 jobs, the
    density trunk) of CUDA tensors."""
    n, S, rpt, spt, steps, grid = _density_launch("density_weights", origins, dirs, ts, box,
                                                  img, b)
    out = torch.empty(n, S, dtype=F32, device=dirs.device)
    err = _fn("d2r_density_weights", [_P] * 3 + [_I, _I] + [_P] * 3 + [_F] + [_I] * 4
              + [_P, _P])(
        build.ptr(origins), build.ptr(dirs), build.ptr(ts), n, S, build.ptr(box), build.ptr(img),
        build.ptr(b), float(min_transmittance), rpt, spt, steps, grid, build.ptr(out),
        build.stream_ptr(dirs.device))
    build.check(err, "density_weights")
    density_weights.launches += 1
    return out


density_weights.launches = 0


def density_sample(origins, dirs, ts_c, exp_draws, box, w, b, n_draw: int,
                   min_transmittance: float, mix: float):
    """K5 wrapper: same arguments and result as ``density_sample_plain``."""
    if not dirs.is_cuda:
        return density_sample_plain(origins, dirs, ts_c, exp_draws, box, w, b, n_draw,
                                    min_transmittance, mix)
    _ray_args("density_sample", origins, dirs, ts_c, box, w, b)
    return _density_sample_launch(origins, dirs, ts_c, exp_draws, box, _image(w), b, n_draw,
                                  min_transmittance, mix)


def _density_sample_launch(origins, dirs, ts_c, exp_draws, box, img, b, n_draw: int,
                           min_transmittance: float, mix: float):
    """K5 on the weight image ``img`` of CUDA tensors."""
    nc = ts_c.shape[1]
    if not 2 <= nc <= 64:
        raise ValueError(f"density_sample: the kernel takes 2 to 64 coarse samples, got {nc}")
    n, _, rpt, spt, steps, grid = _density_launch(
        "density_sample", origins, dirs, ts_c, box, img, b,
        [("exp_draws", exp_draws, F32, (ts_c.shape[0], n_draw + 1))])
    out = torch.empty(n, n_draw, dtype=F32, device=dirs.device)
    err = _fn("d2r_density_sample", [_P] * 4 + [_I] * 3 + [_P] * 3 + [_F, _F] + [_I] * 4
              + [_P, _P])(
        build.ptr(origins), build.ptr(dirs), build.ptr(ts_c), build.ptr(exp_draws), n, nc,
        n_draw, build.ptr(box), build.ptr(img), build.ptr(b), float(min_transmittance),
        float(mix / (1.0 - mix)), rpt, spt, steps, grid, build.ptr(out),
        build.stream_ptr(dirs.device))
    build.check(err, "density_sample")
    density_sample.launches += 1
    return out


density_sample.launches = 0


def train_fwd(origins, dirs, ts, box, w, b, min_transmittance: float):
    """K6 wrapper: same arguments and results as ``train_fwd_plain``."""
    if not dirs.is_cuda:
        return train_fwd_plain(origins, dirs, ts, box, w, b, min_transmittance)
    _ray_args("train_fwd", origins, dirs, ts, box, w, b)
    return _train_fwd_launch(origins, dirs, ts, box, _image(w), b, min_transmittance)


def _train_fwd_launch(origins, dirs, ts, box, img, b, min_transmittance: float):
    """K6 on the weight image ``img`` (``_image``) of CUDA tensors."""
    n, S = _ray_args("train_fwd", origins, dirs, ts, box, img, b, n_w=IMAGE_BYTES // 2)
    dev = dirs.device
    geo = train_geometry(n, S, _sm_count(dev))
    rgb = torch.empty(n, 3, dtype=F32, device=dev)
    alpha = torch.empty(n, dtype=F32, device=dev)
    depth = torch.empty(n, dtype=F32, device=dev)
    err = _fn("d2r_train_fwd", [_P] * 3 + [_I, _I] + [_P] * 3 + [_F] + [_I] * 3 + [_P] * 4)(
        build.ptr(origins), build.ptr(dirs), build.ptr(ts), n, S, build.ptr(box), build.ptr(img),
        build.ptr(b), float(min_transmittance), geo["rays_per_tile"], geo["samples_per_tile"],
        geo["steps"], build.ptr(rgb), build.ptr(alpha), build.ptr(depth), build.stream_ptr(dev))
    build.check(err, "train_fwd")
    train_fwd.launches += 1
    return rgb, alpha, depth


train_fwd.launches = 0


def train_bwd(origins, dirs, ts, box, w, b, min_transmittance: float,
              dC, dA, dD, C, A_out, D, ray_grads: bool):
    """K7 wrapper: same arguments and results as ``train_bwd_plain``. The
    rays go in chunks of ``train_geometry``'s ``chunk_groups`` tiles: each
    chunk's row pass writes its activations and deltas to a scratch, then
    the weight-gradient products add the chunk to ``parts`` f32 sums, which
    a last pass adds up in a fixed order, so the gradients are the same from
    run to run and do not depend on ``ray_grads``."""
    if not dirs.is_cuda:
        return train_bwd_plain(origins, dirs, ts, box, w, b, min_transmittance,
                               dC, dA, dD, C, A_out, D, ray_grads)
    _ray_args("train_bwd", origins, dirs, ts, box, w, b)
    return _train_bwd_launch(origins, dirs, ts, box, _image(w), b, min_transmittance,
                             dC, dA, dD, C, A_out, D, ray_grads)


def _train_bwd_launch(origins, dirs, ts, box, img, b, min_transmittance: float,
                      dC, dA, dD, C, A_out, D, ray_grads: bool, bufs=None):
    """K7 on the weight image ``img`` of CUDA tensors, with ``bwd_buffers``
    of its geometry (allocated here unless given)."""
    R = ts.shape[0]
    n, S = _ray_args("train_bwd", origins, dirs, ts, box, img, b, [
        ("dC", dC, F32, (R, 3)), ("dA", dA, F32, (R,)), ("dD", dD, F32, (R,)),
        ("C", C, F32, (R, 3)), ("A", A_out, F32, (R,)), ("D", D, F32, (R,))],
        n_w=IMAGE_BYTES // 2)
    dev = dirs.device
    geo = train_geometry(n, S, _sm_count(dev))
    bufs = bwd_buffers(geo, dev) if bufs is None else bufs
    grads = torch.empty(N_G, dtype=F32, device=dev)
    d_o = torch.zeros(n, 3, dtype=F32, device=dev)
    d_d = torch.zeros(n, 3, dtype=F32, device=dev)
    err = _fn("d2r_train_bwd", [_P] * 3 + [_I, _I] + [_P] * 3 + [_F] + [_P] * 6 + [_I] * 6
              + [_P] * 7)(
        build.ptr(origins), build.ptr(dirs), build.ptr(ts), n, S, build.ptr(box), build.ptr(img),
        build.ptr(b), float(min_transmittance), build.ptr(dC), build.ptr(dA), build.ptr(dD),
        build.ptr(C), build.ptr(A_out), build.ptr(D), int(bool(ray_grads)),
        geo["rays_per_tile"], geo["samples_per_tile"], geo["steps"], geo["chunk_groups"],
        geo["parts"], build.ptr(bufs["scratch"]), build.ptr(bufs["bias_rows"]),
        build.ptr(bufs["part"]), build.ptr(grads), build.ptr(d_o), build.ptr(d_d),
        build.stream_ptr(dev))
    build.check(err, "train_bwd")
    train_bwd.launches += 1
    train_bwd.ray_grad_launches += bool(ray_grads)  # the launches that fill d_o, d_d
    if n > 0:
        train_bwd.row_pass_launches += geo["n_chunks"]
        train_bwd.weight_grad_launches += geo["n_chunks"]
    return grads, d_o, d_d


def bwd_buffers(geo: dict, dev) -> dict:
    """K7's chunk-sized buffers for ``geo``: the scratch of activations and
    deltas, the tiles' bias rows, the parts' weight sums."""
    return {"scratch": torch.empty(geo["scratch_bytes"], dtype=torch.uint8, device=dev),
            "bias_rows": torch.empty(geo["bias_rows"], N_BIAS, dtype=F32, device=dev),
            "part": torch.empty(geo["part_floats"], dtype=F32, device=dev)}


def scratch_rows(scratch: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """The first n_blocks 64-row blocks of K7's scratch as one f32 (64
    n_blocks, 64 BLOCK_CHUNKS) matrix: a row's activations and deltas in
    SCRATCH_CHUNKS' column order."""
    raw = scratch[: n_blocks * BLOCK_CHUNKS * CHUNK_BYTES].view(torch.bfloat16)
    raw = raw.reshape(n_blocks, BLOCK_CHUNKS, 64 * 64)
    r = torch.arange(64, device=scratch.device)[:, None]
    c = torch.arange(64, device=scratch.device)[None, :]
    pos = (r * 64 + (((c // 8) ^ (r % 8)) * 8) + c % 8).reshape(-1)
    m = raw[:, :, pos].reshape(n_blocks, BLOCK_CHUNKS, 64, 64)
    return m.permute(0, 2, 1, 3).reshape(n_blocks * 64, BLOCK_CHUNKS * 64).to(F32)


def weight_grads_plain(rows: torch.Tensor) -> torch.Tensor:
    """Plain version of K7's weight-gradient products: every dW = act^T
    delta (f32) over the rows of ``scratch_rows``, in G_LAYOUT without the
    biases."""
    cols, off = {}, 0
    for name, n in SCRATCH_CHUNKS:
        cols[name] = rows[:, 64 * off: 64 * (off + n)]
        off += n
    prods = (
        (cols["enc"], cols["dh0"]), (cols["h0"], cols["dh1"]), (cols["h1"], cols["dh2"]),
        (torch.cat([cols["enc"], cols["h2"]], 1), cols["dh3"]), (cols["h3"], cols["dh4"][:, :16]),
        (cols["cin"][:, :32], cols["dc0"]), (cols["c0"], cols["dc1"]),
        (cols["c1"], cols["dc2"][:, :16]))
    return torch.cat([(a.t() @ d).reshape(-1) for a, d in prods])


# Launches of K7 and of its two parts (the row pass, the weight-gradient
# products: one of each a chunk).
train_bwd.launches = train_bwd.row_pass_launches = train_bwd.weight_grad_launches = 0
train_bwd.ray_grad_launches = 0


# ------------------------------------------------------- autograd + renderer
_PARAM_KEYS = ("trunk_w0", "trunk_b0", "trunk_w1", "trunk_b1", "trunk_w2", "trunk_b2",
               "trunk_w3", "trunk_b3", "trunk_w4", "trunk_b4", "color_w0", "color_w1",
               "color_w2")


class _RenderTrainFused(torch.autograd.Function):
    """K6 forward, K7 backward, both on the packed weights ``wk`` (the weight
    image on CUDA, ``pack_train_params``' w on the CPU) and biases ``b``
    that the caller made once; the forward saves its outputs. The backward
    returns the field's (in, out) gradients, zeros for ts, and zeros for the
    rays unless need_ray_grads. CPU tensors take the plain versions."""

    @staticmethod
    def forward(ctx, origins, dirs, ts, box, min_transmittance, need_ray_grads, wk, b, *params):
        fwd = _train_fwd_launch if dirs.is_cuda else train_fwd_plain
        rgb, alpha, depth = fwd(origins, dirs, ts, box, wk, b, min_transmittance)
        ctx.save_for_backward(origins, dirs, ts, box, wk, b, rgb, alpha, depth)
        ctx.min_transmittance = min_transmittance
        ctx.need_ray_grads = need_ray_grads
        return rgb, alpha, depth

    @staticmethod
    def backward(ctx, g_rgb, g_alpha, g_depth):
        origins, dirs, ts, box, wk, b, rgb, alpha, depth = ctx.saved_tensors
        cots = [torch.zeros_like(o) if g is None else g.contiguous()
                for g, o in ((g_rgb, rgb), (g_alpha, alpha), (g_depth, depth))]
        bwd = _train_bwd_launch if dirs.is_cuda else train_bwd_plain
        grads, d_o, d_d = bwd(origins, dirs, ts, box, wk, b, ctx.min_transmittance,
                              *cots, rgb, alpha, depth, ctx.need_ray_grads)
        per_param = unpack_grads(grads)
        return (d_o, d_d, torch.zeros_like(ts), None, None, None, None, None,
                *(per_param[k] for k in _PARAM_KEYS))


def _packed(field: NGPField, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The field's weights as the kernels read them, made once: (the weight
    image on CUDA, the packed w on the CPU; the biases)."""
    w, b = pack_train_params(field.params())
    return (_image(w) if device.type == "cuda" else w), b


def render_train_fused(field: NGPField, origins, dirs, ts, min_transmittance: float = 1e-4,
                       need_ray_grads: bool = True, packed=None) -> dict[str, torch.Tensor]:
    """Differentiable fused training render. origins/dirs (R, 3) world (dirs
    z-normalized, not unit); ts (R, S) sorted (constants in the backward).
    -> rgb (R, 3) premultiplied linear, alpha (R,), depth (R,).

    need_ray_grads=False (extrinsics frozen) skips the origin/dir chain in
    K7 and returns zero ray gradients; parameter gradients are bit-identical
    either way. ``packed``: the field's current weights as ``_packed`` makes
    them, when the caller has them already."""
    p = field.params()
    wk, b = _packed(field, dirs.device) if packed is None else packed
    rgb, alpha, depth = _RenderTrainFused.apply(
        origins.to(F32).contiguous(), dirs.to(F32).contiguous(), ts.to(F32).contiguous(),
        field_box(field.cfg, dirs.device), float(min_transmittance), bool(need_ray_grads), wk, b,
        *(p[k] for k in _PARAM_KEYS))
    return {"rgb": rgb, "alpha": alpha, "depth": depth}


def fused_sampler_default() -> bool:
    """D2R_FUSED_SAMPLER (default 1): K5's in-kernel sampler."""
    return os.environ.get("D2R_FUSED_SAMPLER", "1") == "1"


def sampler_mix_default() -> float:
    """D2R_SAMPLER_MIX (default 0.5): K5's uniform share of the proposal."""
    return float(os.environ.get("D2R_SAMPLER_MIX", "0.5"))


def coarse_samples(cfg: NGPConfig, origins, dirs, settings: RenderSettings,
                   generator: torch.Generator | None = None):
    """The coarse samples of flat rays over the field's box: n_coarse strata
    of [max(t0, near), min(t1, far)], at their midpoints or jittered within
    them from ``generator``. -> (ts_c (R, n_coarse), valid (R,)); a ray that
    misses gets a 1e-3 range at its entry."""
    t0, t1 = ray_aabb(origins, dirs, cfg.aabb_min, cfg.aabb_max)
    t0 = torch.clamp(t0, min=settings.near)
    t1 = torch.clamp(t1, max=settings.far)
    valid = t1 > t0
    t1 = torch.where(valid, t1, t0 + 1e-3)
    nc = settings.n_coarse
    frac = (torch.arange(nc, dtype=F32, device=dirs.device) + 0.5) / nc
    if generator is not None:
        jitter = uniform(generator, (origins.shape[0], nc), dirs.device)
        frac = frac + (jitter - 0.5) / nc
    return (t0[:, None] + (t1 - t0)[:, None] * frac).contiguous(), valid


def exp_draws(n_rays: int, n_draw: int, generator: torch.Generator, device) -> torch.Tensor:
    """(n_rays, n_draw + 1) iid Exp(1) numbers, -log of U[1e-12, 1), K5's input."""
    u = uniform(generator, (n_rays, n_draw + 1), device)
    return -torch.log(1e-12 + (1.0 - 1e-12) * u)


def render_rays_train(field: NGPField, origins, dirs, settings: RenderSettings,
                      generator: torch.Generator | None = None,
                      need_ray_grads: bool = True) -> dict[str, torch.Tensor]:
    """The fused-kernel training render of flat (R, 3) rays over the field's
    box, with hierarchical sampling; -> rgb / alpha / depth.

    With a generator and n_fine > 0 the default sampler is K5's
    defensive mixture (D2R_FUSED_SAMPLER=1, mix D2R_SAMPLER_MIX): n_coarse +
    n_fine draws replace the coarse samples, a deliberately different sample
    distribution from render_rays'. D2R_FUSED_SAMPLER=0, or no generator,
    takes render_rays' sampling: K8's coarse weights, sample_pdf, the sorted
    union. Sampling is stop-gradient either way."""
    cfg = field.cfg
    origins = origins.to(F32).contiguous()
    dirs = dirs.to(F32).contiguous()
    dev = dirs.device
    ts_c, valid = coarse_samples(cfg, origins.detach(), dirs.detach(), settings, generator)

    packed = _packed(field, dev)  # one pack (and on CUDA one image) for the sampler, K6, K7
    if settings.n_fine > 0:
        wk, b = packed
        box = field_box(cfg, dev)
        o_sg, d_sg = origins.detach(), dirs.detach()
        if generator is not None and fused_sampler_default():
            n_draw = settings.n_coarse + settings.n_fine
            draws = exp_draws(origins.shape[0], n_draw, generator, dev)
            sample = _density_sample_launch if dirs.is_cuda else density_sample_plain
            ts_all = sample(o_sg, d_sg, ts_c, draws, box, wk, b, n_draw,
                            settings.min_transmittance, sampler_mix_default())
        else:
            weights = _density_weights_launch if dirs.is_cuda else density_weights_plain
            w_c = weights(o_sg, d_sg, ts_c, box, wk, b, settings.min_transmittance)
            ts_f = sample_pdf(ts_c, w_c, settings.n_fine, generator)
            ts_all = torch.sort(torch.cat([ts_c, ts_f], dim=-1), dim=-1).values
    else:
        ts_all = ts_c

    out = render_train_fused(field, origins, dirs, ts_all.contiguous(),
                             settings.min_transmittance, need_ray_grads, packed)
    zero = torch.zeros_like(out["alpha"])
    return {
        "rgb": torch.where(valid[:, None], out["rgb"], torch.zeros_like(out["rgb"])),
        "alpha": torch.where(valid, out["alpha"], zero),
        "depth": torch.where(valid, out["depth"], zero),
    }
