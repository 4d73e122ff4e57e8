"""The flagship NeRF field and its volume rendering, plainly (Mildenhall et
al., arXiv:2003.08934, with instant-ngp's truncated-exp density, SH view
encoding and transmittance cut).

The field: positions normalised to the box's [-1, 1], the frequency
encoding [p, sin(2^j pi p), cos(2^j pi p)] (10 bands, band-major), a ReLU
trunk of 5 layers with the encoding concatenated again before layer 3, its
last layer giving the log-density and 15 geometry features, then a colour
head of 3 bias-free layers on [geometry, degree-4 real SH of the view
direction] ending in a sigmoid. Density is zero outside the box.

The configuration's numerics come in the three forms its paths state:

- ``Field.__call__`` / ``density`` (full views and the free-space samples):
  the encoding of the normalised position, each layer's output rounded
  (biases rounded too), the density from the rounded last layer;
- ``Field.ray_samples`` with ``head="train"`` (the training render and its
  sampler): per-ray affine encoding, sample position and angles as
  single-rounding fused multiply-adds, float32 biases, the colour head's
  last layer not rounded;
- ``head="march"`` (the imagined object's render): the same trunk, the
  geometry columns of the last trunk layer folded into the colour head's
  first layer (their product rounded once as a weight), the density read
  unrounded from the folded head.

Rendering: directions are z-normalised (t is z-depth; metric steps use
|d|); each sample's opacity 1 - exp(-sigma delta |d|), the last delta 1e2;
weights alpha T, zero where T fell below the transmittance cut; rgb
premultiplied, depth the weighted sum of t.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.precision import F32, Precision


class _TruncExp(torch.autograd.Function):
    """exp(clamp(x, -15, 15)) whose gradient is exp(...) * dy everywhere."""

    @staticmethod
    def forward(ctx, x):
        y = torch.exp(torch.clamp(x, -15.0, 15.0))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, dy):
        (y,) = ctx.saved_tensors
        return dy * y


def trunc_exp(x):
    return _TruncExp.apply(x)


def fma(a, b, c):
    """a * b + c rounded once to float32."""
    return (a.double() * b.double() + c.double()).to(F32)


def sh4(d: torch.Tensor) -> torch.Tensor:
    """Real spherical harmonics up to degree 4 of unit directions (..., 3)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814), -0.48860251190291987 * y,
        0.48860251190291987 * z, -0.48860251190291987 * x, 1.0925484305920792 * x * y,
        -1.0925484305920792 * y * z, 0.94617469575755997 * zz - 0.31539156525251999,
        -1.0925484305920792 * x * z, 0.54627421529603959 * (xx - yy),
        0.59004358992664352 * y * (-3.0 * xx + yy), 2.8906114426405538 * x * y * z,
        0.45704579946446572 * y * (1.0 - 5.0 * zz), 0.3731763325901154 * z * (5.0 * zz - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * zz), 1.4453057213202769 * z * (xx - yy),
        0.59004358992664352 * x * (-xx + 3.0 * yy),
    ], dim=-1)


class Field:
    """The field's weights (a dict under the benchmark's names, float32) and
    box, computed in ``prec``."""

    def __init__(self, weights: dict, cfg: dict, prec: Precision):
        self.w = weights
        self.cfg = cfg
        self.prec = prec
        dev = next(iter(weights.values())).device
        self.lo = torch.tensor(cfg["aabb_min"], dtype=F32, device=dev)
        self.hi = torch.tensor(cfg["aabb_max"], dtype=F32, device=dev)
        self.freqs = (2.0 ** torch.arange(cfg["posenc_deg"], dtype=F32, device=dev)) * math.pi

    # ---------------------------------------------------------- full views

    def density(self, pos):
        """-> (sigma, geometry features) at world positions (..., 3)."""
        r = self.prec.rnd
        p = (pos - self.lo) / (self.hi - self.lo) * 2.0 - 1.0
        flat = (p[..., None, :] * self.freqs[:, None]).flatten(-2)
        enc = r(torch.cat([p, torch.sin(flat), torch.cos(flat)], dim=-1))
        h = enc
        depth, skip = self.cfg["mlp_depth"], self.cfg["skip_layer"]
        for i in range(depth):
            if skip and i == skip:
                h = torch.cat([h, enc], dim=-1)
            h = self.prec.mm(h, self.w[f"trunk_w{i}"]) + r(self.w[f"trunk_b{i}"])
            h = r(torch.relu(h) if i < depth - 1 else h)
        sigma = trunc_exp(h[..., 0])
        inside = ((pos >= self.lo) & (pos <= self.hi)).all(dim=-1)
        return torch.where(inside, sigma, torch.zeros_like(sigma)), h[..., 1:]

    def __call__(self, pos, unit_dirs):
        """-> (sigma, linear rgb)."""
        sigma, geo = self.density(pos)
        x = torch.cat([geo, self.prec.rnd(sh4(unit_dirs))], dim=-1)
        n = self.cfg["n_color_layers"]
        for i in range(n):
            x = self.prec.rnd(self.prec.mm(x, self.w[f"color_w{i}"]))
            if i < n - 1:
                x = torch.relu(x)
        return sigma, torch.sigmoid(x)

    # ---------------------------------------------------------- per-ray samples

    def _trunk(self, enc):
        r, mm, w = self.prec.rnd, self.prec.mm, self.w
        h = enc
        for i in range(self.cfg["mlp_depth"] - 1):
            if i == self.cfg["skip_layer"]:
                h = torch.cat([h, enc], dim=-1)
            h = r(torch.relu(mm(h, w[f"trunk_w{i}"]) + w[f"trunk_b{i}"]))
        return h

    def ray_samples(self, o, d, ts, head: str):
        """Rays o, d (N, 3) at their samples ts (N, S) -> (sigma, rgb) (N, S)
        and (N, S, 3), as the training render (``head="train"``) or the
        imagined object's render (``"march"``) computes them. Density is
        zero outside the field's box."""
        r, mm, w = self.prec.rnd, self.prec.mm, self.w
        scale = 2.0 / (self.hi - self.lo)
        a3 = fma(o, scale, -2.0 * self.lo / (self.hi - self.lo) - 1.0)
        b3 = d * scale
        n = d.shape[0]
        A = (a3[:, None, :] * self.freqs[None, :, None]).reshape(n, -1)
        B = (b3[:, None, :] * self.freqs[None, :, None]).reshape(n, -1)
        dn = torch.sqrt((d * d).sum(-1))
        sh = r(sh4(d / dn[:, None]))
        t = ts[..., None]
        ang = fma(B[:, None], t, A[:, None])
        enc = r(torch.cat([fma(b3[:, None], t, a3[:, None]), torch.sin(ang), torch.cos(ang)], -1))
        pos = fma(d[:, None], t, o[:, None])
        inside = ((pos >= self.lo) & (pos <= self.hi)).all(-1)
        h3 = self._trunk(enc)
        shs = sh[:, None].expand(-1, ts.shape[1], -1)
        G = self.cfg["geo_feat_dim"]
        if head == "train":
            h4 = r(mm(h3, w["trunk_w4"]) + w["trunk_b4"])
            sigma = trunc_exp(h4[..., 0])
            c = r(torch.relu(mm(torch.cat([h4[..., 1:], shs], -1), w["color_w0"])))
        else:
            w4, cw0 = w["trunk_w4"], w["color_w0"]
            fold = torch.cat([torch.matmul(w4[:, 1:], cw0[:G]), w4[:, :1]], 1)
            hm = mm(torch.cat([h3, shs], -1), torch.cat(
                [r(fold), torch.cat([r(cw0[G:]), torch.zeros_like(cw0[G:, :1])], 1)], 0))
            hm = hm + torch.cat([torch.matmul(w["trunk_b4"][1:], cw0[:G]), w["trunk_b4"][:1]])
            sigma = torch.exp(torch.clamp(hm[..., -1], -15.0, 15.0))
            c = r(torch.relu(hm[..., :-1]))
        for i in range(1, self.cfg["n_color_layers"] - 1):
            c = r(torch.relu(mm(c, w[f"color_w{i}"])))
        rgb = torch.sigmoid(mm(c, w[f"color_w{self.cfg['n_color_layers'] - 1}"]))
        return torch.where(inside, sigma, torch.zeros_like(sigma)), rgb, pos


def ray_box(origins, dirs, lo, hi):
    """Slab test -> (t_near, t_far); t_far < t_near on a miss."""
    lo = torch.as_tensor(lo, dtype=F32, device=dirs.device)
    hi = torch.as_tensor(hi, dtype=F32, device=dirs.device)
    safe = torch.where(dirs.abs() < 1e-9, torch.full_like(dirs, 1e-9), dirs)
    a, b = (lo - origins) / safe, (hi - origins) / safe
    return torch.minimum(a, b).amax(-1), torch.maximum(a, b).amin(-1)


def deltas(ts):
    return torch.cat([ts[..., 1:] - ts[..., :-1], torch.full_like(ts[..., :1], 1e2)], dim=-1)


def weights_of(sigma, ts, dn, min_t: float):
    """Compositing weights (..., S) and the transmittance before each sample."""
    a = 1.0 - torch.exp(-sigma * deltas(ts) * dn[..., None])
    trans = torch.cumprod(1.0 - a + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], dim=-1)
    return torch.where(trans < min_t, torch.zeros_like(a), a * trans), trans


def composite(sigma, rgb, ts, dn, min_t: float):
    w, _ = weights_of(sigma, ts, dn, min_t)
    return (w[..., None] * rgb).sum(-2), w.sum(-1), (w * ts).sum(-1)


def pdf_midpoints(ts, w, n: int):
    """Inverse-CDF samples of (ts, w) at the quantile midpoints (k + 0.5) / n:
    bins between the samples' midpoints, weights padded by 1e-5."""
    mids = 0.5 * (ts[..., 1:] + ts[..., :-1])
    lo_b = torch.cat([ts[..., :1], mids], -1)
    hi_b = torch.cat([mids, ts[..., -1:]], -1)
    w = w + 1e-5
    cdf = torch.cumsum(w / w.sum(-1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
    S = ts.shape[-1]
    u = ((torch.arange(n, dtype=F32, device=ts.device) + 0.5) / n).expand(ts.shape[:-1] + (n,))
    k = ((cdf[..., None, :] <= u[..., :, None]).sum(-1) - 1).clamp(0, S - 1)
    c_lo, c_hi = cdf[..., :-1].gather(-1, k), cdf[..., 1:].gather(-1, k)
    b_lo, b_hi = lo_b.gather(-1, k), hi_b.gather(-1, k)
    span = c_hi - c_lo
    span = torch.where(span < 1e-8, torch.ones_like(span), span)
    return b_lo + (u - c_lo) / span * (b_hi - b_lo)


@torch.no_grad()
def render_view(field: Field, T_WC, dirs_cam, settings: dict, chunk: int = 8192):
    """A full view, hierarchically sampled at midpoints (n_coarse strata of
    the box's range within [near, far], then n_fine inverse-CDF samples of
    the coarse weights, all sorted). -> premultiplied rgb (H, W, 3), alpha,
    depth, zero on rays that miss the box."""
    H, W = dirs_cam.shape[:2]
    dirs = (dirs_cam.reshape(-1, 3) @ T_WC[:3, :3].T).contiguous()
    origins = T_WC[:3, 3].expand(dirs.shape)
    nc, nf, min_t = settings["n_coarse"], settings["n_fine"], settings["min_transmittance"]
    outs = []
    for s in range(0, dirs.shape[0], chunk):
        o, d = origins[s : s + chunk], dirs[s : s + chunk]
        dn = torch.linalg.norm(d, dim=-1)
        t0, t1 = ray_box(o, d, field.lo, field.hi)
        t0 = torch.clamp(t0, min=settings["near"])
        t1 = torch.clamp(t1, max=settings["far"])
        valid = t1 > t0
        t1 = torch.where(valid, t1, t0 + 1e-3)
        frac = (torch.arange(nc, dtype=F32, device=d.device) + 0.5) / nc
        ts = t0[:, None] + (t1 - t0)[:, None] * frac
        if nf:
            sig_c, _ = field.density(o[:, None] + d[:, None] * ts[..., None])
            w_c, _ = weights_of(sig_c, ts, dn, min_t)
            ts = torch.sort(torch.cat([ts, pdf_midpoints(ts, w_c, nf)], -1), -1).values
        pos = o[:, None] + d[:, None] * ts[..., None]
        sigma, rgb = field(pos, (d / dn[:, None])[:, None].expand(pos.shape))
        c, a, z = composite(sigma, rgb, ts, dn, min_t)
        v = valid.to(F32)
        outs.append((c * v[:, None], a * v, z * v))
    rgb, alpha, depth = (torch.cat(x) for x in zip(*outs))
    return rgb.reshape(H, W, 3), alpha.reshape(H, W), depth.reshape(H, W)


@torch.no_grad()
def march_box(field: Field, origins, dirs, box, settings: dict, count: bool = False):
    """Rays (N, 3) marched through ``box`` = (lo, hi): n_coarse uniform
    samples at the midpoints of [max(t_in, near), min(t_out, far)], density
    zero outside the field's box and the march box. -> rgb (N, 3), alpha,
    depth (zeros on rays that miss the box), and with ``count`` the samples
    these rays need (a live ray's samples while its transmittance is at or
    above the cut) and the live rays."""
    S, min_t = settings["n_coarse"], settings["min_transmittance"]
    t0, t1 = ray_box(origins, dirs, box[0], box[1])
    t0 = torch.clamp(t0, min=settings["near"])
    t1 = torch.clamp(t1, max=settings["far"])
    idx = torch.nonzero(t0 < t1).squeeze(1)
    n = dirs.shape[0]
    rgb = torch.zeros(n, 3, dtype=F32, device=dirs.device)
    alpha = torch.zeros(n, dtype=F32, device=dirs.device)
    depth = torch.zeros(n, dtype=F32, device=dirs.device)
    needed = 0
    if idx.numel():
        o, d, a0, a1 = origins[idx], dirs[idx], t0[idx], t1[idx]
        dt = (a1 - a0) / S
        k = torch.arange(S, dtype=F32, device=d.device) + 0.5
        ts = fma(k[None, :].expand(len(idx), S), dt[:, None], a0[:, None])
        sigma, c, pos = field.ray_samples(o, d, ts, head="march")
        lo = torch.maximum(field.lo, torch.as_tensor(box[0], dtype=F32, device=d.device))
        hi = torch.minimum(field.hi, torch.as_tensor(box[1], dtype=F32, device=d.device))
        sigma = torch.where(((pos >= lo) & (pos <= hi)).all(-1), sigma, torch.zeros_like(sigma))
        step = torch.cat([dt[:, None].expand(-1, S - 1), torch.full_like(dt[:, None], 1e2)], 1)
        a = 1.0 - torch.exp(-sigma * step * torch.sqrt((d * d).sum(-1))[:, None])
        trans = torch.cumprod(1.0 - a + 1e-10, dim=-1)
        trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=-1)
        w = torch.where(trans < min_t, torch.zeros_like(a), a * trans)
        rgb[idx] = (w[..., None] * c).sum(1)
        alpha[idx] = w.sum(1)
        depth[idx] = (w * ts).sum(1)
        needed = int((trans >= min_t).sum())
    if count:
        return rgb, alpha, depth, needed, int(idx.numel())
    return rgb, alpha, depth


def linear_to_srgb(x):
    x = torch.clamp(x, 0.0, 1.0)
    lo = x <= 0.0031308
    safe = torch.where(lo, torch.full_like(x, 0.0031308), x)
    return torch.where(lo, 12.92 * x, 1.055 * torch.pow(safe, 1.0 / 2.4) - 0.055)


def srgb_to_linear(x):
    x = torch.clamp(x, 0.0, 1.0)
    return torch.where(x <= 0.04045, x / 12.92, torch.pow((x + 0.055) / 1.055, 2.4))


def composite_u8(fg_rgb, fg_alpha, fg_depth, bg_rgb, bg_alpha, bg_depth):
    """The imagined frame: the object's render over the background by depth
    (a depth under 0.05 counts as 100), unpremultiplied, sRGB, rounded to
    u8, black where the alpha rounds under 130."""
    fd = torch.where(fg_depth < 0.05, torch.full_like(fg_depth, 100.0), fg_depth)
    bd = torch.where(bg_depth < 0.05, torch.full_like(bg_depth, 100.0), bg_depth)
    near = fd < bd
    rgb = torch.where(near[..., None], fg_rgb, bg_rgb)
    alpha = torch.where(near, fg_alpha, bg_alpha)
    safe = torch.where(alpha == 0, torch.ones_like(alpha), alpha)
    rgb = torch.where(alpha[..., None] == 0, torch.zeros_like(rgb), rgb / safe[..., None])
    img = (torch.clamp(linear_to_srgb(rgb), 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
    a8 = (torch.clamp(alpha, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
    return torch.where(a8[..., None] < 130, torch.zeros_like(img), img)


def virtual_camera(T_WO_1, T_WO_2, T_WC_1):
    """The camera from which the object at its own pose looks as it would
    moved to T_WO_2 seen from T_WC_1: T_WO_1 inv(T_WO_2) T_WC_1."""
    return T_WO_1 @ torch.linalg.inv(T_WO_2) @ T_WC_1
