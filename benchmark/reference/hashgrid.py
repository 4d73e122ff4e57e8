"""Instant-NGP's NeRF field and its first training steps as a task field,
plainly (Mueller et al., arXiv:2201.05989, section 5.4 and table 1: 16
levels of 2 features, 2^19 entries, a density MLP of one 64-wide hidden
layer, a colour MLP of two on degree-4 SH).

The field: positions normalised to the field's box [0, 1]^3 (clamped) go
through a multiresolution hash encoding, L levels of T entries of F
features (float32); level l has resolution floor(base * b^l), b =
(max / base)^(1 / (L - 1)); a level whose (res + 1)^3 grid fits in T is
indexed densely (x + (res + 1) (y + (res + 1) z)), the others by the spatial
hash x * 1 ^ y * 2654435761 ^ z * 805459861, both taken mod T; each level's
features are the trilinear blend of its cell's 8 corners (weights (wx wy) wz,
summed corner by corner in float32). The L F features, rounded, feed a
bias-free ReLU density MLP (L F -> hidden -> 1 + geo), the log-density
through the truncated exp (zero outside the box); [geo, degree-4 real SH of
the view direction] feed a bias-free ReLU colour MLP (-> 64 -> 64 -> 3) and a
sigmoid. Every product takes its inputs in the precision's rounding and sums
in float32, every layer's output rounded.

A step is ``training.py``'s (its step loss: random-background alpha
supervision, Huber(0.1) x 2 on sRGB, depth Huber(0.05) x 0.1 on solid
pixels, free-space carving x 0.1 in front of the observed depth; its Adam
with L2 decay on the cosine schedule), with this field, its draws and the
hierarchical sampler it trains with in place of that module's: n_coarse
jittered strata of the box's range within [near, far], their density
composited (no gradient) into weights, padded by 1e-5, and n_fine
inverse-CDF samples at uniform random quantiles, all sorted. The random
numbers are drawn from the seed in the order the program draws them: the
table (uniform in +-1e-4) and each weight (uniform in +-sqrt(6 / fan_in))
in the leaves' order, then per step the pixels, background colours,
opaque pixels, free-space quantiles, the coarse jitter and the fine
quantiles.

Departures from tcnn's published field, each the program's:

- level resolutions floor(base * b^l), with no half-cell offset of the
  grid;
- the density MLP's 16 outputs read as 1 density and 15 geometry features;
- 32 + 32 coarse and fine samples a ray in place of occupancy-grid
  marching;
- a float32 table and bf16 products with float32 sums in place of tcnn's
  fp16;
- the port's Adam (eps 1e-8, L2 1e-6, the cosine schedule down to 1%) in
  place of instant-ngp's (eps 1e-15, an EMA of the weights, exponential
  decay).
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import field
from benchmark.reference import training
from benchmark.reference.precision import F32, Precision

PRIMES = (1, 2654435761, 805459861)


def resolutions(grid: dict) -> list[int]:
    """Each level's resolution: floor(base * b^l)."""
    L, base = grid["n_levels"], grid["base_resolution"]
    b = 1.0 if L == 1 else math.exp(
        (math.log(grid["max_resolution"]) - math.log(base)) / (L - 1))
    return [int(math.floor(base * b**l)) for l in range(L)]


def corner_index(x, y, z, res: int, dense: bool, table_size: int):
    """The table row of integer grid corners (int64 tensors in [0, res])."""
    if dense:
        idx = x + (res + 1) * (y + (res + 1) * z)
    else:
        idx = (x * PRIMES[0]) ^ (y * PRIMES[1]) ^ (z * PRIMES[2])
    return idx % table_size


def encode(pos01, table, grid: dict):
    """Positions (..., 3) in the box's [0, 1]^3 -> (..., L F) float32
    features of the (L, T, F) table."""
    T = 1 << grid["log2_hashmap_size"]
    p = torch.clamp(pos01, 0.0, 1.0)
    out = []
    for lvl, res in enumerate(resolutions(grid)):
        dense = (res + 1) ** 3 <= T
        xf = p * float(res)
        x0 = torch.clamp(torch.floor(xf), 0, res - 1)
        w = xf - x0
        x0 = x0.to(torch.int64)
        acc = None
        for c in range(8):
            bits = (c & 1, (c >> 1) & 1, (c >> 2) & 1)
            wc = [w[..., d] if bits[d] else 1.0 - w[..., d] for d in range(3)]
            idx = corner_index(*(x0[..., d] + bits[d] for d in range(3)), res, dense, T)
            term = table[lvl][idx] * (wc[0] * wc[1] * wc[2])[..., None]
            acc = term if acc is None else acc + term
        out.append(acc)
    return torch.cat(out, dim=-1)



class Field:
    """The field's leaves (a dict under the program's names, float32) and
    box, computed in ``prec``."""

    def __init__(self, weights: dict, cfg: dict, prec: Precision):
        self.w, self.cfg, self.prec = weights, cfg, prec
        dev = weights["table"].device
        self.lo = torch.tensor(cfg["aabb_min"], dtype=F32, device=dev)
        self.hi = torch.tensor(cfg["aabb_max"], dtype=F32, device=dev)

    def density(self, pos):
        """-> (sigma, geometry features) at world positions (..., 3)."""
        r = self.prec.rnd
        h = r(encode((pos - self.lo) / (self.hi - self.lo), self.w["table"], self.cfg["grid"]))
        n = self.cfg["n_density_layers"]
        for i in range(n):
            h = r(self.prec.mm(h, self.w[f"sigma_w{i}"]))
            if i < n - 1:
                h = torch.relu(h)
        sigma = field.trunc_exp(h[..., 0])
        inside = ((pos >= self.lo) & (pos <= self.hi)).all(dim=-1)
        return torch.where(inside, sigma, torch.zeros_like(sigma)), h[..., 1:]

    def ray_samples(self, o, d, ts, head: str = "train"):
        """-> (sigma, linear rgb, positions) at the samples ts (N, S) of rays
        o, d (N, 3), seen along d / |d|; one head."""
        pos = o[:, None] + d[:, None] * ts[..., None]
        sigma, geo = self.density(pos)
        unit = (d / torch.linalg.norm(d, dim=-1)[:, None])[:, None].expand(pos.shape)
        x = torch.cat([geo, self.prec.rnd(field.sh4(unit))], dim=-1)
        n = self.cfg["n_color_layers"]
        for i in range(n):
            x = self.prec.rnd(self.prec.mm(x, self.w[f"color_w{i}"]))
            if i < n - 1:
                x = torch.relu(x)
        return sigma, torch.sigmoid(x), pos


def leaf_shapes(cfg: dict) -> list:
    """(name, shape) of the field's leaves in the program's order."""
    g = cfg["grid"]
    out = [("table", (g["n_levels"], 1 << g["log2_hashmap_size"], g["n_features"]))]
    dims = [g["n_levels"] * g["n_features"]] + [cfg["hidden_dim"]] * (
        cfg["n_density_layers"] - 1) + [1 + cfg["geo_feat_dim"]]
    out += [(f"sigma_w{i}", (dims[i], dims[i + 1])) for i in range(len(dims) - 1)]
    cd = [cfg["geo_feat_dim"] + cfg["sh_degree"] ** 2] + \
        [cfg["color_width"]] * (cfg["n_color_layers"] - 1) + [3]
    return out + [(f"color_w{i}", (cd[i], cd[i + 1])) for i in range(len(cd) - 1)]


def init_weights(gen, cfg: dict, device) -> dict:
    """The leaves drawn as the program draws them: one uniform draw a leaf,
    in order; the table in +-1e-4, the weights in +-sqrt(6 / fan_in)."""
    w = {}
    for name, shape in leaf_shapes(cfg):
        u = torch.rand(shape, generator=gen, device=device)
        bound = 1e-4 if name == "table" else math.sqrt(6.0 / shape[0])
        w[name] = (u * 2.0 - 1.0) * bound
    return w


def inverse_cdf(ts, w, u):
    """Samples of (ts, w) at the quantiles u: bins between the samples'
    midpoints, weights padded by 1e-5."""
    mids = 0.5 * (ts[..., 1:] + ts[..., :-1])
    lo_b = torch.cat([ts[..., :1], mids], -1)
    hi_b = torch.cat([mids, ts[..., -1:]], -1)
    w = w + 1e-5
    cdf = torch.cumsum(w / w.sum(-1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
    k = ((cdf[..., None, :] <= u[..., :, None]).sum(-1) - 1).clamp(0, ts.shape[-1] - 1)
    c_lo, c_hi = cdf[..., :-1].gather(-1, k), cdf[..., 1:].gather(-1, k)
    b_lo, b_hi = lo_b.gather(-1, k), hi_b.gather(-1, k)
    span = c_hi - c_lo
    span = torch.where(span < 1e-8, torch.ones_like(span), span)
    return b_lo + (u - c_lo) / span * (b_hi - b_lo)



def sample(fd: Field, o, d, ts_c, u_fine, n: int, min_t: float, mix):
    """The hierarchical sampler in ``training.sample``'s place: the coarse
    samples' density composited (no gradient) into weights, and their
    inverse-CDF samples at the quantiles ``u_fine``, all sorted (``n`` and
    ``mix`` are that sampler's; this one takes neither)."""
    with torch.no_grad():
        sig_c, _ = fd.density(o[:, None] + d[:, None] * ts_c[..., None])
        w_c, _ = field.weights_of(sig_c, ts_c, torch.linalg.norm(d, dim=-1), min_t)
    return torch.sort(torch.cat([ts_c, inverse_cdf(ts_c, w_c, u_fine)], -1), -1).values


def draw_step(gen, data: dict, tc: dict, settings: dict):
    """One step's random numbers, in the program's order."""
    dev = data["images"].device
    n_img, h, w = data["images"].shape[:3]
    R = tc["batch_rays"]
    img_idx = torch.randint(0, n_img, (R,), generator=gen, device=dev)
    py = torch.randint(0, h, (R,), generator=gen, device=dev)
    px = torch.randint(0, w, (R,), generator=gen, device=dev)
    bgc = torch.rand(R, 3, generator=gen, device=dev)
    fgp = data["fg_pixels"]
    n_fg = R // 2
    chosen = fgp[torch.randint(0, fgp.shape[0], (n_fg,), generator=gen, device=dev)]
    img_idx = torch.cat([chosen[:, 0], img_idx[n_fg:]])
    py = torch.cat([chosen[:, 1], py[n_fg:]])
    px = torch.cat([chosen[:, 2], px[n_fg:]])
    u_free = torch.rand(R, tc["freespace_samples"], generator=gen, device=dev)
    jitter = torch.rand(R, settings["n_coarse"], generator=gen, device=dev)
    u_fine = torch.rand(R, settings["n_fine"], generator=gen, device=dev)
    return img_idx, py, px, bgc, u_free, jitter, u_fine



def train_steps(seed: int, data: dict, cfg: dict, settings: dict, tc: dict, n_steps: int,
                prec: Precision) -> dict:
    """The first ``n_steps`` steps from the seed: ``training.train_steps``
    with this module's field, leaves, draws and sampler swapped in for the
    call."""
    swap = {(training, "init_weights"): init_weights, (training, "draw_step"): draw_step,
            (training, "sample"): sample, (field, "Field"): Field}
    kept = {key: getattr(*key) for key in swap}
    try:
        for (mod, name), fn in swap.items():
            setattr(mod, name, fn)
        return training.train_steps(seed, data, cfg, dict(settings, sampler_mix=None), tc,
                                    n_steps, prec)
    finally:
        for (mod, name), fn in kept.items():
            setattr(mod, name, fn)
