"""Hierarchical volumetric ray marcher + compositor (port of
dream2real_tpu/nerf/render.py).

Ray directions are z-normalized (t equals z-depth; metric length uses |d|).
Returned RGB is premultiplied-alpha linear radiance. This is plain PyTorch
on any device and differentiable: the background view of the imagine loop is
rendered here, and training takes it with ``D2R_PALLAS_TRAIN=0`` (exact
autograd, extrinsics gradients included). Without a generator the samples
are deterministic midpoints (rendering); with one, the coarse samples are
stratified-jittered and the fine ones drawn at random quantiles (training);
a shard of a sharded step passes its view of the step's draws
(``parallel.mesh.ShardDraws``) in the generator's place.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dream2real_tpu_torch.device import F32, f32_constant
from dream2real_tpu_torch.nerf.model import NGPField, density_fn, field_fn
from dream2real_tpu_torch.parallel.mesh import uniform


class RenderSettings(NamedTuple):
    n_coarse: int = 32
    n_fine: int = 32
    near: float = 0.05
    far: float = 4.0
    # instant-ngp drops marching contributions below this transmittance.
    min_transmittance: float = 1e-4
    compute_dtype: str = "bfloat16"  # MLP evals in bf16; compositing in f32


def ray_aabb(origins: torch.Tensor, dirs: torch.Tensor, aabb_min, aabb_max):
    """Slab test. (..., 3) -> (t_near, t_far); t_far < t_near on a miss. The
    box's corners: tensors, or numbers made into shared device constants."""
    lo_b, hi_b = (torch.as_tensor(b, dtype=F32, device=dirs.device) if torch.is_tensor(b)
                  else f32_constant(b, dirs.device) for b in (aabb_min, aabb_max))
    safe = torch.where(dirs.abs() < 1e-9, torch.full_like(dirs, 1e-9), dirs)
    lo = (lo_b - origins) / safe
    hi = (hi_b - origins) / safe
    t0 = torch.minimum(lo, hi).amax(dim=-1)
    t1 = torch.maximum(lo, hi).amin(dim=-1)
    return t0, t1


def sample_pdf(ts: torch.Tensor, weights: torch.Tensor, n_samples: int,
               generator: torch.Generator | None = None) -> torch.Tensor:
    """Inverse-CDF importance sampling: at the CDF quantile midpoints, or at
    uniform random quantiles drawn from ``generator`` (training).

    ts: (..., S) sorted positions; weights (..., S) >= 0 -> (..., n_samples).
    Bin selection is a one-hot contraction, like the reference.
    """
    mids = 0.5 * (ts[..., 1:] + ts[..., :-1])
    bin_lo = torch.cat([ts[..., :1], mids], dim=-1)
    bin_hi = torch.cat([mids, ts[..., -1:]], dim=-1)
    w = weights + 1e-5
    pdf = w / w.sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # (..., S+1)

    if generator is None:
        u = (torch.arange(n_samples, dtype=F32, device=ts.device) + 0.5) / n_samples
        u = u.expand(ts.shape[:-1] + (n_samples,))
    else:
        u = uniform(generator, ts.shape[:-1] + (n_samples,), ts.device)
    below = (cdf[..., None, :] <= u[..., :, None]).to(F32)
    sel = below[..., :-1] * (1.0 - below[..., 1:])  # (..., n, S) one-hot bin
    sel[..., -1] += below[..., -1]  # u >= cdf[-1] falls in the last bin

    def read(vals):
        return torch.einsum("...ns,...s->...n", sel, vals)

    cdf_lo = read(cdf[..., :-1])
    cdf_hi = read(cdf[..., 1:])
    lo = read(bin_lo)
    hi = read(bin_hi)
    span = cdf_hi - cdf_lo
    denom = torch.where(span < 1e-8, torch.ones_like(span), span)
    return lo + (u - cdf_lo) / denom * (hi - lo)


class _CumprodPositive(torch.autograd.Function):
    """``torch.cumprod`` over the last dim of factors that are never zero,
    with autograd's gradient for that case (the reversed cumulative sum of
    grad * output, over the input), bit for bit: without autograd's check
    for zero factors, whose ``.item()`` waits for the device and cannot be
    captured in a CUDA graph."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return (out * g).flip(-1).cumsum(-1).flip(-1).div(x)


def _composite(sigma, rgb, ts, d_norm, min_transmittance):
    """Front-to-back compositing. sigma (..., S), rgb (..., S, 3), ts (..., S).
    Returns premultiplied rgb (..., 3), alpha, z-depth, weights (..., S)."""
    deltas = torch.diff(ts, dim=-1)
    deltas = torch.cat([deltas, torch.full_like(deltas[..., :1], 1e2)], dim=-1)
    alpha = 1.0 - torch.exp(-sigma * deltas * d_norm[..., None])
    # 1 - alpha = exp(-x) >= 0, so every factor is at least 1e-10.
    trans = _CumprodPositive.apply(1.0 - alpha + 1e-10)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], dim=-1)
    weights = alpha * trans
    weights = torch.where(trans < min_transmittance, torch.zeros_like(weights), weights)
    comp_rgb = (weights[..., None] * rgb).sum(dim=-2)
    return comp_rgb, weights.sum(dim=-1), (weights * ts).sum(dim=-1), weights


def render_rays(
    field: NGPField,
    origins: torch.Tensor,
    dirs: torch.Tensor,
    settings: RenderSettings,
    march_aabb=None,
    generator: torch.Generator | None = None,
) -> dict[str, torch.Tensor]:
    """March rays through the field. origins/dirs (..., 3) world, dirs
    z-normalized. Returns premultiplied 'rgb' (..., 3), 'alpha', 'depth',
    'weights', 'ts'. ``generator`` (training) jitters the coarse samples
    within their strata and randomises the fine draws.

    march_aabb: optional tighter (lo, hi) box; the t-range comes from it and
    density outside it is zeroed.
    """
    cfg = field.cfg
    d_norm = torch.linalg.norm(dirs, dim=-1)
    unit_dirs = dirs / d_norm[..., None]
    box_lo, box_hi = (cfg.aabb_min, cfg.aabb_max) if march_aabb is None else march_aabb
    t0, t1 = ray_aabb(origins, dirs, box_lo, box_hi)
    t0 = torch.clamp(t0, min=settings.near)
    t1 = torch.clamp(t1, max=settings.far)
    valid = t1 > t0
    t1 = torch.where(valid, t1, t0 + 1e-3)

    nc = settings.n_coarse
    frac = (torch.arange(nc, dtype=F32, device=dirs.device) + 0.5) / nc
    if generator is not None:
        jitter = uniform(generator, origins.shape[:-1] + (nc,), dirs.device)
        frac = frac + (jitter - 0.5) / nc
    ts_c = t0[..., None] + (t1 - t0)[..., None] * frac

    if settings.n_fine > 0:
        with torch.no_grad():  # the fine draws read the coarse weights as constants
            pos_c = origins[..., None, :] + dirs[..., None, :] * ts_c[..., None]
            sigma_c, _ = density_fn(field, pos_c)
            _, _, _, w_c = _composite(
                sigma_c, torch.zeros(sigma_c.shape + (3,), device=dirs.device), ts_c,
                d_norm, settings.min_transmittance,
            )
        ts_f = sample_pdf(ts_c, w_c, settings.n_fine, generator)
        ts_all = torch.sort(torch.cat([ts_c, ts_f], dim=-1), dim=-1).values
    else:
        ts_all = ts_c

    pos = origins[..., None, :] + dirs[..., None, :] * ts_all[..., None]
    sh_dirs = unit_dirs[..., None, :].expand(pos.shape)
    sigma, rgb = field_fn(field, pos, sh_dirs)
    if march_aabb is not None:
        lo = torch.as_tensor(box_lo, dtype=F32, device=dirs.device)
        hi = torch.as_tensor(box_hi, dtype=F32, device=dirs.device)
        inbox = ((pos >= lo) & (pos <= hi)).all(dim=-1)
        sigma = torch.where(inbox, sigma, torch.zeros_like(sigma))
    comp_rgb, acc, depth, weights = _composite(
        sigma, rgb, ts_all, d_norm, settings.min_transmittance
    )
    zero = torch.zeros_like(acc)
    return {
        "rgb": torch.where(valid[..., None], comp_rgb, torch.zeros_like(comp_rgb)),
        "alpha": torch.where(valid, acc, zero),
        "depth": torch.where(valid, depth, zero),
        "weights": weights,
        "ts": ts_all,
    }


@torch.no_grad()
def render_image(
    field: NGPField,
    T_WC: torch.Tensor,
    dirs_cam: torch.Tensor,
    settings: RenderSettings,
    row_chunk: int = 0,
) -> dict[str, torch.Tensor]:
    """Render a full image from camera pose T_WC (OpenCV convention, 4x4).
    dirs_cam (H, W, 3) from ops.cameras.pixel_dirs. Returns premultiplied
    'rgb' (H, W, 3), 'alpha', 'depth'. row_chunk > 0 bounds peak memory by
    marching row blocks one after another. Rendering only: no autograd graph
    is recorded (training goes through render_rays)."""
    h = dirs_cam.shape[0]
    dirs = torch.einsum("ij,hwj->hwi", T_WC[:3, :3], dirs_cam)
    origins = T_WC[:3, 3].expand(dirs.shape)
    keys = ("rgb", "alpha", "depth")
    if row_chunk and row_chunk < h:
        if h % row_chunk:
            raise ValueError(f"row_chunk {row_chunk} does not divide {h}")
        outs = [
            render_rays(field, origins[r : r + row_chunk], dirs[r : r + row_chunk], settings)
            for r in range(0, h, row_chunk)
        ]
        return {k: torch.cat([o[k] for o in outs], dim=0) for k in keys}
    out = render_rays(field, origins, dirs, settings)
    return {k: out[k] for k in keys}
