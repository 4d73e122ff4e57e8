"""NGP-class NeRF field (port of dream2real_tpu/nerf/model.py, mlp field).

Frequency-encoded positions -> width x depth MLP trunk -> (log-density, geo
features), plus an SH-conditioned colour head. Numerics follow the
reference: bf16 matmul inputs with f32 accumulation, bf16 casts between
layers, f32 trunc_exp / sigmoid. The hashgrid field is not ported; its
config is kept so snapshot headers round-trip.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from dream2real_tpu_torch.device import BF16, F32, dot_f32, resolve_device


class HashGridConfig(NamedTuple):
    n_levels: int = 16
    n_features: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    max_resolution: int = 2048


class NGPConfig(NamedTuple):
    field_type: str = "mlp"  # only "mlp" is ported
    posenc_deg: int = 10
    mlp_width: int = 256
    mlp_depth: int = 5
    skip_layer: int = 3  # concat the encoding again before this layer (0=off)
    grid: HashGridConfig = HashGridConfig()
    hidden_dim: int = 64
    n_density_layers: int = 2
    n_color_layers: int = 3
    geo_feat_dim: int = 15
    color_width: int = 64
    sh_degree: int = 4
    aabb_min: tuple = (-1.0, -1.0, -1.0)
    aabb_max: tuple = (1.0, 1.0, 1.0)

    @property
    def sh_dim(self) -> int:
        return self.sh_degree**2

    @property
    def posenc_dim(self) -> int:
        return 3 + 2 * 3 * self.posenc_deg


def layer_dims(cfg: NGPConfig) -> dict[str, tuple[int, ...]]:
    """Parameter shapes in the reference's (in, out) layout, by key."""
    if cfg.field_type != "mlp":
        raise NotImplementedError(f"field_type {cfg.field_type!r} is not ported")
    shapes: dict[str, tuple[int, ...]] = {}
    in_dim = d = cfg.posenc_dim
    for i in range(cfg.mlp_depth):
        if cfg.skip_layer and i == cfg.skip_layer:
            d += in_dim
        out = cfg.mlp_width if i < cfg.mlp_depth - 1 else 1 + cfg.geo_feat_dim
        shapes[f"trunk_w{i}"] = (d, out)
        shapes[f"trunk_b{i}"] = (out,)
        d = out
    cdims = [cfg.geo_feat_dim + cfg.sh_dim] + [cfg.color_width] * (cfg.n_color_layers - 1) + [3]
    for i in range(len(cdims) - 1):
        shapes[f"color_w{i}"] = (cdims[i], cdims[i + 1])
    return shapes


class NGPField(nn.Module):
    """The field's parameters under the reference's flat keys (f32,
    (in, out) layout) plus its config."""

    def __init__(self, cfg: NGPConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        for k, shape in layer_dims(cfg).items():
            self.register_parameter(
                k, nn.Parameter(torch.zeros(shape, dtype=F32, device=dev), requires_grad=False)
            )

    def params(self) -> dict[str, torch.Tensor]:
        return dict(self.named_parameters())


def init_ngp_params(cfg: NGPConfig, generator: torch.Generator, device=None) -> NGPField:
    """Seeded field: weights uniform in +-sqrt(6 / fan_in), zero biases (the
    reference's distribution; torch's generator gives other numbers)."""
    field = NGPField(cfg, device)
    with torch.no_grad():
        for k, p in field.named_parameters():
            if "_w" in k:
                bound = math.sqrt(6.0 / p.shape[0])
                u = torch.rand(p.shape, generator=generator, device=generator.device)
                p.copy_((u * 2.0 - 1.0) * bound)
    return field


def sh_encode_deg4(d: torch.Tensor) -> torch.Tensor:
    """Real SH basis up to degree 4. d: (..., 3) unit dirs -> (..., 16)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    return torch.stack(
        [
            torch.full_like(x, 0.28209479177387814),
            -0.48860251190291987 * y,
            0.48860251190291987 * z,
            -0.48860251190291987 * x,
            1.0925484305920792 * xy,
            -1.0925484305920792 * yz,
            0.94617469575755997 * zz - 0.31539156525251999,
            -1.0925484305920792 * xz,
            0.54627421529603959 * (xx - yy),
            0.59004358992664352 * y * (-3.0 * xx + yy),
            2.8906114426405538 * xy * z,
            0.45704579946446572 * y * (1.0 - 5.0 * zz),
            0.3731763325901154 * z * (5.0 * zz - 3.0),
            0.45704579946446572 * x * (1.0 - 5.0 * zz),
            1.4453057213202769 * z * (xx - yy),
            0.59004358992664352 * x * (-xx + 3.0 * yy),
        ],
        dim=-1,
    )


def posenc_freqs(deg: int, device=None) -> torch.Tensor:
    """f32 band frequencies 2^j * pi (exact power-of-two multiples of f32 pi)."""
    return torch.tensor(2.0, dtype=F32, device=device) ** torch.arange(
        deg, dtype=F32, device=device
    ) * torch.tensor(math.pi, dtype=F32, device=device)


def posenc(p: torch.Tensor, deg: int) -> torch.Tensor:
    """NeRF frequency encoding: (..., 3) -> (..., 3 + 6*deg), freq-major."""
    freqs = posenc_freqs(deg, p.device)
    flat = (p[..., None, :] * freqs[:, None]).flatten(-2)
    return torch.cat([p, torch.sin(flat), torch.cos(flat)], dim=-1)


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    """exp with clamped input (instant-ngp's density activation)."""
    return torch.exp(torch.clamp(x, -15.0, 15.0))


def _aabb(cfg: NGPConfig, device):
    return (
        torch.tensor(cfg.aabb_min, dtype=F32, device=device),
        torch.tensor(cfg.aabb_max, dtype=F32, device=device),
    )


def density_fn(field: NGPField, positions: torch.Tensor):
    """positions (..., 3) world -> (sigma (...,), geo_feat (..., G) bf16).
    Out-of-aabb positions get sigma == 0."""
    cfg = field.cfg
    lo, hi = _aabb(cfg, positions.device)
    pos01 = (positions - lo) / (hi - lo)
    enc0 = posenc(pos01 * 2.0 - 1.0, cfg.posenc_deg).to(BF16)
    h = enc0
    for i in range(cfg.mlp_depth):
        if cfg.skip_layer and i == cfg.skip_layer:
            h = torch.cat([h, enc0], dim=-1)
        w = getattr(field, f"trunk_w{i}")
        b = getattr(field, f"trunk_b{i}").to(BF16).to(F32)
        h = dot_f32(h, w) + b
        if i < cfg.mlp_depth - 1:
            h = torch.relu(h)
        h = h.to(BF16)
    sigma = trunc_exp(h[..., 0].to(F32))
    inside = ((positions >= lo) & (positions <= hi)).all(dim=-1)
    sigma = torch.where(inside, sigma, torch.zeros_like(sigma))
    return sigma, h[..., 1:]


def color_fn(field: NGPField, geo_feat: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """(geo_feat (..., G), unit dirs (..., 3)) -> linear RGB (..., 3)."""
    cfg = field.cfg
    x = torch.cat([geo_feat.to(BF16), sh_encode_deg4(dirs).to(BF16)], dim=-1)
    for i in range(cfg.n_color_layers):
        x = dot_f32(x, getattr(field, f"color_w{i}"))
        if i < cfg.n_color_layers - 1:
            x = torch.relu(x)
        x = x.to(BF16)
    return torch.sigmoid(x.to(F32))


def field_fn(field: NGPField, positions: torch.Tensor, dirs: torch.Tensor):
    """World positions + unit view dirs -> (sigma, rgb)."""
    sigma, geo = density_fn(field, positions)
    return sigma, color_fn(field, geo, dirs)
