"""Multiresolution hash-grid encoding (Instant-NGP, Mueller et al. 2022;
port of dream2real_tpu/nerf/hashgrid.py).

One packed (L, T, F) f32 table; levels whose dense grid fits in T entries
index densely, the others hash, chosen per level from the config. The
uint32 hash is computed in int64: ``x * prime``, XOR, then ``& (T - 1)``;
the low bits of the int64 product equal those of the uint32 product, so the
indices are exact. The gradient reaches the table through autograd of the
gather (``index_select``, whose gradient is a scatter-add); there is no
kernel.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

# instant-ngp's spatial hash primes (coherent in x).
_PRIMES = (1, 2654435761, 805459861)


class HashGridConfig(NamedTuple):
    n_levels: int = 16
    n_features: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    max_resolution: int = 2048

    @property
    def table_size(self) -> int:
        return 1 << self.log2_hashmap_size

    @property
    def per_level_scale(self) -> float:
        if self.n_levels == 1:
            return 1.0
        return math.exp(
            (math.log(self.max_resolution) - math.log(self.base_resolution))
            / (self.n_levels - 1)
        )

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features

    def level_resolutions(self) -> np.ndarray:
        b = self.per_level_scale
        return np.array(
            [int(math.floor(self.base_resolution * (b**l))) for l in range(self.n_levels)],
            dtype=np.int32,
        )

    def level_is_dense(self) -> np.ndarray:
        res = self.level_resolutions()
        return ((res + 1).astype(np.int64) ** 3 <= self.table_size).astype(np.int32)


def init_hash_table(cfg: HashGridConfig, generator: torch.Generator, device=None) -> torch.Tensor:
    """Uniform(-1e-4, 1e-4) f32 (L, T, F), as instant-ngp (the reference's
    distribution; torch's generator gives other numbers)."""
    u = torch.rand((cfg.n_levels, cfg.table_size, cfg.n_features), generator=generator,
                   device=generator.device)
    return ((u * 2.0 - 1.0) * 1e-4).to(device if device is not None else u.device)


# The 8 cube-corner offsets (x fastest): (8, 3).
_CORNERS = [[i & 1, (i >> 1) & 1, (i >> 2) & 1] for i in range(8)]


def _corner_indices(xyz: torch.Tensor, res: int, dense: bool, table_size: int) -> torch.Tensor:
    """Table index of integer grid corners xyz (..., 3) int64 in [0, res]."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    if dense:
        stride = res + 1
        idx = x + stride * (y + stride * z)
    else:
        idx = (x * _PRIMES[0]) ^ (y * _PRIMES[1]) ^ (z * _PRIMES[2])
    return idx & (table_size - 1)


def hash_encode(positions01: torch.Tensor, table: torch.Tensor,
                cfg: HashGridConfig) -> torch.Tensor:
    """Encode positions in [0, 1]^3 -> (..., L * F) features.

    positions01: (..., 3) f32, clamped to [0, 1] (the caller masks samples
    outside the field's box). table: (L, T, F) f32.
    """
    batch_shape = positions01.shape[:-1]
    pos = torch.clamp(positions01.reshape(-1, 3), 0.0, 1.0)
    corners = torch.tensor(_CORNERS, dtype=torch.int64, device=pos.device)
    is_corner = corners.to(torch.bool)[None]
    feats = []
    for lvl, (res, dense) in enumerate(zip(cfg.level_resolutions().tolist(),
                                           cfg.level_is_dense().tolist())):
        xf = pos * float(res)
        x0 = torch.clamp(torch.floor(xf).to(torch.int64), 0, res - 1)
        w = xf - x0.to(torch.float32)
        idx = _corner_indices(x0[:, None, :] + corners[None], res, bool(dense), cfg.table_size)
        # index_select's gradient is index_add_ (a scatter-add with atomics
        # on the card); advanced indexing's would sort the indices first.
        f = table[lvl].index_select(0, idx.reshape(-1)).reshape(idx.shape + (cfg.n_features,))
        cw = torch.where(is_corner, w[:, None, :], 1.0 - w[:, None, :])
        weights = cw[..., 0] * cw[..., 1] * cw[..., 2]
        feats.append((f * weights[..., None]).sum(dim=1))
    return torch.stack(feats, dim=1).reshape(batch_shape + (cfg.out_dim,))
