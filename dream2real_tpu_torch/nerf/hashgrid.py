"""Multiresolution hash-grid encoding (Instant-NGP, Mueller et al. 2022;
port of dream2real_tpu/nerf/hashgrid.py).

One packed (L, T, F) f32 table; levels whose dense grid fits in T entries
index densely, the others hash, chosen per level from the config. On the
card ``hash_encode`` launches H1 (``csrc/hashgrid.cu``) through an autograd
function: the features come back in bf16, each rounded once from its f32
sum, and the backward adds the table's gradient with atomics (no positions
gradient). On the CPU it runs ``hash_encode_plain``, the kernel's twin: the
uint32 hash computed in int64 (``x * prime``, XOR, then ``& (T - 1)``; the
low bits of the int64 product equal those of the uint32 product, so the
indices are exact), f32 features, and the table's gradient through autograd
of the gather (``index_select``, whose gradient is a scatter-add).

While a profiler runs, each encode on the card and each backward through it
is a device span ``field.hash_encode`` (``utils/profiling.py``; not inside
a CUDA graph's capture), as is each plain encode. ``hash_encode.points``
counts the points the host sent through the encoding, ``.launches`` and
``.backward_launches`` the kernel's launches.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from dream2real_tpu_torch import build
from dream2real_tpu_torch.device import shared_constant
from dream2real_tpu_torch.utils.profiling import span

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


def _corners(device) -> torch.Tensor:
    """The 8 cube-corner offsets (x fastest), (8, 3) int64: a shared constant
    (``device.shared_constant``)."""
    return shared_constant("hash_corners", device, lambda dev: torch.tensor(
        [[i & 1, (i >> 1) & 1, (i >> 2) & 1] for i in range(8)], dtype=torch.int64, device=dev))


def _corner_indices(xyz: torch.Tensor, res: int, dense: bool, table_size: int) -> torch.Tensor:
    """Table index of integer grid corners xyz (..., 3) int64 in [0, res]."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    if dense:
        stride = res + 1
        idx = x + stride * (y + stride * z)
    else:
        idx = (x * _PRIMES[0]) ^ (y * _PRIMES[1]) ^ (z * _PRIMES[2])
    return idx & (table_size - 1)


def hash_encode_plain(pos: torch.Tensor, table: torch.Tensor, cfg: HashGridConfig) -> torch.Tensor:
    """H1's plain version: (N, 3) positions in [0, 1]^3 (clamped here) and
    the (L, T, F) f32 table -> (N, L * F) f32 features."""
    pos = torch.clamp(pos, 0.0, 1.0)
    corners = _corners(pos.device)
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
    return torch.stack(feats, dim=1).reshape(pos.shape[0], cfg.out_dim)


_P, _I = ctypes.c_void_p, ctypes.c_int


def _launch(symbol: str, pos, data, cfg: HashGridConfig, out) -> None:
    """One H1 launch on CUDA tensors: ``data`` is the table (forward) or
    the features' gradient (backward), ``out`` the features or the
    table's gradient."""
    fn = getattr(build.load("hashgrid"), symbol)
    fn.argtypes = [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P]
    fn.restype = ctypes.c_int
    levels = cfg.n_levels
    res = (ctypes.c_int * levels)(*cfg.level_resolutions().tolist())
    dense = (ctypes.c_int * levels)(*cfg.level_is_dense().tolist())
    with torch.cuda.device(pos.device):
        err = fn(build.ptr(pos), build.ptr(data), pos.shape[0], levels, cfg.n_features,
                 cfg.log2_hashmap_size, ctypes.cast(res, _P), ctypes.cast(dense, _P),
                 build.ptr(out), build.stream_ptr(pos.device))
    build.check(err, symbol)


def _encode_span():
    """The span of one encode or backward on the card; none while a CUDA
    graph is being captured (its timing events cannot be)."""
    if torch.cuda.is_current_stream_capturing():
        return contextlib.nullcontext()
    return span("field.hash_encode", device=True)


class _HashEncode(torch.autograd.Function):
    """H1's forward, and its backward into the table's gradient."""

    @staticmethod
    def forward(ctx, pos, table, cfg):
        out = torch.empty(pos.shape[0], cfg.out_dim, dtype=torch.bfloat16, device=pos.device)
        with _encode_span():
            _launch("d2r_hash_fwd", pos, table, cfg, out)
        hash_encode.launches += 1
        ctx.cfg = cfg
        ctx.table_shape = table.shape
        ctx.save_for_backward(pos)
        return out

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[1]:
            return None, None, None
        (pos,) = ctx.saved_tensors
        g = g.to(torch.bfloat16).contiguous()
        dtable = torch.zeros(ctx.table_shape, dtype=torch.float32, device=g.device)
        with _encode_span():
            _launch("d2r_hash_bwd", pos, g, ctx.cfg, dtable)
        hash_encode.backward_launches += 1
        return None, dtable, None


def hash_encode(positions01: torch.Tensor, table: torch.Tensor,
                cfg: HashGridConfig) -> torch.Tensor:
    """Encode positions in [0, 1]^3 -> (..., L * F) features: bf16 from H1
    on the card, f32 from the plain version on the CPU.

    positions01: (..., 3) f32, clamped to [0, 1] (the caller masks samples
    outside the field's box). table: (L, T, F) f32.
    """
    batch_shape = positions01.shape[:-1]
    pos = positions01.reshape(-1, 3)
    hash_encode.points += pos.shape[0]
    if not pos.is_cuda:
        with span("field.hash_encode"):
            out = hash_encode_plain(pos, table, cfg)
    else:
        want = (cfg.n_levels, cfg.table_size, cfg.n_features)
        if pos.dtype != torch.float32 or table.dtype != torch.float32:
            raise TypeError(f"hash_encode: float32 positions and table, got {pos.dtype}, "
                            f"{table.dtype}")
        if tuple(table.shape) != want or not table.is_contiguous() or table.device != pos.device:
            raise ValueError(f"hash_encode: a contiguous {want} table on {pos.device}, got "
                             f"{tuple(table.shape)} on {table.device}")
        out = _HashEncode.apply(pos.contiguous(), table, cfg)
    return out.reshape(batch_shape + (cfg.out_dim,))


hash_encode.points = hash_encode.launches = hash_encode.backward_launches = 0
