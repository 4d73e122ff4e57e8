"""Fused crop march of a hash-grid field (H2, ``csrc/hash_march.cu``).

The imagine loop's crop render of an instant-ngp field on the card: each
clip group's crop rays get their box range (``march_kernel.march_ranges``),
the rays that hit the box are compacted on the device
(``march_kernel.compact_live``: no host sync; a group with no live ray
still launches and gives exact zeros), and one launch marches them all,
encoding, both MLPs and the composite per sample, scattering each ray's
result to its flat index. ``march_rays_hash`` returns what
``render.render_rays(field, origins, dirs, settings, march_aabb=box)``
returns for rgb, alpha and depth; ``render_rays`` stays the CPU path and
H2's twin (``tests/test_torch_cuda.py`` holds them together).

``supports`` is the gate: the hash-grid field at instant-ngp's widths (32
encoded features, as 16 levels of 2, the paper's, or 8 of 4; density 32 ->
64 -> 16, colour 31 -> 64 -> 64 -> 3 on degree-4 SH) and the crop settings
(no fine samples); ``combined.pack_crop`` raises for a hash-grid field on
the card outside it. ``pack`` lays the field out once a score call: the
table as it is, the five weight matrices rounded to bf16 and packed in
float32, rows padded to 4.

While a profiler runs, each launch is a device span ``field.hash_march``
(none inside a CUDA graph's capture) and the counter ``field.hash_march``
counts the launches (``utils/profiling.py``); ``hash_march.launches``
counts them always.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import NamedTuple

import torch

from dream2real_tpu_torch import build
from dream2real_tpu_torch.device import F32
from dream2real_tpu_torch.nerf.march_kernel import compact_live, march_ranges
from dream2real_tpu_torch.nerf.model import NGPConfig, NGPField
from dream2real_tpu_torch.nerf.render import RenderSettings
from dream2real_tpu_torch.utils.profiling import count, span

IN, HIDDEN, GEO, SH = 32, 64, 15, 16
#: The encoding's layouts H2 covers: (levels, features a level), IN in all.
LAYOUTS = ((16, 2), (8, 4))
# The packed weights: (name, rows, columns used, columns packed), (in, out)
# row-major, in csrc/hash_march.cu's order.
W_LAYOUT = (
    ("sigma_w0", IN, HIDDEN, HIDDEN),
    ("sigma_w1", HIDDEN, 1 + GEO, 1 + GEO),
    ("color_w0", GEO + SH, HIDDEN, HIDDEN),
    ("color_w1", HIDDEN, HIDDEN, HIDDEN),
    ("color_w2", HIDDEN, 3, 4),
)
N_W = sum(k * n for _, k, _, n in W_LAYOUT)  # 9,408 floats


class HashMarchParams(NamedTuple):
    """A hash-grid field laid out for H2: its table (L, T, F) f32 (the
    field's own parameter, (L, F) one of LAYOUTS), the packed weights (N_W,) f32 of bf16 values, the
    field box [aabb_min | aabb_max] (6,) f32, and the levels' resolutions
    and kinds."""

    table: torch.Tensor
    w: torch.Tensor
    field_box: torch.Tensor
    res: tuple
    dense: tuple
    log2_t: int


def supports(cfg: NGPConfig, settings: RenderSettings) -> bool:
    """H2 covers the hash-grid field at instant-ngp's widths, in either
    layout of its encoding, at the crop settings."""
    g = cfg.grid
    return (
        cfg.field_type == "hashgrid"
        and settings.n_fine == 0
        and settings.n_coarse >= 1
        and (g.n_levels, g.n_features) in LAYOUTS
        and 0 <= g.log2_hashmap_size <= 30
        and cfg.hidden_dim == HIDDEN
        and cfg.n_density_layers == 2
        and cfg.geo_feat_dim == GEO
        and cfg.color_width == HIDDEN
        and cfg.n_color_layers == 3
        and cfg.sh_degree == 4
    )


@torch.no_grad()
def pack(field: NGPField) -> HashMarchParams:
    """The field's weights as H2 reads them, made once a score call."""
    p = field.params()
    parts = []
    for name, k, used, n in W_LAYOUT:
        w = p[name].detach().to(torch.bfloat16).to(F32)
        if n > used:
            w = torch.cat([w, w.new_zeros(k, n - used)], dim=1)
        parts.append(w.reshape(-1))
    g = field.cfg.grid
    box = torch.tensor(tuple(field.cfg.aabb_min) + tuple(field.cfg.aabb_max), dtype=F32)
    dev = p["table"].device
    # An asynchronous copy: from pageable memory it waits for the staging
    # copy only, not for the device.
    return HashMarchParams(p["table"].detach(), torch.cat(parts).contiguous(),
                           box.to(dev, non_blocking=True),
                           tuple(int(v) for v in g.level_resolutions()),
                           tuple(int(v) for v in g.level_is_dense()), g.log2_hashmap_size)


_FN: dict = {}


def _fn():
    """The launch function of csrc/hash_march.cu, typed once; the C side's
    weight length checked against this module's."""
    fn = _FN.get("hash_march")
    if fn is None:
        lib = build.load("hash_march")
        got = lib.d2r_hash_march_weights()
        if got != N_W:
            raise RuntimeError(f"csrc/hash_march.cu: {got} packed weights != {N_W} "
                               "(hash_march.py)")
        P, I = ctypes.c_void_p, ctypes.c_int
        fn = lib.d2r_hash_march
        fn.argtypes = [P] * 7 + [I, I] + [P, P] + [I, I, I, P, P, P] \
            + [I, ctypes.c_float, I] + [P] * 4
        fn.restype = I
        _FN["hash_march"] = fn
    return fn


def _march_span():
    """The span of one launch; none while a CUDA graph is being captured
    (its timing events cannot be)."""
    if torch.cuda.is_current_stream_capturing():
        return contextlib.nullcontext()
    return span("field.hash_march", device=True)


def hash_march(origins, dirs, dnorm, t0, t1, live, count_, box, packed: HashMarchParams,
               n_samples: int, min_transmittance: float, early_exit: bool):
    """H2's wrapper: origins (P, 3) f32, dirs (P, R, 3) f32, dnorm / t0 / t1
    (P * R,) f32, live (P * R,) int32 and count (1,) int32 from
    ``compact_live``, box (12,) = [field lo | field hi | march lo | march
    hi] f32, all on one CUDA device. -> rgb (P * R, 3), alpha, depth (P * R,)
    f32, zero for rays not in live[:count]."""
    if not dirs.is_cuda:
        raise ValueError("hash_march: H2 runs on CUDA tensors; the CPU renders through "
                         "render.render_rays")
    P, R = dirs.shape[0], dirs.shape[1]
    dev = dirs.device
    n_levels, n_feat = len(packed.res), packed.table.shape[-1]
    for name, t, dtype, shape in (
        ("origins", origins, F32, (P, 3)), ("dirs", dirs, F32, (P, R, 3)),
        ("dnorm", dnorm, F32, (P * R,)), ("t0", t0, F32, (P * R,)), ("t1", t1, F32, (P * R,)),
        ("live", live, torch.int32, (P * R,)), ("count", count_, torch.int32, (1,)),
        ("box", box, F32, (12,)), ("w", packed.w, F32, (N_W,)),
        ("table", packed.table, F32, (n_levels, 1 << packed.log2_t, n_feat)),
    ):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"hash_march: {name} must be a contiguous {dtype} tensor of shape {shape} on "
                f"{dev}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    rgb = torch.zeros(P * R, 3, dtype=F32, device=dev)
    alpha = torch.zeros(P * R, dtype=F32, device=dev)
    depth = torch.zeros(P * R, dtype=F32, device=dev)
    res = (ctypes.c_int * n_levels)(*packed.res)
    dense = (ctypes.c_int * n_levels)(*packed.dense)
    p = build.ptr
    with _march_span(), torch.cuda.device(dev):
        err = _fn()(
            p(origins), p(dirs), p(dnorm), p(t0), p(t1), p(live), p(count_), R, P * R, p(box),
            p(packed.table), n_levels, n_feat, packed.log2_t, ctypes.cast(res, ctypes.c_void_p),
            ctypes.cast(dense, ctypes.c_void_p), p(packed.w), n_samples,
            float(min_transmittance), int(bool(early_exit)), p(rgb), p(alpha), p(depth),
            build.stream_ptr(dev))
    build.check(err, "hash_march")
    hash_march.launches += 1
    count("field.hash_march")
    return rgb, alpha, depth


hash_march.launches = 0


def march_rays_hash(
    packed: HashMarchParams,
    origins: torch.Tensor,   # (P, 3) camera centres, one per pose
    dirs: torch.Tensor,      # (P, R, 3) world dirs, z-normalized
    march_aabb,              # (lo, hi), host values or device tensors
    settings: RenderSettings,
    early_exit: bool = True,
) -> dict[str, torch.Tensor]:
    """H2's equivalent of render_rays(...)['rgb'/'alpha'/'depth'] for P poses
    of R rays sharing their pose's origin. -> rgb (P, R, 3), alpha (P, R),
    depth (P, R); rays that miss the box are exact zeros. With the box on
    the device, nothing here waits for the device. ``early_exit`` False
    marches every sample (the same bits; for the card tests)."""
    P, R = dirs.shape[0], dirs.shape[1]
    origins = origins.to(F32).contiguous()
    dirs = dirs.to(F32).contiguous()
    t0, t1 = march_ranges(origins, dirs, march_aabb, settings)
    live, n_live = compact_live(t0, t1)
    dnorm = torch.linalg.norm(dirs, dim=-1).reshape(-1).contiguous()
    lo_m = torch.as_tensor(march_aabb[0], dtype=F32, device=dirs.device)
    hi_m = torch.as_tensor(march_aabb[1], dtype=F32, device=dirs.device)
    box = torch.cat([packed.field_box, lo_m, hi_m])
    rgb, alpha, depth = hash_march(origins, dirs, dnorm, t0, t1, live, n_live, box, packed,
                                   settings.n_coarse, settings.min_transmittance, early_exit)
    return {"rgb": rgb.reshape(P, R, 3), "alpha": alpha.reshape(P, R),
            "depth": depth.reshape(P, R)}
