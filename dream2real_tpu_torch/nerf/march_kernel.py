"""Fused ray-march kernel K1 (port of dream2real_tpu/nerf/march_kernel.py).

``march`` is the kernel's wrapper: on CUDA tensors it launches
``csrc/march.cu`` (or raises), on CPU tensors it runs ``march_plain_live``,
the plain PyTorch version of the same function over the same compacted rays.
``march_rays_fused`` is the caller-facing function: it finds each ray's box
range, compacts the rays that hit the box on the device (``compact_live``:
no host sync; a clip group with no live ray still launches and gives exact
zeros), marches them (all poses of a clip group in one launch) and scatters
their results back through the same index; results do not depend on the
batching. ``march_plain`` is the plain version on per-ray inputs, which the
CPU tests hold against the JAX package's Pallas kernel.

``pack_params`` is the reference's ``_pad_params`` folding, laid out for the
kernel, once a field: every weight (K x N) row-major for ``x @ W``, the sigma
row and the colour layer's geo columns folded into one head matrix, the SH
term folded into that head as 16 extra K rows, and the wgmma image the kernel
streams (``MARCH_JOBS``: the same matrices cut into the K-tiles its products
take, swizzled as shared memory holds them). The plain version consumes the
same packed tensors, so the CPU parity tests check the packing the kernel
reads; ``march_geometry`` is where the kernel's tiles of (ray, sample) rows
and its grid are decided (the C launch function checks them).
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import torch

from dream2real_tpu_torch import build
from dream2real_tpu_torch.device import BF16, F32, bf16_round, dot_exact
from dream2real_tpu_torch.nerf.model import NGPConfig, NGPField, posenc_freqs, sh_encode_deg4
from dream2real_tpu_torch.nerf.render import RenderSettings, ray_aabb

# Packed bf16 weights, (K x N) row-major.
W_LAYOUT = (
    ("w0", 64, 256),    # enc (63 + zero) -> hidden
    ("w1", 256, 256),
    ("w2", 256, 256),
    ("w3", 320, 256),   # [enc 64 | hidden 256] -> hidden
    ("wm", 272, 80),    # [hidden 256 | sh 16] -> [geo colour 64 | sigma | pad 15]
    ("cw1", 64, 64),
    ("cw2", 64, 16),    # -> rgb logits (3 used)
)
B_LAYOUT = (("b0", 256), ("b1", 256), ("b2", 256), ("b3", 256), ("bm", 80))
N_W = sum(k * n for _, k, n in W_LAYOUT)  # 256,256 bf16 (0.5 MB)
N_B = sum(n for _, n in B_LAYOUT)

# K1's weight jobs in the order its products take them, each (matrix, first
# row, rows, first column, columns): a K-tile of one layer, 128 or 64 columns
# wide, columns past the matrix zero. The head is 128 wide (80 used) over
# [h3 | SH]: four K-tiles of h3, then SH's 16 rows.
_K256 = range(0, 256, 64)
MARCH_JOBS = (
    *(("w0", 0, 64, n0, 128) for n0 in (0, 128)),
    *((m, k0, 64, n0, 128) for m in ("w1", "w2") for n0 in (0, 128) for k0 in _K256),
    *(("w3", k0, 64, n0, 128) for n0 in (0, 128) for k0 in range(0, 320, 64)),
    *(("wm", k0, 64, 0, 128) for k0 in _K256),
    ("wm", 256, 16, 0, 128), ("cw1", 0, 64, 0, 64), ("cw2", 0, 64, 0, 64),
)
IMAGE_BYTES = sum(2 * rows * cols for _, _, rows, _, cols in MARCH_JOBS)
TILE_ROWS = 128  # rows of a tile: two warpgroups of 64
RING_STAGES, STAGE_BYTES = 6, 16384
# csrc/march.cu's shared memory: the ring, its barriers, the job table, two
# tile indices, 129 ray slots of 128 bytes, the rows' sigma and rgb.
MARCH_SMEM = RING_STAGES * STAGE_BYTES + 128 + 2 * len(MARCH_JOBS) * 4 + 16 + 129 * 128 \
    + 4 * TILE_ROWS * 4


def image_index(w_layout, jobs) -> torch.Tensor:
    """Gather index of a wgmma weight image: for each bf16 of it, its index
    into the packed weights (``w_layout`` order), or their length (a zero)
    for padding. Each job (matrix, first row, rows, first column, columns,
    ...) is laid out as 64-column chunks of (rows x 128 bytes), 128-byte
    swizzled, one job after another."""
    offs, off = {}, 0
    for name, k, n in w_layout:
        offs[name] = (off, n)
        off += k * n
    parts = []
    for name, k0, rows, n0, cols, *_ in jobs:
        base, n = offs[name]
        r = torch.arange(rows)[:, None]
        c = torch.arange(cols)[None, :]
        src = torch.where(n0 + c < n, base + (k0 + r) * n + n0 + c, torch.full_like(r * c, off))
        dst = (c // 64) * rows * 64 + r * 64 + (((c % 64) // 8) ^ (r % 8)) * 8 + c % 8
        idx = torch.empty(rows * cols, dtype=torch.long)
        idx[dst.reshape(-1)] = src.reshape(-1)
        parts.append(idx)
    return torch.cat(parts)


_IMAGE_INDEX: dict = {}


class MarchParams(NamedTuple):
    """A field packed for K1: w bf16 (N_W,), b f32 (N_B,), the wgmma image
    (IMAGE_BYTES of bf16) and the field box [aabb_min | aabb_max] f32 (6,)."""

    w: torch.Tensor
    b: torch.Tensor
    img: torch.Tensor
    field_box: torch.Tensor


def supports(cfg: NGPConfig, settings: RenderSettings) -> bool:
    """The kernel covers the imagination-loop configuration only."""
    return (
        cfg.field_type == "mlp"
        and settings.n_fine == 0
        and cfg.posenc_deg == 10
        and cfg.mlp_width == 256
        and cfg.mlp_depth == 5
        and cfg.skip_layer == 3
        and cfg.geo_feat_dim == 15
        and cfg.color_width == 64
        and cfg.n_color_layers == 3
        and cfg.sh_degree == 4
    )


@torch.no_grad()
def pack_params(field: NGPField) -> MarchParams:
    """Fold the flagship field's weights for K1, once a field."""
    p = field.params()
    dev = p["trunk_w0"].device

    def zeros(*shape):
        return torch.zeros(shape, dtype=F32, device=dev)

    w4, b4, cw0 = p["trunk_w4"], p["trunk_b4"], p["color_w0"]  # (256,16), (16,), (31,64)
    w3 = p["trunk_w3"]  # (319, 256): rows [hidden 256 | enc 63]
    wm = torch.cat([w4[:, 1:16] @ cw0[:15], w4[:, 0:1], zeros(256, 15)], dim=1)
    csh = torch.cat([cw0[15:31], zeros(16, 16)], dim=1)
    mats = {
        "w0": torch.cat([p["trunk_w0"], zeros(1, 256)]),
        "w1": p["trunk_w1"],
        "w2": p["trunk_w2"],
        "w3": torch.cat([w3[256:], zeros(1, 256), w3[:256]]),
        "wm": torch.cat([wm, csh]),
        "cw1": p["color_w1"],
        "cw2": torch.cat([p["color_w2"], zeros(64, 13)], dim=1),
    }
    bm = torch.cat([b4[1:16] @ cw0[:15], b4[0:1], zeros(15)])
    biases = {"b0": p["trunk_b0"], "b1": p["trunk_b1"], "b2": p["trunk_b2"],
              "b3": p["trunk_b3"], "bm": bm}
    for name, k, n in W_LAYOUT:
        assert mats[name].shape == (k, n), (name, mats[name].shape)
    w = torch.cat([mats[name].reshape(-1) for name, _, _ in W_LAYOUT]).to(BF16).contiguous()
    b = torch.cat([biases[name].reshape(-1) for name, _ in B_LAYOUT]).to(F32).contiguous()
    idx = _IMAGE_INDEX.get(dev)
    if idx is None:
        idx = _IMAGE_INDEX[dev] = image_index(W_LAYOUT, MARCH_JOBS).to(dev)
    img = torch.cat([w, w.new_zeros(1)])[idx]
    # An asynchronous copy: from pageable memory it waits for the staging
    # copy only, not for the device.
    box = torch.tensor(tuple(field.cfg.aabb_min) + tuple(field.cfg.aabb_max), dtype=F32)
    return MarchParams(w, b, img, box.to(dev, non_blocking=True))


def _unpack(w: torch.Tensor, b: torch.Tensor) -> tuple[dict, dict]:
    mats, off = {}, 0
    for name, k, n in W_LAYOUT:
        mats[name] = w[off : off + k * n].reshape(k, n)
        off += k * n
    biases, off = {}, 0
    for name, n in B_LAYOUT:
        biases[name] = b[off : off + n]
        off += n
    return mats, biases


def _fma(a, b, c):
    """a * b + c with one rounding (f32 products are exact in f64), the
    contraction the kernel and the reference's compiled kernel both apply to
    the sample position, encoding angle and world position."""
    return (a.double() * b.double() + c.double()).float()


def march_plain(origins, dirs, t0, t1, box, w, b, n_samples: int, min_transmittance: float,
                early_exit: bool, count_samples: bool = False):
    """Plain PyTorch version of the kernel, ray-major. origins and dirs
    (N, 3), t0/t1 (N,) (a ray with t0 >= t1 is a miss), box (12,) =
    [field lo | field hi | march lo | march hi]. -> rgb (N, 3), alpha (N,),
    depth (N,), f32. count_samples=True also returns the number of samples
    the data needs: those of live rays still above min_transmittance."""
    mats, biases = _unpack(w, b)
    n = dirs.shape[0]
    lo_f, hi_f, lo_m, hi_m = box.reshape(4, 3)
    lo_i, hi_i = torch.maximum(lo_f, lo_m), torch.minimum(hi_f, hi_m)
    scale = 2.0 / (hi_f - lo_f)
    a3 = _fma(origins, scale, -2.0 * lo_f / (hi_f - lo_f) - 1.0)
    b3 = dirs * scale
    freqs = posenc_freqs(10, dirs.device)
    A = (a3[:, None, :] * freqs[None, :, None]).reshape(n, 30)  # freq-major [f0 xyz | f1 xyz ...]
    B = (b3[:, None, :] * freqs[None, :, None]).reshape(n, 30)
    dn = torch.sqrt((dirs * dirs).sum(dim=-1))
    dt = (t1 - t0) / n_samples
    sh = bf16_round(sh_encode_deg4(dirs / dn[:, None]))
    live = t0 < t1
    zeros1 = torch.zeros(n, 1, dtype=F32, device=dirs.device)

    trans = torch.ones(n, dtype=F32, device=dirs.device)
    acc_rgb = torch.zeros(n, 3, dtype=F32, device=dirs.device)
    acc_a = torch.zeros(n, dtype=F32, device=dirs.device)
    acc_d = torch.zeros(n, dtype=F32, device=dirs.device)
    needed = torch.zeros((), dtype=torch.int64, device=dirs.device)
    for s in range(n_samples):
        alive = live & (trans >= min_transmittance)
        needed = needed + alive.sum()
        if early_exit and not bool(alive.any()):
            break  # exact: every remaining weight is zero
        ts = _fma(torch.full_like(dt, s + 0.5), dt, t0)
        ang = _fma(B, ts[:, None], A)
        p2 = _fma(b3, ts[:, None], a3)
        enc = bf16_round(torch.cat([p2, torch.sin(ang), torch.cos(ang), zeros1], dim=1))
        h = bf16_round(torch.relu(dot_exact(enc, mats["w0"]) + biases["b0"]))
        h = bf16_round(torch.relu(dot_exact(h, mats["w1"]) + biases["b1"]))
        h = bf16_round(torch.relu(dot_exact(h, mats["w2"]) + biases["b2"]))
        h = bf16_round(torch.relu(dot_exact(torch.cat([enc, h], 1), mats["w3"]) + biases["b3"]))
        hm = dot_exact(torch.cat([h, sh], 1), mats["wm"]) + biases["bm"]
        sigma = torch.exp(torch.clamp(hm[:, 64], -15.0, 15.0))
        pos = _fma(dirs, ts[:, None], origins)
        inside = ((pos >= lo_i) & (pos <= hi_i)).all(dim=1)
        sigma = torch.where(inside, sigma, torch.zeros_like(sigma))
        c = bf16_round(torch.relu(hm[:, :64]))
        c = bf16_round(torch.relu(dot_exact(c, mats["cw1"])))
        rgb = torch.sigmoid(dot_exact(c, mats["cw2"])[:, :3])

        delta = 1e2 if s == n_samples - 1 else dt
        a = 1.0 - torch.exp(-sigma * delta * dn)
        wgt = torch.where(trans < min_transmittance, torch.zeros_like(a), a * trans)
        acc_rgb = acc_rgb + wgt[:, None] * rgb
        acc_a = acc_a + wgt
        acc_d = acc_d + wgt * ts
        trans = trans * (1.0 - a + 1e-10)
    if count_samples:
        return acc_rgb, acc_a, acc_d, int(needed)
    return acc_rgb, acc_a, acc_d


def march_geometry(n_rays: int, S: int, n_sm: int) -> dict:
    """Tiles and grid of a K1 launch over at most ``n_rays`` live rays of S
    samples. A tile of ``TILE_ROWS`` rows holds ``rays_per_tile`` rays x
    ``samples_per_tile`` samples and walks their S samples in ``steps``; the
    samples a tile takes at a time are chosen from 4-8 (S itself below 4) to
    leave the fewest rows idle, ties to the fewer (the early exit looks at the
    rays between steps). ``grid`` is one block an SM, at most one a tile;
    each block takes tiles from a counter until the live rays run out."""
    if S < 1:
        raise ValueError(f"the march needs at least one sample a ray, got {S}")

    def busy(spt):  # the share of a tile's rows that hold a sample
        return S * (TILE_ROWS // spt) / (-(-S // spt) * TILE_ROWS)

    spt = S if S < 4 else max(range(4, min(S, 8) + 1), key=lambda k: (busy(k), -k))
    rpt = TILE_ROWS // spt
    tiles = max(1, -(-n_rays // rpt))
    return {"samples_per_tile": spt, "rays_per_tile": rpt, "steps": -(-S // spt),
            "tiles": tiles, "grid": max(1, min(n_sm, tiles)), "ring_stages": RING_STAGES,
            "smem_bytes": MARCH_SMEM, "image_bytes": IMAGE_BYTES}


def march_ranges(origins: torch.Tensor, dirs: torch.Tensor, march_aabb,
                 settings: RenderSettings):
    """Each ray's sample range over the march box: origins (P, 3), dirs
    (P, R, 3) -> t0, t1 (P * R,), clamped to [near, far]; t0 >= t1 on a
    miss. ``march_aabb`` (lo, hi) may lie on the device already."""
    t0, t1 = ray_aabb(origins[:, None, :], dirs, march_aabb[0], march_aabb[1])
    return (torch.clamp(t0, min=settings.near).reshape(-1).contiguous(),
            torch.clamp(t1, max=settings.far).reshape(-1).contiguous())


def compact_live(t0: torch.Tensor, t1: torch.Tensor):
    """The rays with t1 > t0, compacted on the device without a host sync:
    live (N,) int32 holds their flat indices in order in its first ``count``
    entries (the rest are not read), count (1,) int32."""
    hit = t1 > t0
    n = hit.numel()
    pos = torch.cumsum(hit, 0, dtype=torch.int32)
    dst = torch.where(hit, pos - 1, n).long()  # misses land in slot n, dropped
    live = torch.zeros(n + 1, dtype=torch.int32, device=hit.device)
    live.scatter_(0, dst, torch.arange(n, dtype=torch.int32, device=hit.device))
    return live[:n], pos[n - 1 :].clone()


def live_rays(origins, dirs, t0, t1, live, count):
    """Per-ray inputs of the live rays (for the plain version; reads count
    on the host): origins, dirs (n, 3), t0, t1 (n,), their flat indices (n,)."""
    g = live[: int(count[0])].long()
    return (origins[g // dirs.shape[1]].contiguous(), dirs.reshape(-1, 3)[g].contiguous(),
            t0[g].contiguous(), t1[g].contiguous(), g)


def march_plain_live(origins, dirs, t0, t1, live, count, box, packed: MarchParams,
                     n_samples: int, min_transmittance: float, early_exit: bool):
    """Plain version of ``march``: ``march_plain`` over the live rays,
    scattered into zeros. -> rgb (P * R, 3), alpha, depth (P * R,)."""
    n_all = dirs.shape[0] * dirs.shape[1]
    rgb = torch.zeros(n_all, 3, dtype=F32, device=dirs.device)
    alpha = torch.zeros(n_all, dtype=F32, device=dirs.device)
    depth = torch.zeros(n_all, dtype=F32, device=dirs.device)
    *rays, g = live_rays(origins, dirs, t0, t1, live, count)
    if g.numel():
        rgb[g], alpha[g], depth[g] = march_plain(*rays, box, packed.w, packed.b, n_samples,
                                                 min_transmittance, early_exit)
    return rgb, alpha, depth


_FN: dict = {}
_N_SM: dict = {}


def _fn():
    """The launch function of csrc/march.cu, typed once; the C side's image
    and shared-memory sizes checked against this module's once."""
    fn = _FN.get("march")
    if fn is None:
        lib = build.load("march")
        for name, want in (("d2r_march_image_bytes", IMAGE_BYTES),
                           ("d2r_march_smem_bytes", MARCH_SMEM)):
            got = getattr(lib, name)()
            if got != want:
                raise RuntimeError(f"csrc/march.cu: {name} {got} != {want} (march_kernel.py)")
        P, I = ctypes.c_void_p, ctypes.c_int
        fn = lib.d2r_march
        fn.argtypes = [P] * 7 + [I] + [P] * 3 + [I, ctypes.c_float] + [I] * 6 + [P] * 4
        fn.restype = I
        _FN["march"] = fn
    return fn


def march(origins, dirs, t0, t1, live, count, box, packed: MarchParams, n_samples: int,
          min_transmittance: float, early_exit: bool):
    """K1 wrapper: origins (P, 3) f32, dirs (P, R, 3) f32, t0 / t1 (P * R,)
    f32, live (P * R,) int32 and count (1,) int32 from ``compact_live``, box
    (12,) = [field lo | field hi | march lo | march hi], ``packed`` from
    ``pack_params``. -> rgb (P * R, 3), alpha, depth (P * R,) f32, zero for
    rays not in live[:count]. CPU tensors take the plain version; CUDA
    tensors launch the kernel, which reads count on the device."""
    if not dirs.is_cuda:
        return march_plain_live(origins, dirs, t0, t1, live, count, box, packed, n_samples,
                                min_transmittance, early_exit)
    P, R = dirs.shape[0], dirs.shape[1]
    dev = dirs.device
    for name, t, dtype, shape in (
        ("origins", origins, F32, (P, 3)), ("dirs", dirs, F32, (P, R, 3)),
        ("t0", t0, F32, (P * R,)), ("t1", t1, F32, (P * R,)),
        ("live", live, torch.int32, (P * R,)), ("count", count, torch.int32, (1,)),
        ("box", box, F32, (12,)), ("w", packed.w, BF16, (N_W,)), ("b", packed.b, F32, (N_B,)),
        ("img", packed.img, BF16, (IMAGE_BYTES // 2,)),
    ):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"march: {name} must be a contiguous {dtype} tensor of shape {shape} on {dev}, "
                f"got {tuple(t.shape)} {t.dtype} on {t.device}"
            )
    n_sm = _N_SM.get(dev)
    if n_sm is None:
        n_sm = _N_SM[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    geo = march_geometry(P * R, n_samples, n_sm)
    rgb = torch.zeros(P * R, 3, dtype=F32, device=dev)
    alpha = torch.zeros(P * R, dtype=F32, device=dev)
    depth = torch.zeros(P * R, dtype=F32, device=dev)
    nxt = torch.zeros(1, dtype=torch.int32, device=dev)
    p = build.ptr
    err = _fn()(
        p(origins), p(dirs), p(t0), p(t1), p(live), p(count), p(nxt), R, p(box), p(packed.img),
        p(packed.b), n_samples, float(min_transmittance), int(bool(early_exit)),
        geo["rays_per_tile"], geo["samples_per_tile"], geo["steps"], geo["grid"],
        geo["smem_bytes"], p(rgb), p(alpha), p(depth), build.stream_ptr(dev),
    )
    build.check(err, "march")
    march.launches += 1
    return rgb, alpha, depth


march.launches = 0


def early_exit_default() -> bool:
    """D2R_MARCH_EARLY (default 1): the exact early-transmittance exit."""
    return os.environ.get("D2R_MARCH_EARLY", "1") == "1"


def march_rays_fused(
    packed: MarchParams,
    origins: torch.Tensor,   # (P, 3) camera centres, one per pose
    dirs: torch.Tensor,      # (P, R, 3) world dirs, z-normalized
    march_aabb,              # (lo, hi), host values or device tensors
    settings: RenderSettings,
    early_exit: bool | None = None,
) -> dict[str, torch.Tensor]:
    """Fused-march equivalent of render_rays(...)['rgb'/'alpha'/'depth'] for
    P poses of R rays sharing their pose's origin. -> rgb (P, R, 3), alpha
    (P, R), depth (P, R); rays that miss the box are exact zeros. With the
    box on the device, nothing here waits for the device."""
    if early_exit is None:
        early_exit = early_exit_default()
    P, R = dirs.shape[0], dirs.shape[1]
    origins = origins.to(F32).contiguous()
    dirs = dirs.to(F32).contiguous()
    t0, t1 = march_ranges(origins, dirs, march_aabb, settings)
    live, count = compact_live(t0, t1)
    lo_m = torch.as_tensor(march_aabb[0], dtype=F32, device=dirs.device)
    hi_m = torch.as_tensor(march_aabb[1], dtype=F32, device=dirs.device)
    box = torch.cat([packed.field_box, lo_m, hi_m])
    rgb, alpha, depth = march(origins, dirs, t0, t1, live, count, box, packed,
                              settings.n_coarse, settings.min_transmittance, early_exit)
    return {"rgb": rgb.reshape(P, R, 3), "alpha": alpha.reshape(P, R),
            "depth": depth.reshape(P, R)}
