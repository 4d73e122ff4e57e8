"""Fused ray-march kernel K1 (port of dream2real_tpu/nerf/march_kernel.py).

``march`` is the kernel's wrapper: on a CUDA tensor it launches
``csrc/march.cu`` (or raises), on a CPU tensor it runs ``march_plain``, the
plain PyTorch version of the same function. ``march_rays_fused`` is the
caller-facing function: it finds each ray's box range, launches only the
rays that hit the box (all poses of a clip group in one launch) and
scatters their results back; results do not depend on the batching.

``pack_params`` is the reference's ``_pad_params`` folding, laid out for the
kernel: every weight (K x N) row-major for ``x @ W``, the sigma row and the
colour layer's geo columns folded into one head matrix, and the SH term
folded into that head as 16 extra K rows. The plain version consumes the same
packed tensors, so the CPU parity tests check the packing the kernel reads.
"""

from __future__ import annotations

import ctypes
import os

import torch

from dream2real_tpu_torch import build
from dream2real_tpu_torch.device import BF16, F32, bf16_round, dot_exact
from dream2real_tpu_torch.nerf.model import NGPConfig, NGPField, posenc_freqs, sh_encode_deg4
from dream2real_tpu_torch.nerf.render import RenderSettings, ray_aabb

# Packed bf16 weights, (K x N) row-major, in csrc/march.cu's order.
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


def pack_params(field: NGPField) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold the flagship field's weights into (w bf16 (N_W,), b f32 (N_B,))."""
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
    w = torch.cat([mats[name].reshape(-1) for name, _, _ in W_LAYOUT]).to(BF16)
    b = torch.cat([biases[name].reshape(-1) for name, _ in B_LAYOUT]).to(F32)
    return w.contiguous(), b.contiguous()


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


def march(origins, dirs, t0, t1, box, w, b, n_samples: int, min_transmittance: float,
          early_exit: bool):
    """K1 wrapper: same arguments and results as ``march_plain``. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if not dirs.is_cuda:
        return march_plain(origins, dirs, t0, t1, box, w, b, n_samples, min_transmittance,
                           early_exit)
    n = dirs.shape[0]
    dev = dirs.device
    for name, t, dtype, shape in (
        ("origins", origins, F32, (n, 3)),
        ("dirs", dirs, F32, (n, 3)),
        ("t0", t0, F32, (n,)),
        ("t1", t1, F32, (n,)),
        ("box", box, F32, (12,)),
        ("w", w, BF16, (N_W,)),
        ("b", b, F32, (N_B,)),
    ):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"march: {name} must be a contiguous {dtype} tensor of shape {shape} on {dev}, "
                f"got {tuple(t.shape)} {t.dtype} on {t.device}"
            )
    rgb = torch.empty(n, 3, dtype=F32, device=dev)
    alpha = torch.empty(n, dtype=F32, device=dev)
    depth = torch.empty(n, dtype=F32, device=dev)
    lib = build.load("march")
    fn = lib.d2r_march
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_float, ctypes.c_int] + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    err = fn(
        build.ptr(origins), build.ptr(dirs), build.ptr(t0), build.ptr(t1), n, build.ptr(box),
        build.ptr(w), build.ptr(b), n_samples, float(min_transmittance), int(bool(early_exit)),
        build.ptr(rgb), build.ptr(alpha), build.ptr(depth), build.stream_ptr(dev),
    )
    build.check(err, "march")
    march.launches += 1
    return rgb, alpha, depth


march.launches = 0


def early_exit_default() -> bool:
    """D2R_MARCH_EARLY (default 1): the exact early-transmittance exit."""
    return os.environ.get("D2R_MARCH_EARLY", "1") == "1"


def march_inputs(cfg: NGPConfig, origins: torch.Tensor, dirs: torch.Tensor, march_aabb,
                 settings: RenderSettings):
    """The kernel's inputs for P poses of R rays: only the rays whose box
    range is not empty, each with its own origin, so that every 128-ray
    block of the kernel marches live rays (the early exit stays exact per
    block; misses composite to zero and are never launched).

    origins (P, 3), dirs (P, R, 3) -> (live (n,) flat ray indices, origins
    (n, 3), dirs (n, 3), t0 (n,), t1 (n,), box (12,)). Finding n waits for
    the device once."""
    dev = dirs.device
    lo_m = torch.as_tensor(march_aabb[0], dtype=F32, device=dev)
    hi_m = torch.as_tensor(march_aabb[1], dtype=F32, device=dev)
    t0, t1 = ray_aabb(origins[:, None, :], dirs, lo_m, hi_m)
    t0 = torch.clamp(t0, min=settings.near).reshape(-1)
    t1 = torch.clamp(t1, max=settings.far).reshape(-1)
    live = torch.nonzero(t1 > t0).squeeze(1)
    box = torch.cat([
        torch.tensor(cfg.aabb_min, dtype=F32, device=dev),
        torch.tensor(cfg.aabb_max, dtype=F32, device=dev),
        lo_m, hi_m,
    ])
    return (live, origins[live // dirs.shape[1]].contiguous(),
            dirs.reshape(-1, 3)[live].contiguous(), t0[live].contiguous(),
            t1[live].contiguous(), box)


def march_rays_fused(
    packed: tuple[torch.Tensor, torch.Tensor],
    cfg: NGPConfig,
    origins: torch.Tensor,   # (P, 3) camera centres, one per pose
    dirs: torch.Tensor,      # (P, R, 3) world dirs, z-normalized
    march_aabb,              # (lo, hi)
    settings: RenderSettings,
    early_exit: bool | None = None,
) -> dict[str, torch.Tensor]:
    """Fused-march equivalent of render_rays(...)['rgb'/'alpha'/'depth'] for
    P poses of R rays sharing their pose's origin. -> rgb (P, R, 3), alpha
    (P, R), depth (P, R); rays that miss the box are exact zeros."""
    if early_exit is None:
        early_exit = early_exit_default()
    P, R = dirs.shape[0], dirs.shape[1]
    live, o, d, t0, t1, box = march_inputs(
        cfg, origins.to(F32), dirs.to(F32), march_aabb, settings)
    rgb = torch.zeros(P * R, 3, dtype=F32, device=dirs.device)
    alpha = torch.zeros(P * R, dtype=F32, device=dirs.device)
    depth = torch.zeros(P * R, dtype=F32, device=dirs.device)
    if live.numel():
        w, b = packed
        rgb[live], alpha[live], depth[live] = march(
            o, d, t0, t1, box, w, b, settings.n_coarse, settings.min_transmittance, early_exit)
    return {"rgb": rgb.reshape(P, R, 3), "alpha": alpha.reshape(P, R),
            "depth": depth.reshape(P, R)}
