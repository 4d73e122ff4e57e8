"""The yardstick's arithmetic: the card's published peaks, the least time a
piece of work could take on it, and the operations and bytes of each kernel
and of each model step, computed from the shapes.

Frozen copies of ``chip_smoke.py``'s ``bound_ms`` and its per-sample MAC
counts of the flagship field (K1, K5-K7), with the counts of the CLIP
vision tower (ViT-L/14@336: 190.9 G multiply-adds a forward) and of the
tower's four GEMMs added. A byte is counted once for each input read and
each output written, whatever a kernel reads again.
"""

from __future__ import annotations

# One H100 SXM, NVIDIA's data sheet, dense rates: bf16 tensor cores and HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# Field MACs a sample at the widths the function needs, not the kernels'
# padded tiles: the trunk 63 -> 256, 2 x 256^2, 319 -> 256, 256 -> 16 (sigma
# and 15 geometry features); the colour head 31 -> 64 -> 64 -> 3; the
# density-only trunk, whose last layer is sigma's one column.
TRUNK_MACS = 63 * 256 + 2 * 256 * 256 + 319 * 256 + 256 * 16
COLOUR_MACS = 31 * 64 + 64 * 64 + 64 * 3
DENSITY_MACS = 63 * 256 + 2 * 256 * 256 + 319 * 256 + 256 * 1
FIELD_MACS = TRUNK_MACS + COLOUR_MACS
# K7 without ray gradients: the forward recompute, the weight-gradient
# products (as many MACs as the forward) and the delta products that feed
# them: rgb -> c1 -> c0 -> the 15 geometry features, then h4 -> h3 -> h2 ->
# h1 -> h0.
DELTA_MACS = 64 * 3 + 64 * 64 + 15 * 64 + 256 * 16 + 3 * 256 * 256
BWD_MACS = 2 * FIELD_MACS + DELTA_MACS

# The packed weights the kernels read: K1's (nerf/march_kernel.py W_LAYOUT,
# B_LAYOUT) and K5-K7's (nerf/train_kernel.py W_LAYOUT, B_LAYOUT, G_LAYOUT).
K1_W = (64 * 256 + 2 * 256 * 256 + 320 * 256 + 272 * 80 + 64 * 64 + 64 * 16)
K1_B = 4 * 256 + 80
TRAIN_FWD_W = (64 * 256 + 2 * 256 * 256 + 320 * 256 + 256 * 16 + 32 * 64 + 64 * 64 + 64 * 16)
TRAIN_W = TRAIN_FWD_W + (16 * 256 + 256 * 320 + 2 * 256 * 256 + 256 * 64 + 16 * 64 + 64 * 64
                         + 64 * 16)
TRAIN_B = 4 * 256 + 16
TRAIN_G = TRAIN_FWD_W + TRAIN_B


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take, and which bound sets it."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


# ------------------------------------------------------------------ K1


def k1_flops(needed_samples: int) -> float:
    """K1's operations: the field at every sample these rays need (the live
    rays' samples while their transmittance is above the cut)."""
    return 2.0 * FIELD_MACS * needed_samples


def k1_bytes(live_rays: int) -> float:
    """Origin, direction, t0, t1 in and rgb, alpha, depth out per live ray
    (13 f32); the two boxes and the packed weights once."""
    return live_rays * 13 * 4 + 12 * 4 + K1_W * 2 + K1_B * 4


# ------------------------------------------------------------------ CLIP


def vit_macs(image_size: int = 336, patch: int = 14, width: int = 1024, layers: int = 24,
             mlp_ratio: int = 4) -> float:
    """Multiply-adds of one image through the published vision tower: the
    patch embedding, every block's dense layers on every token (qkv, the
    out-projection, fc1, fc2: 12 W^2 a token at ratio 4) and its attention
    products (q k^T and p v: 2 T^2 W)."""
    grid = image_size // patch
    tokens = grid * grid + 1
    patch_embed = grid * grid * patch * patch * 3 * width
    dense = tokens * (3 + 1 + 2 * mlp_ratio) * width * width
    attention = 2 * tokens * tokens * width
    return patch_embed + layers * (dense + attention)


def tower_gemms(batch: int, tokens: int = 577, width: int = 1024, layers: int = 24,
                mlp_ratio: int = 4) -> list[tuple[str, int, int, int, bool]]:
    """The vision tower's GEMMs of one clip group as the port runs them on
    ``gemm_tma``: (name, M, K, N, residual read) each. Every block runs qkv,
    the out-projection, fc1 and fc2 on every token, but the last, whose
    out-projection and MLP take the class token alone (only it feeds
    ln_post)."""
    W, F = width, mlp_ratio * width
    M, m = batch * tokens, batch
    out = []
    for i in range(layers):
        rows = M if i < layers - 1 else m
        out += [("qkv", M, W, 3 * W, False), ("proj", rows, W, W, True),
                ("fc1", rows, W, F, False), ("fc2", rows, F, W, True)]
    return out


def gemm_flops_bytes(M: int, K: int, N: int, resid: bool) -> tuple[float, float]:
    """A bf16 GEMM with an f32 bias: A, W, the bias and (when added) the
    residual read once, the bf16 output written once."""
    nbytes = M * K * 2 + K * N * 2 + N * 4 + M * N * 2 + (M * N * 2 if resid else 0)
    return 2.0 * M * K * N, nbytes


def tower_gemm_bound_ms(batch: int, **kw) -> float:
    """The sum of each GEMM's own bound over one clip group."""
    return sum(bound_ms(*gemm_flops_bytes(M, K, N, r))[0]
               for _, M, K, N, r in tower_gemms(batch, **kw))


# ------------------------------------------------------------------ training


def k7_flops(rays: int, samples: int) -> float:
    return 2.0 * BWD_MACS * rays * samples


def k7_bytes(rays: int, samples: int) -> float:
    """Per ray its origin, direction, samples and the ten f32 of the
    outputs' cotangents and saved outputs; the packed weights read once and
    the f32 gradients written once."""
    return rays * (6 + samples + 10) * 4 + TRAIN_W * 2 + TRAIN_G * 4


def train_step_flops(rays: int, coarse: int, samples: int, freespace: int) -> float:
    """The model's operations of one training step, whatever implements
    them: the sampler's density pass over the coarse samples, the forward
    and backward (twice the forward) of the field at every sample the loss
    uses, and of the density trunk at the free-space samples."""
    sampler = 2.0 * DENSITY_MACS * rays * coarse
    render = 3 * 2.0 * FIELD_MACS * rays * samples
    carve = 3 * 2.0 * TRUNK_MACS * rays * freespace
    return sampler + render + carve
