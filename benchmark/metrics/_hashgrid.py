"""The hash-grid field's counts, from the configuration's field (its grid
and widths) that the driver hands a traced run's readers.

The hash encoding (csrc/hashgrid.cu, H1) a point a level: the cell, 3
products and 3 differences, and the 3 complements 1 - w; each of the 8
corners 2 products for its weight and F products and F sums of its
features (the backward: F products and F atomic sums into the table's
gradient). Its bytes that no kernel can avoid: the positions in (3 float32)
and the features out (L F bf16) a point; the backward also the features'
gradient in (L F bf16) a point and the table's gradient written once (L T F
float32) a launch. The corner reads and atomics are not counted: most hit
L2, and counting them would let a share of the bound pass 100%.

The MLPs' multiply-adds a sample: the density MLP (L F -> hidden ... -> 1 +
geo, bias-free) and the colour MLP (geo + SH -> colour width ... -> 3)."""

from __future__ import annotations

from benchmark.metrics import _spans

KERNELS = ("hash_fwd", "hash_bwd")


def grid_shape(field: dict) -> tuple[int, int, int]:
    """(L, T, F) of the field's table."""
    g = field["grid"]
    return g["n_levels"], 1 << g["log2_hashmap_size"], g["n_features"]


def interp_flops(field: dict) -> float:
    """The encoding's operations a point, all levels, one way."""
    L, _, F = grid_shape(field)
    return L * (3 + 3 + 3 + 8 * (2 + 2 * F))


def point_bytes(field: dict) -> float:
    """The bytes a point in or out of one launch: 3 float32 positions and L F
    bf16 features (or their gradient)."""
    L, _, F = grid_shape(field)
    return 3 * 4 + L * F * 2


def table_bytes(field: dict) -> float:
    L, T, F = grid_shape(field)
    return L * T * F * 4


def density_macs(field: dict) -> float:
    L, _, F = grid_shape(field)
    dims = [L * F] + [field["hidden_dim"]] * (field["n_density_layers"] - 1) + \
        [1 + field["geo_feat_dim"]]
    return sum(a * b for a, b in zip(dims, dims[1:]))


def colour_macs(field: dict) -> float:
    dims = [field["geo_feat_dim"] + field["sh_degree"] ** 2] + \
        [field["color_width"]] * (field["n_color_layers"] - 1) + [3]
    return sum(a * b for a, b in zip(dims, dims[1:]))


def backward_points(ctx: dict) -> int:
    """The points a step whose features' gradient reaches the table: the
    samples the loss uses and the free-space samples (the coarse density
    pass takes no gradient)."""
    return ctx["rays"] * (ctx["samples"] + ctx["freespace"])


def encode_window(ctx: dict):
    """(H1's device seconds in the traced window, its backward launches, the
    ``train.encoded_points`` counter), or None: no trace, no span in the
    window, no counter or no launch of the kernel (the plain encoding)."""
    got = _spans.window(ctx)
    if got is None or not ctx.get("field") or not ctx.get("steps"):
        return None
    points = got[1].get("train.encoded_points")
    seconds, launches = ctx["trace"].time_of(*KERNELS)
    if not points or not launches or seconds <= 0:
        return None
    return seconds, ctx["trace"].time_of(KERNELS[1])[1], points
