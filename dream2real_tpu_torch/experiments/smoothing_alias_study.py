"""Smoothing rank fidelity against grid resolution, on the host (port of the
repo's experiments/smoothing_alias_study.py).

``spatially_smooth_heatmap`` blurs with a fixed 3 x 3 kernel in grid cells,
so its physical footprint is three cells: on a coarse grid it averages
poses far apart and flattens a narrow score peak. This study isolates that
with no render or CLIP noise: an analytic score field sampled at growing
resolutions over fixed bounds, smoothed by the production function and
ranked against the analytic truth (Spearman rho over the top quarter of
the true poses), noiseless and with iid score noise.

    python -m dream2real_tpu_torch.experiments.smoothing_alias_study [out.json]

CPU only, seconds. Prints one line per resolution and writes the JSON (the
JAX script's keys and values) to ``out.json`` when given.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from dream2real_tpu_torch.smoothing import spatially_smooth_heatmap

RESOLUTIONS = (9, 15, 25, 41, 81)
NOISE_LEVELS = (0.0, 0.01, 0.03, 0.06)


def true_field(x, y):
    """A smooth multimodal score field on [0, 1]^2: a narrow primary peak,
    a broad secondary bump and a gentle slope."""
    peak = 1.00 * np.exp(-(((x - 0.62) / 0.060) ** 2 + ((y - 0.38) / 0.095) ** 2))
    bump = 0.45 * np.exp(-(((x - 0.25) / 0.22) ** 2 + ((y - 0.70) / 0.20) ** 2))
    slope = 0.10 * (x + 0.5 * y)
    return peak + bump + slope


def rank_corr_top(true_v, est_v, frac=0.25):
    """Spearman rho over the top ``frac`` of the TRUE poses, as the argmax
    validator ranks only the oracle's top poses."""
    from scipy.stats import spearmanr

    k = max(8, int(len(true_v) * frac))
    top = np.argsort(true_v)[-k:]
    return float(spearmanr(true_v[top], est_v[top]).statistic)


def run(log=print) -> dict:
    rng = np.random.default_rng(0)
    out = {"resolutions": [], "noise_levels": list(NOISE_LEVELS)}
    for res in RESOLUTIONS:
        xs = np.linspace(0.0, 1.0, res)
        g = np.stack(np.meshgrid(xs, xs, indexing="ij"), -1).reshape(-1, 2)
        true_v = true_field(g[:, 0], g[:, 1])
        cell = float(xs[1] - xs[0])
        row = {"res": res, "cell": round(cell, 4), "kernel_footprint": round(3 * cell, 4),
               "noise": {}}
        for nz in NOISE_LEVELS:
            raw = true_v + (rng.normal(size=true_v.shape) * nz if nz else 0.0)
            sm = spatially_smooth_heatmap(torch.as_tensor(raw, dtype=torch.float32),
                                          [res, res, 1, 1, 1, 1]).numpy()
            row["noise"][str(nz)] = {
                "rho_raw": round(rank_corr_top(true_v, raw), 3),
                "rho_smoothed": round(rank_corr_top(true_v, sm), 3),
            }
        out["resolutions"].append(row)
        n0 = row["noise"]["0.0"]
        log(f"res {res:3d}  cell {cell:.4f}  3x3 footprint {3 * cell:.4f}  noiseless: raw "
            f"{n0['rho_raw']:.3f} -> smoothed {n0['rho_smoothed']:.3f}")
    # The production observation this explains (the JAX package's TPU log).
    out["production_reference_points"] = {
        "rect_15x15x2x2": {"rho_raw": 0.927, "rho_smoothed": 0.796},
        "rect_25x25x2x2": {"rho_raw": 0.942, "rho_smoothed": 0.893},
        "note": "raw-vs-smoothed gap 0.131 -> 0.049 as the grid densifies "
                "15 -> 25 per axis, matching the noiseless aliasing curve "
                "below; smoothing acts per (z,orientation) slice so "
                "orientation axes are NOT blended (smoothing.py).",
    }
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    out = run()
    if argv:
        with open(argv[0], "w") as f:
            json.dump(out, f, indent=1)
        print(f"# wrote {argv[0]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
