"""Train the selftest configuration and hold the fused training kernels K6
and K7 against their plain versions along the way.

Every ``--every`` training steps, the step's own batch (rays, samples,
cotangents, packed weights) also goes through ``train_fwd_plain`` and
``train_bwd_plain``: one line gives K6's largest output error and K7's worst
per-parameter error (in units of that parameter's largest plain gradient)
and least cosine, each backward fed its own forward's outputs. A run of low
quality whose kernels agree with their plain versions at every check is one
training trajectory among others, not a kernel fault.

    PYTHONPATH=. python tools/train_trajectory.py --seed 5 [--every 100] [--steps 3000]

Run from the repo root; needs one GPU. Prints one line a check, the
selftest's quality lines, and the worst numbers of the run last.
"""

from __future__ import annotations

import argparse
import sys

import torch

from dream2real_tpu_torch.cli.selftest import run_selftest
from dream2real_tpu_torch.nerf import train_kernel as tk


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--every", type=int, default=100, help="steps between checks")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_trajectory: no CUDA device available", file=sys.stderr)
        return 2

    pack, launch = tk.pack_train_params, tk._train_bwd_launch
    last = {}
    worst = {"k6": 0.0, "k7": 0.0, "cos": 1.0, "checks": 0}
    step = [0]

    def packed(p):
        # The step's packed weights (the backward gets only their image).
        last["wb"] = pack(p)
        return last["wb"]

    def checked(origins, dirs, ts, box, img, b, min_t, dC, dA, dD, C, A, D, ray_grads,
                bufs=None):
        out = launch(origins, dirs, ts, box, img, b, min_t, dC, dA, dD, C, A, D, ray_grads, bufs)
        step[0] += 1
        if step[0] % args.every:
            return out
        w = last["wb"][0]
        fwd = tk.train_fwd_plain(origins, dirs, ts, box, w, b, min_t)
        e6 = max(float((k - p).abs().max()) for k, p in zip((C, A, D), fwd))
        g_p = tk.unpack_grads(tk.train_bwd_plain(origins, dirs, ts, box, w, b, min_t, dC, dA,
                                                 dD, *fwd, False)[0])
        e7, c7, zero = 0.0, 1.0, []
        for key, gk in tk.unpack_grads(out[0]).items():
            gp = g_p[key]
            e7 = max(e7, float((gk - gp).abs().max()) / max(float(gp.abs().max()), 1e-12))
            if not bool(gp.any()):
                zero.append(key)  # no cosine: e7 holds the kernel's gradient to zero
                continue
            gk, gp = gk.double().reshape(-1), gp.double().reshape(-1)
            c7 = min(c7, float(gk @ gp / (gk.norm() * gp.norm()).clamp_min(1e-300)))
        worst.update(k6=max(worst["k6"], e6), k7=max(worst["k7"], e7), cos=min(worst["cos"], c7),
                     checks=worst["checks"] + 1)
        print(f"step {step[0]}: mean alpha {float(A.mean()):.3e}; K6 max |kernel - plain| "
              f"{e6:.3e}; K7 worst {e7:.3e} x scale, least cosine {c7:.6f}; plain gradient zero "
              f"for {zero}", flush=True)
        return out

    tk.pack_train_params, tk._train_bwd_launch = packed, checked
    try:
        res = run_selftest(steps=args.steps, seed=args.seed)
    finally:
        tk.pack_train_params, tk._train_bwd_launch = pack, launch
    print(f"seed {args.seed}: {worst['checks']} checks; K6 worst {worst['k6']:.3e}, K7 worst "
          f"{worst['k7']:.3e} x scale, least cosine {worst['cos']:.6f}; PSNR {res['psnr']:.2f} "
          f"dB, median depth error {res['depth_err_m'] * 1000:.1f} mm", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
