"""Seed study of the training sampler: ``tools/train_trajectory.py`` for
each seed under the default sampler (K5's defensive mixture) and under
``D2R_FUSED_SAMPLER=0`` (K8's coarse weights, ``sample_pdf``, the sorted
union), a few runs at a time on one card.

One line a run: the final PSNR and median depth error the selftest reports,
whether they meet its bar (> 22 dB, < 5 cm), the step at which the field
has left its empty start (the first check from which K6's mean alpha over
the step's batch stays above 1e-3), and the worst K6 / K7 agreement with
their plain versions along the way; then each sampler's mean PSNR. Each
run's full output goes to ``<out>/seed<N>_<sampler>.log``; ``--from-logs``
summarises the logs of an earlier run there instead of training.

    PYTHONPATH=. python tools/seed_study.py [--seeds 0 1 2 3 4 5] [--steps 3000]
        [--every 50] [--jobs 4] [--out build/seed_study] [--from-logs]

Run from the repo root; needs one GPU.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

SAMPLERS = {"K5": "1", "K8": "0"}  # the label of a run -> D2R_FUSED_SAMPLER
EMPTY_ALPHA = 1e-3


def parse(text: str) -> dict:
    """A train_trajectory.py log -> its numbers (None where a line is missing).
    The field leaves its empty start at the first checked step from which
    every check reads a mean alpha above EMPTY_ALPHA: a fresh field's fog
    reads near 1 in the first checks before it clears, and an empty field's
    batches read above it now and then."""
    left, steps = None, []
    for m in re.finditer(r"^step (\d+): mean alpha ([0-9.eE+-]+);", text, re.M):
        steps.append(int(m[1]))
        if float(m[2]) <= EMPTY_ALPHA:
            left = None
        elif left is None:
            left = int(m[1])
    every = steps[1] - steps[0] if len(steps) > 1 else None
    m = re.search(r"K6 worst ([0-9.eE+-]+), K7 worst ([0-9.eE+-]+) x scale, least cosine "
                  r"([0-9.]+); PSNR ([0-9.]+) dB, median depth error ([0-9.]+) mm", text)
    if m is None:
        return {"left_empty": left, "every": every, "psnr": None}
    return {"left_empty": left, "every": every, "k6": float(m[1]), "k7": float(m[2]),
            "cos": float(m[3]), "psnr": float(m[4]), "depth_mm": float(m[5])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4, 5])
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--every", type=int, default=50)
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--out", default="build/seed_study")
    ap.add_argument("--from-logs", action="store_true")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    tool = Path(__file__).resolve().parent / "train_trajectory.py"

    def run(job):
        seed, label = job
        log = out / f"seed{seed}_{label}.log"
        if args.from_logs:
            return seed, label, 0, parse(log.read_text())
        env = dict(os.environ, D2R_FUSED_SAMPLER=SAMPLERS[label])
        proc = subprocess.run(
            [sys.executable, str(tool), "--seed", str(seed), "--steps", str(args.steps),
             "--every", str(args.every)], env=env, capture_output=True, text=True)
        log.write_text(proc.stdout + proc.stderr)
        return seed, label, proc.returncode, parse(proc.stdout)

    jobs = [(s, label) for label in SAMPLERS for s in args.seeds]
    with ThreadPoolExecutor(args.jobs) as pool:
        results = list(pool.map(run, jobs))
    ok = True
    for seed, label, rc, r in results:
        if rc != 0 or r["psnr"] is None:
            ok = False
            print(f"seed {seed} {label}: FAILED (exit {rc}; see {out}/seed{seed}_{label}.log)")
            continue
        bar = r["psnr"] > 22.0 and r["depth_mm"] < 50.0
        ok &= bar
        print(f"seed {seed} {label}: PSNR {r['psnr']:.2f} dB, depth error {r['depth_mm']:.1f} mm, "
              f"bar {'met' if bar else 'MISSED'}; left the empty start at step {r['left_empty']} "
              f"(checks every {r['every']}); K6 worst {r['k6']:.3e}, K7 worst {r['k7']:.3e} x "
              f"scale, least cosine {r['cos']:.6f}", flush=True)
    for label in SAMPLERS:
        ps = [r["psnr"] for _, lab, _, r in results if lab == label and r["psnr"] is not None]
        if ps:
            print(f"{label}: mean PSNR {sum(ps) / len(ps):.2f} dB over {len(ps)} seeds "
                  f"({min(ps):.2f}-{max(ps):.2f})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
