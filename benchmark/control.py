"""Readings that the limits of ``correct`` are set from, for one cell over
several seeds in one process (the benchmark's own runs never run this):

    python -m benchmark.control --workload <name> --seeds 11,12,13 [--fault F]
        [--control 0|1] [--out FILE]

For each seed, the cell's driver's ``readings``: its set-up, then the
program's numbers against the reference (scoring: one block of the cell's
size scored, its check sample compared; training: the first steps
compared), and with ``--control 1`` the control's, the reference in the
precision below in the program's place. ``--fault`` plants one of the
driver's ``FAULTS`` in the program first. One JSON line a seed on standard
output (and appended to ``--out``).
"""

from __future__ import annotations

import argparse
import json
import sys

from benchmark import harness
from benchmark.run import cache_env


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--control", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    cache_env()
    import torch

    cell = harness.load_cell(args.workload)
    driver = harness.load_driver(cell.traffic)
    for seed in (int(v) for v in args.seeds.split(",")):
        ctx = harness.RunContext(cell=cell, seed=seed, seconds=0.0, trace=False,
                                 device=torch.device("cuda", 0), t_start=harness.now())
        if args.fault:
            with driver.plant(args.fault):
                out = driver.readings(ctx, False)
        else:
            out = driver.readings(ctx, bool(args.control))
        line = json.dumps(dict(out, seed=seed, fault=args.fault, workload=cell.name))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
