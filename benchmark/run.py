"""Run one cell of the benchmark once and print its result line last.

    python -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the result's metrics are the cell's end-to-end metrics,
timed over an untraced window of ``--seconds``; with ``--trace 1`` they are
its per-layer metrics, read from a traced window and from spans timed after
it. Either way the run ends with the check that decides ``correct``: the
numbers compared are printed beside their limits as the last lines on
standard error and under the result's last key, ``compared``.

Exits non-zero without a result when no CUDA device is there, when there are
fewer than the cell asks for, or when JAX or the JAX package is loaded in
this process once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # noqa: E402  (the process's start, before any import)

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from benchmark import harness  # noqa: E402


def cache_env(root=harness.ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout, and
    no JAX pulled in by a library the port uses."""
    build = root / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    for var in ("USE_FLAX", "USE_JAX", "USE_TF"):
        os.environ[var] = "0"


def device_record(torch, n: int) -> dict:
    """The card as the driver reads it, with its power limit from nvidia-smi
    beside it (left out where nvidia-smi cannot be read)."""
    rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": n}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout.split("\n")[0]
        rec["power_limit"] = out.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return rec


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    cache_env()
    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("benchmark: no CUDA device; no result", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} devices, "
              f"{torch.cuda.device_count()} present; no result", file=sys.stderr)
        return 3
    ctx = harness.RunContext(cell=cell, seed=args.seed, seconds=args.seconds,
                             trace=bool(args.trace), device=torch.device("cuda", 0),
                             t_start=T_START)
    outcome = harness.load_driver(cell.traffic).run(ctx)
    found = harness.forbidden_loaded()
    if found:
        print(f"benchmark: forbidden modules loaded in this process: {found}; no result",
              file=sys.stderr)
        return 4
    line = harness.result_line(outcome, cell, ctx.trace, device_record(torch, cell.chips))
    for name, (value, limit) in outcome.compared.items():
        print(f"compared {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
