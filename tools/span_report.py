"""Where a cell's traced window goes, by the program's own spans.

Runs one traced run of a benchmark cell in this process (as
``python3 -m benchmark.run --trace 1`` does) and prints one JSON object: the
card, the window's length, rate and busy time, the per-layer metrics, the
device's idle time named after the innermost program span open on the host
at each gap's midpoint, and how the spans and the profiler's events line up
at the window's edges. For a scoring cell also each block's device time
split into the background render, the clip groups' render and tower, and
the rest, with the block's idle time by span; for a training cell the
kernels and launch calls a step, and the CUDA runtime calls inside its
steps by name (copies and synchronisations included). Run from the repo root on one GPU:

    PYTHONPATH=. python3 tools/span_report.py --workload field-mlp256.fg_task --seed 7 [--out f.json]
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
from collections import defaultdict

import torch


def idle_by_span(trace, line, at, lo=None, hi=None) -> dict:
    """Idle milliseconds by the innermost span at each gap's midpoint, the
    gaps cut to [lo, hi] seconds where given."""
    out: dict = defaultdict(float)
    for s, d in trace.gaps():
        a, b = s, s + d
        if lo is not None:
            a, b = max(a, lo), min(b, hi)
        if b > a:
            out[str(at(line, (a + b) / 2))] += (b - a) * 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _short(name: str) -> str:
    """A kernel's name without its return type, namespace wrapper, template
    and arguments."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("<")[0].split("(")[0][:48]


def gap_pairs(trace, lo: float, hi: float, groups: int, top: int = 12) -> dict:
    """The device's idle inside [lo, hi] seconds by what bounds each gap:
    the operation that last ended before it and the one that starts it
    (names cut at their arguments), with the gaps' count and milliseconds
    a clip group; the gaps' sizes; the device operations and the host's
    launch calls a group, and the host's time inside launch calls (long
    calls wait for room in the launch queue: the host ahead of the device)."""
    pairs: dict = defaultdict(lambda: [0, 0.0])
    sizes = {"<2us": [0, 0.0], "2-10us": [0, 0.0], "10-100us": [0, 0.0], ">=100us": [0, 0.0]}
    prev, end, n_ops = None, None, 0
    for name, s, d in trace.ops:
        if s + d < lo or s > hi:
            continue
        n_ops += 1
        if end is not None and s > end:
            g = s - end
            key = f"{_short(prev)} -> {_short(name)}"
            pairs[key][0] += 1
            pairs[key][1] += g * 1e3
            us = g * 1e6
            b = "<2us" if us < 2 else "2-10us" if us < 10 else "10-100us" if us < 100 \
                else ">=100us"
            sizes[b][0] += 1
            sizes[b][1] += g * 1e3
        if end is None or s + d >= end:
            prev, end = name, s + d
    launches = [(n, d) for n, t, d in trace.host if "LaunchKernel" in n and lo <= t <= hi]
    g = max(groups, 1)
    best = sorted(pairs.items(), key=lambda kv: -kv[1][1])[:top]
    return {
        "ops_per_group": n_ops / g, "launch_calls_per_group": len(launches) / g,
        "launch_call_ms_per_group": sum(d for _, d in launches) * 1e3 / g,
        "launch_calls_over_50us_per_group": sum(d > 50e-6 for _, d in launches) / g,
        "gaps_per_group": sum(v[0] for v in sizes.values()) / g,
        "gap_sizes": {k: {"per_group": v[0] / g, "ms": v[1]} for k, v in sizes.items()},
        "by_pair": [{"pair": k, "per_group": v[0] / g, "ms": v[1]} for k, v in best],
    }


def scoring_blocks(spans: list, trace, line, at) -> list:
    by_req: dict = defaultdict(list)
    for s in spans:
        by_req[s["request"]].append(s)
    out = []
    for b in (s for s in spans if s["name"] == "score.block"):
        mine = by_req[b["id"]]

        def total(name, key="device_ms"):
            vals = [s[key] if key else (s["end_ns"] - s["start_ns"]) * 1e-6
                    for s in mine if s["name"] == name]
            return sum(v for v in vals if v is not None)

        lo, hi = b["start_ns"] * 1e-9, b["end_ns"] * 1e-9
        idle = idle_by_span(trace, line, at, lo, hi)
        groups = total("score.render") + total("score.tower")
        out.append({
            "host_ms": (b["end_ns"] - b["start_ns"]) * 1e-6, "device_ms": b["device_ms"],
            "bg_render_ms": total("score.bg_render"), "render_ms": total("score.render"),
            "tower_ms": total("score.tower"),
            "groups": sum(s["name"] == "score.render" for s in mine),
            "rest_ms": None if b["device_ms"] is None else
            b["device_ms"] - groups - total("score.bg_render"),
            "slab_host_ms": total("score.slab", None), "drain_host_ms": total("score.drain", None),
            "bg_render_host_ms": total("score.bg_render", None),
            "idle_ms": sum(idle.values()), "idle_by_span_ms": idle,
            "gaps": gap_pairs(trace, lo, hi, sum(s["name"] == "score.render" for s in mine)),
        })
    return out


def step_calls(spans: list, trace) -> dict:
    """The CUDA runtime calls made inside ``train.step`` spans, by name, a
    step: the launches, and the copies and synchronisations that drain the
    stream."""
    steps = sorted((s["start_ns"] * 1e-9, s["end_ns"] * 1e-9) for s in spans
                   if s["name"] == "train.step")
    calls: dict = defaultdict(int)
    for name, t, _ in trace.host:
        i = bisect.bisect_right(steps, (t, float("inf"))) - 1
        if i >= 0 and t <= steps[i][1]:
            calls[name] += 1
    return {n: c / len(steps) for n, c in sorted(calls.items())} if steps else {}


def report(ctx) -> dict:
    """Run the traced cell of ``ctx`` and read its window."""
    from benchmark import harness, run
    from benchmark.metrics import _spans
    from dream2real_tpu_torch.utils import profiling

    cell = ctx.cell
    profiling.reset()
    outcome = harness.load_driver(cell.traffic).run(ctx)
    lc = outcome.layer_ctx
    trace = lc["trace"]
    spans = [s for s in profiling.spans() if s["end_ns"] is not None]
    line = _spans.timeline(spans)
    units = lc.get("steps") or lc.get("poses")
    idle = idle_by_span(trace, line, _spans.at)
    total_idle = sum(idle.values())
    rep = {
        "workload": cell.name, "seed": ctx.seed, "correct": outcome.correct,
        "window_s": trace.window_s, "busy_s": trace.busy_s(), "units": units,
        "rate_in_window": units / trace.window_s,
        "metrics": {k: v["value"] for k, v in harness.read_layer_metrics(cell, lc).items()},
        "counters": profiling.counters(), "spans": len(spans),
        "dropped": profiling.RECORDER.dropped,
        "idle_ms": total_idle, "idle_by_span_ms": idle,
        "idle_named_share": 1 - idle.get("None", 0.0) / total_idle if total_idle else None,
        "edges_ms": {
            "first_span_after_t0": (min(s["start_ns"] for s in spans) * 1e-9 - trace.t0_s) * 1e3,
            "last_span_end_before_window_end":
                (trace.t0_s + trace.window_s - max(s["end_ns"] for s in spans) * 1e-9) * 1e3,
            "first_host_event_after_t0": (trace.host[0][1] - trace.t0_s) * 1e3 if trace.host
            else None,
            "first_device_op_after_t0": (trace.ops[0][1] - trace.t0_s) * 1e3 if trace.ops
            else None,
        } if spans else None,
    }
    if "spans" in lc:
        rep["alone_ms_per_pose"] = {k: lc["spans"][k] / lc["spans"]["poses"]
                                    for k in ("render_ms", "tower_ms")}
    if lc.get("steps"):
        kernels = [op for op in trace.ops if not op[0].startswith(("Memcpy", "Memset"))]
        rep.update(kernels_per_step=len(kernels) / lc["steps"],
                   launch_call_names=sorted({n for n, _, _ in trace.host if "Launch" in n}),
                   launch_calls_per_step=sum("LaunchKernel" in n for n, _, _ in trace.host)
                   / lc["steps"], host_calls_per_step=step_calls(spans, trace))
    else:
        rep["blocks"] = scoring_blocks(spans, trace, line, _spans.at)
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    from benchmark import harness, run

    run.cache_env()
    if not torch.cuda.is_available():
        print("span_report: no CUDA device", file=sys.stderr)
        return 2
    ctx = harness.RunContext(cell=harness.load_cell(args.workload), seed=args.seed,
                             seconds=0.0, trace=True, device=torch.device("cuda", 0),
                             t_start=harness.now())
    rep = dict(report(ctx), device=run.device_record(torch, 1))
    text = json.dumps(rep, indent=1)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
