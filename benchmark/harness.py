"""The harness's data model: BENCHMARK.json, the files it names, one run's
context and its result line.

A cell (an entry of ``workloads`` in BENCHMARK.json) is found by its name:
its configuration in ``configs/<config>.json``, its traffic in
``workloads/<cell>.json`` (the ``driver`` key names the module in
``drivers/`` that runs it), and each per-layer metric it reports in
``metrics/<metric>.py``. Nothing here names a cell, a configuration or a
metric, so a new one is new files and new entries.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Any, Callable, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
MANIFEST = ROOT / "BENCHMARK.json"

#: Top-level module names that no process of the benchmark may hold once its
#: window has closed: JAX and the JAX package the port was made from.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "dream2real_tpu")


def load_manifest(path: Path = MANIFEST) -> dict:
    with open(path) as fh:
        return json.load(fh)


def find(entries: list, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def workload_file(name: str) -> Path:
    return BENCH_DIR / "workloads" / f"{name}.json"


def metric_file(name: str) -> Path:
    return BENCH_DIR / "metrics" / f"{name}.py"


def read_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


@dataclasses.dataclass
class Cell:
    """One cell as the harness runs it: its BENCHMARK.json entry, the
    configuration's file, the traffic's file, and the metrics it reports."""

    name: str
    entry: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


def reports(metric: dict, cell: str, e2e_names: set) -> bool:
    """Whether ``cell`` reports ``metric``: the cells it lists, or without a
    list every cell (for a per-layer metric: every cell that reports the
    end-to-end metric it moves)."""
    listed = metric.get("workloads")
    if listed is not None:
        return cell in listed
    moves = metric.get("moves")
    return moves is None or moves in e2e_names


def load_cell(name: str, manifest: Optional[dict] = None) -> Cell:
    manifest = load_manifest() if manifest is None else manifest
    entry = find(manifest["workloads"], name, "workload")
    cfg_entry = find(manifest["configs"], entry["config"], "config")
    config = read_json(ROOT / cfg_entry["file"])
    traffic = read_json(workload_file(name))
    e2e = [m for m in manifest["end_to_end"] if reports(m, name, set())]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"] if reports(m, name, e2e_names)]
    return Cell(name, entry, config, traffic, e2e, per_layer)


def load_driver(traffic: dict):
    """The module ``benchmark.drivers.<driver>`` that runs this traffic."""
    return importlib.import_module(f"benchmark.drivers.{traffic['driver']}")


def load_metric(name: str):
    """The reader module of one per-layer metric, loaded from its file (the
    file is named after the metric, dots included)."""
    path = metric_file(name)
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class RunContext:
    """What a driver is given: the cell, the seed, the window's length, the
    trace flag, the device, the time the process started and a log."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float
    log: Callable[[str], None] = lambda m: print(m, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Outcome:
    """What a driver hands back.

    ``end_to_end``: name -> value of the cell's end-to-end metrics (the
    harness adds ``setup_s`` and ``peak_mem_gib``). ``layer_ctx``: what the
    per-layer readers read (traced runs only). ``compared``: name ->
    (value, limit) of every number the check compared. ``correct`` is True
    only when every compared number is within its limit and nothing failed.
    """

    setup_s: float
    attempted: int
    failed: int
    correct: bool
    end_to_end: dict
    compared: dict
    memory_peak_bytes: int
    layer_ctx: Optional[dict] = None
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    breakdown: Optional[dict] = None


def within(value: float, limit: float) -> bool:
    return math.isfinite(value) and value <= limit


def forbidden_loaded(modules=None) -> list[str]:
    """The forbidden top-level names present in ``sys.modules``, each
    compared whole (``dream2real_tpu_torch`` is not ``dream2real_tpu``)."""
    modules = sys.modules if modules is None else modules
    tops = {name.split(".", 1)[0] for name in list(modules)}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def read_layer_metrics(cell: Cell, ctx: dict) -> dict:
    """Each per-layer metric of the cell read from the traced run; a reader
    that finds nothing to read returns None and its metric is left out."""
    out = {}
    for metric in cell.per_layer:
        value = load_metric(metric["name"]).read(ctx)
        if value is not None:
            out[metric["name"]] = {"value": float(value), "unit": metric["unit"]}
    return out


def result_line(outcome: Outcome, cell: Cell, trace: bool, device: dict) -> dict:
    """The JSON object printed last, ``compared`` as its last key."""
    if trace:
        metrics = read_layer_metrics(cell, outcome.layer_ctx or {})
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        values = dict(outcome.end_to_end, setup_s=outcome.setup_s,
                      peak_mem_gib=outcome.memory_peak_bytes / 2**30)
        metrics = {name: {"value": float(values[name]), "unit": unit}
                   for name, unit in units.items()}
    dev = dict(device, memory_peak_bytes=int(outcome.memory_peak_bytes))
    if trace:
        dev.update(busy_s=outcome.busy_s, window_s=outcome.window_s)
    line = {"correct": bool(outcome.correct), "attempted": int(outcome.attempted),
            "failed": int(outcome.failed), "metrics": metrics, "device": dev}
    if trace and outcome.breakdown:
        line["breakdown"] = outcome.breakdown
    line["compared"] = {name: {"value": v, "limit": lim}
                        for name, (v, lim) in outcome.compared.items()}
    return line


def now() -> float:
    return time.perf_counter()


class Stages:
    """Seconds of each set-up stage since the last, logged at its end."""

    def __init__(self, ctx: "RunContext"):
        self.ctx, self.t = ctx, now()
        self.spent = {"start": self.t - ctx.t_start}

    def __call__(self, name: str) -> None:
        t = now()
        self.spent[name], self.t = t - self.t, t

    def log(self) -> None:
        self.ctx.log("set-up: " + ", ".join(f"{k} {v:.2f} s" for k, v in self.spent.items()))
