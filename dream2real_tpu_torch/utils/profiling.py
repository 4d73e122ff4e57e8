"""Tracing and stage timing (port of dream2real_tpu/utils/profiling.py).

``trace`` records a region with torch.profiler (CPU and, where there is a
card, CUDA activity) as a Chrome trace under ``log_dir`` or
$D2R_TRACE_DIR, and does nothing when neither is set. ``StageTimer``
accumulates wall-clock seconds by stage; device work must be synchronised by
the caller where it is to count.
"""

from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def trace(name: str, log_dir: str | None = None):
    """Profile a region to ``log_dir/name.json`` (or under $D2R_TRACE_DIR).
    No-op when unset. Usage: with trace("imagine-loop"): ..."""
    log_dir = log_dir or os.environ.get("D2R_TRACE_DIR")
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"{name}.json"))


@contextlib.contextmanager
def timed(name: str, sink=print):
    """Wall-clock a region (host-side; device work must be synced by caller)."""
    t0 = time.time()
    yield
    sink(f"[timed] {name}: {time.time() - t0:.3f}s")


class StageTimer:
    """Accumulates per-stage wall-clock for pipeline observability."""

    def __init__(self):
        self.stages: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + (time.time() - t0)

    def report(self) -> str:
        total = sum(self.stages.values())
        lines = [f"{k}: {v:.2f}s ({100*v/max(total,1e-9):.0f}%)" for k, v in self.stages.items()]
        return "\n".join(lines + [f"total: {total:.2f}s"])
