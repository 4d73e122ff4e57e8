"""Tracing, the program's spans and counters, and stage timing (port of
dream2real_tpu/utils/profiling.py).

``trace`` records a region with torch.profiler (CPU and, where there is a
card, CUDA activity) as a Chrome trace under ``log_dir`` or
$D2R_TRACE_DIR, and does nothing when neither is set.

``span`` and ``count`` record the program's own spans and counters, but
only while a torch.profiler session is active (``trace``, or any other
profiler a caller runs); otherwise a span is one flag read that returns a
shared object doing nothing. A span holds its name, an id, its parent's id
(the span open around it on the same thread), a request id (the id of the
outermost span open on the thread: a scoring block, a training chunk) and
its start and end from ``time.time_ns()``, the clock the profiler stamps
its host and device events with, so spans and those events share one
timeline. With ``device=True`` a span also records CUDA timing events
around its work on the current stream; their milliseconds are resolved
when ``spans()`` reads them, after the caller has synchronised. A recorded
span opens ``torch.profiler.record_function`` of its name too, so that the
program's names show above its kernels in the Chrome trace. The log keeps
the first ``MAX_SPANS`` spans and counts the others as dropped.

``StageTimer`` accumulates wall-clock seconds by stage, each stage a span;
device work must be synchronised by the caller where it is to count.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

#: Spans the log keeps until the next reset (a traced scoring block records
#: about 550, a traced training chunk about 500).
MAX_SPANS = 1 << 16


@contextlib.contextmanager
def trace(name: str, log_dir: str | None = None):
    """Profile a region to ``log_dir/name.json`` (or under $D2R_TRACE_DIR).
    No-op when unset. Usage: with trace("imagine-loop"): ..."""
    log_dir = log_dir or os.environ.get("D2R_TRACE_DIR")
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"{name}.json"))


class _Idle:
    """The span handed out while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_IDLE = _Idle()


class _Span:
    __slots__ = ("stack", "name", "id", "parent", "request", "start_ns", "end_ns", "events",
                 "_range")

    def __init__(self, stack: list, name: str, span_id: int, timed: bool):
        self.stack, self.name, self.id = stack, name, span_id
        self.start_ns = self.end_ns = None
        self.events = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True)) if timed else None

    def __enter__(self):
        top = self.stack[-1] if self.stack else None
        self.parent = None if top is None else top.id
        self.request = self.id if top is None else top.request
        self.stack.append(self)
        if self.events is not None:
            self.events[0].record()
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        self._range.__exit__(*exc)
        if self.events is not None:
            self.events[1].record()
        self.stack.pop()
        return None

    def record(self) -> dict:
        device_ms = None
        if self.events is not None and self.end_ns is not None and self.events[1].query():
            device_ms = self.events[0].elapsed_time(self.events[1])
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "request": self.request, "start_ns": self.start_ns, "end_ns": self.end_ns,
                "device_ms": device_ms}


class Recorder:
    """The spans and counters of one process (``RECORDER``)."""

    def __init__(self, max_spans: int = MAX_SPANS):
        self.max_spans = max_spans
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._log: list = []
            self._counts: dict = {}
            self.dropped = 0

    def span(self, name: str, device: bool = False):
        """A context manager recording the region it wraps as a span named
        ``name``; with ``device`` also its device time on the current CUDA
        stream, where CUDA is in use."""
        if not _autograd_profiler._is_profiler_enabled:
            return _IDLE
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        with self._lock:
            if len(self._log) >= self.max_spans:
                self.dropped += 1
                return _IDLE
            s = _Span(stack, name, next(self._ids), device and torch.cuda.is_initialized())
            self._log.append(s)
        return s

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the counter ``name`` while recording."""
        if not _autograd_profiler._is_profiler_enabled:
            return
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def spans(self) -> list[dict]:
        """The spans recorded since the last reset, in the order they
        opened: name, id, parent, request, start_ns and end_ns (None while
        open), and device_ms (None for a host span, or where the device has
        not reached the span's end)."""
        with self._lock:
            log = list(self._log)
        return [s.record() for s in log]

    def counters(self) -> dict:
        with self._lock:
            return dict(self._counts)


RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count
spans = RECORDER.spans
counters = RECORDER.counters
reset = RECORDER.reset


class StageTimer:
    """Accumulates per-stage wall-clock for pipeline observability; each
    stage is also a span of its name."""

    def __init__(self):
        self.stages: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.time()
        try:
            with span(name):
                yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + (time.time() - t0)

    def report(self) -> str:
        total = sum(self.stages.values())
        lines = [f"{k}: {v:.2f}s ({100*v/max(total,1e-9):.0f}%)" for k, v in self.stages.items()]
        return "\n".join(lines + [f"total: {total:.2f}s"])
