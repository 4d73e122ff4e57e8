"""The traced window: torch.profiler over a region, reduced to what the
per-layer readers and the result line need.

``Trace.ops`` lists the device's operations (kernels, copies, sets) as
(name, start s, duration s) in the order they started; ``busy_s`` is the
union of their intervals, ``window_s`` the traced region's length on the
host's clock, and ``breakdown`` the ten operations that took most time and
the ten longest gaps between them, each named after the innermost host
call (a CUDA runtime call, or the profiler's own buffer work) running at
the gap's midpoint.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict


@dataclasses.dataclass
class Trace:
    ops: list            # (name, start_s, dur_s) on the device, by start
    host: list           # (name, start_s, dur_s) host-side operations
    window_s: float
    t0_s: float          # the window's start on the profiler's clock

    def busy_s(self) -> float:
        busy, end = 0.0, None
        for _, s, d in self.ops:
            e = s + d
            if end is None or s >= end:
                busy += d
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy

    def by_name(self) -> dict:
        """name -> (total seconds, launches)."""
        out: dict = defaultdict(lambda: [0.0, 0])
        for name, _, d in self.ops:
            out[name][0] += d
            out[name][1] += 1
        return {k: tuple(v) for k, v in out.items()}

    def matching(self, *words: str) -> list:
        """The operations whose name holds any of ``words``."""
        return [op for op in self.ops if any(w in op[0] for w in words)]

    def time_of(self, *words: str) -> tuple[float, int]:
        ops = self.matching(*words)
        return sum(d for _, _, d in ops), len(ops)

    def gaps(self) -> list:
        """Idle intervals inside the window: (start_s, dur_s), from the
        window's start to the first operation, between operations, and from
        the last to the window's end."""
        out, end = [], self.t0_s
        for _, s, d in self.ops:
            if s > end:
                out.append((end, s - end))
            end = max(end, s + d)
        if self.t0_s + self.window_s > end:
            out.append((end, self.t0_s + self.window_s - end))
        return out

    def host_at(self, t: float) -> str:
        """The innermost host operation running at ``t``."""
        best = None
        for name, s, d in self.host:
            if s <= t <= s + d and (best is None or d < best[1]):
                best = (name, d)
        return "host: none traced" if best is None else best[0]

    def breakdown(self, n: int = 10) -> dict:
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1][0])[:n]
        gaps = sorted(self.gaps(), key=lambda g: -g[1])[:n]
        return {"device_ops": [[name, tot] for name, (tot, _) in ops],
                "idle_gaps": [[self.host_at(s + d / 2), d] for s, d in gaps]}


def _events(prof):
    """(name, device type, start ns, duration ns) of every profiled event but
    the annotations (a host range's mirror on the device timeline is no
    device work)."""
    for ev in prof.profiler.kineto_results.events():
        kind = str(getattr(ev, "activity_type", lambda: "")()).lower()
        if "annotation" in kind or getattr(ev, "is_user_annotation", lambda: False)():
            continue
        try:
            start, dur = ev.start_ns(), ev.duration_ns()
        except AttributeError:  # older builds: microseconds
            start, dur = ev.start_us() * 1000, ev.duration_us() * 1000
        yield ev.name(), str(ev.device_type()), start, dur


@contextlib.contextmanager
def traced(torch, sync, holder: dict):
    """Profile the body; on exit put its ``Trace`` in ``holder["trace"]``.
    ``sync()`` waits for the device at both ends so the window holds all of
    its work. On a card the profiler records the device's operations and the
    host's CUDA calls only: recording every host operation as well slowed a
    host-paced training window by half or more, which the idle share would
    then read."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        sync()
        t0 = time.perf_counter()
        yield
        sync()
        window = time.perf_counter() - t0
    ops, host = [], []
    for name, dtype, start, dur in _events(prof):
        (ops if "CUDA" in dtype else host).append((name, start * 1e-9, dur * 1e-9))
    ops.sort(key=lambda op: op[1])
    host.sort(key=lambda ev: ev[1])
    starts = [ev[1] for ev in ops[:1] + host[:1]]
    holder["trace"] = Trace(ops=ops, host=host, window_s=window, t0_s=min(starts, default=0.0))
