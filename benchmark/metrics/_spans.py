"""What the readers of the program's own spans share.

The port records spans and counters (``dream2real_tpu_torch/utils/
profiling.py``) while a profiler runs, so in a traced run they cover the
traced window. A reader imports the recorder when it reads: a program
without one gives nothing to read. It keeps the spans that start inside the
window, ``[trace.t0_s, trace.t0_s + trace.window_s]``: the spans are
stamped with ``time.time_ns()`` and the trace by the profiler, so a reading
that finds spans there also shows that the two clocks agree. A span is
kept by its start because the window's end is not its last event's: the
trace's ``t0_s`` is its first profiled event, a few milliseconds before the
window's opening synchronise, so ``t0_s + window_s`` falls a few
milliseconds before the last span closes.
"""

from __future__ import annotations

import bisect


def window(ctx: dict):
    """-> (the program's closed spans that start inside the traced window,
    its counters), or None: no trace, no recorder, or no such span."""
    trace = ctx.get("trace")
    if trace is None or trace.window_s <= 0:
        return None
    try:
        from dream2real_tpu_torch.utils import profiling

        spans, counters = profiling.spans(), profiling.counters()
    except (ImportError, AttributeError):
        return None
    lo, hi = trace.t0_s, trace.t0_s + trace.window_s
    inside = [s for s in spans
              if s["end_ns"] is not None and lo <= s["start_ns"] * 1e-9 <= hi]
    return (inside, counters) if inside else None


def named(spans: list, name: str) -> list:
    return [s for s in spans if s["name"] == name]


def scoring(ctx: dict):
    """(the window's spans, the counters) where the window holds one
    ``score.render`` and one ``score.tower`` span a clip group of the
    ``score.groups`` counter, each with its device time, and ``score.poses``
    is counted; else None."""
    got = window(ctx)
    if got is None:
        return None
    spans, counters = got
    if not counters.get("score.groups") or not counters.get("score.poses"):
        return None
    for name in ("score.render", "score.tower"):
        mine = named(spans, name)
        if len(mine) != counters["score.groups"] or any(s["device_ms"] is None for s in mine):
            return None
    return got


def device_ms(spans: list, name: str) -> float:
    return sum(s["device_ms"] for s in named(spans, name))


def steps(ctx: dict):
    """(the window's ``train.step`` spans by start, the window's spans), or
    None where they are not as many as the ``train.steps`` counter."""
    got = window(ctx)
    if got is None:
        return None
    spans, counters = got
    st = sorted(named(spans, "train.step"), key=lambda s: s["start_ns"])
    if not st or len(st) != counters.get("train.steps"):
        return None
    return st, spans


def timeline(spans: list) -> tuple[list, list]:
    """(times, names): from ``times[i]`` (seconds) until the next time the
    innermost open span is ``names[i]`` (None where none is open). The
    spans nest, as one thread's do."""
    times, names, stack = [], [], []

    def close_until(t):
        while stack and stack[-1][0] <= t:
            end = stack.pop()[0]
            times.append(end * 1e-9)
            names.append(stack[-1][1] if stack else None)

    for s in sorted(spans, key=lambda s: (s["start_ns"], -s["end_ns"])):
        close_until(s["start_ns"])
        stack.append((s["end_ns"], s["name"]))
        times.append(s["start_ns"] * 1e-9)
        names.append(s["name"])
    close_until(float("inf"))
    return times, names


def at(line: tuple[list, list], t: float):
    """The innermost span's name at ``t`` seconds on ``timeline``'s line."""
    i = bisect.bisect_right(line[0], t) - 1
    return line[1][i] if i >= 0 else None


def idle_ms_per_step(ctx: dict, phases: tuple):
    """The device's idle milliseconds a step whose gap's midpoint falls in
    one of ``phases`` (the innermost span there), from the trace's gaps."""
    got = steps(ctx)
    if got is None:
        return None
    st, spans = got
    line = timeline(spans)
    idle = sum(d for s, d in ctx["trace"].gaps() if at(line, s + d / 2) in phases)
    return idle * 1e3 / len(st)
