"""The readers of the program's spans (``metrics/_spans.py`` and the seven
metrics on it) on a synthetic trace and span log: each gives the value
worked out by hand, and nothing without spans, with spans outside the
traced window, with spans that disagree with the counters, or from a
program that has no recorder."""

from __future__ import annotations

import pytest

from benchmark import harness
from benchmark.profile import Trace
from dream2real_tpu_torch.utils import profiling

BASE = 1_700_000_000.0  # seconds on the clock time.time_ns() reads


def _span(i, name, start, end, parent=None, request=None, device_ms=None):
    return {"name": name, "id": i, "parent": parent, "request": request or i,
            "start_ns": int(round((BASE + start) * 1e9)),
            "end_ns": int(round((BASE + end) * 1e9)), "device_ms": device_ms}


def _log(monkeypatch, spans, counters):
    monkeypatch.setattr(profiling, "spans", lambda: [dict(s) for s in spans])
    monkeypatch.setattr(profiling, "counters", lambda: dict(counters))


def _read(name, trace):
    return harness.load_metric(name).read({"trace": trace})


def _shifted(spans, seconds):
    return [dict(s, start_ns=s["start_ns"] + int(seconds * 1e9),
                 end_ns=s["end_ns"] + int(seconds * 1e9)) for s in spans]


# ------------------------------------------------------------------- scoring
SCORE_TRACE = Trace(ops=[("k", BASE + 0.1, 9.0)], host=[], window_s=10.0, t0_s=BASE)
SCORE_SPANS = [
    _span(1, "score.block", 0.5, 4.0, device_ms=3000.0),
    _span(2, "score.bg_render", 0.6, 0.9, 1, 1, device_ms=250.0),
    _span(3, "score.slab", 1.0, 3.0, 1, 1),
    _span(4, "score.render", 1.1, 1.2, 3, 1, device_ms=300.0),
    _span(5, "score.tower", 1.2, 1.3, 3, 1, device_ms=1000.0),
    _span(6, "score.render", 1.3, 1.4, 3, 1, device_ms=310.0),
    _span(7, "score.tower", 1.4, 1.5, 3, 1, device_ms=1010.0),
    _span(8, "score.drain", 3.0, 3.9, 1, 1),
    _span(10, "score.block", 5.0, 8.0, device_ms=1500.0),
    _span(11, "score.render", 5.5, 5.6, 10, 10, device_ms=320.0),
    _span(12, "score.tower", 5.6, 5.7, 10, 10, device_ms=1020.0),
]
SCORE_COUNTERS = {"score.poses": 96, "score.groups": 3}
SCORE_WANT = {
    "score.render_span_ms_per_pose": (300 + 310 + 320) / 96,
    "score.tower_span_ms_per_pose": (1000 + 1010 + 1020) / 96,
    # (3000 - 300 - 1000 - 310 - 1010 + 1500 - 320 - 1020) / 2
    "score.block_fixed_ms": (380.0 + 160.0) / 2,
}


@pytest.mark.parametrize("name", sorted(SCORE_WANT))
def test_score_readers_by_hand(name, monkeypatch):
    _log(monkeypatch, SCORE_SPANS, SCORE_COUNTERS)
    assert _read(name, SCORE_TRACE) == pytest.approx(SCORE_WANT[name], rel=1e-12)


# ------------------------------------------------------------------ training
def _train_log():
    """Two steps in one chunk; each step's phases as the trainer opens them."""
    out = [_span(1, "train.chunk", 0.05, 0.7)]
    for k, t in enumerate((0.1, 0.4)):
        i = 10 * (k + 1)
        out += [_span(i, "train.step", t, t + 0.2, 1, 1),
                _span(i + 1, "train.sample", t, t + 0.02, i, 1),
                _span(i + 2, "train.forward", t + 0.02, t + 0.08, i, 1),
                _span(i + 3, "train.backward", t + 0.08, t + 0.16, i, 1),
                _span(i + 4, "train.optim", t + 0.16, t + 0.2, i, 1)]
    return out + [_span(40, "train.fetch", 0.66, 0.7, 1, 1)]


# Busy everywhere but seven gaps (start, end; seconds after BASE): in step
# 1's sample (10 ms), forward (20 ms), backward (40 ms) and optim (10 ms);
# between the steps (60 ms, the chunk's own); in step 2's backward (40 ms);
# and from the last operation to the window's end (outside every span).
BUSY = [(0.0, 0.105), (0.115, 0.13), (0.15, 0.20), (0.24, 0.27), (0.28, 0.32), (0.38, 0.50),
        (0.54, 0.9)]
LAUNCHES = [("cudaLaunchKernel", 0.11), ("cudaLaunchKernel", 0.2), ("cudaLaunchKernelExC", 0.27),
            ("cudaMemcpyAsync", 0.15), ("cudaLaunchKernel", 0.35), ("cuLaunchKernel", 0.45),
            ("cudaLaunchKernel", 0.5), ("cudaLaunchKernel", 0.65)]
TRAIN_TRACE = Trace(ops=[("k", BASE + s, e - s) for s, e in BUSY],
                    host=[(n, BASE + t, 5e-6) for n, t in LAUNCHES], window_s=1.0, t0_s=BASE)
TRAIN_COUNTERS = {"train.steps": 2}
TRAIN_WANT = {
    "train.launches_per_step": 5 / 2,  # the launches inside a step; not the copy
    "train.forward_idle_ms": (10.0 + 20.0) / 2,
    "train.backward_idle_ms": (40.0 + 40.0) / 2,
    "train.optim_idle_ms": 10.0 / 2,
}


@pytest.mark.parametrize("name", sorted(TRAIN_WANT))
def test_train_readers_by_hand(name, monkeypatch):
    _log(monkeypatch, _train_log(), TRAIN_COUNTERS)
    assert _read(name, TRAIN_TRACE) == pytest.approx(TRAIN_WANT[name], rel=1e-6)


# ------------------------------------------------------- nothing to read
ALL = [(n, SCORE_SPANS, SCORE_COUNTERS, SCORE_TRACE) for n in sorted(SCORE_WANT)] + \
    [(n, _train_log(), TRAIN_COUNTERS, TRAIN_TRACE) for n in sorted(TRAIN_WANT)]


@pytest.mark.parametrize("name,spans,counters,trace", ALL, ids=[a[0] for a in ALL])
def test_readers_find_nothing_to_read(name, spans, counters, trace, monkeypatch):
    _log(monkeypatch, [], counters)
    assert _read(name, trace) is None
    _log(monkeypatch, _shifted(spans, 3600.0), counters)  # another clock: outside the window
    assert _read(name, trace) is None
    _log(monkeypatch, spans, {k: v + 1 for k, v in counters.items()})  # a span missing
    assert _read(name, trace) is None
    _log(monkeypatch, spans, counters)
    assert _read(name, None) is None
    monkeypatch.delattr(profiling, "spans")  # a program without the recorder
    assert _read(name, trace) is None


def test_the_innermost_span_names_each_instant():
    from benchmark.metrics import _spans

    line = _spans.timeline([dict(s, start_ns=s["start_ns"] - int(BASE * 1e9),
                                 end_ns=s["end_ns"] - int(BASE * 1e9)) for s in _train_log()])
    want = {0.01: None, 0.06: "train.chunk", 0.11: "train.sample", 0.15: "train.forward",
            0.22: "train.backward", 0.29: "train.optim", 0.35: "train.chunk",
            0.52: "train.backward", 0.68: "train.fetch", 0.8: None}
    assert {t: _spans.at(line, t) for t in want} == want
