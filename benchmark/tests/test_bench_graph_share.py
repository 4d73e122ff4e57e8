"""The reader of ``train.graph_step_share`` on the synthetic training
window of ``test_bench_spans.py``: every step replayed reads 100, half of
them 50, and a window without the ``train.graph_steps`` counter (an eager
trainer, or a program without the graph) reads nothing."""

from __future__ import annotations

import pytest

from benchmark.tests.test_bench_spans import TRAIN_COUNTERS, TRAIN_TRACE, _log, _read, _train_log

NAME = "train.graph_step_share"


@pytest.mark.parametrize("graph_steps,want", [(2, 100.0), (1, 50.0)],
                         ids=["all_replayed", "half_replayed"])
def test_graph_step_share_by_hand(graph_steps, want, monkeypatch):
    _log(monkeypatch, _train_log(), dict(TRAIN_COUNTERS, **{"train.graph_steps": graph_steps}))
    assert _read(NAME, TRAIN_TRACE) == pytest.approx(want, rel=1e-12)


def test_graph_step_share_reads_nothing_without_the_counter(monkeypatch):
    _log(monkeypatch, _train_log(), TRAIN_COUNTERS)
    assert _read(NAME, TRAIN_TRACE) is None
