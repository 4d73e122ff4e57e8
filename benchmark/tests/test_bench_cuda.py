"""Card tests: each cell run once through the benchmark's command, short,
its result line read back. Marked ``cuda``; each decides inside the test
whether there is a card, and skips without one."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark import harness


def _need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run the port's kernels")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in harness.load_manifest()["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_and_is_correct(cell, trace):
    _need_card()
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", cell,
                          "--seed", str(2**31 + 101), "--seconds", "5", "--trace", str(trace)],
                         capture_output=True, text=True, cwd=harness.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["compared"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    c = harness.load_cell(cell)
    want = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    if trace:
        assert line["device"]["busy_s"] > 0 and line["device"]["window_s"] > 0
        assert set(line["metrics"]) <= want and line["metrics"]
        for name, m in line["metrics"].items():
            if name.endswith(("_roofline", "mfu")):
                assert 0 < m["value"] <= 105, (name, m)
    else:
        assert set(line["metrics"]) == want
