"""BENCHMARK.json against the contract it is written to, and the harness's
discovery by name: a new cell or metric is new files and new entries."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def manifest():
    return harness.load_manifest()


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert manifest["paths"] == ["benchmark"]
    assert 1 <= manifest["run_seconds"] <= 51 and isinstance(manifest["run_seconds"], int)
    assert len(manifest["command"]) <= 32
    assert len(json.dumps(manifest)) <= 64 * 1024


def test_entries_have_only_their_keys(manifest):
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (harness.ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")


def test_names_are_unique_and_well_formed(manifest):
    for key in ("configs", "workloads"):
        names = [e["name"] for e in manifest[key]]
        assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    metrics = [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", [w["name"] for w in harness.load_manifest()["workloads"]])
def test_every_cell_finds_its_files(cell):
    c = harness.load_cell(cell)
    assert c.entry["config"] in [e["name"] for e in harness.load_manifest()["configs"]]
    assert hasattr(harness.load_driver(c.traffic), "run")
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert m["moves"] in e2e
        assert callable(harness.load_metric(m["name"]).read)


def test_a_new_cell_and_metric_are_only_new_files(tmp_path, monkeypatch):
    """Copy the benchmark, add a cell, its traffic file and a metric file and
    entries; the harness finds them by name with no other edit."""
    root = tmp_path / "root"
    shutil.copytree(harness.BENCH_DIR, root / "benchmark")
    m = harness.load_manifest()
    m["workloads"].append({"name": "clip-vitl14-336.other", "config": "clip-vitl14-336",
                           "traffic": "other", "chips": 1, "why": "a test cell"})
    m["per_layer"].append({"name": "score.new_metric", "unit": "ms", "better": "lower",
                           "source": "program_span", "layer": "crop render",
                           "moves": "poses_per_s", "workloads": ["clip-vitl14-336.other"]})
    m["end_to_end"][0]["workloads"].append("clip-vitl14-336.other")
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    traffic = json.loads((root / "benchmark/workloads/clip-vitl14-336.shopping_grid.json")
                         .read_text())
    traffic["block_poses"] = 64
    (root / "benchmark/workloads/clip-vitl14-336.other.json").write_text(json.dumps(traffic))
    (root / "benchmark/metrics/score.new_metric.py").write_text(
        "def read(ctx):\n    return ctx.get('x')\n")
    monkeypatch.setattr(harness, "ROOT", root)
    monkeypatch.setattr(harness, "BENCH_DIR", root / "benchmark")
    cell = harness.load_cell("clip-vitl14-336.other", harness.load_manifest(root / "BENCHMARK.json"))
    assert cell.traffic["block_poses"] == 64
    assert [x["name"] for x in cell.end_to_end] == ["poses_per_s", "peak_mem_gib", "setup_s"]
    assert "score.new_metric" in [x["name"] for x in cell.per_layer]
    assert harness.read_layer_metrics(cell, {"x": 2.5})["score.new_metric"]["value"] == 2.5
    # A reader that finds nothing leaves its metric out.
    assert "score.new_metric" not in harness.read_layer_metrics(cell, {})


def test_result_line_has_the_five_keys_and_compared_last():
    cell = harness.load_cell("clip-vitl14-336.shopping_grid")
    out = harness.Outcome(setup_s=12.5, attempted=100, failed=0, correct=True,
                          end_to_end={"poses_per_s": 500.0}, compared={"score_gap": (0.1, 0.5)},
                          memory_peak_bytes=3 * 2**30)
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    line = harness.result_line(out, cell, False, dev)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "compared"]
    assert line["metrics"] == {"poses_per_s": {"value": 500.0, "unit": "poses/s"},
                               "peak_mem_gib": {"value": 3.0, "unit": "GiB"},
                               "setup_s": {"value": 12.5, "unit": "s"}}
    assert line["device"]["memory_peak_bytes"] == 3 * 2**30
    assert line["compared"] == {"score_gap": {"value": 0.1, "limit": 0.5}}
    out.busy_s, out.window_s, out.layer_ctx = 1.0, 2.0, {}
    out.breakdown = {"device_ops": [["k", 0.5]], "idle_gaps": [["aten::item", 0.1]]}
    line = harness.result_line(out, cell, True, dev)
    assert line["device"]["busy_s"] == 1.0 and line["device"]["window_s"] == 2.0
    assert list(line)[-2:] == ["breakdown", "compared"]
    assert line["metrics"] == {}
