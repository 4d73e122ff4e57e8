"""The hash-grid scoring cell's three metrics (``score.hash_march_ns_per_sample``,
``score.hash_march_roofline``, ``score.hashgrid_mfu``) on a synthetic trace:
each gives the value worked out by hand, and nothing without H2's kernel,
the reference's counts or the field. The roofline's bytes and operations are
those no kernel can avoid, so the share reads 100 exactly when H2 runs at
the bound and cannot read more unless the kernel beats the card's peaks.
The new references and drivers import nothing of the port or of JAX at
import time (the references nothing of the port at all), and both new
cells' workload files name driver modules that exist."""

from __future__ import annotations

import ast
import json

import pytest

from benchmark import harness
from benchmark.profile import Trace

BASE = 1_700_000_000.0
FIELD = json.loads((harness.BENCH_DIR / "configs" / "ngp-clip-vitl14-336.json").read_text())[
    "field"]
CLIP = json.loads((harness.BENCH_DIR / "configs" / "ngp-clip-vitl14-336.json").read_text())[
    "clip"]
GROUPS, CB = 4, 32
POSES = GROUPS * CB
NEEDED, LIVE = 5_000_000, 400_000  # the first traced group's, as the reference counts them
H2_S = 4e-3  # H2's device seconds a group
WINDOW_S = 0.2


def _trace(h2_s=H2_S):
    """Four clip groups: each H2, then the tower's GEMMs."""
    ops, t = [], BASE + 0.001
    for _ in range(GROUPS):
        for name, d in (("void (anonymous namespace)::hash_march<true>(float const*)", h2_s),
                        ("void (anonymous namespace)::gemm_tma<3, 128>(x)", 0.02)):
            ops.append((name, t, d))
            t += d
    return Trace(ops=ops, host=[], window_s=WINDOW_S, t0_s=BASE)


def _ctx(trace, **kw):
    return dict({"trace": trace, "poses": POSES, "clip_batch": CB, "clip": CLIP,
                 "field": FIELD, "hash_needed": NEEDED, "hash_live": LIVE}, **kw)


def _read(name, ctx):
    return harness.load_metric(name).read(ctx)


# By hand, at the published widths (16 levels x 2 features; density 32 -> 64
# -> 16, colour 31 -> 64 -> 64 -> 3): a sample's interpolation 16 x (3 + 3 +
# 3 + 8 x (2 + 2 x 2)) = 912 operations and its MLPs 2 x (32 x 64 + 64 x 16 +
# 31 x 64 + 64 x 64 + 64 x 3) = 18,688; a live ray 48 bytes, a launch
# (9,408 + 12) x 4.
SAMPLE = 16 * 57 + 2 * (32 * 64 + 64 * 16 + 31 * 64 + 64 * 64 + 64 * 3)
FLOPS = GROUPS * NEEDED * SAMPLE
NBYTES = GROUPS * LIVE * 48 + GROUPS * (9408 + 12) * 4
BOUND_S = max(NBYTES / 3.35e12, FLOPS / 989e12)
TOWER = 2 * 190_889_000_000  # roofline.vit_macs at ViT-L/14@336, about
WANT = {
    "score.hash_march_ns_per_sample": GROUPS * H2_S * 1e9 / (GROUPS * NEEDED),
    "score.hash_march_roofline": 100.0 * BOUND_S / (GROUPS * H2_S),
}


@pytest.mark.parametrize("name", sorted(WANT))
def test_readers_by_hand(name):
    assert _read(name, _ctx(_trace())) == pytest.approx(WANT[name], rel=1e-9)


def test_the_mfu_by_hand():
    from benchmark import roofline

    tower = 2.0 * roofline.vit_macs(336, 14, 1024, 24)
    assert tower == pytest.approx(TOWER, rel=1e-3)
    want = 100.0 * POSES * (tower + NEEDED * SAMPLE / CB) / WINDOW_S / 989e12
    assert _read("score.hashgrid_mfu", _ctx(_trace())) == pytest.approx(want, rel=1e-9)


def test_the_roofline_reads_100_only_at_the_bound():
    """H2 taking its bound reads 100%; slower reads less. The bound counts
    the needed samples' operations and the live rays' bytes, none of the
    corner reads."""
    at_bound = _trace(h2_s=BOUND_S / GROUPS)
    assert _read("score.hash_march_roofline", _ctx(at_bound)) == pytest.approx(100.0, rel=1e-9)
    assert _read("score.hash_march_roofline", _ctx(_trace())) < 100.0
    assert WANT["score.hash_march_roofline"] < 100.0


@pytest.mark.parametrize("name", sorted(WANT) + ["score.hashgrid_mfu"])
def test_readers_find_nothing_to_read(name):
    trace = _trace()
    if name != "score.hash_march_ns_per_sample":  # the one that reads no width
        assert _read(name, _ctx(trace, field=None)) is None
    assert _read(name, _ctx(trace, hash_needed=None)) is None  # another cell's context
    assert _read(name, {}) is None
    if name == "score.hashgrid_mfu":  # the window, the field and the counts only
        return
    plain = Trace(ops=[op for op in trace.ops if "hash_march" not in op[0]], host=[],
                  window_s=trace.window_s, t0_s=trace.t0_s)
    assert _read(name, _ctx(plain)) is None  # the parent's plain render


def _imports(path, everywhere: bool) -> set:
    tree = ast.parse(path.read_text())
    nodes = ast.walk(tree) if everywhere else tree.body
    tops = set()
    for node in nodes:
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", ["reference/hashgrid_scoring.py", "reference/extrinsics.py",
                                  "drivers/hashgrid_scoring.py", "drivers/scene_training.py",
                                  "metrics/_hash_march.py", "metrics/score.hash_march_roofline.py",
                                  "metrics/score.hash_march_ns_per_sample.py",
                                  "metrics/score.hashgrid_mfu.py"])
def test_imports_nothing_of_the_port_or_jax(path):
    p = harness.BENCH_DIR / path
    assert not _imports(p, False) & {"dream2real_tpu_torch", *harness.FORBIDDEN_MODULES}
    assert not _imports(p, True) & set(harness.FORBIDDEN_MODULES)
    if path.startswith("reference"):
        assert _imports(p, True) <= {"__future__", "math", "torch", "benchmark"}


@pytest.mark.parametrize("cell", ["ngp-clip-vitl14-336.shopping_grid",
                                  "field-mlp256.scene_extr"])
def test_the_workload_files_name_existing_drivers(cell):
    traffic = harness.load_cell(cell).traffic
    assert (harness.BENCH_DIR / "drivers" / f"{traffic['driver']}.py").exists()
    driver = harness.load_driver(traffic)
    assert callable(driver.run) and callable(driver.readings) and driver.FAULTS
