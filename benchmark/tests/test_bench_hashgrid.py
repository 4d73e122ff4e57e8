"""The hash-grid cell's three metrics (``train.hash_encode_ns_per_point``,
``train.hash_encode_roofline``, ``train.hashgrid_mfu``) on a synthetic
trace, span log and counters: each gives the value worked out by hand, and
nothing without H1's kernels, the counter, the spans or the field. The
roofline's bytes are those no kernel can avoid, so the share reads 100
exactly when H1 runs at the card's peak bandwidth over them and cannot
read more unless the kernels beat the peak. The reference and the driver
import nothing of the port or of JAX."""

from __future__ import annotations

import ast
import json

import pytest

from benchmark import harness
from benchmark.profile import Trace
from dream2real_tpu_torch.utils import profiling

BASE = 1_700_000_000.0
FIELD = json.loads((harness.BENCH_DIR / "configs" / "instant-ngp-base.json").read_text())["field"]
STEPS, RAYS, COARSE, SAMPLES, FREE = 2, 4096, 32, 64, 8
POINTS = STEPS * RAYS * (COARSE + SAMPLES + FREE)  # the counter: 851,968
BWD_POINTS = STEPS * RAYS * (SAMPLES + FREE)
FWD_S, BWD_S = 0.5e-3, 1.5e-3  # H1's device seconds in the window, each way


def _span(i, name, start, end, parent=None):
    return {"name": name, "id": i, "parent": parent, "request": 1,
            "start_ns": int(round((BASE + start) * 1e9)), "end_ns": int(round((BASE + end) * 1e9)),
            "device_ms": None}


SPANS = [_span(1, "train.chunk", 0.001, 0.009), _span(2, "train.step", 0.001, 0.005, 1),
         _span(3, "train.step", 0.005, 0.009, 1)]


def _trace(fwd_s=FWD_S, bwd_s=BWD_S):
    """Two steps: each a forward launch of H1 for the coarse pass, one for the
    samples, one for the free space, and two backward launches."""
    ops, t = [], BASE + 0.001
    for _ in range(STEPS):
        for name, d in (("void (anonymous namespace)::hash_fwd<2>(float const*)", fwd_s / 6),
                        ("gemm", 2e-4), ("void (anonymous namespace)::hash_fwd<2>(x)", fwd_s / 6),
                        ("void (anonymous namespace)::hash_fwd<2>(y)", fwd_s / 6),
                        ("void (anonymous namespace)::hash_bwd<2>(x)", bwd_s / 4),
                        ("void (anonymous namespace)::hash_bwd<2>(y)", bwd_s / 4),
                        ("adam", 5e-4)):
            ops.append((name, t, d))
            t += d
    return Trace(ops=ops, host=[], window_s=0.01, t0_s=BASE)


def _ctx(trace, **kw):
    return dict({"trace": trace, "steps": STEPS, "rays": RAYS, "samples": SAMPLES,
                 "coarse": COARSE, "freespace": FREE, "field": FIELD}, **kw)


def _log(monkeypatch, spans=SPANS, counters=None):
    counters = {"train.steps": STEPS, "train.encoded_points": POINTS} if counters is None \
        else counters
    monkeypatch.setattr(profiling, "spans", lambda: [dict(s) for s in spans])
    monkeypatch.setattr(profiling, "counters", lambda: dict(counters))


def _read(name, ctx):
    return harness.load_metric(name).read(ctx)


# By hand, at the published widths (16 levels x 2^19 x 2; hidden 64, 1 + 15
# outputs; colour 31 -> 64 -> 64 -> 3): a point-level's encoding 3 + 3 + 3 +
# 8 x (2 + 2 x 2) = 57 operations; a point's bytes 12 + 16 x 2 x 2 = 76; the
# table's gradient 16 x 2^19 x 2 x 4 bytes a backward launch.
ENC = 16 * 57
TABLE = 16 * 2**19 * 2 * 4
NBYTES = (POINTS + BWD_POINTS) * 76 + 2 * STEPS * TABLE
FLOPS = (POINTS + BWD_POINTS) * ENC
BOUND_S = max(NBYTES / 3.35e12, FLOPS / 989e12)
DENS = 2 * (32 * 64 + 64 * 16)
COL = 2 * (31 * 64 + 64 * 64 + 64 * 3)
STEP_FLOPS = RAYS * (COARSE * (DENS + ENC) + SAMPLES * (3 * (DENS + COL) + 2 * ENC)
                     + FREE * (3 * DENS + 2 * ENC))
WANT = {
    "train.hash_encode_ns_per_point": (FWD_S + BWD_S) * 1e9 / POINTS,
    "train.hash_encode_roofline": 100.0 * BOUND_S / (FWD_S + BWD_S),
    "train.hashgrid_mfu": 100.0 * STEPS * STEP_FLOPS / 0.01 / 989e12,
}


@pytest.mark.parametrize("name", sorted(WANT))
def test_readers_by_hand(name, monkeypatch):
    _log(monkeypatch)
    assert _read(name, _ctx(_trace())) == pytest.approx(WANT[name], rel=1e-9)


def test_the_roofline_reads_100_only_at_the_peak(monkeypatch):
    """H1 at the card's peak bandwidth over the counted bytes reads 100%;
    slower reads less. The counted bytes are the positions, the features,
    their gradient and the table's gradient, none of the corner reads."""
    _log(monkeypatch)
    assert NBYTES / 3.35e12 > FLOPS / 989e12  # bytes set the bound
    at_peak = _trace(fwd_s=BOUND_S / 4, bwd_s=3 * BOUND_S / 4)
    assert _read("train.hash_encode_roofline", _ctx(at_peak)) == pytest.approx(100.0, rel=1e-9)
    slower = _trace(fwd_s=BOUND_S / 2, bwd_s=3 * BOUND_S / 4)
    assert _read("train.hash_encode_roofline", _ctx(slower)) < 100.0


@pytest.mark.parametrize("name", sorted(WANT))
def test_readers_find_nothing_to_read(name, monkeypatch):
    trace = _trace()
    _log(monkeypatch)
    assert _read(name, _ctx(trace, field=None)) is None  # another cell's context
    assert _read(name, {}) is None
    if name == "train.hashgrid_mfu":  # the window and the field only
        return
    no_kernel = Trace(ops=[op for op in trace.ops if "hash_" not in op[0]], host=[],
                      window_s=trace.window_s, t0_s=trace.t0_s)
    assert _read(name, _ctx(no_kernel)) is None  # the plain encoding
    _log(monkeypatch, counters={"train.steps": STEPS})  # no counter
    assert _read(name, _ctx(trace)) is None
    _log(monkeypatch, spans=[])  # no span in the window
    assert _read(name, _ctx(trace)) is None


def _top_imports(path) -> set:
    """The top-level names of the imports a module makes when it is imported
    (not those inside its functions)."""
    tops = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", ["reference/hashgrid.py", "drivers/hashgrid_training.py",
                                  "metrics/_hashgrid.py"])
def test_imports_nothing_of_the_port_or_jax(path):
    tops = _top_imports(harness.BENCH_DIR / path)
    assert not tops & {"dream2real_tpu_torch", *harness.FORBIDDEN_MODULES}, tops
    if path.startswith("reference"):
        every = set()
        for node in ast.walk(ast.parse((harness.BENCH_DIR / path).read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                every |= {(a.name if isinstance(node, ast.Import) else node.module).split(".")[0]
                          for a in node.names}
        assert every <= {"__future__", "math", "torch", "benchmark"}, every
