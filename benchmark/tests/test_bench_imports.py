"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port: each import's top-level name
compared whole (the port's name begins with the JAX package's)."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

BENCH = Path(harness.BENCH_DIR)
PORT = "dream2real_tpu_torch"


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def _sources(*parts):
    return sorted(p for p in BENCH.joinpath(*parts).rglob("*.py"))


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & set(harness.FORBIDDEN_MODULES)


@pytest.mark.parametrize("path", _sources("reference"), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    assert PORT not in _imports(path)
    assert not {t for t in _imports(path) if t not in ("__future__", "math", "statistics",
                                                       "torch", "benchmark")}


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_loaded({"dream2real_tpu_torch": 1,
                                     "dream2real_tpu_torch.nerf": 1}) == []
    assert harness.forbidden_loaded({"jax.numpy": 1, "jaxlib": 1}) == ["jax", "jaxlib"]
    assert harness.forbidden_loaded({"dream2real_tpu.scoring": 1}) == ["dream2real_tpu"]
    assert harness.forbidden_loaded({"jaxtyping": 1, "flax_like": 1}) == []


def test_a_run_loads_no_jax():
    """Everything a benchmark run imports, the port's modules the drivers
    use included, in a fresh interpreter: no JAX and no JAX package."""
    code = (
        "import sys\n"
        "import benchmark.run, benchmark.control\n"
        "from benchmark import harness\n"
        "from benchmark.drivers import scoring_grid, field_training\n"
        "import dream2real_tpu_torch.scoring, dream2real_tpu_torch.prefetch\n"
        "import dream2real_tpu_torch.nerf.trainer, dream2real_tpu_torch.nerf.combined\n"
        "import dream2real_tpu_torch.parallel.imagine, dream2real_tpu_torch.clip.scorer\n"
        "print(harness.forbidden_loaded())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=harness.ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
