"""The port's GPU health wait (``utils/health.py::wait_cuda_healthy``): the
four behaviours of tests/test_health.py with the probe's subprocess faked
(no card is probed), plus the probe itself: a warm bf16 512 x 512
torch.matmul on cuda:0 that exits 3 when slow."""

import subprocess
import sys
import types

import pytest

from dream2real_tpu_torch.utils import health


def test_skips_when_the_caller_names_the_cpu(monkeypatch):
    monkeypatch.setattr(subprocess, "run",
                        lambda *a, **k: pytest.fail("probe ran for a CPU caller"))
    assert health.wait_cuda_healthy(10.0, device="cpu") is True
    import torch

    assert health.wait_cuda_healthy(10.0, device=torch.device("cpu")) is True


def test_env_budget_zero_disables(monkeypatch):
    monkeypatch.setenv("D2R_X_HEALTH", "0")
    monkeypatch.setattr(subprocess, "run",
                        lambda *a, **k: pytest.fail("probe ran despite budget 0"))
    assert health.wait_cuda_healthy(600.0, env_var="D2R_X_HEALTH") is True
    assert health.wait_cuda_healthy(0.0, device="cuda") is True


def test_budget_exhaustion_returns_false(monkeypatch):
    calls = []
    t = {"now": 0.0}
    monkeypatch.setattr(health.time, "time", lambda: t["now"])
    monkeypatch.setattr(health.time, "sleep", lambda s: None)

    def wedged(*a, **k):
        calls.append(k.get("timeout"))
        t["now"] += 100.0
        raise subprocess.TimeoutExpired(cmd=a[0], timeout=k.get("timeout"))

    monkeypatch.setattr(subprocess, "run", wedged)
    assert health.wait_cuda_healthy(150.0, device="cuda:0") is False
    assert len(calls) == 2
    # Probe timeouts are clamped to the budget left, 60 s at least.
    assert all(60.0 <= c <= 240.0 for c in calls)


def test_recovery_returns_true(monkeypatch):
    monkeypatch.setattr(health.time, "sleep", lambda s: None)
    seq = iter([3, 0])  # degraded once, then healthy
    seen = []

    def fake_run(cmd, **k):
        seen.append(cmd)
        return types.SimpleNamespace(returncode=next(seq), stdout="warm_dispatch_s=0.000100\n",
                                     stderr="")

    monkeypatch.setattr(subprocess, "run", fake_run)
    assert health.wait_cuda_healthy(600.0) is True
    assert len(seen) == 2 and seen[0][0] == sys.executable
    probe = seen[0][-1]
    assert "torch.matmul" in probe and "cuda:0" in probe and "bfloat16" in probe
    assert "jax" not in probe
