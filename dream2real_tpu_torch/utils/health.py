"""Bounded wait for a healthy GPU before unattended measurements (the
port's counterpart of dream2real_tpu/utils/health.py, which waits for a TPU
worker).

A card that is wedged (a launch never returns) or degraded (a small matmul
takes seconds) would hang an unattended run or record numbers off by orders
of magnitude. ``wait_cuda_healthy`` times a warm 512 x 512 bf16
``torch.matmul`` on cuda:0 in a subprocess (a wedged CUDA context cannot be
cancelled from inside the process) and retries within a bounded budget.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

# A warm matmul slower than this means the card is in a degraded window.
# Generous: a healthy warm call with its synchronisation takes well under a
# millisecond.
WARM_DISPATCH_MAX_S = 5.0

_HEALTH_PROBE = """
import sys, time, torch
x = torch.ones((512, 512), dtype=torch.bfloat16, device="cuda:0")
float(torch.matmul(x, x).sum())  # context creation and the first launch
t0 = time.perf_counter(); float(torch.matmul(x, x).sum()); dt = time.perf_counter() - t0
print(f"warm_dispatch_s={dt:.6f}")
sys.exit(0 if dt < %f else 3)
""" % WARM_DISPATCH_MAX_S


def wait_cuda_healthy(budget_s: float, env_var: str | None = None, device=None) -> bool:
    """Block until cuda:0 answers a small matmul at normal speed.

    Returns True when a probe succeeded, False when the budget ran out (the
    caller goes on: a flagged number beats no number). Skipped only when the
    caller names the CPU as ``device``. ``env_var`` names an environment
    override of the budget; 0 disables the wait.
    """
    if device is not None and str(device).split(":")[0] == "cpu":
        return True
    if env_var and env_var in os.environ:
        budget_s = float(os.environ[env_var])
    if budget_s <= 0:
        return True
    deadline = time.time() + budget_s
    attempt = 0
    while True:
        attempt += 1
        try:
            # Each probe gets the budget left, at least 60 s (a cold start
            # of CUDA is not a wedge) and at most 240 s.
            probe_timeout = min(240.0, max(60.0, deadline - time.time()))
            r = subprocess.run(
                [sys.executable, "-c", _HEALTH_PROBE],
                timeout=probe_timeout, capture_output=True, text=True,
            )
            ok = r.returncode == 0
            lines = (r.stdout or r.stderr).strip().splitlines()
            detail = lines[-1] if lines else ""
        except subprocess.TimeoutExpired:
            ok, detail = False, "probe timed out (wedged)"
        if ok:
            print(f"# cuda health ok (attempt {attempt}: {detail})", file=sys.stderr)
            return True
        if time.time() >= deadline:
            print(f"# WARNING: cuda still unhealthy after {budget_s:.0f}s ({detail}); "
                  "proceeding anyway", file=sys.stderr)
            return False
        print(f"# cuda unhealthy (attempt {attempt}: {detail}); retrying", file=sys.stderr)
        time.sleep(min(45.0, max(1.0, deadline - time.time())))
