"""Time the text tower's causal attention (K4) and PyTorch's
scaled_dot_product_attention on the same inputs, at the tower's shape (3
captions, 12 heads, 77 tokens, 64 wide).

Each is timed three ways: with CUDA events (median of 20), one call between
the events, which includes the host's path to the launch, and 10 calls
queued between them; and from torch.profiler's kernel table of 20 calls,
the device's time alone (at this size the queued calls still wait on the
host between launches). Only ``ops/attention.py``'s
``mha(causal=True)`` is used, so the script times the port's K4 in any
checkout that has it:

    PYTHONPATH=. python tools/attention_causal_timing.py

Run from the root of the checkout to time; needs one GPU. Prints one JSON
line with the times in ms and the card's name and power limit.
"""

from __future__ import annotations

import json
import statistics
import subprocess

import torch

from dream2real_tpu_torch.ops import attention as att


def time_ms(fn, inner: int, runs: int = 20) -> float:
    fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_ms(fn, calls: int = 20) -> float:
    """Device time a call from the profiler's kernel table."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(ev, "device_time_total", 0) for ev in prof.key_averages())
    return us / 1e3 / calls


def main() -> int:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(3, 12, 77, 64, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    k4 = lambda: att.mha(q, k, v, causal=True)  # noqa: E731
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True)  # noqa: E731
    err = float((k4().float() - att.mha_causal_plain(q, k, v).float()).abs().max())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({
        "k4_one_call_ms": time_ms(k4, 1), "k4_queued_ms": time_ms(k4, 10),
        "sdpa_one_call_ms": time_ms(sdpa, 1), "sdpa_queued_ms": time_ms(sdpa, 10),
        "k4_device_ms": device_ms(k4), "sdpa_device_ms": device_ms(sdpa),
        "k4_max_abs_err": err, "card": smi,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
