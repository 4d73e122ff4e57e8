"""Device time of one layer alone (a copy of the method of the port's
``experiments/bench_split.py``): warm once, then CUDA events around the
layer's calls over the cell's own inputs, one call an input, queued back to
back, and one wait at the end. On the CPU the host's clock stands in (the
CPU tests only; no device number is ever read from it)."""

from __future__ import annotations

import time


def span_ms(torch, fn, inputs, device) -> float:
    """Milliseconds of ``fn`` over every input, after one warm call."""
    fn(inputs[0])
    if device.type != "cuda":
        t0 = time.perf_counter()
        for x in inputs:
            fn(x)
        return (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for x in inputs:
        fn(x)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)
