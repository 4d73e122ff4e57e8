"""Where K4's (the text tower's causal attention) time goes: throwaway builds
of ``csrc/attention.cu`` with one part of ``attn_exact`` put back the way a
first form had it, timed against the shipped kernel and PyTorch's
scaled_dot_product_attention at the tower's shape (3 captions, 12 heads, 77
tokens, 64 wide).

Variants (each a text substitution in a copy of the source, built with
``build.py``'s nvcc flags into ``build/attention_ab/<variant>/``, which
``.gitignore`` lists):

    shipped        the kernel as committed
    div_a_weight   p = bf16(e / l) with an IEEE division a weight, not e * (1 / l)
    expf           exp(s - m) as expf, not ex2.approx.ftz of (s - m) log2(e)
    both           the two above together
    loads_only     returns once Q, K and V have landed in shared memory

Each is timed from torch.profiler's kernel table (device time, 50 calls);
run from the repo root on one GPU:

    PYTHONPATH=. python tools/attention_causal_ab.py

Prints one line a variant, then the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from dream2real_tpu_torch import build
from dream2real_tpu_torch.ops import attention as att

DIV = [("pack_bf16(s[n][0] * inv0, s[n][1] * inv0)", "pack_bf16(s[n][0] / l[0], s[n][1] / l[0])"),
       ("pack_bf16(s[n][2] * inv1, s[n][3] * inv1)", "pack_bf16(s[n][2] / l[1], s[n][3] / l[1])")]
EXPF = [("ex2_ftz((s[n][e] - m[e >> 1]) * kLog2e)", "expf(s[n][e] - m[e >> 1])")]
LOADS = [("        exact_scores(sQ, sK, warp, lane, tile_keys(kt), s);\n",
          "        if (T > 0) return;\n        exact_scores(sQ, sK, warp, lane, tile_keys(kt), s);\n")]
VARIANTS = {"shipped": [], "div_a_weight": DIV, "expf": EXPF, "both": DIV + EXPF,
            "loads_only": LOADS}


def device_ms(fn, calls: int = 50) -> float:
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(getattr(ev, "device_time_total", 0) for ev in prof.key_averages()) / 1e3 / calls


def main() -> int:
    src = (build.CSRC / "attention.cu").read_text()
    root = build.BUILD_DIR.parent / "attention_ab"
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"{name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "attention.cu").write_text(text)
        for hdr in build.CSRC.glob("*.cuh"):
            (d / hdr.name).write_text(hdr.read_text())
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / "attention.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")

    dev = torch.device("cuda")
    B, H, T, D = 3, 12, 77, 64
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(B, H, T, D, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    out = torch.empty_like(q)
    geo = att.launch_geometry(T, att.MODES["exact"])
    st = (H * T * D, T * D, D)
    for name in VARIANTS:
        fn = ctypes.CDLL(str(root / name / "lib.so")).d2r_attention
        fn.argtypes = att._ARGTYPES["d2r_attention"]
        fn.restype = ctypes.c_int

        def call():
            build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, T, *st,
                           *st, D**-0.5, 1, att.MODES["exact"], geo["grid_x"], geo["stages"],
                           geo["smem_bytes"], torch.cuda.current_stream(dev).cuda_stream), name)

        print(f"{name}: {device_ms(call):.5f} ms", flush=True)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True)  # noqa: E731
    print(f"sdpa: {device_ms(sdpa):.5f} ms")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
