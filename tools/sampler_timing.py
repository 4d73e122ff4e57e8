"""Time the sampler kernels K5 (``density_sample``) and K8
(``density_weights``) at phase 2's shapes, beside K6 on K8's inputs.

The batch is chip_smoke.py phase 2's: the selftest's field box, a field from
seed 0, 8192 rays through random pixels of the 36-view synth orbit, 32
jittered coarse samples and 64 draws a ray. Prints the card, the train
source's build time and each of its kernels' ptxas registers and spills,
K5's and K8's largest gap to their plain versions, whether K6's alpha on
K8's inputs is the in-order sum of K8's weights bit for bit, and each
kernel's time (CUDA events, median of 10) with one call and with three
calls queued between the events. Run from the repo root on one GPU:

    PYTHONPATH=. python tools/sampler_timing.py
"""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke as cs


def main() -> int:
    if not torch.cuda.is_available():
        print("sampler_timing: no CUDA device available", file=sys.stderr)
        return 2
    from dream2real_tpu_torch import build
    from dream2real_tpu_torch.cli.selftest import SELFTEST_AABB
    from dream2real_tpu_torch.data import synth
    from dream2real_tpu_torch.nerf import train_kernel as tk
    from dream2real_tpu_torch.nerf.model import NGPConfig, init_ngp_params
    from dream2real_tpu_torch.nerf.render import RenderSettings
    from dream2real_tpu_torch.ops import cameras

    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    build.load("train")
    print(f"train built in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, (regs, st_b, ld_b) in cs.ptxas_report(build.build_log("train")).items():
        print(f"  ptxas {name}: {regs} registers, {st_b} / {ld_b} bytes spill stores / loads")
    res, R, n_draw = 336, 8192, 64
    f = 0.9 * res
    K = np.array([[f, 0, res / 2], [0, f, res / 2], [0, 0, 1.0]])
    cfg = NGPConfig(**SELFTEST_AABB)
    settings = RenderSettings(n_coarse=32, n_fine=32, near=0.05, far=2.0)
    gen = torch.Generator(device=dev).manual_seed(0)
    field = init_ngp_params(cfg, gen, device=dev)
    dirs_cam = cameras.pixel_dirs(res, res, K, device=dev)
    orbit = torch.as_tensor(synth.orbit_poses(synth.default_scene().centre, 36, radius=0.5,
                                              height=0.4), dtype=torch.float32, device=dev)
    pick = torch.randint(0, 36, (R,), generator=gen, device=dev)
    pix = torch.randint(0, res * res, (R,), generator=gen, device=dev)
    o = orbit[pick, :3, 3].contiguous()
    d = torch.einsum("bij,bj->bi", orbit[pick, :3, :3], dirs_cam.reshape(-1, 3)[pix]).contiguous()
    w, b = tk.pack_train_params(field.params())
    box = tk.field_box(cfg, dev)
    with torch.inference_mode():
        ts_c, _ = tk.coarse_samples(cfg, o, d, settings, gen)
        draws = tk.exp_draws(R, n_draw, gen, dev)
        k8 = (o, d, ts_c, box, w, b, settings.min_transmittance)
        k5 = (o, d, ts_c, draws, box, w, b, n_draw, settings.min_transmittance, 0.5)
        w8 = tk.density_weights(*k8)
        t5 = tk.density_sample(*k5)
        e8 = float((w8 - tk.density_weights_plain(*k8)).abs().max())
        e5 = float((t5 - tk.density_sample_plain(*k5)).abs().max())
        print(f"K8 max |kernel - plain| {e8:.3e}; K5 {e5:.3e}")
        alpha = torch.zeros(R, device=dev)
        for s in range(ts_c.shape[1]):
            alpha = alpha + w8[:, s]
        print(f"K6's alpha == in-order sum of K8's weights: "
              f"{torch.equal(alpha, tk.train_fwd(*k8)[1])}")
        for name, fn in (("K5", lambda: tk.density_sample(*k5)),
                         ("K8", lambda: tk.density_weights(*k8)),
                         ("K6 on K8's inputs", lambda: tk.train_fwd(*k8))):
            print(f"{name}: {cs.time_ms(fn, 10):.4f} ms one call, "
                  f"{cs.time_ms(fn, 10, 3):.4f} ms with 3 queued", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
