"""Save K6's outputs and K7's gradients on phase 2's training batch, so that
two trees can be compared bit for bit on one card.

The batch is chip_smoke.py phase 2's: the selftest's field box, a field
from seed 0, 8192 rays through random pixels of the 36-view synth orbit,
jittered coarse samples and 64 draws a ray, here from the plain sampler
(``density_sample_plain``), so that both trees get the same positions
whatever their K5. K6 runs on them; K7 gets K6's outputs and seeded
cotangents, with and without ray gradients. Run each tree's package on the
same card, then compare:

    PYTHONPATH=<tree> python tools/train_bits.py save OUT.pt
    python tools/train_bits.py compare A.pt B.pt

``compare`` prints one line a tensor and exits nonzero unless every tensor
is bit-identical.
"""

from __future__ import annotations

import sys

import numpy as np
import torch


def batch_outputs() -> dict:
    from dream2real_tpu_torch.cli.selftest import SELFTEST_AABB
    from dream2real_tpu_torch.data import synth
    from dream2real_tpu_torch.nerf import train_kernel as tk
    from dream2real_tpu_torch.nerf.model import NGPConfig, init_ngp_params
    from dream2real_tpu_torch.nerf.render import RenderSettings
    from dream2real_tpu_torch.ops import cameras

    dev = torch.device("cuda")
    res, R = 336, 8192
    f = 0.9 * res
    K = np.array([[f, 0, res / 2], [0, f, res / 2], [0, 0, 1.0]])
    cfg = NGPConfig(**SELFTEST_AABB)
    settings = RenderSettings(n_coarse=32, n_fine=32, near=0.05, far=2.0)
    n_draw = settings.n_coarse + settings.n_fine
    gen = torch.Generator(device=dev).manual_seed(0)
    field = init_ngp_params(cfg, gen, device=dev)
    dirs_cam = cameras.pixel_dirs(res, res, K, device=dev)
    scene = synth.default_scene()
    orbit = torch.as_tensor(synth.orbit_poses(scene.centre, 36, radius=0.5, height=0.4),
                            dtype=torch.float32, device=dev)
    pick = torch.randint(0, 36, (R,), generator=gen, device=dev)
    pix = torch.randint(0, res * res, (R,), generator=gen, device=dev)
    o = orbit[pick, :3, 3].contiguous()
    d = torch.einsum("bij,bj->bi", orbit[pick, :3, :3], dirs_cam.reshape(-1, 3)[pix]).contiguous()
    w, b = tk.pack_train_params(field.params())
    box = tk.field_box(cfg, dev)
    with torch.inference_mode():
        ts_c, _ = tk.coarse_samples(cfg, o, d, settings, gen)
        draws = tk.exp_draws(R, n_draw, gen, dev)
        ts = tk.density_sample_plain(o, d, ts_c, draws, box, w, b, n_draw,
                                     settings.min_transmittance, 0.5).contiguous()
        args = (o, d, ts, box, w, b, settings.min_transmittance)
        C, A, D = tk.train_fwd(*args)
        cot = (torch.randn(R, 3, generator=gen, device=dev),
               torch.randn(R, generator=gen, device=dev),
               0.1 * torch.randn(R, generator=gen, device=dev))
        g_slim, _, _ = tk.train_bwd(*args, *cot, C, A, D, False)
        g_full, d_o, d_d = tk.train_bwd(*args, *cot, C, A, D, True)
    return {"ts": ts, "k6_rgb": C, "k6_alpha": A, "k6_depth": D, "k7_grads": g_slim,
            "k7_grads_with_ray_grads": g_full, "k7_d_origins": d_o, "k7_d_dirs": d_d}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) == 2 and argv[0] == "save":
        if not torch.cuda.is_available():
            print("train_bits: no CUDA device available", file=sys.stderr)
            return 2
        out = {k: v.cpu() for k, v in batch_outputs().items()}
        torch.save(out, argv[1])
        print(f"saved {len(out)} tensors to {argv[1]}")
        return 0
    if len(argv) == 3 and argv[0] == "compare":
        a, b = torch.load(argv[1]), torch.load(argv[2])
        same = True
        for key in a:
            eq = torch.equal(a[key], b[key])
            same &= eq
            gap = float((a[key] - b[key]).abs().max())
            print(f"{key} {tuple(a[key].shape)}: "
                  f"{'bit-identical' if eq else f'differs, max {gap}'}")
        print("all bit-identical" if same else "NOT bit-identical")
        return 0 if same else 1
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
