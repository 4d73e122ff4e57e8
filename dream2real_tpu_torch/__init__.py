"""PyTorch/CUDA port of dream2real_tpu's imagine-and-score path.

The JAX package ``dream2real_tpu`` stays the reference; this package mirrors
its layout (``ops/se3.py``, ``nerf/march_kernel.py``, ``clip/model.py`` ...)
so each module has an obvious counterpart. The Pallas kernels on the path are
hand-written CUDA C++ for Hopper under ``csrc/``, built at first use
(``dream2real_tpu_torch.build``). Entry points run on CUDA unless the caller
passes ``device="cpu"``; on the CPU every kernel wrapper takes its plain
PyTorch version.

This package imports torch and numpy only, never jax and nothing of
``dream2real_tpu``.
"""

import torch

# Matmul precision. TF32 keeps ~3 decimal digits, which corrupts pose algebra
# and the f32 projections/logits; the reference computes those in full f32.
# Both switches are process-wide torch settings, set once on import: f32
# matmuls (cuBLAS) and f32 convolutions (cuDNN) stay full f32. bf16 GEMMs may
# not reduce partial sums in bf16 either (JAX accumulates them in f32).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

from dream2real_tpu_torch.device import resolve_device  # noqa: E402

__all__ = ["resolve_device"]
