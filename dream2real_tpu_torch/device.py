"""Device policy and the bf16 numerics shared by the port.

Entry points take ``device`` (default CUDA) and raise when no GPU is present
and the caller did not ask for the CPU: there is no silent CPU path.

bf16 numerics mirror the JAX package's ``jnp.dot(bf16, bf16,
preferred_element_type=f32)``: inputs are rounded to bf16, products and sums
are taken in f32.
"""

from __future__ import annotations

import torch

BF16 = torch.bfloat16
F32 = torch.float32


def resolve_device(device=None) -> torch.device:
    """CUDA unless the caller names another device; raise without a GPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "dream2real_tpu_torch runs on CUDA and no GPU is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    return dev


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and back to f32 (JAX's ``.astype(bf16)`` on an f32 value
    that is then consumed in f32)."""
    return x.to(BF16).to(F32)


def dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 x bf16 -> f32 matmul for the model's plain (non-kernel) layers.

    CPU: exact f32 products of the bf16-rounded inputs, f32 sums — JAX's
    ``preferred_element_type=f32`` up to summation order. CUDA: cuBLAS bf16
    GEMM with f32 accumulation; its output is rounded to bf16 once before the
    caller's bias add (one extra rounding, at most one bf16 ulp).
    """
    if x.is_cuda:
        return torch.matmul(x.to(BF16), w.to(BF16)).to(F32)
    return torch.matmul(x.to(BF16).to(F32), w.to(BF16).to(F32))


def dot_exact(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16-rounded inputs, f32 products and sums on any device. The kernels'
    plain versions use it so that on the card they stay a faithful f32
    reference of the tensor-core arithmetic."""
    return torch.matmul(x.to(BF16).to(F32), w.to(BF16).to(F32))
