"""Device policy and the bf16 numerics shared by the port.

Entry points take ``device`` (default CUDA) and raise when no GPU is present
and the caller did not ask for the CPU: there is no silent CPU path.

bf16 numerics mirror the JAX package's ``jnp.dot(bf16, bf16,
preferred_element_type=f32)``: inputs are rounded to bf16, products and sums
are taken in f32.
"""

from __future__ import annotations

import threading

import numpy as np
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


_CONSTANTS: dict = {}


def shared_constant(key, device, make) -> torch.Tensor:
    """``make(device)``, made once a (key, device), outside inference mode
    so that autograd may save it, and shared by every caller, who must not
    write into it. A tensor built from host numbers on the card is a copy
    that waits for the device; a training step may not wait, and a captured
    one cannot."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    out = _CONSTANTS.get((key, dev))
    if out is None:
        with torch.inference_mode(False):
            out = _CONSTANTS[key, dev] = make(dev)
    return out


def f32_constant(values, device) -> torch.Tensor:
    """A float32 tensor of the numbers ``values`` on ``device``, a shared
    constant keyed by its float32 bits (-0.0 and NaN keep their own)."""
    host = torch.tensor([float(v) for v in values], dtype=F32)
    return shared_constant(host.numpy().tobytes(), device, lambda dev: host.clone().to(dev))


def to_numpy(x) -> np.ndarray:
    """A tensor (any device) or array-like -> a host numpy array."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and back to f32 (JAX's ``.astype(bf16)`` on an f32 value
    that is then consumed in f32)."""
    return x.to(BF16).to(F32)


class _CastHook(threading.local):
    fn = None


#: Set by a sharded training step while one shard builds its graph
#: (nerf/trainer.py): fn(weight, its rounded copy) -> the tensor to use.
WEIGHT_CAST_HOOK = _CastHook()


def bf16_weight(w: torch.Tensor, dtype=F32) -> torch.Tensor:
    """A weight rounded to bf16, as ``dtype`` (f32, or bf16 for a bf16
    GEMM): how the layers read their parameters. The cast's backward rounds
    the weight's gradient to bf16; a sharded training step hooks the casts
    of its parameters so that the shards' gradients meet before that one
    rounding, as on one device."""
    out = w.to(BF16) if dtype == BF16 else w.to(BF16).to(F32)
    hook = WEIGHT_CAST_HOOK.fn
    if hook is not None and w.is_leaf and w.requires_grad:
        out = hook(w, out)
    return out


def dot_bf16(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 x bf16 -> bf16 with f32 accumulation and one rounding, for the
    plain layers that have no bias (CLIP's patchify, the field's colour
    layers). CUDA: a cuBLAS bf16 GEMM; CPU: exact f32 products of the
    bf16-rounded inputs and f32 sums, rounded once."""
    if x.is_cuda:
        return torch.matmul(x.to(BF16), bf16_weight(w, BF16))
    return dot_exact(x, w).to(BF16)


def dot_exact(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16-rounded inputs, f32 products and sums on any device. The kernels'
    plain versions use it so that on the card they stay a faithful f32
    reference of the tensor-core arithmetic."""
    return torch.matmul(x.to(BF16).to(F32), bf16_weight(w))
