"""The precisions the reference computes in.

The configurations state bfloat16: every matrix product takes bf16 inputs
and sums in float32, and the activations the models pass between layers are
rounded to bf16 where the published numerics round them (LayerNorm,
softmax, the volume rendering and the losses stay float32; the towers'
output projections and the logits are float32 products). ``REFERENCE`` is
that, with TF32 off for every float32 product. ``CONTROL`` is its control,
each stage in the precision below the one the configurations state: float8
e4m3 (one scale a tensor) wherever the reference has bf16, and TF32 inputs
(ten mantissa bits) for the float32 products. Gradients pass each rounding
as the rounding's own backward gives them: rounded again.
"""

from __future__ import annotations

import torch

F32 = torch.float32
BF16 = torch.bfloat16
FP8_MAX = 448.0  # the largest finite float8 e4m3fn


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with its absolute maximum scaled to the
    format's largest value; back in float32."""
    amax = x.detach().abs().amax().to(F32)
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (x.to(F32) / scale).to(torch.float8_e4m3fn).to(F32) * scale


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32's ten mantissa bits (to nearest, ties to even), as
    a TF32 product reads its float32 inputs; back in float32."""
    i = x.to(F32).contiguous().view(torch.int32).to(torch.int64)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.to(torch.int32).view(F32).reshape(x.shape)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return fp8_round(x)

    @staticmethod
    def backward(ctx, g):
        return fp8_round(g)


class Precision:
    """``rnd(x)``: x as the precision holds an activation; ``mm(a, b)``: a
    product of its rounded inputs, summed in float32; ``mm32(a, b)``: a
    product that the configurations state in float32."""

    def __init__(self, name: str):
        if name not in ("bf16", "fp8"):
            raise ValueError(name)
        self.name = name

    def rnd(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(F32)
        if self.name == "bf16":
            return x.to(BF16).to(F32)
        return _Fp8.apply(x)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.rnd(a), self.rnd(b))

    def mm32(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a, b = a.to(F32), b.to(F32)
        if self.name == "bf16":
            return torch.matmul(a, b)
        return torch.matmul(tf32_round(a), tf32_round(b))


REFERENCE = Precision("bf16")
CONTROL = Precision("fp8")
