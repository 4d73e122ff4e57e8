"""The double-rounding witness shared by the CLIP tower tests: a tower
block whose every biased layer tells one rounding of acc + b from two, its
input, and the port's Block holding a parameter tree."""

import numpy as np
import torch

# The double-rounding witness: a row [1, 1] against a weight column
# [1, 2^-8 - 2^-16] (both exact in bf16) gives acc = 1 + 2^-8 - 2^-16, and a
# bias of 2^-9 puts acc + b past the midpoint 1 + 2^-8: one rounding,
# bf16(acc + b), is 1 + 2^-7; two, bf16(bf16(acc) + b), give 1.
WITNESS_C, WITNESS_B = 2.0**-8 - 2.0**-16, 2.0**-9


def witness_block(W: int = 128) -> dict:
    """A tower block (the reference's parameter tree, f32 numpy) whose biased
    layers each meet the witness: LN1 and LN2 have gain 0 and bias [1, 1, 0,
    ...], so their outputs are exactly that row; q = k = 0, so attention
    averages v, which every token shares; v's column 0 is the qkv witness
    (v1 = v2 = 1), the out-projection's column 3 the proj witness over
    [v1, v2] and its column 5 copies v0, fc1's column 0 the fc1 witness and
    fc2's column 4 copies QuickGELU of it. With x = 0.25 at column 3 and 0
    elsewhere, one rounding everywhere gives columns 3, 4, 5 = 1.2578125,
    gelu(1 + 2^-7), 1 + 2^-7; a second rounding gives 1.25, gelu(1), 1."""
    def z(*shape):
        return np.zeros(shape, np.float32)

    row = z(W)
    row[:2] = 1.0
    p = {"ln1_g": z(W), "ln1_b": row.copy(), "ln2_g": z(W), "ln2_b": row.copy(),
         "qkv": {"w": z(W, 3 * W), "b": z(3 * W)}, "proj": {"w": z(W, W), "b": z(W)},
         "fc1": {"w": z(W, 4 * W), "b": z(4 * W)}, "fc2": {"w": z(4 * W, W), "b": z(W)}}
    v = 2 * W
    p["qkv"]["w"][:2, v] = 1.0, WITNESS_C
    p["qkv"]["b"][v] = WITNESS_B
    p["qkv"]["w"][0, v + 1] = p["qkv"]["w"][0, v + 2] = 1.0
    p["proj"]["w"][1:3, 3] = 1.0, WITNESS_C
    p["proj"]["b"][3] = WITNESS_B
    p["proj"]["w"][0, 5] = 1.0
    p["fc1"]["w"][:2, 0] = 1.0, WITNESS_C
    p["fc1"]["b"][0] = WITNESS_B
    p["fc2"]["w"][0, 4] = 1.0
    return p


def witness_input(W: int = 128, T: int = 16) -> np.ndarray:
    x = np.zeros((1, T, W), np.float32)
    x[..., 3] = 0.25
    return x


def port_block(p: dict, device):
    """The port's Block holding the parameter tree p."""
    from dream2real_tpu_torch.clip import model as cm

    blk = cm.Block(p["ln1_g"].shape[0], device)
    with torch.no_grad():
        for name, t in blk.named_parameters():
            node = p
            for part in name.split("."):
                node = node[part]
            t.copy_(torch.as_tensor(node))
    return blk
