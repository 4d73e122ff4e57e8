"""The tower's biased layers (ops/attention.py's linear_bias*, on the card
the GEMM with f32 epilogues) against the JAX package's CLIP layers: the
plain versions at small widths, and the double-rounding witness bit for
bit."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from clip_witness import port_block, witness_block, witness_input

from dream2real_tpu.clip import model as jclip
from dream2real_tpu_torch.clip import model as tclip
from dream2real_tpu_torch.ops import attention as tatt

torch.set_num_threads(1)


def _bf16(a) -> np.ndarray:
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).astype(np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16)


def _np(t) -> np.ndarray:
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else jnp.asarray(t, jnp.float32))


def _within_one_ulp(out: np.ndarray, ref: np.ndarray, layer: np.ndarray, what: str,
                    capsys) -> None:
    """Every element within one bf16 step of the reference's, and at most
    1e-3 of them off it at all (the two libraries sum in other orders and
    take the sigmoid their own way, which moves a bf16 rounding now and
    then). The step is that of the larger of the result and ``layer``, the
    reference's layer output before the residual add: the result is the
    residual plus that bf16 value, so one rounding of the layer moves it by
    the layer's step, which is several of the result's where the two
    nearly cancel."""
    mag = np.maximum(np.abs(ref), np.abs(layer))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0**-126))) - 7)
    diff = np.abs(out - ref)
    share = float((diff > 0).mean())
    with capsys.disabled():
        print(f"\n{what}: {share:.2e} of {ref.size} elements off the reference, worst "
              f"{float((diff / ulp).max()):.2f} bf16 steps (allowed 1 step on 1e-3)")
    assert (diff <= ulp).all() and share <= 1e-3


def _random_block(seed: int, W: int) -> dict:
    rng = np.random.default_rng(seed)

    def lin(k, n):
        return {"w": _bf16(rng.normal(0, k**-0.5, (k, n))),
                "b": rng.normal(0, 0.02, n).astype(np.float32)}

    return {"ln1_g": (1 + 0.1 * rng.normal(size=W)).astype(np.float32),
            "ln1_b": (0.1 * rng.normal(size=W)).astype(np.float32),
            "ln2_g": (1 + 0.1 * rng.normal(size=W)).astype(np.float32),
            "ln2_b": (0.1 * rng.normal(size=W)).astype(np.float32),
            "qkv": lin(W, 3 * W), "proj": lin(W, W), "fc1": lin(W, 4 * W), "fc2": lin(4 * W, W)}


def _jax_tree(p: dict):
    return jax.tree_util.tree_map(jnp.asarray, p)


@pytest.mark.parametrize("W", [64, 128])
def test_mlp_matches_reference_mlp_block(W, capsys):
    """fc1 + QuickGELU (linear_bias_gelu) and fc2 + residual
    (linear_bias_then_resid) against the reference's x + _mlp_block(xn),
    on the same LN'd rows."""
    p = _random_block(W, W)
    rng = np.random.default_rng(W + 1)
    x = _bf16(rng.normal(0, 1.0, (4, 64, W)))
    xn = _bf16(rng.normal(0, 1.0, (4, 64, W)))
    jx, jxn = jnp.asarray(x, jnp.bfloat16), jnp.asarray(xn, jnp.bfloat16)
    layer = jclip._mlp_block(jxn, _jax_tree(p))
    ref = _np(jx + layer)
    blk = port_block(p, "cpu")
    h = tatt.linear_bias_gelu(_t(xn), blk.fc1.w, blk.fc1.b)
    out = _np(tatt.linear_bias_then_resid(h, blk.fc2.w, blk.fc2.b, _t(x)))
    _within_one_ulp(out, ref, _np(layer), f"fc1 + QuickGELU, fc2 + residual, W {W}", capsys)


@pytest.mark.parametrize("W", [64, 128])
def test_proj_residual_matches_reference_block(W, capsys):
    """The out-projection + residual (and the MLP after it) inside the
    reference's _block, split path: q = k = 0 and v from its bias, so the
    attention output is exactly v on both sides and the block's layers are
    what is compared."""
    p = _random_block(2 * W, W)
    p["qkv"]["w"][:] = 0.0
    x = _bf16(np.random.default_rng(W).normal(0, 1.0, (4, 16, W)))
    mask = jnp.zeros((16, 16), jnp.float32)  # the reference's plain attention path
    ref = _np(jclip._block(jnp.asarray(x, jnp.bfloat16), _jax_tree(p), W // 32, mask=mask))
    out = _np(tclip._block(_t(x), port_block(p, "cpu"), W // 32))
    _within_one_ulp(out, ref, ref - x, f"the block's proj + residual and MLP, W {W}", capsys)


@pytest.mark.parametrize("causal,fused", [(False, "0"), (False, "1"), (True, "0")])
def test_double_rounding_witness_matches_reference(causal, fused, monkeypatch):
    """The witness block (clip_witness.witness_block) through the port's
    _block on the CPU and the reference's _block: bit for bit, and one
    rounding at each layer (qkv's v, proj, fc1)."""
    monkeypatch.setenv("D2R_ATTN_FUSED_LN", fused)
    p, x = witness_block(), witness_input()
    mask = None if causal else jnp.zeros((16, 16), jnp.float32)
    ref = _np(jclip._block(jnp.asarray(x, jnp.bfloat16), _jax_tree(p), 2, mask=mask,
                           causal=causal))
    out = _np(tclip._block(_t(x), port_block(p, "cpu"), 2, causal=causal))
    np.testing.assert_array_equal(out, ref)
    gelu = _bf16(_bf16(1 + 2**-7) * _bf16(1 / (1 + np.exp(-1.702 * (1 + 2**-7)))))
    np.testing.assert_array_equal(out[0, 0, 3:6], [1.2578125, gelu, 1 + 2**-7])


@pytest.mark.parametrize("layer", ["linear_bias", "linear_bias_gelu", "linear_bias_then_resid"])
def test_double_rounding_witness_per_wrapper(layer):
    """Each wrapper's plain version on the witness row against the
    reference's expression for that layer (clip/model.py: qkv and fc1 round
    acc + b once; proj and fc2 round, then add the residual in bf16)."""
    K, N = 64, 128
    x = np.zeros((3, K), np.float32)
    x[:, :2] = 1.0
    w = np.zeros((K, N), np.float32)
    w[:2, 0] = 1.0, 2.0**-8 - 2.0**-16
    b = np.zeros(N, np.float32)
    b[0] = 2.0**-9
    r = np.full((3, N), 0.25, np.float32)
    jx, jw, jr = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, r))
    h = (jnp.dot(jx, jw, preferred_element_type=jnp.float32) + jnp.asarray(b)).astype(jnp.bfloat16)
    ref = {"linear_bias": h,
           "linear_bias_gelu": h * jax.nn.sigmoid(1.702 * h.astype(jnp.float32)).astype(jnp.bfloat16),
           "linear_bias_then_resid": jr + h}[layer]
    args = (_t(x), _t(w), torch.from_numpy(b)) + ((_t(r),) if layer.endswith("resid") else ())
    out = _np(getattr(tatt, layer)(*args))
    np.testing.assert_array_equal(out, _np(ref))
    assert out[0, 0] == _np(ref)[0, 0] != {"linear_bias": 1.0, "linear_bias_then_resid": 1.25}.get(
        layer, 0.0)
