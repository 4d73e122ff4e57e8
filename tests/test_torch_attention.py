"""K2 / K3 / K4 (CLIP attention): the port's plain versions against the JAX
Pallas kernels (interpret mode on the CPU) on the same seeded inputs, at the
reference's attention tolerance (atol 0.02, rtol 0.05)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dream2real_tpu.ops import attention as jatt
from dream2real_tpu_torch.ops import attention as tatt

torch.set_num_threads(1)

B, H, D = 2, 4, 16
W = H * D
TOL = dict(atol=0.02, rtol=0.05)


def _bf16_pair(x: np.ndarray):
    """The same bf16 values in both frameworks."""
    j = jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
    t = torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(torch.bfloat16)
    return j, t


def _np(x):
    return np.asarray(x.astype(jnp.float32)) if isinstance(x, jnp.ndarray) else x.float().numpy()


@pytest.mark.parametrize("T", [17, 37])
@pytest.mark.parametrize("maxsub", ["0", "1"])
def test_mha_qkv_plain_matches_pallas(T, maxsub, monkeypatch):
    monkeypatch.setenv("D2R_ATTN_MAXSUB", maxsub)
    rng = np.random.default_rng(T)
    jq, tq = _bf16_pair(rng.normal(size=(B, T, 3 * W)) * 2.0)
    ref = jatt.mha_qkv(jq, H)
    out = tatt.mha_qkv(tq, H)
    assert out.shape == (B, T, W) and out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), _np(ref), **TOL)


@pytest.mark.parametrize("T", [17, 37])
@pytest.mark.parametrize("maxsub", ["0", "1"])
def test_mha_ln_qkv_plain_matches_pallas(T, maxsub, monkeypatch):
    monkeypatch.setenv("D2R_ATTN_MAXSUB", maxsub)
    rng = np.random.default_rng(100 + T)
    jx, tx = _bf16_pair(rng.normal(size=(B, T, W)) * 3.0 + 0.5)
    jw, tw = _bf16_pair(rng.normal(size=(W, 3 * W)) * W**-0.5)
    bq = rng.normal(size=(3 * W,)).astype(np.float32) * 0.1
    g = (1.0 + 0.1 * rng.normal(size=(W,))).astype(np.float32)
    beta = (0.1 * rng.normal(size=(W,))).astype(np.float32)
    ref = jatt.mha_ln_qkv(jx, jw, jnp.asarray(bq), jnp.asarray(g), jnp.asarray(beta), H)
    out = tatt.mha_ln_qkv(tx, tw, torch.from_numpy(bq), torch.from_numpy(g),
                          torch.from_numpy(beta), H)
    assert out.shape == (B, T, W)
    np.testing.assert_allclose(_np(out), _np(ref), **TOL)


@pytest.mark.parametrize("T", [37, 77])
def test_mha_causal_plain_matches_pallas(T):
    rng = np.random.default_rng(200 + T)
    pairs = [_bf16_pair(rng.normal(size=(B, H, T, D))) for _ in range(3)]
    ref = jatt.mha(*(p[0] for p in pairs), causal=True)
    out = tatt.mha(*(p[1] for p in pairs), causal=True)
    assert out.shape == (B, H, T, D)
    np.testing.assert_allclose(_np(out), _np(ref), **TOL)


def test_k9_not_ported_and_cpu_launches_nothing():
    """The bidirectional head-split kernel (K9) is not part of this port yet;
    on the CPU the wrappers run their plain versions and launch nothing."""
    x = torch.zeros(1, 2, 5, 16, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        tatt.mha(x, x, x, causal=False)
    assert tatt.mha_qkv.launches == 0 and tatt.mha_ln_qkv.launches == 0 and tatt.mha.launches == 0
