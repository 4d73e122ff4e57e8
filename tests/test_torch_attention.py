"""K2 / K3 / K4 / K9 (CLIP attention): the port's plain versions against the
JAX Pallas kernels (interpret mode on the CPU) on the same seeded inputs, at
the reference's attention tolerance (atol 0.02, rtol 0.05)."""

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


# 65 and 129: one row past the card kernel's 64-row warpgroups and 128-key tiles.
@pytest.mark.parametrize("T", [17, 37, 65, 129])
@pytest.mark.parametrize("maxsub", ["0", "1"])
def test_mha_qkv_plain_matches_pallas(T, maxsub, monkeypatch):
    monkeypatch.setenv("D2R_ATTN_MAXSUB", maxsub)
    rng = np.random.default_rng(T)
    jq, tq = _bf16_pair(rng.normal(size=(B, T, 3 * W)) * 2.0)
    ref = jatt.mha_qkv(jq, H)
    out = tatt.mha_qkv(tq, H)
    assert out.shape == (B, T, W) and out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), _np(ref), **TOL)


@pytest.mark.parametrize("T", [17, 37, 65, 129])
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


@pytest.mark.parametrize("T", [45, 64, 65, 129])
def test_mha_bidirectional_plain_matches_pallas(T, capsys):
    """K9: mha(causal=False) against the reference's _attn_kernel2, with T a
    multiple of 8 and not (the reference pads queries to 8 and keys to 128
    and masks the padding; the port attends over the T keys)."""
    rng = np.random.default_rng(300 + T)
    pairs = [_bf16_pair(rng.normal(size=(B, H, T, D))) for _ in range(3)]
    ref = jatt.mha(*(p[0] for p in pairs))
    out = tatt.mha(*(p[1] for p in pairs))
    assert out.shape == (B, H, T, D) and out.dtype == torch.bfloat16
    with capsys.disabled():
        print(f"\nK9 T={T}: max |port - pallas| {np.abs(_np(out) - _np(ref)).max():.3e} "
              f"(allowed atol 0.02 + rtol 0.05)")
    np.testing.assert_allclose(_np(out), _np(ref), **TOL)


def test_k9_not_ported_and_cpu_launches_nothing():
    """K9 is ported (the name is from before): mha(causal=False) runs on the
    CPU; there the wrappers run their plain versions and launch nothing."""
    x = torch.zeros(1, 2, 5, 16, dtype=torch.bfloat16)
    assert tatt.mha(x, x, x, causal=False).shape == x.shape
    with pytest.raises(ValueError):
        tatt.head_attention(x, x, x, "maxsub")  # the bare launch takes CUDA tensors only
    assert tatt.proj_residual(x[0], torch.zeros(16, 16, dtype=torch.bfloat16), torch.zeros(16),
                              x[0]).shape == x[0].shape
    assert tatt.mha_qkv.launches == 0 and tatt.mha_ln_qkv.launches == 0 and tatt.mha.launches == 0
    assert tatt.proj_residual.launches == 0 and tatt.ln_qkv.launches == 0


@pytest.mark.parametrize("mode", sorted(tatt.MODES))
def test_launch_geometry_covers_every_length(mode):
    """The attention launch geometry as a pure function: for every T from 1
    to 700 the query blocks and the key tiles cover T without a spare tile,
    the ring has 3 stages, and the dynamic
    shared memory holds the Q tile, the ring and its barriers within
    what a block can ask for on an H100."""
    m = tatt.MODES[mode]
    for T in range(1, 701):
        geo = tatt.launch_geometry(T, m)
        assert (geo["grid_x"] - 1) * geo["q_rows"] < T <= geo["grid_x"] * geo["q_rows"]
        assert (geo["n_key_tiles"] - 1) * geo["key_tile"] < T <= geo["n_key_tiles"] * geo["key_tile"]
        assert geo["smem_bytes"] <= tatt.SMEM_LIMIT == 232_448
        if mode == "exact":
            assert (geo["q_rows"], geo["stages"], geo["smem_bytes"]) == (64, 0, tatt.EXACT_SMEM)
            continue
        two_pass = mode in ("maxsub", "probe_softmax")
        assert geo["n_jobs"] == geo["n_key_tiles"] * (2 if two_pass else 1)
        assert geo["stages"] == 3 and geo["q_rows"] == 128 and geo["key_tile"] == 128
        assert geo["smem_bytes"] == (1 + 2 * geo["stages"]) * 128 * 64 * 2 + 64
    with pytest.raises(ValueError):
        tatt.launch_geometry(0, m)


@pytest.mark.parametrize("mode,T", [("clamp", 577), ("maxsub", 65), ("exact", 77)])
def test_launch_hands_the_geometry_to_the_c_side(mode, T, monkeypatch):
    """_attention_launch passes launch_geometry's grid, stages and shared
    memory to d2r_attention, after the strides and before the stream."""
    seen = []
    monkeypatch.setattr(tatt, "_fn", lambda name: lambda *a: seen.append((name, a)) or 0)
    monkeypatch.setattr(tatt.build, "stream_ptr", lambda dev: "stream")
    out = torch.zeros(1)
    tatt._attention_launch(1, 2, 3, out, 2, 16, T, (10, 20, 30), (40, 50, 60), 0.125,
                           mode == "exact", tatt.MODES[mode], "dev")
    (name, args), = seen
    geo = tatt.launch_geometry(T, tatt.MODES[mode])
    assert name == "d2r_attention"
    assert args[:3] == (1, 2, 3) and args[3].value == out.data_ptr()
    assert args[4:] == (2, 16, T, 10, 20, 30, 40, 50, 60, 0.125, int(mode == "exact"),
                        tatt.MODES[mode], geo["grid_x"], geo["stages"], geo["smem_bytes"], "stream")
    assert len(args) == len(tatt._ARGTYPES["d2r_attention"])
