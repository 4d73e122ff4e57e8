"""The attention bench's variants (X1-X4): the port's plain versions against
the functions of experiments/bench_attention.py on the same seeded inputs.

The reference file is a script; it is loaded by path. Its pallas_calls have
no ``interpret`` switch, so each test swaps the ``pallas_call`` attribute of
the pallas module that file imports for one that interprets; nothing in the
file changes. Tolerance: the reference's attention tolerance (atol 0.02,
rtol 0.05) for attention outputs, the bench's own maxrel form (<= 2e-2) on
the residual stream.
"""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dream2real_tpu.ops import attention as jatt
from dream2real_tpu_torch.experiments import bench_attention as tb
from dream2real_tpu_torch.ops import attention as tatt

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
B, H, D = 2, 4, 16
W = H * D
TOL = dict(atol=0.02, rtol=0.05)


@pytest.fixture(scope="module")
def ref_module():
    spec = importlib.util.spec_from_file_location(
        "ref_bench_attention", ROOT / "experiments" / "bench_attention.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def ref(ref_module, monkeypatch):
    """The reference script with its pallas_calls interpreted."""
    monkeypatch.setattr(ref_module.pl, "pallas_call",
                        functools.partial(ref_module.pl.pallas_call, interpret=True))
    return ref_module


def _bf16_pair(x: np.ndarray):
    j = jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)
    return j, t


def _np(x):
    return np.asarray(x.astype(jnp.float32)) if isinstance(x, jax.Array) else x.float().numpy()


def _report(capsys, what, out, want, allowed):
    with capsys.disabled():
        print(f"\n{what}: max |port - reference| {np.abs(out - want).max():.3e} ({allowed})")


def _qkv_heads(seed, T):
    rng = np.random.default_rng(seed)
    return [_bf16_pair(rng.normal(size=(B, H, T, D))) for _ in range(3)]


@pytest.mark.parametrize("T", [45, 64])
@pytest.mark.parametrize("name", ["v1_unrolled", "v2_nomax", "v3_pipelined"])
def test_x1_variants_match_reference(ref, name, T, capsys):
    pairs = _qkv_heads(400 + T, T)
    want = _np(getattr(ref, f"_mha_{name}")(*(p[0] for p in pairs)))
    out = _np(getattr(tb, f"mha_{name}")(*(p[1] for p in pairs)))
    assert out.shape == (B, H, T, D)
    _report(capsys, f"X1 {name} T={T}", out, want, "allowed atol 0.02 + rtol 0.05")
    np.testing.assert_allclose(out, want, **TOL)


def test_x1_keeps_the_unmasked_zero_keys(ref, capsys):
    """The reference masks key columns at or past the PADDED query count
    (45 -> 48), so three zero keys enter X1's softmax with logit 0 and its
    result differs from K9's on the same input. The port reproduces that."""
    pairs = _qkv_heads(7, 45)
    jq, tq = zip(*pairs)
    x1_ref, k9_ref = _np(ref._mha_v1_unrolled(*jq)), _np(jatt.mha(*jq))
    x1, k9 = _np(tb.mha_v1_unrolled(*tq)), _np(tatt.mha(*tq))
    gap = np.abs(x1 - k9).max()
    with capsys.disabled():
        print(f"\nX1 vs K9 on one input: port {gap:.3e}, reference "
              f"{np.abs(x1_ref - k9_ref).max():.3e}; port X1 vs reference X1 "
              f"{np.abs(x1 - x1_ref).max():.3e}")
    assert gap > 5e-3 and np.abs(x1_ref - k9_ref).max() > 5e-3
    assert np.abs(x1 - x1_ref).max() < gap / 4
    assert np.abs(k9 - k9_ref).max() < gap / 4
    # With T a multiple of 8 nothing is padded and X1 is K9.
    pairs = _qkv_heads(8, 64)
    tq = [p[1] for p in pairs]
    assert torch.equal(tb.mha_v1_unrolled(*tq), tatt.mha(*tq))


@pytest.mark.parametrize("name", ["exp_only", "softmax_only", "matmul_only"])
def test_probes_match_reference(ref, name, capsys):
    pairs = _qkv_heads(500, 45)
    want = _np(ref._probe(getattr(ref, f"_kernel_{name.replace('_', '')}"))(
        *(p[0] for p in pairs)))
    out = _np(tb.probe(name)(*(p[1] for p in pairs)))
    assert out.shape == want.shape == (B, H, 45, D)
    if name == "matmul_only":
        # No softmax bounds these outputs: one bf16 ulp of a score moves a
        # sum of 48 products, so the bound is relative to the largest output.
        _report(capsys, f"probe {name}", out, want, "allowed 2e-2 x max |reference|")
        assert np.abs(out - want).max() <= 2e-2 * np.abs(want).max()
    else:
        _report(capsys, f"probe {name}", out, want, "allowed atol 0.02 + rtol 0.05")
        np.testing.assert_allclose(out, want, **TOL)
    assert np.abs(want).max() > 0


@pytest.mark.parametrize("kernel,body", [("v8", "_kernel_fused_layout"),
                                         ("v9", "_kernel_fused_nomax"),
                                         ("v10", "_kernel_fused_pipelined"),
                                         ("v11", "_kernel_fused_nomax_pipe")])
def test_x2_projection_layout_matches_reference(ref, kernel, body, capsys):
    T = 40  # the reference takes T unpadded: a multiple of 8 here
    jq, tq = _bf16_pair(np.random.default_rng(600).normal(size=(B, T, 3 * W)) * 2.0)
    want = _np(ref._mha_v8_projlayout(jq, n_heads=H, kernel=getattr(ref, body)))
    out = _np(tb.mha_v8_projlayout(tq, n_heads=H, kernel=kernel))
    assert out.shape == (B, T, W)
    _report(capsys, f"X2 {kernel}", out, want, "allowed atol 0.02 + rtol 0.05")
    np.testing.assert_allclose(out, want, **TOL)


def _block_inputs(seed, T):
    rng = np.random.default_rng(seed)
    x = _bf16_pair(rng.normal(size=(B, T, W)) * 2.0 + 0.3)
    wqkv = _bf16_pair(rng.normal(size=(W, 3 * W)) * W**-0.5)
    wo = _bf16_pair(rng.normal(size=(W, W)) * W**-0.5)
    f32 = [(rng.normal(size=n) * s + o).astype(np.float32)
           for n, s, o in ((3 * W, 0.1, 0.0), (W, 0.1, 1.0), (W, 0.1, 0.0), (W, 0.1, 0.0))]
    return x, wqkv, wo, f32  # f32: bqkv, g, b, bo


def test_x4_block_fused_matches_reference(ref, capsys):
    x, wqkv, _, (bqkv, g, b, _) = _block_inputs(700, 40)
    want = _np(ref._block_fused(x[0], wqkv[0], jnp.asarray(bqkv), jnp.asarray(g), jnp.asarray(b),
                                n_heads=H))
    out = _np(tb.block_fused(x[1], wqkv[1], *(torch.from_numpy(a) for a in (bqkv, g, b)),
                             n_heads=H))
    _report(capsys, "X4 block_fused", out, want, "allowed atol 0.02 + rtol 0.05")
    np.testing.assert_allclose(out, want, **TOL)


def test_x3_block_fused_o_matches_reference(ref, capsys):
    """v13 whole: the reference's _block_fused_o in interpret mode (its body
    keeps a VMEM scratch, which the interpreter runs), and its composed
    baseline (LN + qkv matmul + v9 + out-projection + residual in plain
    jnp). Bound: the bench's maxrel form, 2e-2."""
    x, wqkv, wo, (bqkv, g, b, bo) = _block_inputs(800, 40)
    jf = [jnp.asarray(a) for a in (bqkv, g, b, bo)]
    want = _np(ref._block_fused_o(x[0], wqkv[0], jf[0], jf[1], jf[2], wo[0], jf[3], n_heads=H))
    tf = [torch.from_numpy(a) for a in (bqkv, g, b, bo)]
    out = _np(tb.block_fused_o(x[1], wqkv[1], tf[0], tf[1], tf[2], wo[1], tf[3], n_heads=H))

    x32 = x[0].astype(jnp.float32)
    mu = x32.mean(-1, keepdims=True)
    xn = ((x32 - mu) * jax.lax.rsqrt(((x32 - mu) ** 2).mean(-1, keepdims=True) + 1e-5) * jf[1]
          + jf[2]).astype(jnp.bfloat16)
    qkv = (jnp.dot(xn, wqkv[0], preferred_element_type=jnp.float32) + jf[0]).astype(jnp.bfloat16)
    a = ref._mha_v8_projlayout(qkv, n_heads=H, kernel=ref._kernel_fused_nomax)
    base = np.asarray(x32 + (jnp.dot(a, wo[0], preferred_element_type=jnp.float32) + jf[3]))
    for what, w_ in (("X3 vs _block_fused_o", want), ("X3 vs the composed baseline", base)):
        rel = np.abs(out - w_).max() / (np.abs(w_).max() + 1e-9)
        with capsys.disabled():
            print(f"\n{what}: maxrel {rel:.3e} (allowed 2e-2)")
        assert rel <= 2e-2
    # One rounding at the end: the port's value is the bf16 of the f32 sum.
    assert out.dtype == np.float32 and np.abs(out - base).max() <= np.abs(base).max() * 2**-8


def test_bench_main_runs_on_the_cpu(capsys):
    """The bench's control flow at a tiny shape: every row printed, both
    cross-checks under the bench's 2e-2, no launch counted on the CPU."""
    res = tb.main(["1"], device="cpu", shape=(2, 4, 21, 16))
    text = capsys.readouterr().out
    for row in ("mha (production)", "v1_unrolled", "v2_nomax", "v3_pipelined", "probe_exp_only",
                "probe_softmax_only", "probe_matmul_only", "v8_projlayout", "v9_proj_nomax",
                "v10_proj_pipelined", "v11_nomax_pipelined", "v12_block_fused",
                "subblock: v13 all-fused", "block: v13 | plain mlp", "v13 maxrel vs baseline",
                "full-block maxrel vs baseline"):
        assert row in text, row
    assert len(res["rows"]) == 18 and all(np.isfinite(v) for v in res["rows"].values())
    assert res["maxrel"]["v13"] < 2e-2 and res["maxrel"]["full-block"] < 2e-2
    layer = tb.main(["1", "--layer-only"], device="cpu", shape=(2, 4, 21, 16), out=lambda m: None)
    assert len(layer["rows"]) == 7
    assert tb.mha_v1_unrolled.launches == tb.block_fused.launches == tb.block_fused_o.launches == 0
    assert not any(tb.probe.launches.values()) and not any(tb.mha_v8_projlayout.launches.values())
