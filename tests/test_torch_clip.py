"""Tiny CLIP towers: the port against the JAX package on bridged parameters
and the same seeded inputs, plus tokenizer and preprocessing parity."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dream2real_tpu.clip import model as jclip
from dream2real_tpu.clip.scorer import build_captions as jbuild_captions
from dream2real_tpu.clip.scorer import reduce_logits as jreduce
from dream2real_tpu.clip.tokenizer import ClipTokenizer as JTokenizer
from dream2real_tpu_torch.bridge import clip_from_jax
from dream2real_tpu_torch.clip import model as tclip
from dream2real_tpu_torch.clip.scorer import build_captions, reduce_logits
from dream2real_tpu_torch.clip.tokenizer import ClipTokenizer, hash_tokenize

torch.set_num_threads(1)

KW = dict(image_size=32, patch_size=8, vision_width=32, vision_layers=2, vision_heads=4,
          text_width=32, text_layers=2, text_heads=4, projection_dim=16)
JCFG = jclip.CLIPConfig(**KW)
CFG = tclip.CLIPConfig(**KW)
# Embeddings pass through bf16 matmuls and a bf16 residual stream; the two
# frameworks sum in different orders, so bf16 roundings flip here and there.
EMB_TOL = dict(atol=3e-2, rtol=3e-2)
CAPTIONS = build_captions("a red box on the green box", ["a red box", "a green box"])


@pytest.fixture(scope="module")
def models():
    params = jclip.init_clip_params(jax.random.PRNGKey(0), JCFG)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return params, clip_from_jax(np_params, CFG, device="cpu")


def _pixels(seed, size=32, n=3):
    u8 = np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    return u8, np.asarray(jclip.preprocess_images(jnp.asarray(u8), JCFG))


def test_hash_tokenizer_ids_equal():
    assert CAPTIONS == jbuild_captions("a red box on the green box", ["a red box", "a green box"])
    texts = CAPTIONS + ["", "Mixed CASE words  and   spaces", " ".join(["w"] * 100)]
    np.testing.assert_array_equal(hash_tokenize(texts), JTokenizer()._hash_tokenize(texts))
    # The tokenizer classes pick the same path here and give the same ids.
    jt, tt = JTokenizer(), ClipTokenizer()
    assert tt.is_semantic == jt.is_semantic
    np.testing.assert_array_equal(tt(texts), jt(texts))


@pytest.mark.parametrize("size", [32, 40])
def test_preprocess_images_parity(size):
    u8, ref = _pixels(1, size=size)
    out = tclip.preprocess_images(torch.from_numpy(u8), CFG)
    assert out.shape == (3, 32, 32, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("fused", ["1", "0"])
def test_encode_image_parity(models, fused, monkeypatch):
    monkeypatch.setenv("D2R_ATTN_FUSED_LN", fused)
    params, model = models
    _, px = _pixels(2)
    px = np.array(px)
    ref = np.asarray(jclip.encode_image(params, JCFG, jnp.asarray(px)))
    out = tclip.encode_image(model, torch.from_numpy(px)).numpy()
    assert out.shape == (3, 16)
    np.testing.assert_allclose(out, ref, **EMB_TOL)


def test_encode_text_and_logits_parity(models):
    params, model = models
    ids = hash_tokenize(CAPTIONS)
    ref_t = jclip.encode_text(params, JCFG, jnp.asarray(ids))
    out_t = tclip.encode_text(model, torch.from_numpy(ids))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(ref_t), **EMB_TOL)

    _, px = _pixels(3)
    px = np.array(px)
    ref_i = jclip.encode_image(params, JCFG, jnp.asarray(px))
    out_i = tclip.encode_image(model, torch.from_numpy(px))
    ref_l = jclip.logits_per_image(params, ref_i, ref_t)
    out_l = tclip.logits_per_image(model, out_i, out_t)
    np.testing.assert_allclose(out_l.numpy(), np.asarray(ref_l), atol=0.05, rtol=0.02)
    # The logit layout and reduction agree exactly on the same logits.
    lg = np.asarray(ref_l)
    np.testing.assert_allclose(reduce_logits(torch.from_numpy(lg), 2, False).numpy(),
                               np.asarray(jreduce(jnp.asarray(lg), 2, False)), rtol=1e-6)
