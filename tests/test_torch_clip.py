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
from dream2real_tpu.clip import convert as jconvert
from dream2real_tpu_torch.bridge import clip_from_jax, clip_to_numpy
from dream2real_tpu_torch.clip import convert as tconvert
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


def _hf_state_dict(cfg, seed):
    """A state dict under HF transformers' CLIPModel key names and shapes
    ((out, in) linears, separate q / k / v), from a numpy seed."""
    rng = np.random.default_rng(seed)
    sd = {}

    def put(key, shape, std=0.05, mean=0.0):
        sd[key] = (rng.normal(size=shape) * std + mean).astype(np.float32)

    def tower(prefix, width, layers):
        for i in range(layers):
            lp = f"{prefix}.encoder.layers.{i}"
            for ln in ("layer_norm1", "layer_norm2"):
                put(f"{lp}.{ln}.weight", (width,), 0.1, 1.0)
                put(f"{lp}.{ln}.bias", (width,), 0.1)
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                put(f"{lp}.self_attn.{proj}.weight", (width, width), width**-0.5)
                put(f"{lp}.self_attn.{proj}.bias", (width,), 0.02)
            put(f"{lp}.mlp.fc1.weight", (4 * width, width), width**-0.5)
            put(f"{lp}.mlp.fc1.bias", (4 * width,), 0.02)
            put(f"{lp}.mlp.fc2.weight", (width, 4 * width), (4 * width) ** -0.5)
            put(f"{lp}.mlp.fc2.bias", (width,), 0.02)

    vm, tm, W, Wt = "vision_model", "text_model", cfg.vision_width, cfg.text_width
    put(f"{vm}.embeddings.patch_embedding.weight", (W, 3, cfg.patch_size, cfg.patch_size))
    put(f"{vm}.embeddings.class_embedding", (W,))
    put(f"{vm}.embeddings.position_embedding.weight", (cfg.grid**2 + 1, W))
    for ln in ("pre_layrnorm", "post_layernorm"):
        put(f"{vm}.{ln}.weight", (W,), 0.1, 1.0)
        put(f"{vm}.{ln}.bias", (W,), 0.1)
    put("visual_projection.weight", (cfg.projection_dim, W), W**-0.5)
    tower(vm, W, cfg.vision_layers)
    put(f"{tm}.embeddings.token_embedding.weight", (cfg.vocab_size, Wt))
    put(f"{tm}.embeddings.position_embedding.weight", (cfg.context_length, Wt), 0.01)
    put(f"{tm}.final_layer_norm.weight", (Wt,), 0.1, 1.0)
    put(f"{tm}.final_layer_norm.bias", (Wt,), 0.1)
    put("text_projection.weight", (cfg.projection_dim, Wt), Wt**-0.5)
    tower(tm, Wt, cfg.text_layers)
    sd["logit_scale"] = np.float32(np.log(1 / 0.07))
    return sd


def test_hf_state_dict_conversion_parity():
    """One HF-named state dict through both packages' converters: the
    parameter trees agree exactly, and the towers agree at this file's
    embedding tolerance."""
    kw = dict(KW, vocab_size=600, context_length=16, eot_id=599)
    jcfg, cfg = jclip.CLIPConfig(**kw), tclip.CLIPConfig(**kw)
    sd = _hf_state_dict(cfg, 11)
    jparams = jconvert.params_from_hf_state_dict(sd, jcfg)
    tparams = tconvert.params_from_hf_state_dict(sd, cfg)
    jleaves = jax.tree_util.tree_leaves_with_path(jparams)
    tleaves = dict(jax.tree_util.tree_leaves_with_path(tparams))
    assert len(jleaves) == len(tleaves)
    for path, leaf in jleaves:
        np.testing.assert_array_equal(np.asarray(leaf), tleaves[path], err_msg=str(path))
    # q / k / v are packed [q | k | v] along the output axis.
    W = cfg.vision_width
    np.testing.assert_array_equal(
        tparams["v_blk0"]["qkv"]["w"][:, W : 2 * W],
        sd["vision_model.encoder.layers.0.self_attn.k_proj.weight"].T)

    model = tconvert.model_from_hf_state_dict(sd, cfg, device="cpu")
    _, px = _pixels(4)
    px = np.array(px)
    np.testing.assert_allclose(
        tclip.encode_image(model, torch.from_numpy(px)).numpy(),
        np.asarray(jclip.encode_image(jparams, jcfg, jnp.asarray(px))), **EMB_TOL)
    ids = np.random.default_rng(12).integers(1, 599, size=(3, 16)).astype(np.int32)
    ids[0, 5:], ids[1, 9:], ids[2, 15:] = 599, 599, 599  # EOT, then padding with it
    np.testing.assert_allclose(
        tclip.encode_text(model, torch.from_numpy(ids)).numpy(),
        np.asarray(jclip.encode_text(jparams, jcfg, jnp.asarray(ids))), **EMB_TOL)


def test_bridge_clip_round_trip_exact(models):
    """Port model -> the reference's parameter tree (numpy) -> port model:
    every parameter bit for bit; and the tree runs in the JAX package."""
    params, model = models
    tree = clip_to_numpy(model)
    ref_paths = {p for p, _ in jax.tree_util.tree_leaves_with_path(params)}
    assert {p for p, _ in jax.tree_util.tree_leaves_with_path(tree)} == ref_paths
    back = clip_from_jax(tree, CFG, device="cpu")
    for (name, a), b in zip(model.named_parameters(), back.parameters()):
        assert torch.equal(a, b), name
    _, px = _pixels(5)
    px = np.array(px)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    np.testing.assert_allclose(
        np.asarray(jclip.encode_image(jtree, JCFG, jnp.asarray(px))),
        tclip.encode_image(model, torch.from_numpy(px)).numpy(), **EMB_TOL)


def test_config_from_hf_matches_reference():
    import types

    ns = types.SimpleNamespace
    hf = ns(projection_dim=24,
            vision_config=ns(image_size=64, patch_size=16, hidden_size=48, num_hidden_layers=3,
                             num_attention_heads=6),
            text_config=ns(vocab_size=300, max_position_embeddings=20, hidden_size=40,
                           num_hidden_layers=2, num_attention_heads=5, eos_token_id=299))
    assert tuple(tconvert.config_from_hf(hf)) == tuple(jconvert.config_from_hf(hf))


def test_clip_load_dryrun_on_a_tiny_checkpoint(tmp_path, capsys):
    """cli/selftest.py --clip-load-dryrun at a tiny width: a checkpoint in
    HF's file layout is written, loaded through load_clip and scored once."""
    transformers = pytest.importorskip("transformers")
    pytest.importorskip("safetensors")
    from dream2real_tpu_torch.cli.selftest import clip_load_dryrun

    hf = transformers.CLIPConfig(
        projection_dim=16,
        text_config_dict=dict(hidden_size=32, intermediate_size=128, num_hidden_layers=2,
                              num_attention_heads=4, max_position_embeddings=16, vocab_size=600,
                              hidden_act="quick_gelu", eos_token_id=599),
        vision_config_dict=dict(hidden_size=32, intermediate_size=128, num_hidden_layers=2,
                                num_attention_heads=4, image_size=32, patch_size=8,
                                hidden_act="quick_gelu"))
    assert clip_load_dryrun(str(tmp_path / "ckpt"), device="cpu", hf_config=hf) == 0
    assert "CLIP LOAD DRYRUN PASS" in capsys.readouterr().out
    model, cfg = tconvert.load_clip(str(tmp_path / "ckpt"), device="cpu")
    assert tuple(cfg) == tuple(tconvert.config_from_hf(hf)) and model.cfg == cfg
    with pytest.raises(FileNotFoundError):
        tconvert.load_clip(str(tmp_path / "missing"), device="cpu")
