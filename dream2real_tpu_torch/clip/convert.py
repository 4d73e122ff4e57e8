"""HF transformers CLIPModel -> the port's CLIPModel (port of
dream2real_tpu/clip/convert.py).

Lets the scorer load openai/clip-vit-large-patch14-336 from a local HF
checkpoint directory or an in-memory transformers model. No network access
is assumed: pass a path, set ``D2R_CLIP_PATH``, or hand over a loaded
``transformers.CLIPModel``. ``transformers`` is imported only where a
checkpoint or an HF config is touched.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np

from dream2real_tpu_torch.bridge import clip_from_jax
from dream2real_tpu_torch.clip.model import CLIPConfig, CLIPModel
from dream2real_tpu_torch.device import resolve_device


def config_from_hf(hf_cfg) -> CLIPConfig:
    v, t = hf_cfg.vision_config, hf_cfg.text_config
    return CLIPConfig(
        image_size=v.image_size,
        patch_size=v.patch_size,
        vision_width=v.hidden_size,
        vision_layers=v.num_hidden_layers,
        vision_heads=v.num_attention_heads,
        vocab_size=t.vocab_size,
        context_length=t.max_position_embeddings,
        text_width=t.hidden_size,
        text_layers=t.num_hidden_layers,
        text_heads=t.num_attention_heads,
        projection_dim=hf_cfg.projection_dim,
        eot_id=t.eos_token_id,
    )


def _linear(sd, prefix):
    return {"w": sd[f"{prefix}.weight"].T, "b": sd[f"{prefix}.bias"]}


def _qkv(sd, prefix):
    # HF stores q, k and v apart; the model holds one matrix, packed [q | k | v].
    ws = [sd[f"{prefix}.{n}_proj.weight"] for n in "qkv"]
    bs = [sd[f"{prefix}.{n}_proj.bias"] for n in "qkv"]
    return {"w": np.concatenate(ws, axis=0).T, "b": np.concatenate(bs, axis=0)}


def _block(sd, prefix):
    return {
        "ln1_g": sd[f"{prefix}.layer_norm1.weight"],
        "ln1_b": sd[f"{prefix}.layer_norm1.bias"],
        "qkv": _qkv(sd, f"{prefix}.self_attn"),
        "proj": _linear(sd, f"{prefix}.self_attn.out_proj"),
        "ln2_g": sd[f"{prefix}.layer_norm2.weight"],
        "ln2_b": sd[f"{prefix}.layer_norm2.bias"],
        "fc1": _linear(sd, f"{prefix}.mlp.fc1"),
        "fc2": _linear(sd, f"{prefix}.mlp.fc2"),
    }


def params_from_hf_state_dict(sd: dict, cfg: CLIPConfig) -> dict[str, Any]:
    """A transformers CLIPModel state_dict (torch tensors or numpy) -> the
    parameter tree under the reference's keys, as numpy arrays."""
    sd = {k: np.asarray(v.detach().cpu().float().numpy() if hasattr(v, "detach") else v)
          for k, v in sd.items()}
    p: dict[str, Any] = {}
    vm = "vision_model"
    # (W, 3, ps, ps) conv kernel -> (ps, ps, 3, W).
    p["v_patch_w"] = sd[f"{vm}.embeddings.patch_embedding.weight"].transpose(2, 3, 1, 0)
    p["v_class_emb"] = sd[f"{vm}.embeddings.class_embedding"]
    p["v_pos_emb"] = sd[f"{vm}.embeddings.position_embedding.weight"]
    p["v_ln_pre_g"] = sd[f"{vm}.pre_layrnorm.weight"]  # HF's own spelling
    p["v_ln_pre_b"] = sd[f"{vm}.pre_layrnorm.bias"]
    p["v_ln_post_g"] = sd[f"{vm}.post_layernorm.weight"]
    p["v_ln_post_b"] = sd[f"{vm}.post_layernorm.bias"]
    p["v_proj"] = sd["visual_projection.weight"].T
    for i in range(cfg.vision_layers):
        p[f"v_blk{i}"] = _block(sd, f"{vm}.encoder.layers.{i}")

    tm = "text_model"
    p["t_tok_emb"] = sd[f"{tm}.embeddings.token_embedding.weight"]
    p["t_pos_emb"] = sd[f"{tm}.embeddings.position_embedding.weight"]
    p["t_ln_final_g"] = sd[f"{tm}.final_layer_norm.weight"]
    p["t_ln_final_b"] = sd[f"{tm}.final_layer_norm.bias"]
    p["t_proj"] = sd["text_projection.weight"].T
    for i in range(cfg.text_layers):
        p[f"t_blk{i}"] = _block(sd, f"{tm}.encoder.layers.{i}")
    p["logit_scale"] = np.asarray(sd["logit_scale"], np.float32)
    return p


def model_from_hf_state_dict(sd: dict, cfg: CLIPConfig, device=None) -> CLIPModel:
    """A transformers CLIPModel state_dict -> the port's CLIPModel on
    ``device`` (None: CUDA)."""
    dev = resolve_device(device)  # refuse a missing GPU before converting
    return clip_from_jax(params_from_hf_state_dict(sd, cfg), cfg, dev)


def vit_l_336_hf_config():
    """The architecture of openai/clip-vit-large-patch14-336 as a
    transformers CLIPConfig, built locally."""
    import transformers

    return transformers.CLIPConfig(
        projection_dim=768,
        text_config_dict=dict(
            hidden_size=768, intermediate_size=3072, num_hidden_layers=12,
            num_attention_heads=12, max_position_embeddings=77,
            vocab_size=49408, hidden_act="quick_gelu", eos_token_id=49407,
        ),
        vision_config_dict=dict(
            hidden_size=1024, intermediate_size=4096, num_hidden_layers=24,
            num_attention_heads=16, image_size=336, patch_size=14,
            hidden_act="quick_gelu",
        ),
    )


def write_random_hf_checkpoint(out_dir: str, hf_config=None, seed: int = 0) -> str:
    """Write a random-weight HF CLIP checkpoint with the real tensor names,
    shapes and file layout (config.json + model.safetensors), so that
    ``load_clip`` can be dry-run as it would take the production download.
    Shapes come from a meta-device CLIPModel; values are N(0, 0.02): good
    for the load path, useless for scoring. Returns out_dir."""
    import torch
    import transformers
    from safetensors.torch import save_file

    if hf_config is None:
        hf_config = vit_l_336_hf_config()
    with torch.device("meta"):
        shapes = {k: tuple(v.shape)
                  for k, v in transformers.CLIPModel(hf_config).state_dict().items()}
    rng = np.random.default_rng(seed)
    sd = {k: torch.from_numpy(rng.normal(0.0, 0.02, s).astype(np.float32))
          for k, s in shapes.items()}
    os.makedirs(out_dir, exist_ok=True)
    hf_config.save_pretrained(out_dir)
    save_file(sd, os.path.join(out_dir, "model.safetensors"))
    return out_dir


def load_clip(path_or_model=None, device=None) -> tuple[CLIPModel, CLIPConfig]:
    """Load CLIP weights from a local HF checkpoint directory or a
    transformers CLIPModel instance, onto ``device`` (None: CUDA).

    Resolution order: the argument, then $D2R_CLIP_PATH, then the HF cache.
    Raises FileNotFoundError when no checkpoint can be reached (callers fall
    back to random weights for smoke runs).
    """
    if path_or_model is None:
        path_or_model = os.environ.get("D2R_CLIP_PATH")
    if path_or_model is None:
        path_or_model = "openai/clip-vit-large-patch14-336"

    if hasattr(path_or_model, "state_dict"):  # a transformers CLIPModel
        model = path_or_model
    else:
        from transformers import CLIPModel as HFCLIPModel

        try:
            model = HFCLIPModel.from_pretrained(path_or_model, local_files_only=True)
        except Exception as e:
            raise FileNotFoundError(f"No local CLIP checkpoint at {path_or_model!r}: {e}") from e
    cfg = config_from_hf(model.config)
    return model_from_hf_state_dict(model.state_dict(), cfg, device), cfg
