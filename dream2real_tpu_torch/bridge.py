"""Weight bridge between the reference's parameter pytrees (as numpy arrays)
and the port's modules, so both packages run the same parameters: JAX
pytrees into the port, and a port field or CLIP model back out
(``field_to_numpy``, ``clip_to_numpy``).

NGP keys: trunk_w0..4, trunk_b0..4, color_w0..2 (f32, (in, out)).
CLIP keys: v_*, t_*, v_blk{i} / t_blk{i} with ln1_g/b, ln2_g/b and
qkv/proj/fc1/fc2 {w, b}, and logit_scale. Arrays are converted with numpy
only (``np.asarray`` of a JAX array is a numpy array), so this module needs
no JAX.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from dream2real_tpu_torch.clip.model import CLIPConfig, CLIPModel
from dream2real_tpu_torch.device import resolve_device
from dream2real_tpu_torch.nerf.model import NGPConfig, NGPField
from dream2real_tpu_torch.nerf.render import RenderSettings
from dream2real_tpu_torch.nerf.snapshot import load_snapshot, settings_from_extra


def _copy(dst: torch.nn.Parameter, src, key: str) -> None:
    arr = np.asarray(src, dtype=np.float32)
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"{key}: shape {arr.shape} != expected {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(torch.tensor(arr).to(device=dst.device, dtype=dst.dtype))


def field_from_jax(params: Mapping, cfg: NGPConfig, device=None) -> NGPField:
    """NGP field params ({key: array}, optionally nested under "field")."""
    if "field" in params:
        params = params["field"]
    field = NGPField(cfg, resolve_device(device))
    own = dict(field.named_parameters())
    missing = set(own) - set(params)
    if missing:
        raise KeyError(f"field params lack {sorted(missing)}")
    for k, p in own.items():
        _copy(p, params[k], k)
    return field


def field_to_numpy(field: NGPField) -> dict[str, np.ndarray]:
    """A port field -> {key: f32 array} in the reference's (in, out) layout,
    the pytree its ``field_fn`` takes (``jnp.asarray`` each to use it)."""
    return {k: p.detach().cpu().numpy().astype(np.float32) for k, p in field.named_parameters()}


def clip_from_jax(params: Mapping, cfg: CLIPConfig, device=None) -> CLIPModel:
    """CLIP params pytree -> CLIPModel (matmul weights rounded to bf16, as the
    reference rounds them at every use)."""
    model = CLIPModel(cfg, resolve_device(device))
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] in ("v_blk", "t_blk"):
            node = params[f"{parts[0]}{parts[1]}"]
            for part in parts[2:]:
                node = node[part]
        else:
            node = params[name]
        _copy(p, node, name)
    return model


def clip_to_numpy(model: CLIPModel) -> dict:
    """A port CLIPModel -> the reference's parameter tree as f32 numpy
    arrays (``jax.tree_util.tree_map(jnp.asarray, ...)`` to use it there).
    The bf16 matmul weights widen exactly, so ``clip_from_jax`` of the
    result gives the same model bit for bit."""
    out: dict = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        node = out
        if parts[0] in ("v_blk", "t_blk"):
            node = out.setdefault(f"{parts[0]}{parts[1]}", {})
            for part in parts[2:-1]:
                node = node.setdefault(part, {})
        node[parts[-1]] = p.detach().to(torch.float32).cpu().numpy()
    return out


def field_from_snapshot(path: str, device=None) -> tuple[NGPField, RenderSettings | None]:
    """Load a snapshot written by either package: the field and the
    RenderSettings its training run persisted (None if absent)."""
    params, cfg, extra = load_snapshot(path)
    return field_from_jax(params, cfg, device), settings_from_extra(extra)
