"""NGP snapshot save/load (port of dream2real_tpu/nerf/snapshot.py).

Same file format as the reference, so a snapshot written by either package
loads in the other: an npz holding the flattened parameter tree ("/"-joined
keys) plus a ``__header__`` entry with the JSON-encoded NGPConfig and an
``extra`` dict; the training run stores its RenderSettings under
``extra["settings"]``.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from dream2real_tpu_torch.nerf.model import HashGridConfig, NGPConfig, NGPField
from dream2real_tpu_torch.nerf.render import RenderSettings

_MAGIC = "dream2real_tpu.ngp.v1"


def _flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, torch.Tensor):
        out[prefix[:-1]] = tree.detach().cpu().numpy()
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten(flat: dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for k, v in flat.items():
        parts = k.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_snapshot(path: str, params: Any, cfg: NGPConfig, extra: dict | None = None):
    """Write params (a nested dict of arrays/tensors, or an NGPField, stored
    under "field" like the reference's trainer) to ``path`` verbatim."""
    if isinstance(params, NGPField):
        params = {"field": params.params()}
    cfg_dict = cfg._asdict()
    cfg_dict["grid"] = cfg.grid._asdict()
    cfg_dict["aabb_min"] = list(cfg.aabb_min)
    cfg_dict["aabb_max"] = list(cfg.aabb_max)
    header = {"magic": _MAGIC, "cfg": cfg_dict, "extra": extra or {}}
    with open(path, "wb") as f:
        np.savez(
            f,
            __header__=np.frombuffer(json.dumps(header).encode(), np.uint8),
            **_flatten(params),
        )


def load_snapshot(path: str) -> tuple[dict, NGPConfig, dict]:
    """-> (nested dict of numpy arrays, NGPConfig, extra)."""
    with np.load(snapshot_path(path)) as z:
        header = json.loads(bytes(z["__header__"].tobytes()).decode())
        if header.get("magic") != _MAGIC:
            raise ValueError(f"not a dream2real_tpu snapshot: {path}")
        flat = {k: z[k] for k in z.files if k != "__header__"}
    c = dict(header["cfg"])
    c["grid"] = HashGridConfig(**c["grid"])
    c["aabb_min"] = tuple(c["aabb_min"])
    c["aabb_max"] = tuple(c["aabb_max"])
    return _unflatten(flat), NGPConfig(**c), header["extra"]


def settings_from_extra(extra: dict) -> RenderSettings | None:
    """The RenderSettings a training run persisted in the header, if any."""
    s = extra.get("settings")
    if not s:
        return None
    return RenderSettings(
        n_coarse=int(s["n_coarse"]), n_fine=int(s["n_fine"]),
        near=float(s["near"]), far=float(s["far"]),
        min_transmittance=float(s["min_transmittance"]),
        compute_dtype=s.get("compute_dtype", "bfloat16"),
    )


def snapshot_path(path: str) -> str:
    """np.savez appends .npz when given a name; accept both spellings so the
    reference's ``.ingp`` file names keep working."""
    return path if os.path.exists(path) else path + ".npz"
