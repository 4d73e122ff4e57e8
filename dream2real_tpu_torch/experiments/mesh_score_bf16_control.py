"""Control: the sharded-vs-single score gap with the CLIP tower in bf16 and in
f32 (port of the repo's experiments/mesh_score_bf16_control.py).

On the JAX package's 8-device CPU mesh the sharded program's scores drifted
from the single-device program's by about 0.8%, and the JAX script showed
that the gap was XLA placing the bf16 roundings of the tower differently in
the two programs: with the tower in f32 it collapsed. The port runs every
clip group as the same work on any shard, so both gaps are expected to be
0. The pipeline-shaped program (crop path, 112 px, 32 poses, clip_batch 2,
a 2-layer tower 128 wide in heads of 64) on 8 shards of one device, twice:
the tower as it is (bf16 matmul inputs, the kernels on the card), then
``imagine.encode_image`` replaced by an f32 tower on the same weights.

    python -m dream2real_tpu_torch.experiments.mesh_score_bf16_control [--device cpu] [out.json]

Prints one JSON line an arm (the JAX script's keys, plus ``bit_identical``
and the device).
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from dream2real_tpu_torch.cli.bench import device_line
from dream2real_tpu_torch.clip.model import CLIPConfig, CLIPModel, init_clip_params
from dream2real_tpu_torch.device import F32, resolve_device
from dream2real_tpu_torch.nerf.combined import BackgroundView
from dream2real_tpu_torch.nerf.model import NGPConfig, init_ngp_params
from dream2real_tpu_torch.nerf.render import RenderSettings
from dream2real_tpu_torch.ops import cameras
from dream2real_tpu_torch.parallel import imagine
from dream2real_tpu_torch.parallel.mesh import data_mesh

N_SHARDS = 8


def build(dev, res: int = 112):
    """-> (make_imagine_and_score's arguments, its keywords, score_fn's
    arguments): the JAX script's program and inputs, weights from seeds."""
    gen = torch.Generator(device=dev).manual_seed(3)
    ngp_cfg = NGPConfig(mlp_width=48, mlp_depth=3, skip_layer=2, posenc_deg=5,
                        aabb_min=(0.0, -0.6, -0.1), aabb_max=(1.1, 0.6, 0.9))
    field = init_ngp_params(ngp_cfg, gen, device=dev)
    # Heads of 64, which the card's attention kernels take (the JAX script's
    # width 48 in 4 heads of 12 they refuse).
    clip_cfg = CLIPConfig(image_size=res, patch_size=16, vision_width=128, vision_layers=2,
                          vision_heads=2, text_width=128, text_layers=2, text_heads=2,
                          projection_dim=32)
    clip = init_clip_params(clip_cfg, gen, device=dev)
    settings = RenderSettings(n_coarse=16, n_fine=16, near=0.05, far=2.0)
    crop_settings = RenderSettings(n_coarse=24, n_fine=0, near=0.05, far=2.0)
    f = 0.9 * res
    K = np.array([[f, 0, res / 2], [0, f, res / 2], [0, 0, 1.0]])
    dirs_cam = cameras.pixel_dirs(res, res, K, device=dev)
    bg = BackgroundView(rgb=torch.zeros(res, res, 3, device=dev),
                        alpha=torch.ones(res, res, device=dev),
                        depth=torch.ones(res, res, device=dev))
    T_WC = torch.tensor([[1, 0, 0, 0.5], [0, -1, 0, 0.0], [0, 0, -1, 0.6], [0, 0, 0, 1]],
                        dtype=F32, device=dev)
    T_WO = torch.eye(4, dtype=F32, device=dev)
    T_WO[:3, 3] = torch.tensor([0.5, 0.0, 0.05])
    txt = torch.as_tensor(np.random.default_rng(1).normal(size=(2, 32)).astype(np.float32),
                          device=dev)
    obj_aabb = (np.array([0.45, -0.05, 0.0]), np.array([0.55, 0.05, 0.1]))
    poses = np.tile(np.eye(4, dtype=np.float32)[None], (32, 1, 1))
    poses[:, 0, 3] = np.linspace(0.35, 0.65, 32)
    poses[:, 1, 3] = np.tile(np.linspace(-0.1, 0.1, 8), 4)
    poses[:, 2, 3] = 0.05
    kwargs = dict(n_norm_captions=1, clip_batch=2, obj_aabb=obj_aabb, fg_crop=48,
                  crop_settings=crop_settings, intrinsics=K, row_chunk=56)
    args = (field, clip, T_WO, T_WC, bg, txt, torch.as_tensor(poses, device=dev))
    return (ngp_cfg, clip_cfg, settings, dirs_cam), kwargs, args


def encode_image_f32(model: CLIPModel, pixels: torch.Tensor) -> torch.Tensor:
    """The image tower in f32 throughout, on the model's weights (no bf16
    rounding anywhere; exact softmax)."""
    cfg = model.cfg
    B, W, H = pixels.shape[0], cfg.vision_width, cfg.vision_heads
    g, ps = cfg.grid, cfg.patch_size

    def ln(x, gain, bias):
        return torch.nn.functional.layer_norm(x, (x.shape[-1],), gain.float(), bias.float(), 1e-5)

    def lin(x, layer):
        return x @ layer.w.float() + layer.b.float()

    x = pixels.reshape(B, g, ps, g, ps, 3).permute(0, 1, 3, 2, 4, 5).reshape(B, g * g, -1)
    x = x @ model.v_patch_w.float().reshape(ps * ps * 3, W)
    x = torch.cat([model.v_class_emb.float().expand(B, 1, W), x], dim=1) + model.v_pos_emb.float()
    x = ln(x, model.v_ln_pre_g, model.v_ln_pre_b)
    T = x.shape[1]
    for blk in model.v_blk:
        q, k, v = (t.reshape(B, T, H, W // H).transpose(1, 2)
                   for t in lin(ln(x, blk.ln1_g, blk.ln1_b), blk.qkv).split(W, dim=-1))
        a = torch.softmax(q @ k.transpose(-1, -2) * (W // H) ** -0.5, dim=-1) @ v
        x = x + lin(a.transpose(1, 2).reshape(B, T, W), blk.proj)
        h = lin(ln(x, blk.ln2_g, blk.ln2_b), blk.fc1)
        x = x + lin(h * torch.sigmoid(1.702 * h), blk.fc2)
    return ln(x[:, 0], model.v_ln_post_g, model.v_ln_post_b) @ model.v_proj.float()


def compare(tag: str, dev, res: int = 112) -> dict:
    make_args, kwargs, args = build(dev, res)
    single = imagine.make_imagine_and_score(*make_args, device=dev, **kwargs)
    sharded = imagine.make_imagine_and_score(
        *make_args, mesh=data_mesh(devices=[dev] * N_SHARDS), **kwargs)
    s1 = single(*args).double().cpu().numpy()
    s8 = sharded(*args).double().cpu().numpy()
    rel = np.abs(s8 - s1) / np.maximum(np.abs(s1), 1e-12)
    return {"tag": tag, "max_abs": float(np.abs(s8 - s1).max()), "max_rel": float(rel.max()),
            "mean_rel": float(rel.mean()), "bit_identical": bool(np.array_equal(s1, s8)),
            "n_shards": N_SHARDS, "device": device_line(dev)}


def run(device=None, res: int = 112, log=print) -> list:
    dev = resolve_device(device)
    results = [compare("bf16_stock", dev, res)]
    log(json.dumps(results[-1]))
    stock = imagine.encode_image
    imagine.encode_image = encode_image_f32
    try:
        results.append(compare("clip_f32", dev, res))
    finally:
        imagine.encode_image = stock
    log(json.dumps(results[-1]))
    return results


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = None
    if argv[:1] == ["--device"]:
        device, argv = argv[1], argv[2:]
    results = run(device)
    if argv:
        with open(argv[0], "w") as fh:
            json.dump(results, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
