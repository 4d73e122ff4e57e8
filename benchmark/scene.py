"""The inputs the benchmark makes from the seed and hands to both the port
and the reference: the synthetic tabletop and its scan, the cameras, the
candidate pose grid, the caption token ids and the random weights.

The tabletop is the port's ``data/synth.py`` default scene (a table plane
and three boxes; box 0, the red one, is the movable object), rendered here
on the device in one batch by the same analytic rules: exact ray-plane and
ray-box hits, Lambert shading, z-depth and instance ids. Weights are drawn
on the device from one ``torch.Generator`` in one call a distribution and
cut into leaves, in the dtype they are served in.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np

BOXES = (  # (lo, hi, colour); box 0 is the movable object
    ((0.42, -0.12, 0.0), (0.50, -0.04, 0.10), (0.85, 0.15, 0.10)),
    ((0.55, 0.05, 0.0), (0.68, 0.18, 0.06), (0.10, 0.75, 0.20)),
    ((0.36, 0.08, 0.0), (0.44, 0.16, 0.08), (0.15, 0.20, 0.85)),
)
PLANE_Z = 0.0
PLANE_COLOUR = (0.75, 0.7, 0.65)
SKY_COLOUR = (0.0, 0.0, 0.0)
CENTRE = (0.5, 0.0, 0.05)
LIGHT = (0.3, 0.2, 0.9)


def look_at(eye, target, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """Camera-to-world pose, OpenCV convention (+z forward, +y down)."""
    eye, target = np.asarray(eye, np.float64), np.asarray(target, np.float64)
    fwd = target - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    T = np.eye(4)
    T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = right, down, fwd, eye
    return T


def orbit(n: int, radius: float, height: float, centre=CENTRE) -> np.ndarray:
    """n look-at poses on a full circle around the centre: (n, 4, 4) f32."""
    c = np.asarray(centre, np.float64)
    return np.stack([
        look_at(c + np.array([radius * math.cos(2 * math.pi * i / n),
                              radius * math.sin(2 * math.pi * i / n), height]), c)
        for i in range(n)]).astype(np.float32)


def intrinsics(camera: dict, scale: float = 1.0) -> np.ndarray:
    """The camera's pinhole matrix, scaled (a halved image: 0.5)."""
    return np.array([[camera["fx"] * scale, 0.0, camera["cx"] * scale],
                     [0.0, camera["fy"] * scale, camera["cy"] * scale],
                     [0.0, 0.0, 1.0]])


def clip_view_intrinsics(camera: dict, res: int) -> np.ndarray:
    """The CLIP view of a camera: its image centre-cropped to a square and
    resized to ``res`` (how the engine derives its render intrinsics)."""
    h, w = camera["h"], camera["w"]
    side = min(h, w)
    s = res / side
    return np.array([[camera["fx"] * s, 0.0, (camera["cx"] - (w - side) / 2) * s],
                     [0.0, camera["fy"] * s, (camera["cy"] - (h - side) / 2) * s],
                     [0.0, 0.0, 1.0]])


def pixel_dirs(torch, h: int, w: int, K, device):
    """(h, w, 3) z-normalised pinhole directions through pixel centres, f32."""
    K = torch.as_tensor(np.asarray(K), dtype=torch.float32, device=device)
    ys = torch.arange(h, dtype=torch.float32, device=device) + 0.5
    xs = torch.arange(w, dtype=torch.float32, device=device) + 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    x = (gx - K[0, 2]) / K[0, 0]
    y = (gy - K[1, 2]) / K[1, 1]
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def render_tabletop(torch, T_WC, K, h: int, w: int, device):
    """Views (V, 4, 4) of the tabletop -> rgb u8 (V, h, w, 3), z-depth f32
    (V, h, w) (0 where nothing is hit), instance ids u8 (V, h, w): 0 the
    plane, 1.. the boxes, 255 the sky."""
    f64 = torch.float64
    T = torch.as_tensor(np.asarray(T_WC), dtype=f64, device=device)
    dcam = pixel_dirs(torch, h, w, K, device).to(f64)
    dirs = torch.einsum("vij,hwj->vhwi", T[:, :3, :3], dcam)
    o = T[:, None, None, :3, 3]
    V = T.shape[0]
    t_best = torch.full((V, h, w), math.inf, dtype=f64, device=device)
    colour = torch.tensor(SKY_COLOUR, dtype=f64, device=device).expand(V, h, w, 3).clone()
    inst = torch.full((V, h, w), 255, dtype=torch.uint8, device=device)
    normal = torch.zeros((V, h, w, 3), dtype=f64, device=device)
    dz = dirs[..., 2]
    t_plane = (PLANE_Z - o[..., 2]) / torch.where(dz.abs() < 1e-9, torch.full_like(dz, 1e-9), dz)
    upd = (t_plane > 1e-4) & (t_plane < t_best)
    t_best = torch.where(upd, t_plane, t_best)
    colour[upd] = torch.tensor(PLANE_COLOUR, dtype=f64, device=device)
    inst[upd] = 0
    normal[upd] = torch.tensor([0.0, 0.0, 1.0], dtype=f64, device=device)
    safe = torch.where(dirs.abs() < 1e-9, torch.full_like(dirs, 1e-9), dirs)
    for k, (lo, hi, col) in enumerate(BOXES):
        t_lo = (torch.tensor(lo, dtype=f64, device=device) - o) / safe
        t_hi = (torch.tensor(hi, dtype=f64, device=device) - o) / safe
        t0 = torch.minimum(t_lo, t_hi)
        t_near = t0.amax(dim=-1)
        t_far = torch.maximum(t_lo, t_hi).amin(dim=-1)
        upd = (t_far > t_near) & (t_near > 1e-4) & (t_near < t_best)
        t_best = torch.where(upd, t_near, t_best)
        axis = t0.argmax(dim=-1, keepdim=True)
        face_n = torch.zeros_like(normal).scatter_(
            -1, axis, -torch.sign(torch.gather(dirs, -1, axis)))
        colour[upd] = torch.tensor(col, dtype=f64, device=device)
        inst[upd] = k + 1
        normal[upd] = face_n[upd]
    light = torch.tensor(LIGHT, dtype=f64, device=device)
    light = light / torch.linalg.norm(light)
    lam = torch.clamp((normal * light).sum(-1), 0.0, 1.0) * 0.5 + 0.5
    shaded = torch.clamp(colour * lam[..., None], 0.0, 1.0)
    depth = torch.where(torch.isfinite(t_best), t_best, torch.zeros_like(t_best))
    return (shaded * 255 + 0.5).to(torch.uint8), depth.to(torch.float32), inst


def pose_grid(sample_res, bounds, centre=CENTRE) -> np.ndarray:
    """The candidate grid: (prod(sample_res), 4, 4) f32 world poses, x
    slowest, translations on linspaces of ``bounds`` around the centre;
    orientations are identity (the grid's angle ranges are all zero)."""
    axes = [np.linspace(lo + c, hi + c, int(n))
            for (lo, hi), c, n in zip(bounds[:3], centre, sample_res[:3])]
    if any(int(n) != 1 or lo != hi for n, (lo, hi) in zip(sample_res[3:], bounds[3:])):
        raise ValueError("pose_grid makes translation grids only")
    grids = np.meshgrid(*axes, indexing="ij")
    xyz = np.stack([g.reshape(-1) for g in grids], axis=-1)
    poses = np.tile(np.eye(4, dtype=np.float32)[None], (len(xyz), 1, 1))
    poses[:, :3, 3] = xyz.astype(np.float32)
    return poses


def hash_tokenize(texts, context_length: int = 77, vocab_size: int = 49408) -> np.ndarray:
    """Caption ids without a vocabulary: one id a whitespace word (its md5),
    framed by the start and end ids; the end id is the largest, where the
    text tower pools. (B, context_length) int32."""
    sot, eot = 49406, 49407
    ids = np.zeros((len(texts), context_length), np.int32)
    for r, text in enumerate(texts):
        toks = [sot]
        for word in text.lower().strip().split():
            toks.append(1 + int(hashlib.md5(word.encode()).hexdigest(), 16) % (vocab_size - 3))
            if len(toks) >= context_length - 1:
                break
        toks.append(eot)
        ids[r, : len(toks)] = toks
    return ids


def draw(torch, gen, specs, device) -> dict:
    """Leaves from one generator in few calls: ``specs`` is a list of
    (name, shape, kind, scale, dtype), kind "normal" (std scale), "uniform"
    (in +-scale), "const" (filled with scale). One draw a kind over all its
    leaves, cut in order."""
    out = {}
    for kind, fn in (("normal", torch.randn), ("uniform", torch.rand)):
        leaves = [s for s in specs if s[2] == kind]
        total = sum(math.prod(s[1]) for s in leaves)
        flat = fn(total, generator=gen, device=device) if total else None
        off = 0
        for name, shape, _, scale, dtype in leaves:
            n = math.prod(shape)
            x = flat[off : off + n].reshape(shape)
            x = x * scale if kind == "normal" else (x * 2.0 - 1.0) * scale
            out[name] = x.to(dtype)
            off += n
    for name, shape, kind, scale, dtype in specs:
        if kind == "const":
            out[name] = torch.full(shape, float(scale), dtype=dtype, device=device)
    return {name: out[name] for name, *_ in specs}


def field_specs(torch, cfg: dict) -> list:
    """The flagship field's leaves, (in, out) layout, as the port names
    them: weights uniform in +-sqrt(6 / fan_in) and held at bf16-exact f32
    values (the field rounds its weights to bf16 at every use), zero
    biases."""
    enc = 3 + 6 * cfg["posenc_deg"]
    width, depth, skip = cfg["mlp_width"], cfg["mlp_depth"], cfg["skip_layer"]
    specs, d = [], enc
    for i in range(depth):
        if skip and i == skip:
            d += enc
        out = width if i < depth - 1 else 1 + cfg["geo_feat_dim"]
        specs.append((f"trunk_w{i}", (d, out), "uniform", math.sqrt(6.0 / d), torch.float32))
        specs.append((f"trunk_b{i}", (out,), "const", 0.0, torch.float32))
        d = out
    cdims = [cfg["geo_feat_dim"] + cfg["sh_degree"] ** 2] + \
        [cfg["color_width"]] * (cfg["n_color_layers"] - 1) + [3]
    for i in range(len(cdims) - 1):
        specs.append((f"color_w{i}", (cdims[i], cdims[i + 1]), "uniform",
                      math.sqrt(6.0 / cdims[i]), torch.float32))
    return specs


def field_weights(torch, gen, cfg: dict, device) -> dict:
    w = draw(torch, gen, field_specs(torch, cfg), device)
    return {k: v.to(torch.bfloat16).to(torch.float32) for k, v in w.items()}


def clip_specs(torch, c: dict) -> list:
    """Both CLIP towers' leaves under the port's names, with the
    distributions of the port's ``init_clip_params``: matrices bf16, normal
    with std fan_in^-0.5; embeddings bf16 (std 0.02, the text positions
    0.01); LayerNorm gains 1 and biases 0, f32; the output projections f32;
    the logit scale log(1 / 0.07)."""
    bf, f32 = torch.bfloat16, torch.float32
    W, Wt, P = c["vision_width"], c["text_width"], c["projection_dim"]
    grid = c["image_size"] // c["patch_size"]
    ps = c["patch_size"]
    specs = [
        ("v_patch_w", (ps, ps, 3, W), "normal", 0.02, bf),
        ("v_class_emb", (W,), "normal", 0.02, bf),
        ("v_pos_emb", (grid * grid + 1, W), "normal", 0.02, bf),
        ("v_ln_pre_g", (W,), "const", 1.0, f32), ("v_ln_pre_b", (W,), "const", 0.0, f32),
        ("v_ln_post_g", (W,), "const", 1.0, f32), ("v_ln_post_b", (W,), "const", 0.0, f32),
        ("v_proj", (W, P), "normal", W ** -0.5, f32),
        ("t_tok_emb", (c["vocab_size"], Wt), "normal", 0.02, bf),
        ("t_pos_emb", (c["context_length"], Wt), "normal", 0.01, bf),
        ("t_ln_final_g", (Wt,), "const", 1.0, f32), ("t_ln_final_b", (Wt,), "const", 0.0, f32),
        ("t_proj", (Wt, P), "normal", Wt ** -0.5, f32),
        ("logit_scale", (), "const", math.log(1 / 0.07), f32),
    ]
    for tower, width, layers in (("v", W, c["vision_layers"]), ("t", Wt, c["text_layers"])):
        for i in range(layers):
            p = f"{tower}_blk.{i}."
            specs += [(p + "ln1_g", (width,), "const", 1.0, f32),
                      (p + "ln1_b", (width,), "const", 0.0, f32)]
            for name, d_in, d_out in (("qkv", width, 3 * width), ("proj", width, width),
                                      ("fc1", width, 4 * width), ("fc2", 4 * width, width)):
                specs += [(p + name + ".w", (d_in, d_out), "normal", d_in ** -0.5, bf),
                          (p + name + ".b", (d_out,), "const", 0.0, f32)]
            specs += [(p + "ln2_g", (width,), "const", 1.0, f32),
                      (p + "ln2_b", (width,), "const", 0.0, f32)]
    return specs


def clip_weights(torch, gen, c: dict, device) -> dict:
    return draw(torch, gen, clip_specs(torch, c), device)
