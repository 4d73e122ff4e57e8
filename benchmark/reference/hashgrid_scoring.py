"""Imagine and score with instant-ngp fields, plainly: Dream2Real's own
scoring configuration, each object's visual model an instant-ngp field
(Mueller et al., arXiv:2201.05989; ``hashgrid.py``'s field), each candidate
pose's frame that field rendered from the virtual camera and composited
over the background view by depth, scored by CLIP (the goal caption's
logit over the mean of the normalising captions').

It is ``scoring.py`` with the hash-grid field in the flagship field's
place: the background view (``scoring.background``: the background field's
full view, hierarchically sampled, with the scan's depth), the pose rays
(``scoring.pose_rays``), the composite (``field.composite_u8``) and CLIP
(``clip.py``) are theirs. The object's frame is this module's crop march
over the hash field: each ray's range over the object's box within [near,
far], S uniform samples at the midpoints of S strata (t0 + (t1 - t0) (k +
0.5) / S), the field at each (density zero outside the field's box and the
object's box), the front-to-back composite with the last delta 1e2 and
the transmittance cut. ``march_box(count=True)`` also counts the samples
the rays need (a live ray's samples while its transmittance is at or above
the cut) and the live rays, as ``field.march_box`` does.

Departures from the upstream (reconstruction/ngp_visual_model.py renders
each object with pyngp's testbed), each the program's:

- 20 uniform samples in the object's box (the port's crop march) in place
  of pyngp's occupancy-grid cone marching with its adaptive steps;
- the background view 32 coarse + 32 inverse-CDF samples at the quantiles'
  midpoints over the field's box, in place of pyngp's marching;
- ``hashgrid.py``'s departures from tcnn's field: level resolutions
  floor(base b^l) with no half-cell offset, a float32 table, bf16 products
  with float32 sums in place of fp16, the density MLP's 16 outputs read as
  1 density and 15 geometry features;
- random weights from the seed (no trained field): each table uniform in
  +-1, the MLPs uniform in +-sqrt(6 / fan_in).
"""

from __future__ import annotations

import torch

from benchmark.reference import clip, field, hashgrid, scoring
from benchmark.reference.precision import F32, Precision, no_tf32


class Field(hashgrid.Field):
    """``hashgrid.Field`` with the full-view call ``field.render_view``
    takes."""

    def __call__(self, pos, unit_dirs):
        """-> (sigma, linear rgb) at world positions (..., 3) seen along the
        unit directions."""
        sigma, geo = self.density(pos)
        x = torch.cat([geo, self.prec.rnd(field.sh4(unit_dirs))], dim=-1)
        n = self.cfg["n_color_layers"]
        for i in range(n):
            x = self.prec.rnd(self.prec.mm(x, self.w[f"color_w{i}"]))
            if i < n - 1:
                x = torch.relu(x)
        return sigma, torch.sigmoid(x)


@torch.no_grad()
def march_box(fd: Field, origins, dirs, box, settings: dict, count: bool = False):
    """Rays (N, 3) marched through ``box`` = (lo, hi) as the port's crop
    march marches them. -> rgb (N, 3), alpha, depth (zeros on rays that miss
    the box), and with ``count`` the samples these rays need and the live
    rays."""
    S, min_t = settings["n_coarse"], settings["min_transmittance"]
    t0, t1 = field.ray_box(origins, dirs, box[0], box[1])
    t0 = torch.clamp(t0, min=settings["near"])
    t1 = torch.clamp(t1, max=settings["far"])
    idx = torch.nonzero(t0 < t1).squeeze(1)
    n = dirs.shape[0]
    rgb = torch.zeros(n, 3, dtype=F32, device=dirs.device)
    alpha = torch.zeros(n, dtype=F32, device=dirs.device)
    depth = torch.zeros(n, dtype=F32, device=dirs.device)
    needed = 0
    if idx.numel():
        o, d, a0, a1 = origins[idx], dirs[idx], t0[idx], t1[idx]
        frac = (torch.arange(S, dtype=F32, device=d.device) + 0.5) / S
        ts = a0[:, None] + (a1 - a0)[:, None] * frac
        sigma, c, pos = fd.ray_samples(o, d, ts)
        lo = torch.maximum(fd.lo, torch.as_tensor(box[0], dtype=F32, device=d.device))
        hi = torch.minimum(fd.hi, torch.as_tensor(box[1], dtype=F32, device=d.device))
        sigma = torch.where(((pos >= lo) & (pos <= hi)).all(-1), sigma, torch.zeros_like(sigma))
        w, trans = field.weights_of(sigma, ts, torch.linalg.norm(d, dim=-1), min_t)
        rgb[idx] = (w[..., None] * c).sum(1)
        alpha[idx] = w.sum(1)
        depth[idx] = (w * ts).sum(1)
        needed = int((trans >= min_t).sum())
    if count:
        return rgb, alpha, depth, needed, int(idx.numel())
    return rgb, alpha, depth


@torch.no_grad()
def frames(fg: Field, bg_view, T_WC, T_WO_1, poses, dirs_cam, box, crop_settings: dict):
    """(P, 4, 4) poses -> (P, H, W, 3) u8 frames, every pixel's ray marched
    (a ray that misses the object's box keeps the background)."""
    H, W = dirs_cam.shape[:2]
    out = []
    for i in range(poses.shape[0]):
        o, d = scoring.pose_rays(T_WO_1, poses[i], T_WC, dirs_cam)
        rgb, a, z = march_box(fg, o, d, box, crop_settings)
        out.append(field.composite_u8(rgb.reshape(H, W, 3), a.reshape(H, W), z.reshape(H, W),
                                      *bg_view))
    return torch.stack(out)


@torch.no_grad()
def forward(inp: dict, poses: torch.Tensor, prec: Precision, block: int = 8) -> dict:
    """Every stage of scoring ``poses`` (N, 4, 4) from the benchmark's
    inputs ``inp`` (``scoring.forward``'s, the fields' leaves the hash
    field's): the frames (N, H, W, 3) u8, the image embeddings, the
    captions' embeddings, the goal and normalising logits (N,) each, and the
    frame of the background alone (1, H, W, 3), on the host."""
    no_tf32()
    dev = poses.device
    fcfg, ccfg = inp["field_cfg"], inp["clip_cfg"]
    f32w = {k: v.to(F32) for k, v in inp["clip_w"].items()}
    fg = Field({k: v.to(F32) for k, v in inp["fg_w"].items()}, fcfg, prec)
    bg = Field({k: v.to(F32) for k, v in inp["bg_w"].items()}, fcfg, prec)
    bg_view = scoring.background(bg, inp["T_WC"], inp["dirs_cam"], inp["settings"],
                                 inp["gt_depth"], inp["movable_mask"])
    txt = clip.encode_text(f32w, ccfg, torch.as_tensor(inp["ids"], device=dev), prec)
    frs, embs, lgs = [], [], []
    for s in range(0, poses.shape[0], block):
        fr = frames(fg, bg_view, inp["T_WC"], inp["T_WO_1"], poses[s : s + block],
                    inp["dirs_cam"], inp["obj_box"], inp["crop_settings"])
        emb = clip.encode_image(f32w, ccfg, clip.preprocess(fr), prec)
        lgs.append(clip.logits(f32w, emb, txt, prec))
        frs.append(fr.cpu())
        embs.append(emb.cpu())
    goal, norm = scoring.goal_and_norm(torch.cat(lgs), inp["n_norm"])
    H, W = inp["dirs_cam"].shape[:2]
    nothing = torch.zeros(H, W, device=dev)
    alone = field.composite_u8(torch.zeros(H, W, 3, device=dev), nothing, nothing, *bg_view)
    return {"frames": torch.cat(frs), "image_emb": torch.cat(embs), "text_emb": txt.cpu(),
            "goal": goal.cpu(), "norm": norm.cpu(), "background": alone[None].cpu()}
