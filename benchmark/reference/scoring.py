"""Imagine and score, plainly: each candidate pose's frame (the movable
object's field marched through its box from the virtual camera, composited
over the background view by depth) and its CLIP score (the goal caption's
logit over the mean of the normalising captions').

The background view is worked out again here from the background field,
the scan's depth of the render view and the movable object's mask; the
frames are rendered full-frame (a ray that misses the object's box keeps
the background, so no crop window is needed)."""

from __future__ import annotations

import torch

from benchmark.reference import clip, field
from benchmark.reference.precision import F32, Precision, no_tf32


def background(bg: field.Field, T_WC, dirs_cam, settings: dict, gt_depth, movable_mask):
    """-> (rgb, alpha, depth) of the view: the field's render, opaque, with
    the scan's depth where the object is not (100 where it is)."""
    rgb, _, _ = field.render_view(bg, T_WC, dirs_cam, settings)
    depth = torch.where(movable_mask == 0, torch.full_like(gt_depth, 100.0), gt_depth)
    return rgb, torch.ones_like(depth), depth


def pose_rays(T_WO_1, T_WO_2, T_WC, dirs_cam):
    """Origins and directions (H * W, 3) of every pixel of the virtual
    camera that shows the object moved to T_WO_2."""
    T = field.virtual_camera(T_WO_1, T_WO_2, T_WC)
    d = dirs_cam.reshape(-1, 3) @ T[:3, :3].T
    return T[:3, 3].expand(d.shape), d


@torch.no_grad()
def frames(fg: field.Field, bg_view, T_WC, T_WO_1, poses, dirs_cam, box, crop_settings: dict):
    """(P, 4, 4) poses -> (P, H, W, 3) u8 frames."""
    H, W = dirs_cam.shape[:2]
    out = []
    for i in range(poses.shape[0]):
        o, d = pose_rays(T_WO_1, poses[i], T_WC, dirs_cam)
        rgb, a, z = field.march_box(fg, o, d, box, crop_settings)
        out.append(field.composite_u8(rgb.reshape(H, W, 3), a.reshape(H, W), z.reshape(H, W),
                                      *bg_view))
    return torch.stack(out)


def goal_and_norm(lg: torch.Tensor, n_norm: int):
    """(N, captions) logits -> the goal caption's logit and the normalising
    captions' mean (ones without normalising captions): the score is their
    ratio."""
    return lg[:, 0], (lg[:, 1:].mean(1) if n_norm else torch.ones_like(lg[:, 0]))


@torch.no_grad()
def forward(inp: dict, poses: torch.Tensor, prec: Precision, block: int = 8) -> dict:
    """Every stage of scoring ``poses`` (N, 4, 4) from the benchmark's
    inputs ``inp``, on the host: the frames (N, H, W, 3) u8, the image
    embeddings (N, P), the captions' embeddings, the goal and normalising
    logits (N,) each, and the frame of the background alone (1, H, W, 3)."""
    no_tf32()
    dev = poses.device
    fcfg, ccfg = inp["field_cfg"], inp["clip_cfg"]
    f32w = {k: v.to(F32) for k, v in inp["clip_w"].items()}
    fg = field.Field({k: v.to(F32) for k, v in inp["fg_w"].items()}, fcfg, prec)
    bg = field.Field({k: v.to(F32) for k, v in inp["bg_w"].items()}, fcfg, prec)
    bg_view = background(bg, inp["T_WC"], inp["dirs_cam"], inp["settings"], inp["gt_depth"],
                         inp["movable_mask"])
    txt = clip.encode_text(f32w, ccfg, torch.as_tensor(inp["ids"], device=dev), prec)
    frs, embs, lgs = [], [], []
    for s in range(0, poses.shape[0], block):
        fr = frames(fg, bg_view, inp["T_WC"], inp["T_WO_1"], poses[s : s + block],
                    inp["dirs_cam"], inp["obj_box"], inp["crop_settings"])
        emb = clip.encode_image(f32w, ccfg, clip.preprocess(fr), prec)
        lgs.append(clip.logits(f32w, emb, txt, prec))
        frs.append(fr.cpu())
        embs.append(emb.cpu())
    goal, norm = goal_and_norm(torch.cat(lgs), inp["n_norm"])
    H, W = inp["dirs_cam"].shape[:2]
    nothing = torch.zeros(H, W, device=dev)
    alone = field.composite_u8(torch.zeros(H, W, 3, device=dev), nothing, nothing, *bg_view)
    return {"frames": torch.cat(frs), "image_emb": torch.cat(embs), "text_emb": txt.cpu(),
            "goal": goal.cpu(), "norm": norm.cpu(), "background": alone[None].cpu()}
