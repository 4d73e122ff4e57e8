"""A NeRF field's first training steps, plainly: the task field's loss
(random-background alpha supervision with Huber(0.1) x 2 on sRGB, depth
Huber(0.05) x 0.1 on solid pixels, free-space carving x 0.1 in front of the
observed depth), autograd, and Adam with L2 weight decay on a cosine
schedule.

Every random number a step takes is drawn again here from the seed, in the
order the trained program draws them from its generator on the same
device: the field's initial weights (uniform in +-sqrt(6 / fan_in), zero
biases), then each step's pixels (image, row, column), background colours,
opaque pixels for half of the rays, free-space quantiles, the coarse
samples' jitter and the Exp(1) draws of the sampler. The sampler is the
defensive-mixture importance sampler: the coarse weights plus mix / (1 -
mix) of their mean plus 1e-8 as the proposal, and n sorted inverse-CDF
samples placed by the order statistics of the Exp(1) draws."""

from __future__ import annotations

import math

import torch

from benchmark.reference import field
from benchmark.reference.precision import F32, Precision, no_tf32


def init_weights(gen, cfg: dict, device) -> dict:
    """The field's leaves drawn as the program's initialiser draws them: one
    uniform draw per weight matrix, in the leaves' order; biases zero."""
    enc = 3 + 6 * cfg["posenc_deg"]
    depth, width, skip = cfg["mlp_depth"], cfg["mlp_width"], cfg["skip_layer"]
    shapes, d = [], enc
    for i in range(depth):
        if skip and i == skip:
            d += enc
        out = width if i < depth - 1 else 1 + cfg["geo_feat_dim"]
        shapes += [(f"trunk_w{i}", (d, out)), (f"trunk_b{i}", (out,))]
        d = out
    cd = [cfg["geo_feat_dim"] + cfg["sh_degree"] ** 2] + \
        [cfg["color_width"]] * (cfg["n_color_layers"] - 1) + [3]
    shapes += [(f"color_w{i}", (cd[i], cd[i + 1])) for i in range(len(cd) - 1)]
    w = {}
    for name, shape in shapes:
        if "_w" in name:
            u = torch.rand(shape, generator=gen, device=device)
            w[name] = (u * 2.0 - 1.0) * math.sqrt(6.0 / shape[0])
        else:
            w[name] = torch.zeros(shape, dtype=F32, device=device)
    return w


def huber(x, delta: float):
    ax = x.abs()
    return torch.where(ax <= delta, 0.5 * x * x, delta * (ax - 0.5 * delta))


def cosine_lr(tc: dict, step: int) -> float:
    decay = max(tc["n_steps"], 1)
    frac = min(step, decay) / decay
    return tc["lr"] * ((1.0 - 0.01) * 0.5 * (1.0 + math.cos(math.pi * frac)) + 0.01)


def sample(fd: field.Field, o, d, ts_c, e, n: int, min_t: float, mix: float):
    """The mixture sampler's n sorted positions in [ts_c[:, 0], ts_c[:, -1]]."""
    with torch.no_grad():
        sig, _, _ = fd.ray_samples(o, d, ts_c, head="train")
        w, _ = field.weights_of(sig, ts_c, torch.sqrt((d * d).sum(-1)), min_t)
        nc = ts_c.shape[1]
        w = w + (mix / (1.0 - mix)) * (w.sum(1, keepdim=True) / nc) + 1e-8
        cdf = torch.cumsum(w / w.sum(1, keepdim=True), 1)
        c_lo = torch.cat([torch.zeros_like(cdf[:, :1]), cdf[:, :-1]], 1)
        mids = 0.5 * (ts_c[:, 1:] + ts_c[:, :-1])
        b_lo = torch.cat([ts_c[:, :1], mids], 1)
        b_hi = torch.cat([mids, ts_c[:, -1:]], 1)
        u = torch.cumsum(e[:, :n], 1) / e.sum(1, keepdim=True)
        k = (cdf[:, None, :] <= u[:, :, None]).sum(-1).clamp(max=nc - 1)
        lo, hi = b_lo.gather(1, k), b_hi.gather(1, k)
        clo, chi = c_lo.gather(1, k), cdf.gather(1, k)
        den = torch.where(chi - clo < 1e-8, torch.ones_like(chi), chi - clo)
        return lo + (u - clo) / den * (hi - lo)


def step_loss(fd: field.Field, data: dict, draws, settings: dict, tc: dict):
    """-> (the loss to differentiate, the task loss to report)."""
    img_idx, py, px, bgc, u_free, jitter, e = draws
    target = data["images"][img_idx, py, px].to(F32) / 255.0
    t_rgb, t_a = field.srgb_to_linear(target[:, :3]), target[:, 3]
    T = data["poses"][img_idx]
    d = torch.einsum("bij,bj->bi", T[:, :3, :3], data["dirs_cam"][py, px])
    o = T[:, :3, 3]
    t0, t1 = field.ray_box(o, d, fd.lo, fd.hi)
    t0 = torch.clamp(t0, min=settings["near"])
    t1 = torch.clamp(t1, max=settings["far"])
    valid = t1 > t0
    t1 = torch.where(valid, t1, t0 + 1e-3)
    nc = settings["n_coarse"]
    frac = (torch.arange(nc, dtype=F32, device=d.device) + 0.5) / nc + (jitter - 0.5) / nc
    ts_c = t0[:, None] + (t1 - t0)[:, None] * frac
    n = settings["n_coarse"] + settings["n_fine"]
    ts = sample(fd, o, d, ts_c, e, n, settings["min_transmittance"], settings["sampler_mix"])
    sigma, rgb, _ = fd.ray_samples(o, d, ts, head="train")
    c, a, z = field.composite(sigma, rgb, ts, torch.sqrt((d * d).sum(-1)),
                              settings["min_transmittance"])
    c = torch.where(valid[:, None], c, torch.zeros_like(c))
    a = torch.where(valid, a, torch.zeros_like(a))
    z = torch.where(valid, z, torch.zeros_like(z))
    pred = c + bgc * (1.0 - a[:, None])
    tgt = t_rgb * t_a[:, None] + bgc * (1.0 - t_a[:, None])
    err = field.linear_to_srgb(torch.clamp(pred, 0.0, 1.0)) - field.linear_to_srgb(tgt)
    loss = huber(err, 0.1).mean() * 2.0
    gt = data["depths"][img_idx, py, px]
    mask = (gt > 0) & (t_a > 0.5)
    loss = loss + tc["depth_weight"] * huber(torch.where(mask, z - gt, torch.zeros_like(gt)),
                                             0.05).mean()
    task = loss.detach()
    near = settings["near"]
    t_hi = torch.clamp(gt * 0.9, min=near)
    t_free = near + u_free * (t_hi - near)[:, None]
    o_sg, d_sg = o.detach(), d.detach()
    sig_f, _ = fd.density(o_sg[:, None] + d_sg[:, None] * t_free[..., None])
    dt = (t_hi - near) / u_free.shape[1] * torch.linalg.norm(d_sg, dim=-1)
    occ = 1.0 - torch.exp(-sig_f * dt[:, None])
    loss = loss + tc["freespace_weight"] * (occ * (gt > 0).to(F32)[:, None]).mean()
    return loss, task


def draw_step(gen, data: dict, tc: dict, settings: dict):
    """One step's random numbers, in the program's order."""
    dev = data["images"].device
    n_img, h, w = data["images"].shape[:3]
    R = tc["batch_rays"]
    img_idx = torch.randint(0, n_img, (R,), generator=gen, device=dev)
    py = torch.randint(0, h, (R,), generator=gen, device=dev)
    px = torch.randint(0, w, (R,), generator=gen, device=dev)
    bgc = torch.rand(R, 3, generator=gen, device=dev)
    fgp = data["fg_pixels"]
    n_fg = R // 2
    sel = torch.randint(0, fgp.shape[0], (n_fg,), generator=gen, device=dev)
    chosen = fgp[sel]
    img_idx = torch.cat([chosen[:, 0], img_idx[n_fg:]])
    py = torch.cat([chosen[:, 1], py[n_fg:]])
    px = torch.cat([chosen[:, 2], px[n_fg:]])
    u_free = torch.rand(R, tc["freespace_samples"], generator=gen, device=dev)
    jitter = torch.rand(R, settings["n_coarse"], generator=gen, device=dev)
    n = settings["n_coarse"] + settings["n_fine"]
    e_u = torch.rand(R, n + 1, generator=gen, device=dev)
    e = -torch.log(1e-12 + (1.0 - 1e-12) * e_u)
    return img_idx, py, px, bgc, u_free, jitter, e


def train_steps(seed: int, data: dict, cfg: dict, settings: dict, tc: dict, n_steps: int,
                prec: Precision) -> dict:
    """The first ``n_steps`` steps from the seed. -> {"losses": [task loss a
    step], "grad_norms": {leaf: the norm of its first gradient as the
    optimizer takes it, decay included}, "change_norms": {leaf: the norm of
    its change over the steps}}."""
    no_tf32()
    dev = data["images"].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    w = {k: v.requires_grad_(True) for k, v in init_weights(gen, cfg, dev).items()}
    start = {k: v.detach().clone() for k, v in w.items()}
    fd = field.Field(w, cfg, prec)
    opt = torch.optim.Adam(list(w.values()), lr=tc["lr"], betas=(0.9, 0.99), eps=1e-8,
                           weight_decay=tc["weight_decay"])
    losses, grad_norms = [], {}
    for step in range(n_steps):
        opt.zero_grad(set_to_none=True)
        loss, task = step_loss(fd, data, draw_step(gen, data, tc, settings), settings, tc)
        loss.backward()
        if step == 0:
            grad_norms = {k: float(torch.linalg.norm(v.grad + tc["weight_decay"] * v.detach()))
                          for k, v in w.items()}
        for group in opt.param_groups:
            group["lr"] = cosine_lr(tc, step)
        opt.step()
        losses.append(float(task))
    change = {k: float(torch.linalg.norm(w[k].detach() - start[k])) for k in w}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
