"""A full-scene field's first training steps with its cameras' extrinsics
optimised, plainly: every shipped demo trains its scene field so
(``optimize_extrinsics``), with ``training.py``'s field, sampler, loss and
Adam.

The scene field sees every pixel opaque, so it is trained as
``reconstruction.build_vis_model`` trains an unmasked field: each step's
rays are ``batch_rays`` uniform pixels of uniform images, with
random-background alpha supervision and the depth term; there is no
opaque-pixel half and no free-space carving (the free-space quantiles are
drawn all the same, in the program's order, and not used).

Each image n carries a rotation vector r_n and a translation t_n, zero at
the start; a step's camera pose is P_n [R(g r_n) | g t_n], P_n the scanned
pose, R the Rodrigues exponential (R = I + A K + B K^2, K the skew matrix of
the vector, A = sin(theta) / theta and B = (1 - cos(theta)) / theta^2, their
Taylor forms 1 - theta^2 / 6 and 1 / 2 - theta^2 / 24 where theta^2 < 1e-8)
and g the step gate, 1 from ``ext_start_step`` on and 0 before it. A ray of
image n starts at that pose's centre along its rotated pixel direction.
The corrections take their own Adam (betas 0.9 and 0.99, eps 1e-8, the
constant rate ``ext_lr``, no decay) after the field's.

Departure from exact autograd, the program's stated numerics (the fused
backward's closed form; ``nerf/train_kernel.py``'s ``train_bwd_plain`` is
its plain twin): a ray's origin and direction take their gradient through
the encoding of its sample positions alone. The direction's norm in the
composite's step lengths and the direction the SH view encoding reads are
held constant for the gradient (``detach``), as are the sample depths (the
sampler's, which take none anyway): those terms are dropped on purpose, as
the program drops them.
"""

from __future__ import annotations

import torch

from benchmark.reference import field, training
from benchmark.reference.precision import F32, Precision, no_tf32

LEAVES = ("ext_rot", "ext_trans")


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rotation vectors (..., 3) -> rotations (..., 3, 3)."""
    th2 = (w * w).sum(-1, keepdim=True)
    small = th2 < 1e-8
    safe = torch.where(small, torch.ones_like(th2), th2)
    th = torch.sqrt(safe)
    A = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    B = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / safe)
    x, y, z = w[..., 0], w[..., 1], w[..., 2]
    o = torch.zeros_like(x)
    K = torch.stack([o, -z, y, z, o, -x, -y, x, o], -1).reshape(w.shape[:-1] + (3, 3))
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + A[..., None] * K + B[..., None] * (K @ K)


def camera_poses(init_poses, rot, trans, gate: float):
    """P_n [R(g r_n) | g t_n] for every image: (N, 4, 4)."""
    n = init_poses.shape[0]
    top = torch.cat([so3_exp(rot * gate), (trans * gate)[..., None]], -1)
    last = torch.zeros(n, 1, 4, dtype=F32, device=init_poses.device)
    last[..., 3] = 1.0
    return init_poses @ torch.cat([top, last], 1)


def ray_samples(fd: field.Field, o, d, ts):
    """``field.Field.ray_samples(head="train")`` whose SH reads the
    direction as a constant: (sigma, rgb) at the samples ts of rays o, d."""
    r, mm, w = fd.prec.rnd, fd.prec.mm, fd.w
    scale = 2.0 / (fd.hi - fd.lo)
    a3 = field.fma(o, scale, -2.0 * fd.lo / (fd.hi - fd.lo) - 1.0)
    b3 = d * scale
    n = d.shape[0]
    A = (a3[:, None, :] * fd.freqs[None, :, None]).reshape(n, -1)
    B = (b3[:, None, :] * fd.freqs[None, :, None]).reshape(n, -1)
    dc, oc = d.detach(), o.detach()
    sh = r(field.sh4(dc / torch.sqrt((dc * dc).sum(-1))[:, None]))
    t = ts[..., None]
    ang = field.fma(B[:, None], t, A[:, None])
    enc = r(torch.cat([field.fma(b3[:, None], t, a3[:, None]), torch.sin(ang), torch.cos(ang)],
                      -1))
    pos = field.fma(dc[:, None], t, oc[:, None])
    inside = ((pos >= fd.lo) & (pos <= fd.hi)).all(-1)
    h3 = fd._trunk(enc)
    h4 = r(mm(h3, w["trunk_w4"]) + w["trunk_b4"])
    sigma = field.trunc_exp(h4[..., 0])
    c = r(torch.relu(mm(torch.cat([h4[..., 1:], sh[:, None].expand(-1, ts.shape[1], -1)], -1),
                        w["color_w0"])))
    n_col = fd.cfg["n_color_layers"]
    for i in range(1, n_col - 1):
        c = r(torch.relu(mm(c, w[f"color_w{i}"])))
    rgb = torch.sigmoid(mm(c, w[f"color_w{n_col - 1}"]))
    return torch.where(inside, sigma, torch.zeros_like(sigma)), rgb


def draw_step(gen, data: dict, tc: dict, settings: dict):
    """One step's random numbers in the program's order, for unmasked
    images: pixels, background colours, free-space quantiles (unused), the
    coarse jitter and the sampler's Exp(1) draws."""
    dev = data["images"].device
    n_img, h, w = data["images"].shape[:3]
    R = tc["batch_rays"]
    img_idx = torch.randint(0, n_img, (R,), generator=gen, device=dev)
    py = torch.randint(0, h, (R,), generator=gen, device=dev)
    px = torch.randint(0, w, (R,), generator=gen, device=dev)
    bgc = torch.rand(R, 3, generator=gen, device=dev)
    torch.rand(R, tc["freespace_samples"], generator=gen, device=dev)
    jitter = torch.rand(R, settings["n_coarse"], generator=gen, device=dev)
    n = settings["n_coarse"] + settings["n_fine"]
    e = -torch.log(1e-12 + (1.0 - 1e-12) * torch.rand(R, n + 1, generator=gen, device=dev))
    return img_idx, py, px, bgc, jitter, e


def step_loss(fd: field.Field, data: dict, draws, settings: dict, tc: dict, poses):
    """The task loss of one step's rays from the cameras ``poses`` (N, 4,
    4): alpha supervision on sRGB and the depth term."""
    img_idx, py, px, bgc, jitter, e = draws
    target = data["images"][img_idx, py, px].to(F32) / 255.0
    t_rgb, t_a = field.srgb_to_linear(target[:, :3]), target[:, 3]
    T = poses[img_idx]
    d = torch.einsum("bij,bj->bi", T[:, :3, :3], data["dirs_cam"][py, px])
    o = T[:, :3, 3]
    dc, oc = d.detach(), o.detach()
    t0, t1 = field.ray_box(oc, dc, fd.lo, fd.hi)
    t0 = torch.clamp(t0, min=settings["near"])
    t1 = torch.clamp(t1, max=settings["far"])
    valid = t1 > t0
    t1 = torch.where(valid, t1, t0 + 1e-3)
    nc = settings["n_coarse"]
    frac = (torch.arange(nc, dtype=F32, device=d.device) + 0.5) / nc + (jitter - 0.5) / nc
    ts_c = t0[:, None] + (t1 - t0)[:, None] * frac
    n = nc + settings["n_fine"]
    ts = training.sample(fd, oc, dc, ts_c, e, n, settings["min_transmittance"],
                         settings["sampler_mix"])
    sigma, rgb = ray_samples(fd, o, d, ts)
    c, a, z = field.composite(sigma, rgb, ts, torch.sqrt((dc * dc).sum(-1)),
                              settings["min_transmittance"])
    c = torch.where(valid[:, None], c, torch.zeros_like(c))
    a = torch.where(valid, a, torch.zeros_like(a))
    z = torch.where(valid, z, torch.zeros_like(z))
    pred = c + bgc * (1.0 - a[:, None])
    tgt = t_rgb * t_a[:, None] + bgc * (1.0 - t_a[:, None])
    err = field.linear_to_srgb(torch.clamp(pred, 0.0, 1.0)) - field.linear_to_srgb(tgt)
    loss = training.huber(err, 0.1).mean() * 2.0
    gt = data["depths"][img_idx, py, px]
    mask = (gt > 0) & (t_a > 0.5)
    return loss + tc["depth_weight"] * training.huber(
        torch.where(mask, z - gt, torch.zeros_like(gt)), 0.05).mean()


def train_steps(seed: int, data: dict, cfg: dict, settings: dict, tc: dict, n_steps: int,
                prec: Precision, start_step: int) -> dict:
    """The first ``n_steps`` steps from the seed, the step counter starting
    at ``start_step`` (the cosine rate and the gate read it). -> {"losses":
    [task loss a step], "grad_norms": {leaf: the norm of its first gradient
    as its optimizer takes it}, "change_norms": {leaf: the norm of its
    change over the steps}}, the leaves the field's and ``LEAVES``."""
    no_tf32()
    dev = data["images"].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    w = {k: v.requires_grad_(True) for k, v in training.init_weights(gen, cfg, dev).items()}
    n_img = data["images"].shape[0]
    ext = {k: torch.zeros(n_img, 3, dtype=F32, device=dev, requires_grad=True) for k in LEAVES}
    start = {k: v.detach().clone() for k, v in {**w, **ext}.items()}
    fd = field.Field(w, cfg, prec)
    opt = torch.optim.Adam(list(w.values()), lr=tc["lr"], betas=(0.9, 0.99), eps=1e-8,
                           weight_decay=tc["weight_decay"])
    opt_ext = torch.optim.Adam(list(ext.values()), lr=tc["ext_lr"], betas=(0.9, 0.99), eps=1e-8)
    losses, grad_norms = [], {}
    for k in range(n_steps):
        step = start_step + k
        opt.zero_grad(set_to_none=True)
        opt_ext.zero_grad(set_to_none=True)
        gate = 1.0 if step >= tc["ext_start_step"] else 0.0
        poses = camera_poses(data["poses"], ext["ext_rot"], ext["ext_trans"], gate)
        loss = step_loss(fd, data, draw_step(gen, data, tc, settings), settings, tc, poses)
        loss.backward()
        if k == 0:
            grad_norms = {n: float(torch.linalg.norm(v.grad + tc["weight_decay"] * v.detach()))
                          for n, v in w.items()}
            grad_norms.update({n: float(torch.linalg.norm(v.grad)) for n, v in ext.items()})
        for group in opt.param_groups:
            group["lr"] = training.cosine_lr(tc, step)
        opt.step()
        opt_ext.step()
        losses.append(float(loss.detach()))
    now = {**w, **ext}
    change = {k: float(torch.linalg.norm(now[k].detach() - start[k])) for k in now}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
