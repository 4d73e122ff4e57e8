"""NGP training loop (port of dream2real_tpu/nerf/trainer.py).

``make_train_chunk`` builds ``train_chunk(state) -> (state, mean task loss)``,
which runs ``poll_steps`` optimizer steps and waits for the device once, and
``train_with_governor`` drives chunks under the reference's convergence
governor (stable polls, relaxed thresholds, x1.3 extensions up to a cap).
Per step, as the reference:

- rays: ``batch_rays`` random pixels of random images; with ``fg_pixels``
  (alpha-masked task fields) half of them from the opaque pixels;
- random-background alpha supervision and Huber(0.1) x 2 on sRGB;
- depth Huber(0.05) on solid pixels with valid depth (``depth_weight``);
- free-space carving in front of the observed depth for masked task fields,
  on the plain field with stop-gradient ray geometry (gradient only: the
  reported loss is the task loss);
- learnable per-image se(3) extrinsics, gated to zero before
  ``ext_start_step``, picked per ray by a one-hot product.

The render is ``render_rays_train`` (K5 + K6 + K7 on the card) when the field
is the flagship one, else, or with ``D2R_PALLAS_TRAIN=0``, the plain
differentiable ``render_rays``. Randomness comes from the state's
``torch.Generator`` (seeded by ``TrainConfig.seed``); it draws other numbers
than the reference's PRNG keys.

With ``ray_sharding`` (``parallel.mesh.pose_sharding(mesh)``) the step is
data-parallel over the mesh: the global batch is drawn once, shard i takes
its contiguous rays and runs forward and backward on its device's replica
of the field, and the gradients come back to the first device, summed in
shard order and divided by the mesh size (``pmean`` with a fixed order);
those of the bf16 weight casts join shard 0's backward before the cast
rounds them, so they round once, as on one device (``backward_sharded``).
The losses are the mean of the shards' means. The render's draws are each
shard's rows of one draw over the whole batch (``parallel.mesh.ShardDraws``),
so a sharded step sees the unsharded step's samples and a one-shard mesh is
the unsharded step bit for bit. Both optimizers step once, on the first
device, and the replicas take the new parameters at the next step.

Optimizer: for the field, ``wd * p`` added to the gradient, then Adam (b1
0.9, b2 0.99, eps 1e-8) on a cosine schedule down to 1% of ``lr``: the
reference's ``add_decayed_weights`` + ``adam`` chain, which is what
``torch.optim.Adam(weight_decay=...)`` computes (``AdamW`` would not). The
extrinsics take Adam at ``ext_lr``.

On one card, with the fused kernels, the step's gradients are a CUDA graph:
the chunk that first meets a state warms them up on a side stream, puts the
generator back and captures the draws, the loss, the backward through K5-K7
and the task-loss sum; every step then fills the extrinsics gate, replays
the graph and runs both optimizers as the eager step does. A replay is the
eager step bit for bit: the same kernels, the generator registered with the
graph, and the same optimizer step on the gradients the graph leaves. The
CPU, the sharded step and the plain render take the eager step.

While a profiler runs (``utils/profiling.py``), a chunk is a ``train.chunk``
span holding a ``train.step`` span a step and ``train.fetch``; an eager step
holds ``train.sample``, ``train.forward``, ``train.backward`` and
``train.optim`` (a sharded step's ``train.backward`` holds the shards'
forwards too), a replayed one ``train.replay`` and ``train.optim``.
``train.steps`` counts the steps, ``train.graph_steps`` the replayed ones.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import os
import warnings

import torch

from dream2real_tpu_torch.device import F32, WEIGHT_CAST_HOOK, resolve_device
from dream2real_tpu_torch.nerf.model import NGPConfig, density_fn, init_ngp_params
from dream2real_tpu_torch.nerf.render import RenderSettings, render_rays
from dream2real_tpu_torch.nerf.train_kernel import render_rays_train, supports_training
from dream2real_tpu_torch.ops.image import linear_to_srgb, srgb_to_linear
from dream2real_tpu_torch.ops.se3 import make_pose, so3_exp
from dream2real_tpu_torch.parallel.mesh import ShardDraws, run_shards
from dream2real_tpu_torch.utils.profiling import count, span


@dataclasses.dataclass
class TrainConfig:
    n_steps: int = 2000
    batch_rays: int = 4096
    lr: float = 1e-2
    ext_lr: float = 3e-4
    ext_start_step: int = 256
    weight_decay: float = 1e-6
    optimize_extrinsics: bool = False
    # RGB-D depth supervision weight; 0 disables.
    depth_weight: float = 0.1
    # Free-space carving for masked task fields (fg_pixels given); 0 disables.
    freespace_weight: float = 0.1
    freespace_samples: int = 8
    # Convergence governor (the reference's train_ngp.py:95-97).
    stable_polls_thresh: int = 50
    stable_loss_thresh: float = 2e-4
    max_infinity_steps: int = 40000
    poll_steps: int = 100  # steps per chunk == one governor poll
    dynamic_time_extension: bool = True
    seed: int = 0


def use_train_kernel(cfg: NGPConfig) -> bool:
    """The fused kernels train the flagship field unless D2R_PALLAS_TRAIN=0."""
    return os.environ.get("D2R_PALLAS_TRAIN") != "0" and supports_training(cfg)


def cosine_lr(tc: TrainConfig, step: int) -> float:
    """optax.cosine_decay_schedule(lr, max(n_steps, 1), alpha=0.01) at step."""
    decay = max(tc.n_steps, 1)
    frac = min(step, decay) / decay
    return tc.lr * ((1.0 - 0.01) * 0.5 * (1.0 + math.cos(math.pi * frac)) + 0.01)


def init_train_state(cfg: NGPConfig, tc: TrainConfig, n_images: int, device=None) -> dict:
    """Seeded field, zero extrinsics deltas, both optimizers, step 0."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(tc.seed)
    field = init_ngp_params(cfg, gen, device=dev)
    ext_rot = torch.zeros(n_images, 3, dtype=F32, device=dev, requires_grad=True)
    ext_trans = torch.zeros(n_images, 3, dtype=F32, device=dev, requires_grad=True)
    return {
        "field": field,
        "ext_rot": ext_rot,
        "ext_trans": ext_trans,
        "opt_field": torch.optim.Adam(field.parameters(), lr=tc.lr, betas=(0.9, 0.99), eps=1e-8,
                                      weight_decay=tc.weight_decay),
        "opt_ext": torch.optim.Adam([ext_rot, ext_trans], lr=tc.ext_lr, betas=(0.9, 0.99),
                                    eps=1e-8),
        "step": 0,
        "generator": gen,
    }


def optimized_poses(ext_rot: torch.Tensor, ext_trans: torch.Tensor,
                    init_poses: torch.Tensor) -> torch.Tensor:
    """Compose the learned se(3) deltas onto the initial camera-to-world
    poses (N, 4, 4), accio convention, in full f32."""
    return init_poses @ make_pose(so3_exp(ext_rot), ext_trans)


def _huber(x: torch.Tensor, delta: float) -> torch.Tensor:
    """optax.huber_loss(x, delta=delta) elementwise."""
    ax = x.abs()
    return torch.where(ax <= delta, 0.5 * x * x, delta * (ax - 0.5 * delta))


def make_train_chunk(
    cfg: NGPConfig,
    tc: TrainConfig,
    settings: RenderSettings,
    images_rgba: torch.Tensor,       # (N, H, W, 4) uint8, sRGB + alpha, on the device
    init_poses: torch.Tensor,        # (N, 4, 4) accio camera-to-world
    dirs_cam: torch.Tensor,          # (H, W, 3) z-normalized camera-frame pixel dirs
    depths: torch.Tensor | None = None,      # (N, H, W) f32 z-depth metres, 0 = invalid
    ray_sharding=None,
    fg_pixels: torch.Tensor | None = None,   # (M, 3) int64 [img, y, x] opaque pixels
):
    """Build train_chunk(state) -> (state, mean task loss over the chunk).
    ``ray_sharding``: shard each step's rays over its mesh (``batch_rays``
    must divide by the mesh size), the first device holding the state."""
    n_img, h, w = images_rgba.shape[:3]
    dev = images_rgba.device
    mesh = None if ray_sharding is None else ray_sharding.mesh
    if mesh is not None:
        if tc.batch_rays % mesh.size:
            raise ValueError(f"batch_rays {tc.batch_rays} does not divide over {mesh.size} shards")
        if mesh.lead != dev:
            raise ValueError(f"the mesh leads from {mesh.lead}, the training data is on {dev}")
    use_kernel = use_train_kernel(cfg)
    if tc.optimize_extrinsics and use_kernel:
        warnings.warn(
            "optimize_extrinsics with the fused training kernels uses approximate "
            "ray-origin/direction gradients; set D2R_PALLAS_TRAIN=0 for exact autograd "
            "extrinsics gradients.",
            stacklevel=2,
        )
    # The images, poses, pixel directions and depths on every device.
    data = {dev: (images_rgba, init_poses, dirs_cam, depths)}
    for d in ({} if mesh is None else mesh.distinct()):
        if d not in data:
            data[d] = tuple(None if t is None else t.to(d) for t in data[dev])

    # The chunk's task-loss sum, zeroed a chunk, and the extrinsics gate,
    # filled a step: tensors that the step's graph reads and writes.
    total = torch.zeros((), dtype=F32, device=dev)
    ext_gate = torch.zeros((), dtype=F32, device=dev)

    def sample_batch(gen):
        """-> (img_idx, py, px, bg, u_free): the step's rays, background
        colours and free-space sample quantiles."""
        img_idx = torch.randint(0, n_img, (tc.batch_rays,), generator=gen, device=dev)
        py = torch.randint(0, h, (tc.batch_rays,), generator=gen, device=dev)
        px = torch.randint(0, w, (tc.batch_rays,), generator=gen, device=dev)
        bg = torch.rand(tc.batch_rays, 3, generator=gen, device=dev)
        if fg_pixels is not None:
            n_fg = tc.batch_rays // 2
            sel = torch.randint(0, fg_pixels.shape[0], (n_fg,), generator=gen, device=dev)
            chosen = fg_pixels[sel]
            img_idx = torch.cat([chosen[:, 0], img_idx[n_fg:]])
            py = torch.cat([chosen[:, 1], py[n_fg:]])
            px = torch.cat([chosen[:, 2], px[n_fg:]])
        u_free = torch.rand(tc.batch_rays, tc.freespace_samples, generator=gen, device=dev)
        return img_idx, py, px, bg, u_free

    def loss_fn(state, batch, render_generator, on=None):
        """(loss to differentiate, task loss to report) of one batch; the
        render draws its samples from render_generator (None: midpoints).
        ``on``: the device whose copy of the data the batch indexes (the
        state's device by default)."""
        images, poses_init, dirs_px, depth_maps = data[dev if on is None else on]
        img_idx, py, px, bg, u_free = batch
        target = images[img_idx, py, px].to(F32) / 255.0
        target_rgb = srgb_to_linear(target[:, :3])
        target_a = target[:, 3]

        if tc.optimize_extrinsics:
            # The gate zeroes the deltas (and their gradients) before
            # ext_start_step; the one-hot product keeps the pick
            # differentiable in every pose.
            gate = ext_gate if on in (None, dev) else ext_gate.to(on, non_blocking=True)
            poses = optimized_poses(state["ext_rot"] * gate, state["ext_trans"] * gate,
                                    poses_init)
            sel = torch.nn.functional.one_hot(img_idx, n_img).to(F32)
            T = torch.einsum("bn,nij->bij", sel, poses)
        else:
            T = poses_init[img_idx]
        d_cam = dirs_px[py, px]
        dirs = torch.einsum("bij,bj->bi", T[:, :3, :3], d_cam)
        origins = T[:, :3, 3]

        if use_kernel:
            out = render_rays_train(state["field"], origins, dirs, settings, render_generator,
                                    need_ray_grads=tc.optimize_extrinsics)
        else:
            out = render_rays(state["field"], origins, dirs, settings,
                              generator=render_generator)
        # Random-background alpha supervision.
        pred = out["rgb"] + bg * (1.0 - out["alpha"][:, None])
        tgt = target_rgb * target_a[:, None] + bg * (1.0 - target_a[:, None])
        err = linear_to_srgb(torch.clamp(pred, 0.0, 1.0)) - linear_to_srgb(tgt)
        loss = _huber(err, 0.1).mean() * 2.0
        if depth_maps is not None and tc.depth_weight > 0:
            gt_d = depth_maps[img_idx, py, px]
            mask = (gt_d > 0) & (target_a > 0.5)
            d_err = torch.where(mask, out["depth"] - gt_d, torch.zeros_like(gt_d))
            loss = loss + tc.depth_weight * _huber(d_err, 0.05).mean()
        task_loss = loss.detach()
        if depth_maps is not None and fg_pixels is not None and tc.freespace_weight > 0:
            # Carving shapes the field only: the ray geometry is detached, or
            # the term would pull the cameras off density.
            o_sg, d_sg = origins.detach(), dirs.detach()
            gt_free = depth_maps[img_idx, py, px]
            t_hi = torch.clamp(gt_free * 0.9, min=settings.near)
            t_free = settings.near + u_free * (t_hi - settings.near)[:, None]
            pos_f = o_sg[:, None, :] + d_sg[:, None, :] * t_free[..., None]
            sigma_f, _ = density_fn(state["field"], pos_f)
            dt = (t_hi - settings.near) / tc.freespace_samples * torch.linalg.norm(d_sg, dim=-1)
            occ = 1.0 - torch.exp(-sigma_f * dt[:, None])
            fmask = (gt_free > 0).to(F32)[:, None]
            loss = loss + tc.freespace_weight * (occ * fmask).mean()
        return loss, task_loss

    # The field and the extrinsics on the devices after the first, made at
    # the first sharded step and given the state's values at every step.
    replicas: dict = {}

    def shard_state(state, d):
        if d == dev:
            return state
        trained = [state["field"], state["ext_rot"], state["ext_trans"]]
        if d not in replicas:
            replicas[d] = [copy.deepcopy(m).to(d) if isinstance(m, torch.nn.Module)
                           else m.detach().to(d).requires_grad_(True) for m in trained]
        field, ext_rot, ext_trans = replicas[d]
        with torch.no_grad():
            for rp, p in zip(_tensors_of([field, ext_rot, ext_trans]), _tensors_of(trained)):
                rp.copy_(p, non_blocking=True)
        return {"field": field, "ext_rot": ext_rot, "ext_trans": ext_trans, "step": state["step"]}

    def _trained(state):
        """The tensors a step differentiates: the field's parameters, and
        the extrinsics when they are optimised."""
        ext = [state["ext_rot"], state["ext_trans"]] if tc.optimize_extrinsics else []
        return list(state["field"].parameters()) + ext

    def backward_sharded(state, batch, gen):
        """The sharded step's gradients, left in the state's .grad; -> the
        mean of the shards' task losses.

        Shards 1.. run forward and backward on their devices, their weight
        casts cut into leaves (``device.bf16_weight``), and return the
        gradients of their local means at those leaves and at the trained
        tensors. Shard 0 builds its graph on the first device with each
        weight cast passing through ``_AddShards``; its backward adds the
        other shards' gradients (summed in shard order) at each cast before
        the cast rounds the total to bf16 once, and at the trained tensors
        after. Every term is divided by the mesh size first: the gradient
        of the mean of the local means, as one device takes it. A one-shard
        mesh is the unsharded step bit for bit."""
        n = mesh.size
        draws = ShardDraws(gen, tc.batch_rays, n)
        slots: list = []

        def join(w, out):  # shard 0: the k-th cast waits for the others' gradients
            slots.append({})
            return _AddShards.apply(out, slots[-1])

        def shard(i, d):
            lo, hi = draws.bounds[i]
            part = tuple(t[lo:hi].to(d, non_blocking=True) for t in batch)
            view = shard_state(state, d)
            leaves = []

            def cut(w, out):
                leaves.append(out.detach().requires_grad_(True))
                return leaves[-1]

            WEIGHT_CAST_HOOK.fn = join if i == 0 else cut
            try:
                loss, task_loss = loss_fn(view, part, draws.shard(i), on=d)
            finally:
                WEIGHT_CAST_HOOK.fn = None
            if i == 0:
                return loss, task_loss
            trained = _trained(view)
            grads = torch.autograd.grad(loss, leaves + trained, allow_unused=True)
            return task_loss, grads[: len(leaves)], grads[len(leaves):]

        outs = run_shards(mesh, shard)
        loss0, task_loss = outs[0]
        for out in outs[1:]:
            task_loss = task_loss + out[0]
            if len(out[1]) != len(slots):
                raise RuntimeError(f"shard {len(slots)} weight casts against {len(out[1])}")
        for k, slot in enumerate(slots):
            slot["grad"] = _shard_sum([out[1][k] for out in outs[1:]], n)
            if dev.type == "cuda":
                slot["ready"] = torch.cuda.current_stream(dev).record_event()
        (loss0 / n).backward()
        for j, p in enumerate(_trained(state)):
            extra = _shard_sum([out[2][j] for out in outs[1:]], n)
            if extra is not None:
                p.grad = extra if p.grad is None else p.grad + extra
        return task_loss / n

    def grads_step(state):
        """The step's draws, loss and gradients, left in the trained tensors'
        ``.grad``, its task loss added into ``total``: called, or captured."""
        state["opt_field"].zero_grad(set_to_none=True)
        state["opt_ext"].zero_grad(set_to_none=True)
        gen = state["generator"]
        with span("train.sample"):
            batch = sample_batch(gen)
        if mesh is None:
            with span("train.forward"):
                loss, task_loss = loss_fn(state, batch, gen)
            with span("train.backward"):
                loss.backward()
        else:
            with span("train.backward"):
                task_loss = backward_sharded(state, batch, gen)
        total.add_(task_loss)

    def fill_gate(state):
        if tc.optimize_extrinsics:
            ext_gate.fill_(float(state["step"] >= tc.ext_start_step))

    def optim_step(state):
        with span("train.optim"):
            opt_f = state["opt_field"]
            for group in opt_f.param_groups:
                group["lr"] = cosine_lr(tc, state["step"])
            opt_f.step()
            if tc.optimize_extrinsics:
                state["opt_ext"].step()

    # The flagship field's gradients on one card are replayed as a CUDA
    # graph: the sharded step and the plain render stay eager.
    graphed = dev.type == "cuda" and mesh is None and use_kernel
    captured: dict = {}

    def step_graph(state):
        """The CUDA graph of ``grads_step`` on ``state``, captured at its
        first chunk (and again if the state's parts are replaced), with the
        trained tensors' ``.grad`` pointing at the gradients it writes."""
        parts = [state[k] for k in _GRAPH_PARTS]
        if not captured or any(a is not b for a, b in zip(captured["parts"], parts)):
            captured.clear()  # one graph, and its memory, at a time
            fill_gate(state)
            captured["graph"] = _capture(grads_step, state)
            captured["parts"] = parts
            captured["grads"] = [(p, p.grad) for p in _trained(state)]
        for p, g in captured["grads"]:  # another chunk of the state may have moved them
            if p.grad is not g:
                p.grad = g
        return captured["graph"]

    def train_chunk(state):
        with span("train.chunk"):
            graph = step_graph(state) if graphed else None
            total.zero_()
            for _ in range(tc.poll_steps):
                with span("train.step"):
                    if graph is None:
                        fill_gate(state)
                        grads_step(state)
                    else:
                        with span("train.replay"):
                            fill_gate(state)
                            graph.replay()
                        count("train.graph_steps")
                    optim_step(state)
                    state["step"] += 1
                count("train.steps")
            with span("train.fetch"):
                loss = float(total) / tc.poll_steps
        return state, loss

    def batch_loss(state, batch, render_generator):
        """One batch's loss at the state's step, for tests that inject a batch."""
        fill_gate(state)
        return loss_fn(state, batch, render_generator)

    train_chunk.loss_fn = batch_loss
    return train_chunk


#: The parts of a state that its captured gradients read: another object in
#: any of them is another state, captured anew.
_GRAPH_PARTS = ("field", "ext_rot", "ext_trans", "generator")


def _capture(step, state):
    """Capture ``step(state)`` as a CUDA graph, leaving the state as it was.

    The step runs once first on a side stream: the kernels set their
    shared-memory limits, cuBLAS makes its workspace and the shared
    constants are made, none of which a capture may do. The generator then
    goes back to where it was and the gradients to None, so that the capture
    allocates them in the graph's pool and the first replay draws the
    state's next step. The generator is registered with the graph: a replay
    draws from its offset then and advances it by the step's draws, as the
    eager step does."""
    gen, dev = state["generator"], next(state["field"].parameters()).device
    gen_before = gen.get_state()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        step(state)
    torch.cuda.current_stream(dev).wait_stream(side)
    gen.set_state(gen_before)
    for opt in (state["opt_field"], state["opt_ext"]):
        opt.zero_grad(set_to_none=True)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    # thread_local: the engine's prefetch thread works on the card, on its
    # own stream, while the task fields train.
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        step(state)
    return graph


class _AddShards(torch.autograd.Function):
    """Identity forward; backward adds the other shards' gradient held in
    ``slot`` (filled after the graph is built, ordered on the card by its
    event) to the one arriving."""

    @staticmethod
    def forward(ctx, x, slot):
        ctx.slot = slot
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        extra = ctx.slot.get("grad")
        if extra is None:
            return g, None
        if "ready" in ctx.slot:
            stream = torch.cuda.current_stream(g.device)
            stream.wait_event(ctx.slot["ready"])
            extra.record_stream(stream)
        return g + extra.to(g.dtype), None


def _shard_sum(grads, n: int):
    """The shards' gradients summed in shard order and divided by ``n``, or
    None when no shard has one."""
    total = None
    for g in grads:
        if g is not None:
            total = g if total is None else total + g
    return None if total is None else total / n


def _tensors_of(items) -> list:
    """The parameters of each module and each plain tensor, in order."""
    out = []
    for m in items:
        out.extend(m.parameters() if isinstance(m, torch.nn.Module) else [m])
    return out


def train_with_governor(train_chunk, state, tc: TrainConfig, log_fn=None):
    """Run chunks under the dynamic-time-extension convergence governor.

    Stop when more than stable_polls_thresh consecutive polls see loss <
    stable_loss_thresh, or past max_infinity_steps; at n_steps, unless
    converged or extension is off, relax the thresholds (x1.5 loss, /1.5
    polls) and extend n_steps x1.3 up to the cap. -> (state, losses)."""
    n_steps = tc.n_steps
    stable_polls_thresh = tc.stable_polls_thresh
    stable_loss_thresh = tc.stable_loss_thresh
    stable_polls = 0
    losses: list[float] = []

    while True:
        state, loss = train_chunk(state)
        loss = float(loss)
        step = int(state["step"])
        losses.append(loss)
        if log_fn is not None:
            log_fn(step, loss)

        if loss < stable_loss_thresh:
            stable_polls += 1
        else:
            stable_polls = 0

        if stable_polls > stable_polls_thresh or step > tc.max_infinity_steps:
            break
        if step >= n_steps:
            if (
                stable_polls > stable_polls_thresh and loss < stable_loss_thresh
            ) or not tc.dynamic_time_extension:
                break
            stable_loss_thresh *= 1.5
            stable_polls_thresh = int(stable_polls_thresh / 1.5)
            n_steps = int(n_steps * 1.3)
            if n_steps > tc.max_infinity_steps:
                break
    return state, losses
