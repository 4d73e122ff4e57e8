"""The hash-grid field's training step against the benchmark's plain
reference (``benchmark/reference/hashgrid.py``), and H1 against its twin.

On the CPU, at a small size (4 levels of 2^10 entries, hidden 16, 256 rays
of 8 + 8 samples and 8 free-space samples, a 32 x 18 scan): the program's
first 3 steps from a seed against the reference's, within the limits of the
cell ``instant-ngp-base.fg_task``; the control (the reference in float8)
and each planted fault outside them; the reference's level layout and hash
indices worked out by hand; a traced run counting the points each step
encodes.

On the card (marked ``cuda``; they skip here): H1 against
``hash_encode_plain`` at the published widths on 2^18 points and on the
cell's 4096 rays of 64, 32 and 8 ray-ordered samples (the features
within one bf16 step, plus 2^-20 of their sum of |corner terms| for the
sums' other order; the table's gradient within 1e-5 of its largest entry
with cosine >= 0.99999: the atomics' order varies), and the training step
as a CUDA graph against the eager step. Without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_hashgrid_train.py
"""

from __future__ import annotations

import copy
import math

import pytest
import torch

from benchmark import harness
from benchmark.drivers import hashgrid_training
from benchmark.reference import hashgrid as ref_hashgrid

torch.set_num_threads(2)
CELL = "instant-ngp-base.fg_task"
TINY_GRID = dict(n_levels=4, n_features=2, log2_hashmap_size=10, base_resolution=4,
                 max_resolution=64)


def tiny_ctx(seed: int, trace: bool = False) -> harness.RunContext:
    """The cell cut to the small size; everything else as the cell runs."""
    cell = harness.load_cell(CELL)
    cfg, tr = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    cfg["field"].update(grid=dict(TINY_GRID), hidden_dim=16)
    cfg["render"].update(n_coarse=8, n_fine=8)
    cfg["scan"].update(views=4, scale=0.05)
    cfg["train"].update(batch_rays=256, poll_steps=2)
    tr["trace"]["chunks"] = 1
    tiny = harness.Cell(cell.name, cell.entry, cfg, tr, cell.end_to_end, cell.per_layer)
    return harness.RunContext(cell=tiny, seed=seed, seconds=0.0, trace=trace,
                              device=torch.device("cpu"), t_start=harness.now(),
                              log=lambda m: None)


def _over(gaps: dict, limits: dict) -> list:
    return [k for k, lim in limits.items() if not harness.within(gaps[k], lim)]


@pytest.mark.parametrize("seed", [5, 2**31 + 9])
def test_first_steps_match_the_reference_and_the_control_does_not(seed):
    ctx = tiny_ctx(seed)
    limits = ctx.cell.traffic["check"]["limits"]
    out = hashgrid_training.readings(ctx, True)
    print({k: out[k] for k in limits}, "control", out["control"], "limits", limits)
    assert not _over(out, limits), out
    assert _over(out["control"], limits), out["control"]
    assert out["prog"]["grad_norms"]["table"] > 0 and out["prog"]["change_norms"]["table"] > 0


@pytest.mark.parametrize("fault", hashgrid_training.FAULTS)
def test_a_planted_fault_is_not_correct(fault):
    ctx = tiny_ctx(3)
    with hashgrid_training.plant(fault):
        out = hashgrid_training.run(ctx)
    assert not out.correct and out.failed > 0, out.compared


def test_a_traced_run_counts_the_encoded_points():
    """A whole tiny traced run is correct, and each step counts the points
    it sends through the hash encoding: the coarse pass, the samples the
    loss uses and the free-space samples."""
    from dream2real_tpu_torch.utils import profiling

    ctx = tiny_ctx(2**31 + 3, trace=True)
    profiling.reset()
    out = hashgrid_training.run(ctx)
    assert out.correct, out.compared
    counters = profiling.counters()
    st, tc = ctx.cell.config["render"], ctx.cell.config["train"]
    per_step = tc["batch_rays"] * (2 * st["n_coarse"] + st["n_fine"] + tc["freespace_samples"])
    assert counters["train.steps"] == out.attempted > 0
    assert counters["train.encoded_points"] == out.attempted * per_step
    assert out.layer_ctx["field"]["grid"] == TINY_GRID


@pytest.mark.parametrize("grid", [{}, TINY_GRID], ids=["published", "tiny"])
def test_reference_level_layout_is_the_programs(grid):
    from dream2real_tpu_torch.nerf.hashgrid import HashGridConfig

    cfg = HashGridConfig(**grid)
    full = dict(cfg._asdict())
    assert ref_hashgrid.resolutions(full) == cfg.level_resolutions().tolist()
    if not grid:  # floor(16 * 2^(7 l / 15)); dense while (res + 1)^3 <= 2^19
        assert ref_hashgrid.resolutions(full) == [16, 22, 30, 42, 58, 80, 111, 153, 212, 294,
                                                   406, 561, 776, 1072, 1482, 2048]
        assert cfg.level_is_dense().tolist() == [1] * 5 + [0] * 11


def test_reference_hash_indices_by_hand():
    t = torch.tensor
    # Dense, res 4 (stride 5): 1 + 5 * (2 + 5 * 3) = 86.
    assert int(ref_hashgrid.corner_index(t(1), t(2), t(3), 4, True, 1024)) == 86
    # Hashed: 5 * 2654435761 = 387276917 and 7 * 805459861 = 1343251731 mod
    # 2^32, whose low 10 bits are 117 and 275; 3 ^ 117 ^ 275 = 357.
    assert (387276917 % 1024, 1343251731 % 1024, 3 ^ 117 ^ 275) == (117, 275, 357)
    assert int(ref_hashgrid.corner_index(t(3), t(5), t(7), 25, False, 1024)) == 357
    assert int(ref_hashgrid.corner_index(t(0), t(0), t(0), 25, False, 1024)) == 0
    # The top corner of the finest level: 2048 * 2654435761 and 2048 *
    # 805459861 carry past 32 bits; the low 19 bits are what the uint32 hash
    # keeps.
    want = (2048 ^ ((2048 * 2654435761) % 2**32) ^ ((2048 * 805459861) % 2**32)) % 2**19
    got = ref_hashgrid.corner_index(t(2048), t(2048), t(2048), 2048, False, 2**19)
    assert int(got) == want


def test_reference_encode_is_the_plain_version():
    """The reference's encoding and the program's plain version (H1's twin)
    on the same table: equal to float32 rounding of the corner sums."""
    from dream2real_tpu_torch.nerf.hashgrid import HashGridConfig, hash_encode_plain

    cfg = HashGridConfig(**TINY_GRID)
    g = torch.Generator().manual_seed(4)
    table = torch.rand(cfg.n_levels, cfg.table_size, cfg.n_features, generator=g) * 2 - 1
    pos = torch.rand(4096, 3, generator=g) * 1.1 - 0.05
    want = hash_encode_plain(pos, table, cfg)
    got = ref_hashgrid.encode(pos, table, dict(cfg._asdict()))
    assert (got - want).abs().max() <= 1e-6


# ------------------------------------------------------------------ the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: H1 and the step's graph")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("samples", [None, 64, 32, 8])
def test_kernel_against_its_twin_at_published_widths(samples):
    """On 2^18 points spread over the box (samples None), and ray-ordered as
    the cell sends them: 4096 rays of 64, 32 or 8 sorted samples, each ray a
    chord of the box (the loss's samples, the coarse pass, the free-space
    samples), so that neighbouring points meet in a cell's atomics."""
    from dream2real_tpu_torch.nerf.hashgrid import (HashGridConfig, hash_encode,
                                                    hash_encode_plain, init_hash_table)

    dev = _card()
    cfg = HashGridConfig()
    g = torch.Generator(device=dev).manual_seed(1)
    table = (init_hash_table(cfg, g, dev) * 1e4).requires_grad_(True)  # features O(1)
    if samples is None:
        pos = torch.rand(1 << 18, 3, generator=g, device=dev) * 1.1 - 0.05  # some clamped
    else:
        a, b = (torch.rand(4096, 1, 3, generator=g, device=dev) for _ in range(2))
        u = torch.sort(torch.rand(4096, samples, 1, generator=g, device=dev), dim=1).values
        pos = (a + (b - a) * u).reshape(-1, 3).contiguous()
    cot = torch.randn(pos.shape[0], cfg.out_dim, generator=g, device=dev).to(torch.bfloat16)
    launches = hash_encode.launches, hash_encode.backward_launches
    got = hash_encode(pos, table, cfg)
    got.backward(cot)
    assert (hash_encode.launches, hash_encode.backward_launches) == (launches[0] + 1,
                                                                     launches[1] + 1)
    g_kernel, table.grad = table.grad, None
    want = hash_encode_plain(pos, table, cfg)
    want.backward(cot.float())
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    with torch.no_grad():
        # One bf16 step of the feature, plus the f32 sums' other order
        # (2^-20 of the feature's sum of |corner terms|, as the GEMMs'
        # card tests allow): near-cancelling sums differ by more than their
        # own step.
        terms = hash_encode_plain(pos, table.abs(), cfg)
        step = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=2.0**-100))) - 7)
        gap = (got.float() - want).abs()
        worst = float((gap / (step + 2.0**-20 * terms)).max())
    print(f"features: worst gap {worst:.3f} of one bf16 step plus 2^-20 of the terms")
    assert worst <= 1.0
    gk, gp = g_kernel.double().flatten(), table.grad.double().flatten()
    rel = float((gk - gp).abs().max() / gp.abs().max())
    cos = float(torch.nn.functional.cosine_similarity(gk, gp, dim=0))
    print(f"table gradient: max gap {rel:.2e} of its largest entry, cosine {cos:.8f}")
    assert rel <= 1e-5 and cos >= 0.99999


@pytest.mark.cuda
def test_graph_step_against_the_eager_step(monkeypatch):
    """Three one-step chunks of the small cell's program on the card, as a
    CUDA graph and eagerly (D2R_PALLAS_TRAIN=0) from one seed: every graph
    step a replay and no eager one; the first loss bit for bit (no update
    has run), the next within 1e-3 (the atomics' sums round in another
    order each run)."""
    from torch.profiler import ProfilerActivity, profile

    from dream2real_tpu_torch.utils import profiling

    dev = _card()
    losses, counts = {}, {}
    for mode in ("graph", "eager"):
        if mode == "eager":
            monkeypatch.setenv("D2R_PALLAS_TRAIN", "0")
        ctx = tiny_ctx(11)
        ctx.device = dev
        s = hashgrid_training.Session(ctx)
        s.tc.poll_steps = 1
        profiling.reset()
        with profile(activities=[ProfilerActivity.CPU]):
            losses[mode] = [s.chunk(s.state)[1] for _ in range(3)]
        counts[mode] = profiling.counters()
        s.release()
    assert counts["graph"].get("train.graph_steps") == 3 and "train.graph_steps" not in \
        counts["eager"]
    assert counts["graph"]["train.encoded_points"] == counts["eager"]["train.encoded_points"]
    assert losses["graph"][0] == losses["eager"][0]
    for a, b in zip(losses["graph"][1:], losses["eager"][1:]):
        assert math.isfinite(a) and abs(a - b) <= 1e-3 * abs(b)
