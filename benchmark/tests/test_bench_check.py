"""The check that decides ``correct`` sees what it must: the control (the
reference in float8 in the program's place) and each fault the cells can
have, planted in the timed path of a whole tiny run, come out not correct
under the cells' own limits."""

from __future__ import annotations

import pytest

from benchmark import harness
from benchmark.drivers import field_training, scoring_grid
from benchmark.tests.tiny import tiny_ctx

SCORING = "clip-vitl14-336.shopping_grid"
TRAINING = "field-mlp256.fg_task"


def test_score_gap_reads_no_more_than_the_logit_errors():
    """The gap is the least logit change that explains the program's score:
    never above the logits' own errors, however near zero the normalising
    logit lies; and a pose that near zero is not counted."""
    import random

    from benchmark.reference import compare

    rng = random.Random(3)
    for _ in range(2000):
        g, n = rng.uniform(-1, 1), rng.uniform(-1, 1) * 10 ** rng.uniform(-4, 0)
        dg, dn = rng.uniform(-0.01, 0.01), rng.uniform(-0.01, 0.01)
        s = (g + dg) / (n + dn)
        assert compare.score_gap([s], [g], [n])[0] <= max(abs(dg), abs(dn)) * (1 + 1e-6) + 1e-12


def test_frame_and_embedding_gaps_read_what_they_say():
    """A frame's gap counts channel values more than one level off, not
    those one level off; an embedding's gap ignores its length."""
    import math

    import torch

    from benchmark.reference import compare

    ref = torch.full((2, 4, 4, 3), 100, dtype=torch.uint8)
    prog = ref.clone()
    prog[0] += 1
    prog[1, 0, 0, 0] = 103
    assert compare.frame_gaps(prog, ref) == [0.0, 1 / 48]
    a = torch.tensor([[3.0, 4.0], [1.0, 0.0], [float("nan"), 0.0]])
    b = torch.tensor([[6.0, 8.0], [0.0, 1.0], [1.0, 0.0]])
    gaps = compare.unit_gaps(a, b)
    assert gaps[0] < 1e-12 and abs(gaps[1] - math.sqrt(2)) < 1e-12
    assert compare.worst(gaps) == math.inf and compare.worst([]) == 0.0


def _over(readings: dict, limits: dict) -> list:
    return [k for k, lim in limits.items() if not harness.within(readings[k], lim)]


@pytest.mark.parametrize("seed", [5, 2**31 + 9])
def test_scoring_control_is_not_correct(seed):
    ctx = tiny_ctx(SCORING, seed=seed)
    limits = ctx.cell.traffic["check"]["limits"]
    assert _over(scoring_grid.readings(ctx, True)["control"], limits)


@pytest.mark.parametrize("seed", [5, 2**31 + 9])
def test_training_control_is_not_correct(seed):
    ctx = tiny_ctx(TRAINING, seed=seed)
    s = field_training.Session(ctx)
    s.release()
    limits = ctx.cell.traffic["check"]["limits"]
    assert _over(field_training.control_readings(s, ctx.cell.traffic["check"]["steps"]), limits)


#: Seeds of the tiny runs that plant a fault: the first three, for every
#: fault of every cell.
FAULT_SEEDS = (1, 2, 3)


@pytest.mark.parametrize("cell,fault,seed", [
    (c, f, seed) for c, d in ((SCORING, scoring_grid), (TRAINING, field_training))
    for f in d.FAULTS for seed in FAULT_SEEDS])
def test_a_planted_fault_is_not_correct(cell, fault, seed):
    ctx = tiny_ctx(cell, seed=seed)
    driver = harness.load_driver(ctx.cell.traffic)
    with driver.plant(fault):
        out = driver.run(ctx)
    assert not out.correct, out.compared
    assert out.failed > 0
