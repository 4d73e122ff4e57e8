"""The port's reference-scale and extrinsics experiments against the root
JAX scripts, on the CPU: ``extr_grad_ab``'s perturbed cameras identical to
the ones the JAX script trains from (its ``make_train_chunk`` intercepted),
at every level; ``run_shelfscale``'s grid, dedup and regrasp masks identical
to the JAX package's at a small grid with the shelf's 4 x 4 x 4
orientations (keep fractions 0.375 and 0.25, as the JAX run records for the
full grid), and its cut of the valid poses to the cap as the JAX script
makes it."""

import importlib.util
import os
import sys
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dream2real_tpu import sampling as jsampling
from dream2real_tpu.nerf import trainer as jtrainer
from dream2real_tpu.physics import collision as jcoll
from dream2real_tpu_torch.experiments import extr_grad_ab as tab
from dream2real_tpu_torch.experiments import run_refscale as tref
from dream2real_tpu_torch.experiments import run_shelfscale as tshelf

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(ROOT, "experiments", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Stop(Exception):
    pass


@pytest.mark.parametrize("level", tab.LEVELS)
def test_extr_grad_ab_perturbs_as_the_jax_script(level, monkeypatch):
    """The JAX script's main run to its first make_train_chunk (16 views of
    16^2): the poses it hands over equal the port's ``perturb``."""
    script = _load_jax_script("extr_grad_ab")
    seen = []

    def capture(ngp_cfg, tc, settings, rgba, poses, *a, **k):
        seen.append((np.asarray(poses), tc))
        raise _Stop

    monkeypatch.setattr(jtrainer, "make_train_chunk", capture)
    monkeypatch.setenv("D2R_BENCH_RES", "16")
    monkeypatch.setattr(sys, "argv", ["extr_grad_ab.py", "10", "", f"{level[0]:g}:{level[1]:g}"])
    with pytest.raises(_Stop):
        script.main()
    (want, tc), = seen
    _, _, true_poses, _, _, _ = tref.synth_scan(16, 0.5, 0.4, 16)
    got = tab.perturb(true_poses, *level)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[::2], true_poses[::2])  # the anchors
    # The configuration both arms train.
    assert (tc.batch_rays, tc.seed, tc.optimize_extrinsics, tc.poll_steps) == (4096, 3, True, 200)
    errs = [tab.rot_err_deg(got[i, :3, :3], true_poses[i, :3, :3]) for i in range(1, 16, 2)]
    np.testing.assert_allclose(errs, level[0], atol=1e-3)
    moved = 1e3 * np.linalg.norm(got[1::2, :3, 3] - true_poses[1::2, :3, 3], axis=1)
    np.testing.assert_allclose(moved, level[1], atol=1e-3)


@pytest.mark.parametrize("grid", [(3, 2, 2, 4, 4, 4), (2, 1, 3, 2, 3, 4)])
def test_shelf_grid_and_masks_match_jax(grid):
    centre = tref.synth.default_scene().centre
    poses, oris, dedup, regrasp = tshelf.shelf_grid(centre, grid, device="cpu")
    want = jsampling.sample_poses_grid(centre, grid, bounds_override=tshelf.BOUNDS)
    assert len(poses) == int(np.prod(grid)) and oris == grid[3] * grid[4] * grid[5]
    np.testing.assert_array_equal(poses, want)
    p44 = jnp.asarray(want.reshape(-1, 4, 4))
    np.testing.assert_array_equal(dedup, np.asarray(jcoll.orientation_dedup_mask(p44, oris)))
    np.testing.assert_array_equal(regrasp, np.asarray(jcoll.regrasp_mask(p44, oris)))
    if grid[3:] == (4, 4, 4):
        assert (dedup.mean(), regrasp.mean()) == (0.375, 0.25)
    assert int(np.prod(tshelf.GRID)) == 2_211_840


def test_score_subset_cuts_as_the_jax_script(rng):
    valid = rng.random(5000) < 0.3
    n_valid, cap = int(valid.sum()), 512
    vidx = np.flatnonzero(valid)
    want = np.zeros(len(valid), bool)
    want[vidx[(np.arange(cap) * (n_valid / cap)).astype(int)]] = True
    got = tshelf.score_subset(valid, cap)
    np.testing.assert_array_equal(got, want)
    assert got.sum() == cap and not (got & ~valid).any()
    assert tshelf.score_subset(valid, n_valid) is valid


def test_scripts_wait_for_a_healthy_card_and_name_it():
    """Each main waits (wait_cuda_healthy) for the card it runs on before
    anything else."""
    for mod in (tref, tshelf, tab):
        with mock.patch.object(mod, "wait_cuda_healthy", side_effect=_Stop) as wait, \
                pytest.raises(_Stop):
            mod.main([], device="cpu")
        assert wait.call_args.kwargs["device"] == torch.device("cpu")


def test_run_refscale_drives_the_grid_scorer_on_the_cpu(tmp_path):
    """run_refscale's whole path at a tiny size (32^2, a 2-layer tower, 2
    training steps, a 4 x 4 x 2 grid): every pose scored and finite, the
    best pose a grid pose, the JAX script's keys in the record."""
    from dream2real_tpu_torch.clip.model import CLIPConfig

    tiny = CLIPConfig(image_size=16, patch_size=8, vision_width=32, vision_layers=2,
                      vision_heads=2, text_width=32, text_layers=1, text_heads=2,
                      projection_dim=16, context_length=8)
    out = tref.run((4, 4, 2), train_steps=2, n_views=3, data_dir=str(tmp_path), device="cpu",
                   res=32, clip_cfg=tiny, log=lambda m: None)
    jax_keys = {"n_poses", "wall_s", "poses_per_s_sustained", "mesh_devices", "slab",
                "peak_pending_mb", "save_renders", "scores_nonzero", "best_pose_t", "grid",
                "stage_s", "dispatch_s", "drain_s", "n_slabs"}
    assert jax_keys <= set(out) and out["device"] == "cpu"
    assert out["n_poses"] == out["scores_nonzero"] == 32 and out["grid"] == [4, 4, 2, 1, 1, 1]
    assert np.isfinite(out["pose_scores"]).all() and out["pose_batch"].shape == (32, 16)
    hit = np.all(np.isclose(out["pose_batch"], out["best_pose"].reshape(1, 16)), axis=1)
    assert hit.sum() == 1
