"""The port's experiments against the root JAX scripts, on the CPU:
``extr_grad_ab``'s perturbed cameras identical to the ones the JAX script
trains from (its ``make_train_chunk`` intercepted), at every level;
``run_shelfscale``'s grid, dedup and regrasp masks identical to the JAX
package's at a small grid with the shelf's 4 x 4 x 4 orientations (keep
fractions 0.375 and 0.25, as the JAX run records for the full grid), and its
cut of the valid poses to the cap as the JAX script makes it. The mesh and
measurement scripts: ``smoothing_alias_study``'s JSON equal to the JAX
script's; ``sharded_slab_prodshape``, ``mesh_score_bf16_control`` and
``verify_save_drive`` at tiny sizes on the CPU; the card-only benches'
variants, knobs and keys against the JAX scripts'."""

import importlib.util
import json
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
from dream2real_tpu_torch.experiments import bench_march as tbm
from dream2real_tpu_torch.experiments import bench_split as tbs
from dream2real_tpu_torch.experiments import bench_train_extr as tbte
from dream2real_tpu_torch.experiments import extr_grad_ab as tab
from dream2real_tpu_torch.experiments import mem_analysis as tmem
from dream2real_tpu_torch.experiments import mesh_score_bf16_control as tbf16
from dream2real_tpu_torch.experiments import run_refscale as tref
from dream2real_tpu_torch.experiments import run_shelfscale as tshelf
from dream2real_tpu_torch.experiments import sharded_slab_prodshape as tssp
from dream2real_tpu_torch.experiments import smoothing_alias_study as tsas
from dream2real_tpu_torch.experiments import verify_save_drive as tvsd

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
    for mod in (tref, tshelf, tab, tbm, tbs, tmem):
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


# ------------------------------------------------------ mesh and measurement
def test_smoothing_alias_study_matches_the_jax_script(tmp_path, monkeypatch):
    script = _load_jax_script("smoothing_alias_study")
    path = tmp_path / "jax.json"
    monkeypatch.setattr(sys, "argv", ["smoothing_alias_study.py", str(path)])
    script.main()
    want = json.load(open(path))
    got = json.loads(json.dumps(tsas.run(log=lambda m: None)))

    def close(a, b, where="") -> None:
        if isinstance(a, dict):
            assert set(a) == set(b), where
            for k in a:
                close(a[k], b[k], f"{where}/{k}")
        elif isinstance(a, list):
            assert len(a) == len(b), where
            for i, (x, y) in enumerate(zip(a, b)):
                close(x, y, f"{where}[{i}]")
        elif isinstance(a, str):
            assert a == b, where
        else:
            assert abs(a - b) <= 1e-6, (where, a, b)

    close(got, want)
    rows = got["resolutions"]
    assert [r["res"] for r in rows] == list(tsas.RESOLUTIONS)
    assert rows[-1]["noise"]["0.0"]["rho_smoothed"] > rows[0]["noise"]["0.0"]["rho_smoothed"]


def _tiny_clip(image_size, patch_size):
    from dream2real_tpu_torch.clip.model import CLIPConfig

    return CLIPConfig(eot_id=127, image_size=image_size, patch_size=patch_size, vision_width=32,
                      vision_layers=2, vision_heads=2, vocab_size=128, context_length=16,
                      text_width=32, text_layers=1, text_heads=2, projection_dim=16)


def test_sharded_slab_is_bit_identical_at_a_tiny_size():
    """The JAX script's slab cut to 32^2, a 2-layer tower and clip_batch 2,
    on 2 CPU shards: bit for bit the single device's, finite and varying."""
    out = tssp.run(n_shards=2, device="cpu", res=32, clip_cfg=_tiny_clip(32, 8), clip_batch=2,
                   fg_crop=16)
    assert out["bit_identical"] and out["max_abs_diff"] == 0.0
    assert out["n_poses"] == 4 and out["n_devices"] == 2 and out["mesh"] == ["cpu", "cpu"]
    assert {"max_rel_diff", "scores_finite", "scores_nonconstant", "wall_s_sharded",
            "wall_s_single", "crop_samples"} <= set(out)


def test_mesh_score_control_gaps_are_zero_on_cpu():
    """Both arms of the control (the stock tower, the f32 tower) on 8 CPU
    shards at 48^2: no gap, where the JAX mesh showed 0.8% in bf16."""
    res = tbf16.run("cpu", res=48, log=lambda m: None)
    assert [r["tag"] for r in res] == ["bf16_stock", "clip_f32"]
    for r in res:
        assert r["bit_identical"] and r["max_abs"] == r["max_rel"] == r["mean_rel"] == 0.0


def test_f32_tower_matches_the_stock_tower_to_bf16():
    """The control's f32 tower computes the stock tower's function: the
    embeddings agree to within the stock tower's bf16 roundings."""
    from dream2real_tpu_torch.clip.model import encode_image, init_clip_params

    cfg = _tiny_clip(32, 8)
    model = init_clip_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    pixels = torch.randn(3, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        a, b = encode_image(model, pixels), tbf16.encode_image_f32(model, pixels)
    cos = torch.nn.functional.cosine_similarity(a, b, dim=-1)
    assert a.dtype == b.dtype == torch.float32 and cos.min() > 0.999, cos


def test_verify_save_drive_on_the_cpu(tmp_path, monkeypatch):
    """The drive at 56^2 with a pending cap of 0 MB: every slab over the
    cap, every PNG written, the backlog within its bound."""
    monkeypatch.setenv("D2R_RENDER_PENDING_MB", "0")
    out = tvsd.run(str(tmp_path / "cb"), device="cpu", n_poses=24, res=56,
                   clip_cfg=_tiny_clip(56, 14))
    assert out["pngs"] == 24 and out["slab"] == 8 and out["n_slabs"] == 3
    assert out["pending_cap_mb"] == 0.0 and 0 < out["peak_pending_mb"] <= out["bound_mb"] + 0.05
    assert os.environ["D2R_RENDER_PENDING_MB"] == "0" and "D2R_SCORE_SLAB" not in os.environ


def _env_knobs(source: str) -> set:
    """The (name, default) of every os.environ.get("D2R_...", "...") in a
    source."""
    import re

    return set(re.findall(r'os\.environ\.get\(\s*"(D2R_[A-Z_]+)",\s*"([^"]*)"\)', source))


def test_card_benches_take_the_jax_scripts_variants_and_knobs():
    """bench_march's variants; bench_split's and bench_march's knobs with
    their defaults (the JAX scripts' but D2R_RENDER_BATCH, the TPU's vmap
    width, which the port has no use for); mem_analysis's keys."""
    import ast
    import inspect

    jbm = _load_jax_script("bench_march")
    assert tbm.VARIANTS == jbm.VARIANTS
    for name, mod in (("bench_march", tbm), ("bench_split", tbs), ("mem_analysis", tmem)):
        want = _env_knobs(open(os.path.join(ROOT, "experiments", f"{name}.py")).read())
        want.discard(("D2R_RENDER_BATCH", "4"))
        assert _env_knobs(inspect.getsource(mod)) == want, name
    tree = ast.parse(open(os.path.join(ROOT, "experiments", "mem_analysis.py")).read())
    jax_keys = {k.value for node in ast.walk(tree) if isinstance(node, ast.Dict)
                for k in node.keys if isinstance(k, ast.Constant)}
    port_keys = {k.value for node in ast.walk(ast.parse(inspect.getsource(tmem)))
                 if isinstance(node, ast.Dict) for k in node.keys if isinstance(k, ast.Constant)}
    assert jax_keys <= port_keys
    for mod in (tmem, tbm, tbs):
        if not torch.cuda.is_available() and mod is tmem:
            with pytest.raises(RuntimeError, match="needs a GPU"):
                mod.run(device="cpu")


def test_bench_train_extr_trains_the_jax_scripts_variants(monkeypatch):
    """The JAX script's main up to its glue-only arm, with the dataset and
    the timing stubbed: the configurations it trains are the port's."""
    script = _load_jax_script("bench_train_extr")
    seen = []

    def tiny_dataset():
        return (jnp.zeros((24, 4, 4, 4), jnp.uint8), jnp.tile(jnp.eye(4)[None], (24, 1, 1)),
                jnp.zeros((32, 128, 3)), jnp.zeros((24, 4, 4)))

    def capture(ncfg, tc, *a, **k):
        seen.append(tc)

    def stop(*a, **k):
        raise _Stop

    monkeypatch.setattr(script, "_dataset", tiny_dataset)
    monkeypatch.setattr(script, "init_train_state", lambda *a, **k: {})
    monkeypatch.setattr(script, "make_train_chunk", capture)
    monkeypatch.setattr(script, "_time_chunk", lambda chunk, state, reps: (1e-3, state))
    monkeypatch.setattr(script, "optimized_poses", stop)
    monkeypatch.setattr(sys, "argv", ["bench_train_extr.py", "3"])
    with pytest.raises(_Stop):
        script.main()
    assert len(seen) == len(tbte.VARIANTS) == 3
    for want, (_, extr, start) in zip(seen, tbte.VARIANTS):
        got = tbte.train_config(extr, start, 3)
        for field in ("n_steps", "batch_rays", "poll_steps", "optimize_extrinsics",
                      "ext_start_step", "dynamic_time_extension"):
            assert getattr(got, field) == getattr(want, field), field
    assert tbte.POLL == script.POLL
