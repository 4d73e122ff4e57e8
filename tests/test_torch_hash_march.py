"""The hash-grid scoring path and the two cells that the benchmark added with
it, on the CPU at tiny sizes (torch at 2 threads; H2 itself is held on the
card by ``tests/test_torch_cuda.py``).

- The port's crop render of an instant-ngp field (4 levels of 2^10 entries,
  hidden 16, 2 poses, a 16-pixel crop, 8 samples; ``render_rays`` on the
  CPU, H2's twin) against ``benchmark/reference/hashgrid_scoring.py``'s
  crop march: the frames within the cell's ``frame_gap``, the live rays
  equal, the needed samples within 1%.
- One ``_fused_score`` slab of 4 poses with a tiny tower against the
  reference's scores, through the cell's driver, within the cell's limits;
  the control outside them.
- ``scene_training``'s first 3 steps past the extrinsics' gate against
  ``benchmark/reference/extrinsics.py``, within the cell's limits; the
  control outside them.
- Each driver's faults caught by its check.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.drivers import hashgrid_scoring, scene_training
from benchmark.reference import compare
from benchmark.reference import hashgrid_scoring as ref_hs
from benchmark.reference.precision import REFERENCE
from benchmark.tests import tiny

torch.set_num_threads(2)
SCORING = "ngp-clip-vitl14-336.shopping_grid"
SCENE = "field-mlp256.scene_extr"
TINY_GRID = dict(n_levels=4, n_features=2, log2_hashmap_size=10, base_resolution=4,
                 max_resolution=64)
#: TINY_GRID's 8 features as H2's other layout lays them out: half the
#: levels, twice the features.
TINY_GRID_F4 = dict(TINY_GRID, n_levels=2, n_features=4)


def tiny_scoring_cell() -> harness.Cell:
    """The scoring cell cut as ``benchmark/tests/tiny.py`` cuts the MLP
    scoring cell, the field cut to TINY_GRID and hidden 16: one block of 4
    poses, one clip group of 4, all 4 checked."""
    cell = harness.load_cell(SCORING)
    cfg, tr = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    cfg["clip"].update(tiny.TINY_CLIP)
    cfg["engine"].update(render_res=56, fg_crop=28, clip_batch=4)
    cfg["field"]["grid"].update(TINY_GRID)
    cfg["field"].update(hidden_dim=16, color_width=16)
    tr["grid"]["sample_res"] = [4, 4, 2, 1, 1, 1]
    tr.update(block_poses=4, warm_poses=4)
    tr["trace"].update(blocks=1, split_groups=1)
    tr["check"]["poses"] = 4
    return harness.Cell(cell.name, cell.entry, cfg, tr, cell.end_to_end, cell.per_layer)


def tiny_scene_cell() -> harness.Cell:
    """The scene cell cut as ``tiny.py`` cuts field_training's."""
    cell = harness.load_cell(SCENE)
    cfg, tr = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    cfg["scan"].update(views=4, scale=0.05)
    cfg["train"].update(batch_rays=256, poll_steps=2)
    tr["train"]["ext_start_step"] = 4  # the steps to the gate cut as the chunks are
    tr["trace"]["chunks"] = 1
    return harness.Cell(cell.name, cell.entry, cfg, tr, cell.end_to_end, cell.per_layer)


def _ctx(cell: harness.Cell, seed: int) -> harness.RunContext:
    return harness.RunContext(cell=cell, seed=seed, seconds=0.0, trace=False,
                              device=torch.device("cpu"), t_start=harness.now(),
                              log=lambda m: None)


def _over(readings: dict, limits: dict) -> list:
    return [k for k, lim in limits.items() if not harness.within(readings[k], lim)]


# ------------------------------------------------------------ the crop render


@pytest.mark.parametrize("grid,gain", [(TINY_GRID, 2.0), (TINY_GRID_F4, 8.0)],
                         ids=["2_features", "4_features"])
def test_crop_render_matches_the_reference_crop_march(grid, gain):
    from dream2real_tpu_torch.nerf import combined
    from dream2real_tpu_torch.nerf.hashgrid import HashGridConfig
    from dream2real_tpu_torch.nerf.march_kernel import compact_live, march_ranges
    from dream2real_tpu_torch.nerf.model import NGPConfig, NGPField
    from dream2real_tpu_torch.nerf.render import RenderSettings, render_rays
    from dream2real_tpu_torch.ops import cameras

    fcfg = dict(copy.deepcopy(harness.load_cell(SCORING).config["field"]), hidden_dim=16,
                color_width=16, aabb_min=[0.0, -0.6, -0.5], aabb_max=[1.1, 0.6, 0.9])
    fcfg["grid"].update(grid)
    w = hashgrid_scoring.field_weights(torch, torch.Generator().manual_seed(3), fcfg, "cpu")
    # A denser field, some of whose rays pass the cut (bf16-exact: a power of 2).
    w["sigma_w1"][:, 0] = w["sigma_w1"][:, 0].abs() * gain
    fg = NGPField(NGPConfig(**dict(fcfg, grid=HashGridConfig(**fcfg["grid"]),
                                   aabb_min=tuple(fcfg["aabb_min"]),
                                   aabb_max=tuple(fcfg["aabb_max"]))), device="meta")
    fg.load_state_dict(w, assign=True)
    st = RenderSettings(n_coarse=8, n_fine=0, near=0.05, far=2.0)
    st_d = {"n_coarse": 8, "near": 0.05, "far": 2.0, "min_transmittance": st.min_transmittance}
    res, crop = 32, 16
    K = np.array([[0.9 * res, 0, res / 2], [0, 0.9 * res, res / 2], [0, 0, 1.0]], np.float32)
    dirs_cam = cameras.pixel_dirs(res, res, K, device="cpu")
    T_WO = torch.eye(4)
    T_WO[:3, 3] = torch.tensor([0.5, 0.0, 0.15])
    T_WC = torch.tensor([[1, 0, 0, 0.5], [0, -1, 0, 0.0], [0, 0, -1, 0.7], [0, 0, 0, 1.0]])
    poses = T_WO[None].repeat(2, 1, 1)
    poses[1, :3, 3] += torch.tensor([0.03, -0.02, 0.01])
    box = ((0.45, -0.05, 0.1), (0.55, 0.05, 0.2))
    assert combined.required_crop(box, K, res, T_WO.numpy(), T_WC[None].numpy(),
                                  poses.numpy()) <= crop
    bg = combined.BackgroundView(rgb=torch.full((res, res, 3), 0.2), alpha=torch.ones(res, res),
                                 depth=torch.full((res, res), 100.0))
    with torch.inference_mode():
        frames = combined.render_pose_cropped(fg, st, dirs_cam, K, box, crop, T_WO, T_WC, bg,
                                              combined.background_only_image(bg), poses)
        T_WC_2, _, _, dirs = combined.crop_rays(dirs_cam, K, box, crop, T_WO, T_WC, poses)
        origins = T_WC_2[:, :3, 3]
        out = render_rays(fg, origins[:, None].expand(dirs.shape), dirs, st, march_aabb=box)
        t0, t1 = march_ranges(origins, dirs, box, st)
        live = int(compact_live(t0, t1)[1][0])
    # The samples the port's render needs: a live ray's, while the
    # transmittance before them (1 - the weights so far) is at the cut or above.
    wts = out["weights"].double().reshape(-1, st.n_coarse)
    before = 1.0 - torch.cumsum(wts, -1) + wts
    needed = int(((before >= st.min_transmittance) & (t1 > t0)[:, None]).sum())

    fd = ref_hs.Field({k: v.float() for k, v in w.items()}, fcfg, REFERENCE)
    want = ref_hs.frames(fd, tuple(bg), T_WC, T_WO, poses, dirs_cam, box, st_d)
    ref_needed = ref_live = 0
    for p in poses:
        o, d = ref_hs.scoring.pose_rays(T_WO, p, T_WC, dirs_cam)
        *_, n, lv = ref_hs.march_box(fd, o, d, box, st_d, count=True)
        ref_needed, ref_live = ref_needed + n, ref_live + lv
    limit = harness.load_cell(SCORING).traffic["check"]["limits"]["frame_gap"]
    gap = compare.worst(compare.frame_gaps(frames, want))
    print(f"frame gap {gap:.2e} (limit {limit}); live {live} / {ref_live}; needed {needed} / "
          f"{ref_needed}")
    assert float(out["alpha"].max()) > 0.5 and (frames != frames[:, :1, :1]).any()
    assert gap <= limit
    assert live == ref_live > 0
    assert abs(needed - ref_needed) <= 0.01 * ref_needed
    assert ref_needed < live * st.n_coarse  # some rays pass the cut


def test_the_engine_s_field_overrides_reach_h2():
    """``reconstruction.field_spec`` with the engine's override
    ``field_type="hashgrid"`` gives the field H2 takes at the crop settings
    (the configuration's widths, as the cell runs them); the flagship field
    and the CPU keep their paths."""
    import types

    from dream2real_tpu_torch.nerf import combined, hash_march
    from dream2real_tpu_torch.nerf.hashgrid import HashGridConfig
    from dream2real_tpu_torch.nerf.model import NGPConfig, init_ngp_params
    from dream2real_tpu_torch.reconstruction import field_spec

    cfg = types.SimpleNamespace(scene_phys_bounds=((0.2, -0.4, 0.0), (1.0, 1.4, 1.2)),
                                near_distance=0.1, max_depth=4.0)
    ngp, settings = field_spec(cfg, None, {"field_type": "hashgrid"})
    crop = settings._replace(n_coarse=20, n_fine=0)
    cell = harness.load_cell(SCORING).config["field"]
    assert ngp.grid == HashGridConfig(**cell["grid"])
    assert all(getattr(ngp, k) == v for k, v in cell.items() if k not in ("grid", "aabb_min",
                                                                          "aabb_max"))
    assert hash_march.supports(ngp, crop) and not hash_march.supports(ngp, settings)
    assert not hash_march.supports(NGPConfig(), crop)
    assert not hash_march.supports(ngp._replace(hidden_dim=32), crop)
    fg = init_ngp_params(ngp, torch.Generator().manual_seed(0), device="cpu")
    assert combined.pack_crop(fg, crop, "cpu") is None  # the CPU renders through render_rays
    assert isinstance(combined.pack_crop(fg, crop, "cuda"), hash_march.HashMarchParams)


def _hash_field(grid=None, **change):
    from dream2real_tpu_torch.nerf.hashgrid import HashGridConfig
    from dream2real_tpu_torch.nerf.model import NGPConfig, init_ngp_params

    cfg = NGPConfig(field_type="hashgrid", grid=HashGridConfig(**(grid or {})), **change)
    return init_ngp_params(cfg, torch.Generator().manual_seed(0), device="cpu")


def test_h2_takes_the_8_levels_of_4_features_layout():
    """The encoding's other layout of 32 features, 8 levels of 4 (a
    template case of H2): covered, packed with its (8, T, 4) table and the
    same weight layout as 16 x 2."""
    from dream2real_tpu_torch.nerf import combined, hash_march
    from dream2real_tpu_torch.nerf.render import RenderSettings

    crop = RenderSettings(n_coarse=20, n_fine=0)
    fg = _hash_field(dict(n_levels=8, n_features=4))
    assert hash_march.supports(fg.cfg, crop)
    packed = combined.pack_crop(fg, crop, "cuda")
    assert isinstance(packed, hash_march.HashMarchParams)
    assert tuple(packed.table.shape) == (8, 1 << 19, 4) and len(packed.res) == 8
    assert packed.w.shape == (hash_march.N_W,)


@pytest.mark.parametrize("grid,change,n_fine", [
    (dict(n_levels=4), {}, 0),
    (dict(n_levels=16, n_features=4), {}, 0),
    (dict(n_levels=32, n_features=1), {}, 0),
    ({}, dict(hidden_dim=32, color_width=32), 0),
    ({}, dict(sh_degree=3), 0),
    ({}, {}, 16),
], ids=["4x2", "16x4", "32x1", "hidden32", "sh3", "fine"])
def test_a_hash_field_h2_does_not_cover_raises_on_the_card(grid, change, n_fine):
    """A hash-grid field on the card outside H2's widths or settings is
    refused with its widths, not rendered by the plain path unseen; on the
    CPU it renders through render_rays."""
    from dream2real_tpu_torch.nerf import combined, hash_march
    from dream2real_tpu_torch.nerf.render import RenderSettings

    crop = RenderSettings(n_coarse=20, n_fine=n_fine)
    fg = _hash_field(grid, **change)
    assert not hash_march.supports(fg.cfg, crop)
    with pytest.raises(ValueError, match="H2 covers hash-grid fields"):
        combined.pack_crop(fg, crop, "cuda")
    assert combined.pack_crop(fg, crop, "cpu") is None


def test_the_crop_kernel_follows_the_packed_layout():
    """render_pose_cropped dispatches on what pack_crop gave, and nothing
    else: H2's layout goes to H2 (which refuses CPU tensors), so no second
    test of the widths can pick another path."""
    from dream2real_tpu_torch.nerf import combined, hash_march
    from dream2real_tpu_torch.nerf.render import RenderSettings

    crop = RenderSettings(n_coarse=8, n_fine=0)
    fg = _hash_field(dict(n_levels=8, n_features=4))
    res = 16
    K = np.array([[0.9 * res, 0, res / 2], [0, 0.9 * res, res / 2], [0, 0, 1.0]], np.float32)
    from dream2real_tpu_torch.ops import cameras

    dirs_cam = cameras.pixel_dirs(res, res, K, device="cpu")
    T_WO = torch.eye(4)
    T_WC = torch.tensor([[1, 0, 0, 0.0], [0, -1, 0, 0.0], [0, 0, -1, 0.7], [0, 0, 0, 1.0]])
    bg = combined.BackgroundView(rgb=torch.zeros(res, res, 3), alpha=torch.ones(res, res),
                                 depth=torch.full((res, res), 100.0))
    args = (fg, crop, dirs_cam, K, ((-0.1,) * 3, (0.1,) * 3), 8, T_WO, T_WC, bg,
            combined.background_only_image(bg), T_WO[None])
    with torch.inference_mode():
        assert combined.render_pose_cropped(*args).shape == (1, res, res, 3)  # render_rays
        with pytest.raises(ValueError, match="H2 runs on CUDA tensors"):
            combined.render_pose_cropped(*args, packed=hash_march.pack(fg))


# ------------------------------------------------------------ scoring


@pytest.mark.parametrize("seed", [5, 2**31 + 9])
def test_a_slab_scores_as_the_reference_and_the_control_does_not(seed):
    ctx = _ctx(tiny_scoring_cell(), seed)
    limits = ctx.cell.traffic["check"]["limits"]
    got = hashgrid_scoring.readings(ctx, True)
    print({k: got[k] for k in limits}, {k: got["control"][k] for k in limits})
    assert not _over(got, limits)
    assert _over(got["control"], limits)


# ------------------------------------------------------------ the scene field


@pytest.mark.parametrize("seed", [5, 2**31 + 9])
def test_scene_steps_past_the_gate_match_the_reference(seed):
    ctx = _ctx(tiny_scene_cell(), seed)
    limits = ctx.cell.traffic["check"]["limits"]
    got = scene_training.readings(ctx, True)
    print({k: got[k] for k in limits}, {k: got["control"][k] for k in limits})
    assert not _over(got, limits)
    assert _over(got["control"], limits)
    ext = got["prog"]["change_norms"]
    assert ext["ext_rot"] > 0 and ext["ext_trans"] > 0  # the gate is open


# ------------------------------------------------------------ the faults


@pytest.mark.parametrize("make,driver,fault", [
    (m, d, f) for m, d in ((tiny_scoring_cell, hashgrid_scoring), (tiny_scene_cell, scene_training))
    for f in d.FAULTS])
def test_each_planted_fault_is_caught(make, driver, fault):
    ctx = _ctx(make(), 3)
    with driver.plant(fault):
        out = driver.run(ctx)
    assert not out.correct, out.compared
    assert out.failed > 0
