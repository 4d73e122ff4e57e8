"""The port's engine, its CLI and the scoring prefetch against the JAX
package's, on the CPU.

- Parity: the JAX engine runs the hermetic demo once on a small synth scan
  (narrow fields, 40 steps each, tiny CLIP; module-scoped), and both engines
  then replay its caches (dynamic masks, segs, camera poses, physics, the
  JAX-made field snapshots) with the same bridged CLIP. They must give the
  same pose_batch.txt, the same valid poses, raw scores within the slice
  test's rtol 2e-2 (tests/test_torch_slice.py), and the same goal_pose.txt.
  The CLIP seed is one whose goal / mean(norm) ratio is well conditioned on
  this scene and whose smoothed winner leads by more than twice the largest
  smoothed-score difference between the packages (printed with -s).
- Training: the port alone trains a narrow field for a few steps through
  cli/demo.py's main; the stage names and artifact set of
  tests/test_pipeline.py, result.txt, and a cache replay with the same goal
  pose.
- The prefetch against D2R_PREFETCH=0, bit for bit; the CLI's argv; the
  entry points raising without a GPU.
- Every config under configs/ builds the engine; the pcd ablation
  (configs/synth/pcd.json with narrow fields) replays the JAX engine's caches
  to the same pose_batch.txt and goal_pose.txt; a replay with vis.gui writes
  viewer.html with the JAX engine's JSON (the goal frame to 1e-5) and the
  cost-volume and multiverse PNGs.
"""

import glob
import json
import os
import re
import shutil

import jax
import numpy as np
import pytest
import torch

from dream2real_tpu.cfg import Config as JConfig
from dream2real_tpu.clip import model as jclip
from dream2real_tpu.engine import ImaginationEngine as JEngine
from dream2real_tpu_torch import reconstruction, scoring
from dream2real_tpu_torch.bridge import clip_from_jax
from dream2real_tpu_torch.cfg import Config
from dream2real_tpu_torch.cli import demo
from dream2real_tpu_torch.clip.model import CLIPConfig
from dream2real_tpu_torch.data import synth
from dream2real_tpu_torch.engine import ImaginationEngine
from dream2real_tpu_torch.experiments import run_exp

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSTR = "put the red box on the green box"
H, W, VIEWS = 96, 128, 12
CLIP_KW = dict(image_size=32, patch_size=8, vision_width=32, vision_layers=2, vision_heads=4,
               text_width=32, text_layers=2, text_heads=4, projection_dim=16)
CLIP_SEED = 34
FIELD = dict(mlp_width=48, mlp_depth=3, skip_layer=2, posenc_deg=5)
TRAIN = dict(n_steps=40, batch_rays=256, poll_steps=20, dynamic_time_extension=False)
CACHES = ("use_cache_dynamic_masks", "use_cache_segs", "use_cache_cam_poses", "use_cache_phys",
          "use_cache_vis")
PORT_LANG_CACHE = os.path.join(ROOT, "dream2real_tpu_torch", "lang", "cache.json")


@pytest.fixture(autouse=True, scope="module")
def _protect_port_lang_cache():
    """LangModel writes through to the package's cache.json; the tests'
    scripted completions must not persist there."""
    before = open(PORT_LANG_CACHE, "rb").read()
    yield
    if open(PORT_LANG_CACHE, "rb").read() != before:
        open(PORT_LANG_CACHE, "wb").write(before)


def fake_llm(prompt: str, temperature: float) -> str:
    if "extract the goal caption" in prompt:
        return ("Goal caption: a red box on top of the green box\n"
                "Normalising caption: a red box and a green box")
    if "which one object the user wants the robot to move" in prompt:
        return "1"
    if "determine whether it is a distractor" in prompt:
        return "Object 1: No\nObject 2: No\nObject 3: Yes"
    raise AssertionError(f"unexpected prompt: {prompt[:80]}")


def _write_cfg(path: str, base: str = "synth_demo.json", **engine):
    raw = json.load(open(os.path.join(ROOT, "configs", base)))
    raw["engine"].update(sample_res=[8, 8, 2, 1, 1, 1], render_res=32, clip_batch=4, **engine)
    raw["trainer"].update(n_steps=40)
    f = 0.9 * W
    raw["camera"].update(fx=f, fy=f, cx=W / 2, cy=H / 2, w=W, h=H)
    with open(path, "w") as fh:
        json.dump(raw, fh)


def _jax_clip():
    cfg = jclip.CLIPConfig(**CLIP_KW)
    return jclip.init_clip_params(jax.random.PRNGKey(CLIP_SEED), cfg), cfg


def _port_clip():
    params, _ = _jax_clip()
    return (clip_from_jax(jax.tree_util.tree_map(np.asarray, params), CLIPConfig(**CLIP_KW),
                          device="cpu"), CLIPConfig(**CLIP_KW))


def _cached(cfg):
    for flag in CACHES:
        setattr(cfg, flag, True)
    return cfg


def _outputs(d):
    return {k: np.loadtxt(os.path.join(d, f"{k}.txt"))
            for k in ("goal_pose", "pose_batch", "pose_scores")}


OV = {"field": FIELD, "train": TRAIN}


def _jax_run(base, cfg_path) -> str:
    """The JAX engine's full run on a fresh scan -> the directory of its
    caches."""
    made = str(base / "made")
    synth.write_dataset(made, n_views=VIEWS, h=H, w=W)
    eng = JEngine(JConfig(cfg_path, made), llm_backend=fake_llm, clip_loader=_jax_clip,
                  ngp_overrides=OV)
    eng.build_scene_model()
    eng.dream_best_pose(eng.interpret_user_instr(INSTR), vis_cost_vol=False)
    return made


def _replay(tag, cfg_path, made, d, vis_cost_vol=False):
    """One engine's replay of the JAX run's caches in a copy of ``made``.
    -> (engine, task model)."""
    shutil.copytree(made, d)
    if tag == "jax":
        e = JEngine(_cached(JConfig(cfg_path, d)), llm_backend=fake_llm,
                    clip_loader=_jax_clip, ngp_overrides=OV)
    else:
        e = ImaginationEngine(_cached(Config(cfg_path, d)), llm_backend=fake_llm,
                              clip_loader=_port_clip, ngp_overrides=OV, device="cpu")
    e.build_scene_model()
    task = e.interpret_user_instr(INSTR)
    e.dream_best_pose(task, vis_cost_vol=vis_cost_vol)
    return e, task


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """The JAX engine's full run, then both engines' replays of its caches."""
    base = tmp_path_factory.mktemp("engine_parity")
    cfg_path = str(base / "cfg.json")
    _write_cfg(cfg_path)
    made = _jax_run(base, cfg_path)
    out = {}
    for tag in ("jax", "torch"):
        _replay(tag, cfg_path, made, str(base / tag))
        out[tag] = _outputs(str(base / tag))
        out[tag]["raw"] = (np.asarray(scoring.LAST_RUN_INFO["raw_scores"]) if tag == "torch"
                           else None)
    from dream2real_tpu import scoring as jscoring

    out["jax"]["raw"] = np.asarray(jscoring.LAST_RUN_INFO["raw_scores"])
    out["made"], out["cfg_path"] = made, cfg_path
    return out


def test_engine_parity_pose_batch_and_valid_set(parity):
    j, t = parity["jax"], parity["torch"]
    np.testing.assert_array_equal(t["pose_batch"], j["pose_batch"])
    assert t["pose_batch"].shape == (128, 16)
    np.testing.assert_array_equal(t["raw"] != 0, j["raw"] != 0)  # the same physics-valid set
    assert 0 < int((t["raw"] != 0).sum()) < 128


def test_engine_parity_scores(parity, capsys):
    j, t = parity["jax"], parity["torch"]
    valid = j["raw"] != 0
    rel = np.abs(t["raw"][valid] / j["raw"][valid] - 1).max()
    with capsys.disabled():
        print(f"\nengine raw scores: max relative difference {rel:.3e} (allowed 2e-2)")
    np.testing.assert_allclose(t["raw"], j["raw"], rtol=2e-2, atol=0)
    np.testing.assert_allclose(t["pose_scores"], j["pose_scores"], rtol=2e-2, atol=1e-6)


def test_engine_parity_goal_pose(parity, capsys):
    j, t = parity["jax"]["pose_scores"], parity["torch"]["pose_scores"]
    win = int(np.argmax(j))
    delta = np.abs(t - j)
    # The equal argmax follows from the parity, not from a coin toss: the
    # JAX winner leads every other pose by more than the two packages'
    # differences at the two poses together.
    margin = np.delete(j[win] - j - (delta[win] + delta), win)
    with capsys.disabled():
        print(f"\nsmoothed winner's least margin over the packages' differences "
              f"{margin.min():.3e} (lead {np.sort(j)[-1] - np.sort(j)[-2]:.3e})")
    assert margin.min() > 0
    np.testing.assert_array_equal(parity["torch"]["goal_pose"], parity["jax"]["goal_pose"])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """cli/demo.py's main from a fresh scan on the port alone (module-scoped)."""
    base = tmp_path_factory.mktemp("engine_trained")
    scan, out = str(base / "scan"), str(base / "out")
    synth.write_dataset(scan, n_views=VIEWS, h=H, w=W)
    cfg_path = str(base / "cfg.json")
    _write_cfg(cfg_path)
    kw = dict(llm_backend=fake_llm, clip_loader=_port_clip,
              ngp_overrides={"field": FIELD, "train": TRAIN})
    cwd = os.getcwd()
    os.chdir(base)  # result.txt goes to the working directory
    try:
        reconstruction.TRAIN_LOG.clear()
        eng, task, goal = demo.main([scan, out, cfg_path, INSTR, "--device", "cpu"], **kw)
        fields = list(reconstruction.TRAIN_LOG)
    finally:
        os.chdir(cwd)
    return dict(base=base, scan=scan, out=out, cfg_path=cfg_path, kw=kw, eng=eng, task=task,
                goal=goal, fields=fields, result=open(base / "result.txt").read())


def test_engine_trains_the_demo(trained):
    """The stages, fields and artifacts of tests/test_pipeline.py, and
    result.txt."""
    eng, out, goal = trained["eng"], trained["out"], trained["goal"]
    assert [f["files"] for f in trained["fields"]] == [
        "transforms.json", "fg_transforms.json", "bg_transforms.json"]
    assert all(f["steps"] == TRAIN["n_steps"] for f in trained["fields"])
    for stage in ("data_load", "segmentation", "full_scene_nerf", "llm_interpret",
                  "task_phys_models", "task_nerfs", "imagine_and_score"):
        assert stage in eng.stage_timer.stages, eng.stage_timer.stages
    assert "total" in eng.stage_timer.report()
    for artifact in (
        "goal_pose.txt", "pose_batch.txt", "pose_scores.txt", "best_render.png",
        "opt_cam_poses.npy", "full_base.ingp", "fg_base.ingp", "bg_base.ingp",
        "fg_transforms.json", "bg_transforms.json", "phys_mod/mesh_concave_0.obj",
        "phys_mod/init_pose_1.txt", "cb_render/cb_rgb_0000.png",
        "images/dynamic_mask_rgb_0000.png", "XMem_masks/rgb_0000.png",
    ):
        assert os.path.exists(os.path.join(out, artifact)), artifact
    assert not os.path.exists(os.path.join(trained["scan"], "goal_pose.txt"))  # read only
    assert trained["result"] == (
        f"user_instr: {INSTR}\ngoal_caption: a red box on top of the green box\n"
        f"norm_captions: ['a red box and a green box']\ngoal_pose:\n{goal}\n")
    scores = np.loadtxt(os.path.join(out, "pose_scores.txt"))
    batch = np.loadtxt(os.path.join(out, "pose_batch.txt"))
    hit = np.flatnonzero(np.all(np.isclose(batch, goal.reshape(1, 16)), axis=1))
    assert len(hit) == 1 and scores[hit[0]] != 0
    assert trained["task"].movable_obj.mask_idx == 1 and eng.device.type == "cpu"
    for module in (eng.renderer.fg, eng.renderer.bg, eng._clip_scorer.params):
        assert {p.device.type for p in module.parameters()} == {"cpu"}


def test_engine_replays_the_caches(trained, tmp_path):
    """Every cache flag of the finished run: no field trains, the goal pose
    is scored again to the same pose (cli/demo.py and run_exp.py)."""
    cached_cfg = str(tmp_path / "cached.json")
    raw = json.load(open(trained["cfg_path"]))
    raw["engine"].update({flag: True for flag in CACHES})
    with open(cached_cfg, "w") as f:
        json.dump(raw, f)
    out = str(tmp_path / "replay")
    shutil.copytree(trained["out"], out)
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        reconstruction.TRAIN_LOG.clear()
        _, _, goal2 = demo.main([trained["scan"], out, cached_cfg, INSTR, "--device", "cpu"],
                                **trained["kw"])
        goal3 = run_exp.main([trained["scan"], out, cached_cfg, INSTR, "--device", "cpu"],
                             **trained["kw"])
    finally:
        os.chdir(cwd)
    assert reconstruction.TRAIN_LOG == []
    np.testing.assert_allclose(goal2, trained["goal"], atol=1e-5)
    np.testing.assert_array_equal(goal3, goal2)


def test_prefetch_equals_the_serial_path(trained, tmp_path, monkeypatch):
    """The physics mask and the text embeddings the prefetch thread makes
    equal the serial path's, and so do the scores, bit for bit
    (D2R_PREFETCH=0); both runs replay the trained run's fields."""
    runs = {}
    for flag in ("1", "0"):
        d = str(tmp_path / f"prefetch{flag}")
        shutil.copytree(trained["out"], d)
        monkeypatch.setenv("D2R_PREFETCH", flag)
        eng = ImaginationEngine(_cached(Config(trained["cfg_path"], d)), device="cpu",
                                **trained["kw"])
        eng.build_scene_model()
        task = eng.interpret_user_instr(INSTR)
        pf = eng._score_prefetch.result() if eng._score_prefetch else None
        assert (pf is not None) == (flag == "1")
        if pf is not None:
            assert set(pf) >= {"phys_check", "is_valid", "pose_batch", "fg_crop", "txt"}
            runs["pf"] = pf
        eng.dream_best_pose(task, vis_cost_vol=False)
        runs[flag] = dict(scoring.LAST_RUN_INFO)
    pf = runs["pf"]
    np.testing.assert_array_equal(pf["is_valid"], runs["0"]["raw_scores"] != 0)
    np.testing.assert_array_equal(runs["1"]["raw_scores"], runs["0"]["raw_scores"])
    np.testing.assert_array_equal(runs["1"]["smoothed_scores"], runs["0"]["smoothed_scores"])
    from dream2real_tpu_torch.clip.scorer import build_captions

    caps = build_captions("a red box on top of the green box", ["a red box and a green box"],
                          False)
    assert pf["captions"] == caps
    assert torch.equal(pf["txt"],
                       pf["clip_scorer"].text_embeddings(np.asarray(pf["tokenizer"](caps))))


def test_demo_cli_argv():
    args = demo.parse_args(["d", "o", "c.json", "put it there", "--goal_caption", "g",
                            "--norm_captions", "a", "b", "--device", "cpu"])
    assert (args.data_dir, args.out_dir, args.cfg_path, args.user_instr) == (
        "d", "o", "c.json", "put it there")
    assert args.goal_caption == "g" and args.norm_captions == ["a", "b"] and args.device == "cpu"
    args = demo.parse_args(["d", "o", "c.json", "x"])
    assert args.goal_caption is None and args.norm_captions is None and args.device is None


def test_demo_cli_checks_cache_flags_and_scan(tmp_path):
    cfg_path = str(tmp_path / "cfg.json")
    _write_cfg(cfg_path, use_cache_phys=True)  # cached physics without cached poses
    with pytest.raises(AssertionError, match="use_cache_phys"):
        demo.prepare(demo.parse_args([str(tmp_path / "none"), str(tmp_path / "o"), cfg_path,
                                      "x"]))
    _write_cfg(cfg_path)
    with pytest.raises(ValueError, match="data_dir does not exist"):
        demo.prepare(demo.parse_args([str(tmp_path / "none"), str(tmp_path / "o"), cfg_path,
                                      "x"]))


def test_engine_refuses_a_silent_cpu_fallback_and_unported_options(tmp_path):
    """No GPU and no device="cpu": the engine raises. The options that were
    not ported (inpainting, the point-cloud models, the viewer) now build."""
    from dream2real_tpu_torch.data.loader import D2RDataLoader

    cfg_path = str(tmp_path / "cfg.json")
    _write_cfg(cfg_path)
    cfg = Config(cfg_path, str(tmp_path))
    scan = tmp_path / "scan"
    scan.mkdir()
    (scan / "poses.txt").write_text("")
    if not torch.cuda.is_available():
        for call in (lambda: ImaginationEngine(cfg), lambda: D2RDataLoader(cfg),
                     lambda: demo.main([str(scan), str(tmp_path / "o"), cfg_path, "x"])):
            with pytest.raises(RuntimeError, match="CUDA"):
                call()
    assert ImaginationEngine(cfg, device="cpu").device.type == "cpu"
    for flag in ("inpaint_holes", "use_vis_pcds", "gui"):
        c = Config(cfg_path, str(tmp_path))
        setattr(c, flag, True)
        assert getattr(ImaginationEngine(c, device="cpu").cfg, flag)


CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "**", "*.json"), recursive=True))


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: os.path.relpath(p, ROOT))
def test_engine_builds_from_every_config(path, tmp_path):
    """Every scene config builds the engine with its options as the config
    sets them; the task fields' trainer blocks (no engine section) are
    refused with a ValueError that names them."""
    cfg = Config(path, str(tmp_path))
    if "engine" not in cfg.raw:
        assert os.path.basename(path) in ("fg_scene.json", "bg_scene.json")
        with pytest.raises(ValueError, match="no engine section"):
            ImaginationEngine(cfg, device="cpu")
        return
    eng = ImaginationEngine(cfg, device="cpu")
    assert eng.use_vis_pcds == cfg.use_vis_pcds and eng.inpaint_holes == cfg.inpaint_holes
    assert eng.cfg.gui == cfg.raw.get("vis", {}).get("gui", False)


def test_configs_cover_every_option():
    assert len(CONFIGS) == 45
    raws = [json.load(open(p)) for p in CONFIGS]
    assert sum(r.get("vis", {}).get("gui", False) for r in raws) == 39
    assert sum(r.get("engine", {}).get("use_vis_pcds", False) for r in raws) == 5


@pytest.fixture(scope="module")
def pcd_parity(tmp_path_factory):
    """configs/synth/pcd.json with narrow fields: the JAX engine's full run,
    then both engines' replays of its caches (the point clouds included)."""
    base = tmp_path_factory.mktemp("engine_pcd")
    cfg_path = str(base / "cfg.json")
    _write_cfg(cfg_path, base=os.path.join("synth", "pcd.json"))
    made = _jax_run(base, cfg_path)
    out = {}
    for tag in ("jax", "torch"):
        e, task = _replay(tag, cfg_path, made, str(base / tag))
        out[tag] = dict(_outputs(str(base / tag)), engine=e, task=task)
    return out


def test_pcd_engine_replays_to_the_jax_goal_pose(pcd_parity):
    from dream2real_tpu_torch.pcd.renderer import PointCloudRenderer
    from dream2real_tpu_torch.pcd.visual_model import PointCloud

    j, t = pcd_parity["jax"], pcd_parity["torch"]
    assert isinstance(t["engine"].renderer, PointCloudRenderer)
    assert isinstance(t["task"].movable_obj.vis_model, PointCloud)
    np.testing.assert_array_equal(t["task"].movable_obj.vis_model.points,
                                  j["task"].movable_obj.vis_model.points)
    np.testing.assert_array_equal(t["pose_batch"], j["pose_batch"])
    assert t["pose_batch"].shape == (128, 16)
    np.testing.assert_array_equal(t["pose_scores"] != 0, j["pose_scores"] != 0)
    np.testing.assert_allclose(t["pose_scores"], j["pose_scores"], rtol=2e-2, atol=1e-6)
    np.testing.assert_array_equal(t["goal_pose"], j["goal_pose"])


def _viewer_data(path):
    html = open(path).read()
    return json.loads(re.search(r"const DATA = (.*);\n", html).group(1))


def test_gui_replay_writes_the_jax_viewer(parity, tmp_path):
    """A replay of the parity run's caches with vis.gui: viewer.html holds
    the JAX engine's layers (the goal frame to 1e-5), and both PNGs decode."""
    from dream2real_tpu_torch.utils.png import read_png

    raw = json.load(open(parity["cfg_path"]))
    raw["vis"]["gui"] = True
    cfg_path = str(tmp_path / "gui.json")
    with open(cfg_path, "w") as f:
        json.dump(raw, f)
    data = {}
    for tag in ("jax", "torch"):
        d = str(tmp_path / tag)
        e, _ = _replay(tag, cfg_path, parity["made"], d, vis_cost_vol=True)
        data[tag] = _viewer_data(os.path.join(d, "viewer.html"))
        assert "artifacts" in e.stage_timer.stages
        if tag == "torch":
            for png_name in ("cost_volume.png", "multiverse.png"):
                img = read_png(os.path.join(d, png_name))
                assert img.ndim == 3 and img.shape[2] == 3 and (img != 255).any()
    j, t = data["jax"], data["torch"]
    assert t["title"] == j["title"]
    assert [L["name"] for L in t["layers"]] == [L["name"] for L in j["layers"]]
    assert any(L["kind"] == "mesh" for L in t["layers"])
    for a, b in zip(t["layers"], j["layers"]):
        if a["name"] == "goal":
            np.testing.assert_allclose(a["T"], b["T"], atol=1e-5)
        else:
            assert a == b, a["name"]
