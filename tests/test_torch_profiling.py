"""The port's span and counter recorder (``utils/profiling.py``) and the
spans the scorer and the trainer record.

- With no profiler running a span is the shared object that does nothing,
  and nothing is logged.
- Under a CPU torch.profiler: nesting, parent and request ids, a thread's
  own stack, counters, the log's bound and its dropped count, and each
  span's start beside its own ``record_function`` event on the profiler's
  timeline.
- ``scoring._fused_score`` at tiny sizes: one block, its background render,
  its slabs and drain, one ``score.render`` and one ``score.tower`` a clip
  group, ``score.poses`` and ``score.groups``.
- ``make_train_chunk``'s chunk: ``poll_steps`` steps, each with its phases.
- On a card (marked ``cuda``): a kernel launched inside a device span that
  closes after a synchronise has its launch call and its device operation
  inside the span's interval on the profiler's timeline.
- ``tools/span_report.py``'s account of a block's idle gaps: each gap named
  by the operations that bound it, its size, and the launches a group.
"""

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dream2real_tpu_torch import scoring
from dream2real_tpu_torch.clip.model import CLIPConfig, init_clip_params
from dream2real_tpu_torch.clip.scorer import ClipScorer
from dream2real_tpu_torch.nerf import trainer
from dream2real_tpu_torch.nerf.combined import CombinedRenderer
from dream2real_tpu_torch.nerf.model import NGPConfig, init_ngp_params
from dream2real_tpu_torch.nerf.render import RenderSettings
from dream2real_tpu_torch.ops import cameras
from dream2real_tpu_torch.parallel import mesh as tmesh
from dream2real_tpu_torch.utils import profiling

TINY_FIELD = dict(mlp_width=32, mlp_depth=3, skip_layer=2, posenc_deg=4, geo_feat_dim=7,
                  aabb_min=(0.0, -0.6, -0.1), aabb_max=(1.1, 0.6, 0.9))


@pytest.fixture(autouse=True)
def _fresh_log():
    profiling.reset()
    yield
    profiling.reset()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _by_name(spans):
    out: dict = {}
    for s in spans:
        out.setdefault(s["name"], []).append(s)
    return out


# ------------------------------------------------------------------ recorder
def test_nothing_records_without_a_profiler():
    a, b = profiling.span("a"), profiling.span("b", device=True)
    assert a is b
    with a:
        profiling.count("n", 5)
    assert profiling.spans() == [] and profiling.counters() == {}


def test_spans_nest_with_parents_requests_and_counters():
    with _cpu_profile():
        with profiling.span("outer"):
            with profiling.span("mid"):
                with profiling.span("inner"):
                    profiling.count("n")
                profiling.count("n", 2)
            with profiling.span("sibling"):
                pass
        with profiling.span("next", device=True):
            pass
    outer, mid, inner, sibling, nxt = profiling.spans()
    assert [s["name"] for s in (outer, mid, inner, sibling, nxt)] == \
        ["outer", "mid", "inner", "sibling", "next"]
    assert outer["parent"] is None and outer["request"] == outer["id"]
    assert mid["parent"] == outer["id"] and inner["parent"] == mid["id"]
    assert sibling["parent"] == outer["id"]
    assert {s["request"] for s in (mid, inner, sibling)} == {outer["id"]}
    assert nxt["parent"] is None and nxt["request"] == nxt["id"] != outer["id"]
    for s in (outer, mid, inner, sibling, nxt):
        assert s["start_ns"] <= s["end_ns"] and s["device_ms"] is None
    assert outer["start_ns"] <= mid["start_ns"] <= inner["start_ns"] <= inner["end_ns"] \
        <= mid["end_ns"] <= sibling["start_ns"] <= sibling["end_ns"] <= outer["end_ns"]
    assert profiling.counters() == {"n": 3}


def test_each_thread_keeps_its_own_stack():
    done = threading.Event()

    def worker():
        with profiling.span("thread.outer"):
            with profiling.span("thread.inner"):
                pass
        done.set()

    with _cpu_profile():
        with profiling.span("main"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
    assert done.is_set() and not t.is_alive()
    s = _by_name(profiling.spans())
    main, t_outer, t_inner = s["main"][0], s["thread.outer"][0], s["thread.inner"][0]
    assert t_outer["parent"] is None and t_outer["request"] == t_outer["id"]
    assert t_inner["parent"] == t_outer["id"] and t_inner["request"] == t_outer["id"]
    assert main["parent"] is None


def test_the_log_is_bounded_and_counts_what_it_drops():
    rec = profiling.Recorder(max_spans=3)
    with _cpu_profile():
        with rec.span("kept.0"):
            for i in range(4):
                with rec.span(f"child.{i}"):
                    pass
    names = [s["name"] for s in rec.spans()]
    assert names == ["kept.0", "child.0", "child.1"] and rec.dropped == 2
    assert rec.span("off") is profiling.span("off")  # no profiler: the idle span
    rec.reset()
    assert rec.spans() == [] and rec.dropped == 0


def test_a_span_starts_beside_its_record_function_event():
    """The spans' clock is the profiler's: each span's start lies within 1 ms
    of the start of the ``record_function`` range it opens."""
    with _cpu_profile():
        with torch.profiler.record_function("warm"):  # a process's first range resolves its op
            pass
    profiling.reset()
    names = [f"s.{i}" for i in range(20)]
    with _cpu_profile() as prof:
        for name in names:
            with profiling.span(name):
                torch.ones(8).sum()
    events = {e.name(): e for e in prof.profiler.kineto_results.events() if e.name() in names}
    spans = profiling.spans()
    assert sorted(events) == sorted(names) and len(spans) == len(names)
    for s in spans:
        ev = events[s["name"]]
        assert abs(ev.start_ns() - s["start_ns"]) < 1_000_000, (s, ev.start_ns())
        assert ev.start_ns() <= s["end_ns"] <= ev.start_ns() + ev.duration_ns() + 1_000_000


def test_a_stage_is_a_span():
    timer = profiling.StageTimer()
    with _cpu_profile():
        with timer.stage("imagine_and_score"):
            with profiling.span("score.block"):
                pass
    stage, block = profiling.spans()
    assert stage["name"] == "imagine_and_score" and block["parent"] == stage["id"]
    assert timer.stages["imagine_and_score"] >= 0


# ------------------------------------------------------------------- scoring
class _TaskCaptions:
    goal_caption = "a red box on the green box"
    norm_captions = ["a red box and a green box"]


def _tok(texts, ctx=16):
    ids = np.zeros((len(texts), ctx), np.int32)
    for r, t in enumerate(texts):
        toks = [1] + [2 + sum(map(ord, w)) % 124 for w in t.split()][: ctx - 2] + [127]
        ids[r, : len(toks)] = toks
    return ids


@pytest.mark.parametrize("n_poses,batch,slab", [(16, 4, 8), (10, 4, 4)],
                         ids=["two_slabs", "padded"])
def test_fused_score_records_a_block(n_poses, batch, slab, monkeypatch):
    monkeypatch.setenv("D2R_SCORE_SLAB", str(slab))
    monkeypatch.setattr(tmesh, "auto_mesh", lambda: None)
    res = 32
    gen = torch.Generator().manual_seed(0)
    field = init_ngp_params(NGPConfig(**TINY_FIELD), gen, device="cpu")
    f = 0.9 * res
    K = np.array([[f, 0, res / 2], [0, f, res / 2], [0, 0, 1.0]])
    renderer = CombinedRenderer(field, field, settings=RenderSettings(n_coarse=4, n_fine=4,
                                                                      near=0.05, far=2.0),
                                res=res, intrinsics=K, row_chunk=16,
                                obj_aabb=((0.35, -0.1, 0.0), (0.65, 0.1, 0.15)), fg_crop=16,
                                device="cpu")
    clip_cfg = CLIPConfig(eot_id=127, image_size=res, patch_size=16, vision_width=32,
                          vision_layers=1, vision_heads=4, vocab_size=128, context_length=16,
                          text_width=32, text_layers=1, text_heads=4, projection_dim=16)
    scorer = ClipScorer(init_clip_params(clip_cfg, gen, device="cpu"), batch_size=batch)
    T_WO_1 = np.eye(4, dtype=np.float32)
    T_WO_1[:3, 3] = [0.5, 0.0, 0.05]
    cam = np.array([[1, 0, 0, 0.5], [0, -1, 0, 0.0], [0, 0, -1, 0.7], [0, 0, 0, 1]], np.float32)
    poses = np.tile(T_WO_1[None], (n_poses, 1, 1))
    poses[:, 0, 3] += np.linspace(-0.08, 0.12, n_poses)

    def run():
        return scoring._fused_score(renderer, scorer, _tok, _TaskCaptions(), poses, cam[None],
                                    None, None, T_WO_1, use_templates=False)

    untraced = run()
    with _cpu_profile():
        traced = run()
    np.testing.assert_array_equal(traced, untraced)
    groups = -(-n_poses // batch)
    s = _by_name(profiling.spans())
    assert sorted(s) == ["score.bg_render", "score.block", "score.drain", "score.render",
                         "score.slab", "score.tower"]
    (block,) = s["score.block"]
    assert block["parent"] is None and block["request"] == block["id"]
    assert all(x["request"] == block["id"] for v in s.values() for x in v)
    assert s["score.bg_render"][0]["parent"] == block["id"]
    assert s["score.drain"][0]["parent"] == block["id"]
    assert len(s["score.slab"]) == scoring.LAST_RUN_INFO["n_slabs"] == -(-n_poses // slab)
    slab_ids = {x["id"] for x in s["score.slab"]}
    assert {x["parent"] for x in s["score.slab"]} == {block["id"]}
    for name in ("score.render", "score.tower"):
        assert len(s[name]) == groups
        assert {x["parent"] for x in s[name]} == slab_ids
    for render, tower in zip(s["score.render"], s["score.tower"]):
        assert render["end_ns"] <= tower["start_ns"]
    # Every LayerNorm of the towers runs plain on the CPU: a clip group's
    # ln_pre, its one block's LN1 and LN2 and ln_post; the captions' text
    # block's LN1 and LN2 and ln_final.
    assert profiling.counters() == {"score.poses": n_poses, "score.groups": groups,
                                    "clip.ln_plain": 4 * groups + 3}


# ------------------------------------------------------------------ training
@pytest.mark.parametrize("sharded", [False, True], ids=["one_device", "sharded"])
def test_train_chunk_records_its_steps(sharded, monkeypatch):
    monkeypatch.setenv("D2R_PALLAS_TRAIN", "0")
    h = w = 16
    f = 0.9 * w
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]])
    images = torch.as_tensor(np.random.default_rng(0).integers(0, 255, (2, h, w, 4),
                                                                dtype=np.uint8))
    poses = torch.eye(4).repeat(2, 1, 1)
    cfg = NGPConfig(**TINY_FIELD)
    tc = trainer.TrainConfig(n_steps=3, batch_rays=32, poll_steps=3)
    sharding = tmesh.pose_sharding(tmesh.data_mesh(devices=["cpu"] * 2)) if sharded else None
    chunk = trainer.make_train_chunk(cfg, tc, RenderSettings(n_coarse=4, n_fine=4, near=0.05,
                                                             far=2.0),
                                     images, poses, cameras.pixel_dirs(h, w, K, device="cpu"),
                                     depths=torch.full((2, h, w), 0.5), ray_sharding=sharding)
    state = trainer.init_train_state(cfg, tc, 2, device="cpu")
    with _cpu_profile():
        state, loss = chunk(state)
    assert np.isfinite(loss) and state["step"] == 3
    spans = profiling.spans()
    s = _by_name(spans)
    (ck,) = s["train.chunk"]
    assert len(s["train.step"]) == 3 and len(s["train.fetch"]) == 1
    assert {x["parent"] for x in s["train.step"] + s["train.fetch"]} == {ck["id"]}
    assert all(x["request"] == ck["id"] for x in spans)
    phases = ["train.sample", "train.backward", "train.optim"] if sharded else \
        ["train.sample", "train.forward", "train.backward", "train.optim"]
    for step in s["train.step"]:
        children = [x for x in spans if x["parent"] == step["id"]]
        assert [x["name"] for x in children] == phases
        assert all(step["start_ns"] <= x["start_ns"] <= x["end_ns"] <= step["end_ns"]
                   for x in children)
    assert s["train.fetch"][0]["start_ns"] >= s["train.step"][-1]["end_ns"]
    assert profiling.counters() == {"train.steps": 3}


def test_cpu_chunk_of_the_fused_path_replays_no_graph(monkeypatch):
    """The fused kernels' path (their plain versions on the CPU) takes the
    eager step there: its phases under each step, no ``train.replay`` and
    no ``train.graph_steps``."""
    monkeypatch.setenv("D2R_PALLAS_TRAIN", "1")
    h = w = 16
    K = np.array([[14.4, 0, w / 2], [0, 14.4, h / 2], [0, 0, 1.0]])
    images = torch.as_tensor(np.random.default_rng(1).integers(0, 255, (2, h, w, 4),
                                                                dtype=np.uint8))
    cfg = NGPConfig(aabb_min=TINY_FIELD["aabb_min"], aabb_max=TINY_FIELD["aabb_max"])
    assert trainer.use_train_kernel(cfg)
    tc = trainer.TrainConfig(n_steps=2, batch_rays=16, poll_steps=2)
    chunk = trainer.make_train_chunk(cfg, tc, RenderSettings(n_coarse=4, n_fine=4, near=0.05,
                                                             far=2.0),
                                     images, torch.eye(4).repeat(2, 1, 1),
                                     cameras.pixel_dirs(h, w, K, device="cpu"))
    state = trainer.init_train_state(cfg, tc, 2, device="cpu")
    with _cpu_profile():
        state, loss = chunk(state)
    assert np.isfinite(loss) and state["step"] == 2
    spans = profiling.spans()
    s = _by_name(spans)
    assert "train.replay" not in s and len(s["train.step"]) == 2
    for step in s["train.step"]:
        assert [x["name"] for x in spans if x["parent"] == step["id"]] == \
            ["train.sample", "train.forward", "train.backward", "train.optim"]
    assert profiling.counters() == {"train.steps": 2}


# ---------------------------------------------------------------------- card
@pytest.mark.cuda
def test_card_launch_and_kernel_fall_inside_their_span():
    """Under a CUDA-only profiler (the benchmark's traced window) the span's
    clock is the profiler's for host calls and device operations alike."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the clock of device operations")
    x = torch.randn(4096, 4096, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with profiling.span("card", device=True):
            y = x * 2.0 + 1.0
            torch.cuda.synchronize()
    (s,) = profiling.spans()
    assert s["device_ms"] is not None and s["device_ms"] > 0
    launches, kernels = [], []
    for ev in prof.profiler.kineto_results.events():
        kind = str(getattr(ev, "activity_type", lambda: "")()).lower()
        if "annotation" in kind or getattr(ev, "is_user_annotation", lambda: False)():
            continue
        if "LaunchKernel" in ev.name():
            launches.append(ev)
        elif "CUDA" in str(ev.device_type()):
            kernels.append(ev)
    assert launches and kernels, [e.name() for e in prof.profiler.kineto_results.events()]
    for ev in launches + kernels:
        assert s["start_ns"] <= ev.start_ns() <= ev.start_ns() + ev.duration_ns() \
            <= s["end_ns"], (ev.name(), ev.start_ns(), s)
    assert torch.equal(y[:2, :2], x[:2, :2] * 2.0 + 1.0)


def test_span_report_names_each_gap_by_the_operations_around_it():
    """Overlapping operations leave no gap; a gap is named after the
    operation that ended last before it, not the one that started last;
    operations outside the interval are not counted; sizes and per-group
    counts add up."""
    from benchmark.profile import Trace
    from tools.span_report import gap_pairs

    us = 1e-6
    ops = [("void (anonymous namespace)::gemm_tma<1, 256>(args)", 0.0, 100 * us),
           ("ln_rows(x)", 10 * us, 20 * us),         # inside the GEMM: no gap
           ("attn_fwd<0>", 101 * us, 50 * us),       # 1 us after the GEMM
           ("void (anonymous namespace)::hash_march<2, true>(float const*)", 156 * us,
            30 * us),                                # 5 us after attn_fwd
           ("gemm_tma<1, 256>(args)", 386 * us, 10 * us),  # 200 us after H2
           ("late", 900 * us, 1 * us)]               # outside the interval
    host = [("cudaLaunchKernel", 0.0, 2 * us), ("cudaLaunchKernel", 50 * us, 80 * us),
            ("cudaMemcpyAsync", 60 * us, 1 * us)]
    got = gap_pairs(Trace(ops=ops, host=host, window_s=1e-3, t0_s=0.0), 0.0, 500 * us, 2)
    assert got["ops_per_group"] == 2.5 and got["gaps_per_group"] == 1.5
    assert got["launch_calls_per_group"] == 1.0
    assert got["launch_calls_over_50us_per_group"] == 0.5
    assert got["launch_call_ms_per_group"] == pytest.approx(0.041)
    pairs = {p["pair"]: p for p in got["by_pair"]}
    assert list(pairs) == ["hash_march -> gemm_tma", "attn_fwd -> hash_march",
                           "gemm_tma -> attn_fwd"]
    assert pairs["gemm_tma -> attn_fwd"]["ms"] == pytest.approx(1e-3)
    assert pairs["hash_march -> gemm_tma"]["per_group"] == 0.5
    sizes = {k: v["per_group"] for k, v in got["gap_sizes"].items()}
    assert sizes == {"<2us": 0.5, "2-10us": 0.5, "10-100us": 0.0, ">=100us": 0.5}
