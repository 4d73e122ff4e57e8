"""The engine's inputs in the port against the JAX package, PIL and OpenCV,
on the CPU: the PNG codec, the synth scan writer, the loader's dynamic
masks, the frame association, the LLM orchestration, the segmentation and
captioning functions and the OpenCV counterparts they use
(perception/imgproc.py).

Exact where the reference is exact. Where OpenCV rounds a value that lies on
a threshold, each difference is shown a tie: a min-area-rect corner within
1e-4 px of an integer (OpenCV's f32 calipers put 54.99999 where the exact
value is 55, and the int64 cast truncates), two rectangles of equal area, or
a blurred value within 2e-3 of one half (OpenCV's fixed-point blur).
"""

import filecmp
import io
import os
import sys

import cv2
import jax
import numpy as np
import pytest
import torch
from PIL import Image

from dream2real_tpu.data import associate as jassoc
from dream2real_tpu.data import synth as jsynth
from dream2real_tpu.data.loader import D2RDataLoader as JLoader
from dream2real_tpu.cfg import Config as JConfig
from dream2real_tpu.lang import llm as jllm
from dream2real_tpu.ops import cameras as jcam
from dream2real_tpu.perception import captioner as jcap
from dream2real_tpu.perception import segmentation as jseg
from dream2real_tpu_torch.cfg import Config
from dream2real_tpu_torch.data import associate as tassoc
from dream2real_tpu_torch.data import synth as tsynth
from dream2real_tpu_torch.data.loader import D2RDataLoader
from dream2real_tpu_torch.lang import llm as tllm
from dream2real_tpu_torch.ops import cameras as tcam
from dream2real_tpu_torch.perception import captioner as tcap
from dream2real_tpu_torch.perception import imgproc
from dream2real_tpu_torch.perception import segmentation as tseg
from dream2real_tpu_torch.utils import png

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNER_TIE = 1e-4
AREA_TIE = 1e-6
BLUR_TIE = 2e-3


# ----------------------------------------------------------------- codec


def _pil_bytes(arr) -> bytes:
    b = io.BytesIO()
    Image.fromarray(arr).save(b, format="PNG")
    return b.getvalue()


def _images(rng, h=23, w=37):
    ys, xs = np.mgrid[0:h, 0:w]
    smooth = ((np.sin(xs / 5.0) + np.cos(ys / 4.0)) * 60 + 128).astype(np.uint8)
    noise = rng.integers(0, 256, (h, w), dtype=np.uint8)
    return {
        "L": smooth,
        "LA": np.stack([smooth, noise], -1),
        "RGB": np.stack([smooth, smooth[::-1], noise], -1),
        "RGBA": np.stack([smooth, noise, smooth[::-1, ::-1], noise], -1),
        "I;16": (smooth.astype(np.uint16) * 251 + noise).astype(np.uint16),
    }


def test_png_decodes_what_pil_writes(rng):
    """PIL's own files (it picks a filter per row), every format."""
    seen_filters = set()
    for mode, arr in _images(rng, 60, 90).items():
        blob = _pil_bytes(arr)
        assert Image.open(io.BytesIO(blob)).mode == mode
        _, rows = png._parse(blob, mode)
        seen_filters |= set(rows[:, 0].tolist())
        got = png.decode_pngs([blob])[0]
        want = np.asarray(Image.open(io.BytesIO(blob)))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert seen_filters >= {1, 2, 4}


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
def test_png_every_filter_type_both_ways(rng, filter_type, tmp_path):
    """Files with every row in one filter type: PIL reads the port's, the
    port reads them back, and PIL re-saves read equal."""
    for mode, arr in _images(rng).items():
        if mode == "LA":
            continue  # the encoder writes grey, RGB, RGBA and 16-bit grey
        blob = png.encode_png(arr, filter_type)
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(blob))), arr)
        np.testing.assert_array_equal(png.decode_pngs([blob])[0], arr)
        path = str(tmp_path / f"{mode.replace(';', '')}_{filter_type}.png")
        png.write_png(path, arr, filter_type)
        np.testing.assert_array_equal(png.read_png(path), arr)


def test_png_batches_and_rgb(rng, tmp_path):
    arrs = [np.asarray(_images(np.random.default_rng(i))["RGB"]) for i in range(5)]
    paths = []
    for i, a in enumerate(arrs):
        paths.append(str(tmp_path / f"{i}.png"))
        Image.fromarray(a).save(paths[-1])
    np.testing.assert_array_equal(png.read_pngs(paths, group=2), np.stack(arrs))
    for mode, arr in _images(rng).items():
        if arr.dtype == np.uint8:
            want = np.asarray(Image.open(io.BytesIO(_pil_bytes(arr))).convert("RGB"))
            np.testing.assert_array_equal(png.to_rgb(arr), want)
    with pytest.raises(ValueError, match="differs"):
        png.decode_pngs([_pil_bytes(arrs[0]), _pil_bytes(arrs[0][:5])])
    with pytest.raises(NotImplementedError):
        png.decode_pngs([_pil_bytes(np.zeros((4, 4), bool))])  # 1-bit


# ---------------------------------------------------- cameras and synth


def test_camera_helpers(rng):
    K = np.array([[288.0, 0, 160.0], [0, 290.0, 90.0], [0, 0, 1.0]])
    np.testing.assert_array_equal(tcam.clip_view_intrinsics_like(K, (180, 320), 336),
                                  jcam.clip_view_intrinsics_like(K, (180, 320), 336))
    T = jsynth.orbit_poses((0.5, 0, 0.05), 4)[1].astype(np.float32)
    for row, col, d in ((10.0, 20.0, 0.7), (100.0, 3.0, 1.3)):
        got = tcam.pix_to_world(row, col, 180, d, T, K).numpy()
        want = np.asarray(jcam.pix_to_world(row, col, 180, d, jax.numpy.asarray(T),
                                            jax.numpy.asarray(K, jax.numpy.float32)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("variant", ["pinhole", "distort", "noise", "rect"])
def test_write_dataset_matches_reference(variant, tmp_path):
    kw = {"distort": dict(distortion=jsynth.DEFAULT_DISTORTION),
          "noise": dict(noise=jsynth.DEFAULT_NOISE)}.get(variant, {})
    a, b = str(tmp_path / "jax"), str(tmp_path / "torch")
    jsynth.write_dataset(a, n_views=3, h=36, w=64,
                         **dict(kw, **({"scene": jsynth.rect_scene()} if variant == "rect" else {})))
    meta = tsynth.write_dataset(b, n_views=3, h=36, w=64,
                                **dict(kw, **({"scene": tsynth.rect_scene()}
                                              if variant == "rect" else {})))
    assert meta["n_objects"] == 3
    for sub, prefix in (("images", "rgb"), ("depth", "depth"), ("masks", "mask")):
        for i in range(3):
            want = np.asarray(Image.open(f"{a}/{sub}/{prefix}_{i:04d}.png"))
            got = png.read_png(f"{b}/{sub}/{prefix}_{i:04d}.png")
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    files = ["poses.txt", "transforms.json", "synth_meta.json", "captions.json"]
    files += ["poses_true.txt"] if variant == "noise" else []
    for f in files:
        assert filecmp.cmp(f"{a}/{f}", f"{b}/{f}", shallow=False), f
    assert tsynth.DEFAULT_NOISE == jsynth.DEFAULT_NOISE
    assert tsynth.DEFAULT_DISTORTION == jsynth.DEFAULT_DISTORTION


# ----------------------------------------------------------------- loader


def _face_ties(depths, T_WC, K, bounds, tol=1e-5):
    """Pixels whose f64 back-projection lies within tol of a bounds face."""
    h, w = depths.shape[1:]
    us = (np.arange(w) - K[0, 2]) / K[0, 0]
    vs = (np.arange(h) - K[1, 2]) / K[1, 1]
    cam = np.stack([depths * us[None, None], depths * vs[None, :, None], depths], -1)
    pts = np.einsum("nij,nhwj->nhwi", T_WC[:, :3, :3].astype(np.float64), cam)
    pts = pts + T_WC[:, None, None, :3, 3]
    lo, hi = np.asarray(bounds[0]), np.asarray(bounds[1])
    near = (np.abs(pts - lo) < tol) | (np.abs(pts - hi) < tol)
    return near.any(-1) | (np.abs(pts[..., 2] + 0.40) < tol)


@pytest.mark.parametrize("distort", [False, True])
def test_loader_and_dynamic_masks_match_reference(distort, tmp_path):
    d = str(tmp_path / "scan")
    jsynth.write_dataset(d, n_views=4, h=180, w=320, noise=jsynth.DEFAULT_NOISE,
                         distortion=jsynth.DEFAULT_DISTORTION if distort else None)
    cfg_path = os.path.join(ROOT, "configs", "synth_demo.json")
    jl, tl = JLoader(JConfig(cfg_path, d)), D2RDataLoader(Config(cfg_path, d), device="cpu")
    for got, want in zip(tl.load_rgbds(), jl.load_rgbds()):
        assert got.dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got, np.asarray(want))
    K = np.array([[288.0, 0, 160.0], [0, 288.0, 90.0], [0, 0, 1.0]])
    bounds = [[0.2, -0.35, 0.0], [0.85, 0.35, 0.35]]
    dist = jsynth.DEFAULT_DISTORTION if distort else None
    want = np.asarray(jl.remove_background(K, bounds, distortion=dist))
    got = tl.remove_background(K, bounds, distortion=dist)
    assert got.dtype == np.uint8 and 0 < (got == 255).mean() < 1
    differ = got != want
    if differ.any():  # each difference within the closing's reach of a tie
        b = np.asarray(bounds, np.float64).copy()
        b[0][2] = -100.0
        ties = _face_ties(tl.depth_data, tl.T_WC_data, K, b)
        reach = imgproc.dilate(ties.astype(np.uint8), 101).astype(bool)
        assert not (differ & ~reach).any()
    # The cache: written through the codec, read back equal, also by PIL.
    np.testing.assert_array_equal(tl.remove_background(K, bounds, use_cache=True), got)
    np.testing.assert_array_equal(
        np.asarray(Image.open(os.path.join(d, "images", "dynamic_mask_rgb_0001.png"))), got[1])


def test_associate_matches_reference(tmp_path):
    d = tmp_path
    (d / "rgb_timestamps.txt").write_text("# rgb\n1.0 a\n2.5 b\n4.0 c\n")
    (d / "seg_timestamps.txt").write_text("0.5\n1.2\n1.9\n2.6\n3.9\n5.0\n")
    assert tassoc.associate(str(d)) == jassoc.associate(str(d)) == [1, 3, 4]
    (d / "associate_index.txt").write_text("3\n7\n11\n")
    assert tassoc.associate(str(d)) == jassoc.associate(str(d)) == [3, 7, 11]
    assert tassoc.read_file_list(str(d / "rgb_timestamps.txt")) == jassoc.read_file_list(
        str(d / "rgb_timestamps.txt"))


# -------------------------------------------------------------------- LLM


def test_lang_files_are_the_reference_copies():
    for name in ("prompts.json", "cache.json"):
        assert filecmp.cmp(os.path.join(ROOT, "dream2real_tpu", "lang", name),
                           os.path.join(ROOT, "dream2real_tpu_torch", "lang", name),
                           shallow=False), name


def _scripted(prompt, temperature):
    if "extract the goal caption" in prompt:
        return "Goal caption: a mug in the bowl\nNormalising caption: a mug and a bowl"
    if "which one object" in prompt:
        return "The answer is 2."
    if "distractor" in prompt:
        return "Object 1: No\nObject 2: Yes\nObject 3: No"
    if "aggregate" in prompt:
        return "a white mug"
    return "Mug."


def test_lang_model_matches_reference(tmp_path):
    caps = ["__background__", "a cup", "a mug", "a bowl"]
    outs = {}
    for tag, mod in (("jax", jllm), ("torch", tllm)):
        path = str(tmp_path / f"{tag}.json")
        lm = mod.LangModel(read_cache=True, cache_path=path, backend=_scripted)
        outs[tag] = (
            lm.parse_instr("put the mug in the bowl"),
            lm.get_movable_obj_idx("put the mug in the bowl", caps),
            lm.get_relevant_obj_idxs("a mug in the bowl", caps, 2),
            lm.aggregate_captions_for_obj(["a mug", "a white cup"]),
            lm.get_principal_noun("a white mug"),
        )
        # A second model replays the cache with no backend.
        again = mod.LangModel(read_cache=True, cache_path=path, backend=None)
        assert again.parse_instr("put the mug in the bowl") == outs[tag][0]
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][1] == 2 and outs["torch"][2] == [2, 3]
    assert filecmp.cmp(str(tmp_path / "jax.json"), str(tmp_path / "torch.json"), shallow=False)
    # "None" as the last line: every object is relevant.
    lm = tllm.LangModel(cache_path="", backend=lambda p, t: "Object 1: No\nNone")
    assert lm.get_relevant_obj_idxs("x", caps, 1) == [1, 2, 3]
    # A miss with neither cache nor backend raises (no openai package here
    # or on the card), and so does a prompt that is too long.
    lm = tllm.LangModel(read_cache=True, cache_path=str(tmp_path / "none.json"), backend=None)
    with pytest.raises(RuntimeError, match="no backend"):
        lm.parse_instr("something new")
    with pytest.raises(Exception, match="too long"):
        tllm.LangModel(backend=_scripted).submit_prompt("x" * 5001)


def test_lang_model_replays_the_packaged_cache():
    """The hermetic demo's prompts hit the port's cache copy, no backend."""
    lm = tllm.LangModel(read_cache=True, backend=None,
                        cache_path=os.path.join(ROOT, "dream2real_tpu_torch", "lang",
                                                "cache.json"))
    caps = ["__background__", "a red box", "a green box", "a blue box"]
    goal, norm = lm.parse_instr("put the red box on the green box")
    assert (goal, norm) == ("a red box on top of the green box", "a red box and a green box")
    assert lm.get_movable_obj_idx("put the red box on the green box", caps) == 1
    assert lm.get_relevant_obj_idxs(goal, caps, 1) == [1, 2]


# ---------------------------------------------------- OpenCV counterparts


def _masks(rng, n, h=60, w=80):
    out = []
    for _ in range(n):
        m = np.zeros((h, w), bool)
        yy, xx = np.mgrid[0:h, 0:w]
        for _ in range(rng.integers(1, 4)):
            cy, cx = rng.integers(5, h - 5), rng.integers(5, w - 5)
            ry, rx, th = rng.integers(2, 20), rng.integers(2, 20), rng.uniform(0, np.pi)
            y = (yy - cy) * np.cos(th) + (xx - cx) * np.sin(th)
            x = -(yy - cy) * np.sin(th) + (xx - cx) * np.cos(th)
            m |= (y / ry) ** 2 + (x / rx) ** 2 <= 1
        if rng.random() < 0.3:
            m[rng.integers(0, h):, rng.integers(0, w):] = False
        if rng.random() < 0.2:
            m = rng.random((h, w)) < 0.3
        out.append(m)
    return out


def test_connected_components_match_cv2(rng):
    for shape in [(1, 1), (3, 40), (37, 29)] + [(200, 300)] * 3:
        for p in (0.0, 0.1, 0.5, 1.0):
            m = (rng.random(shape) < p).astype(np.uint8)
            n, lab = cv2.connectedComponents(m)
            n2, lab2 = imgproc.connected_components(m)
            assert n2 == n
            np.testing.assert_array_equal(lab2, lab)


def test_external_contours_match_cv2(rng):
    for m in _masks(rng, 60):
        want, _ = cv2.findContours(m.astype(np.uint8) * 255, cv2.RETR_EXTERNAL,
                                   cv2.CHAIN_APPROX_NONE)
        got = imgproc.external_contours(m.astype(np.uint8) * 255)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    ring = np.zeros((20, 20), np.uint8)
    ring[2:18, 2:18] = 1
    ring[5:15, 5:15] = 0
    ring[8:11, 8:11] = 1  # inside the hole: not external
    assert len(imgproc.external_contours(ring)) == 1


def _rect_tie(mask) -> bool:
    """OpenCV's and the port's min-area rectangles of the mask's longest
    contour differ only at a tie: equal areas, or a corner of OpenCV's box
    within CORNER_TIE of an integer."""
    c, _ = cv2.findContours(mask.astype(np.uint8) * 255, cv2.RETR_EXTERNAL,
                            cv2.CHAIN_APPROX_NONE)
    mc = max(c, key=len)
    r, g = cv2.minAreaRect(mc), imgproc.min_area_rect(mc)
    box = cv2.boxPoints(r).astype(np.float64)
    corner = np.abs(box - np.round(box)).min() < CORNER_TIE
    area_r, area_g = r[1][0] * r[1][1], g[1][0] * g[1][1]
    return corner or abs(area_r - area_g) <= AREA_TIE * max(area_r, 1.0)


def test_min_area_rect_and_sides_match_reference(rng, capsys):
    same, ties = 0, 0
    masks = _masks(rng, 150)
    for r0, c0, hh, ww in rng.integers(1, 25, (40, 4)):
        m = np.zeros((60, 70), bool)
        m[r0 : r0 + hh, c0 : c0 + ww] = True
        masks.append(m)
    for m in masks:
        if not m.any():
            continue
        mc = max(cv2.findContours(m.astype(np.uint8), cv2.RETR_EXTERNAL,
                                  cv2.CHAIN_APPROX_NONE)[0], key=len)
        np.testing.assert_array_equal(imgproc.box_points(cv2.minAreaRect(mc)).astype(np.int64)
                                      .shape, (4, 2))
        for jf, tf in ((jseg.get_smallest_side, tseg.get_smallest_side),
                       (jseg.get_biggest_side, tseg.get_biggest_side)):
            a, b = jf(m), tf(m)
            if a[1] == b[1] and np.array_equal(a[0], b[0]):
                same += 1
            else:
                assert _rect_tie(m), (a, b)
                ties += 1
    with capsys.disabled():
        print(f"\nmin-area-rect sides: {same} equal to OpenCV's, {ties} differ at ties")
    assert ties <= 0.05 * (same + ties)


def test_moments_blur_and_morphology_match_cv2(rng):
    for m in _masks(rng, 10):
        if m.any():
            want = cv2.moments(m.astype(np.float64))
            got = imgproc.moments(m)
            assert (got["m00"], got["m10"], got["m01"]) == (want["m00"], want["m10"], want["m01"])
            np.testing.assert_array_equal(tseg.centre_of_mass(m), jseg.centre_of_mass(m))
    for k in (3, 4, 5, 60):
        for it in (1, 2):
            m = (rng.random((70, 90)) < 0.05).astype(np.uint8)
            ones = np.ones((k, k), np.uint8)
            np.testing.assert_array_equal(imgproc.dilate(m, k, it),
                                          cv2.dilate(m, ones, iterations=it))
            np.testing.assert_array_equal(imgproc.erode(1 - m, k, it),
                                          cv2.erode(1 - m, ones, iterations=it))
    # The 201-tap blur of a 0 / 1 image (the captioner's), OpenCV's sigma
    # and border; a difference only where the blurred value is a tie.
    from scipy import ndimage

    for m in _masks(rng, 4, 240, 300):
        img = (~m).astype(np.uint8)
        want = cv2.GaussianBlur(img, (201, 201), 0)
        got = imgproc.gaussian_blur(img, 201, 0)
        k = cv2.getGaussianKernel(201, 0)[:, 0]
        exact = ndimage.correlate1d(ndimage.correlate1d(img.astype(np.float64), k, axis=0,
                                                        mode="mirror"), k, axis=1, mode="mirror")
        differ = got != want
        assert np.all(np.abs(exact[differ] - 0.5) < BLUR_TIE)


# ---------------------------------------------------- segmentation module


def test_mask_caches_cross_the_packages(rng, tmp_path):
    masks = (rng.random((3, 20, 30)) * 5).astype(np.uint8)
    jseg.save_masks(str(tmp_path / "j"), masks)
    tseg.save_masks(str(tmp_path / "t"), masks)
    np.testing.assert_array_equal(tseg.load_cached_masks(str(tmp_path / "j"), 3), masks)
    np.testing.assert_array_equal(jseg.load_cached_masks(str(tmp_path / "t"), 3), masks)
    os.makedirs(tmp_path / "s" / "masks")
    for i, m in enumerate(masks):
        Image.fromarray(m).save(tmp_path / "s" / "masks" / f"mask_{i:04d}.png")
    np.testing.assert_array_equal(tseg.load_synth_masks(str(tmp_path / "s"), 3),
                                  jseg.load_synth_masks(str(tmp_path / "s"), 3))
    with pytest.raises(FileNotFoundError):
        tseg.load_cached_masks(str(tmp_path / "j"), 4)
    # _save_frame: the same id image and label visualisation files.
    jseg.Segmentor()._save_frame(str(tmp_path / "jf"), 2, masks[0])
    tseg.Segmentor()._save_frame(str(tmp_path / "tf"), 2, masks[0])
    for sub in ("XMem_masks", "XMem_vis_masks"):
        a = np.asarray(Image.open(tmp_path / "jf" / sub / "rgb_0002.png"))
        b = png.read_png(str(tmp_path / "tf" / sub / "rgb_0002.png"))
        np.testing.assert_array_equal(b, a)


class _Gen:
    """A first-frame segmenter: fixed boolean masks."""

    def __init__(self, masks):
        self.masks = masks
        self.seen = []

    def __call__(self, img):
        self.seen.append(img.shape)
        return [m.copy() for m in self.masks]


class _Prop:
    """A propagator: the seeded id image, shifted by a frame's index."""

    def start(self, rgb, id_mask):
        self.mask, self.i = np.asarray(id_mask).copy(), 0
        return self.mask

    def step(self, rgb):
        self.i += 1
        return np.roll(self.mask, self.i, axis=1)


def _sam_masks(h, w, rng):
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for cy, cx, ry, rx in ((16, 22, 12, 15), (52, 80, 14, 13), (60, 26, 12, 17), (16, 22, 4, 5),
                           (72, 100, 3, 3), (40, 60, 40, 60)):
        out.append(((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1)
    two = np.zeros((h, w), bool)
    two[5:15, 5:15] = two[5:15, 60:70] = True  # two islands: suppressed
    return out + [two]


def test_segmentor_with_injected_backends_matches_reference(rng, tmp_path):
    h, w = 80, 110
    rgbs = rng.integers(0, 256, (4, h, w, 3), dtype=np.uint8)
    depths = np.full((4, h, w), 0.8, np.float32)
    sam = _sam_masks(h, w, rng)
    outs = {}
    for tag, mod in (("jax", jseg), ("torch", tseg)):
        d = str(tmp_path / tag)
        os.makedirs(d)
        gen = _Gen(sam)
        seg = mod.Segmentor(mask_generator=gen, propagator=_Prop())
        outs[tag] = np.asarray(seg.segment(rgbs, depths, d))
        np.testing.assert_array_equal(
            mod.load_cached_masks(d, 4) if tag == "torch" else tseg.load_cached_masks(d, 4),
            outs[tag])
    np.testing.assert_array_equal(outs["torch"], outs["jax"])
    assert len(np.unique(outs["torch"][0])) > 2
    # No backend and no cache: the port names what is missing.
    with pytest.raises(NotImplementedError, match="SAM"):
        tseg.Segmentor().segment(rgbs, depths, str(tmp_path / "none"))


def test_segment_associate_matches_reference(rng, tmp_path):
    h, w = 80, 110
    n_video = 7
    sam = _sam_masks(w, h, rng)  # the first frame is segmented rotated upright
    T = np.stack([jsynth.orbit_poses((0.5, 0, 0.05), 3)[i] for i in range(3)]).astype(np.float32)
    K = np.array([[100.0, 0, w / 2], [0, 100.0, h / 2], [0, 0, 1]])
    depths = np.full((3, h, w), 0.7, np.float32)
    sb = np.zeros((3, h, w), np.uint8)
    sb[:, :, :8] = 255
    outs = {}
    for tag, mod in (("jax", jseg), ("torch", tseg)):
        d = tmp_path / tag
        (d / "seg_images").mkdir(parents=True)
        for i in range(n_video):
            Image.fromarray(np.random.default_rng(i).integers(0, 256, (h, w, 3), dtype=np.uint8)
                            ).save(d / "seg_images" / f"{i:05d}.png")
        (d / "associate_index.txt").write_text("1\n3\n6\n")
        seg = mod.Segmentor(mask_generator=_Gen(sam), propagator=_Prop())
        outs[tag] = np.asarray(seg.segment_associate(str(d / "seg_images"), depths, T, K, str(d),
                                                     sb, (0.5, 0.0, 0.05)))
    np.testing.assert_array_equal(outs["torch"], outs["jax"])
    assert outs["torch"].shape == (3, h, w) and (outs["torch"][:, :, :8] == 255).all()


def test_postprocessing_matches_reference(rng):
    h, w = 80, 110
    sam = _sam_masks(h, w, rng)
    for jf, tf in ((jseg.subpart_suppression, tseg.subpart_suppression),
                   (jseg.disconnected_components_suppression,
                    tseg.disconnected_components_suppression),
                   (jseg.small_obj_suppression, tseg.small_obj_suppression)):
        a, b = jf(sam), tf(sam)
        assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))
    a = jseg.large_obj_suppression(sam, (h, w))
    b = tseg.large_obj_suppression(sam, (h, w))
    assert len(a) == len(b) == len(sam) - 1
    for scale in (1.6, 0.6, 1.0):
        for m in sam[:3]:
            np.testing.assert_array_equal(tseg.rescale_mask(m.astype(np.uint8), scale),
                                          jseg.rescale_mask(m.astype(np.uint8), scale))
    np.testing.assert_array_equal(tseg.build_background_mask(sam[:3]),
                                  jseg.build_background_mask(sam[:3]))
    a, b = jseg.postprocess_sam_masks(sam, (h, w)), tseg.postprocess_sam_masks(sam, (h, w))
    assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))
    sb = np.ones((h, w), bool)
    sb[:, :20] = False
    a = jseg.postprocess_sam_masks(sam, (h, w), scene_bound_mask=sb)
    b = tseg.postprocess_sam_masks(sam, (h, w), scene_bound_mask=sb)
    assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))
    np.testing.assert_array_equal(tseg.integrate_masks(b), jseg.integrate_masks(a))
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    for m in sam[:3]:
        np.testing.assert_array_equal(tseg.get_obj_img(img, m), jseg.get_obj_img(img, m))
        np.testing.assert_array_equal(tseg.get_thumbnail(img, m), jseg.get_thumbnail(img, m))
        np.testing.assert_array_equal(tseg.get_thumbnail(img, m, 2, False),
                                      jseg.get_thumbnail(img, m, 2, False))
        assert tseg.mask_touches_edge(m) == jseg.mask_touches_edge(m)


def test_pruning_matches_reference(rng):
    h, w = 90, 120
    ids = np.zeros((h, w), np.uint8)
    ids[10:40, 10:40] = 1
    ids[60:85, 80:115] = 1  # a duplicate blob of object 1
    ids[50:55, 5:10] = 1    # under 200 px
    ids[5:30, 70:100] = 2
    ids[0:8, 0:5] = 3
    ids[80:90, 0:30] = 3
    depth = np.full((h, w), 0.9, np.float32)
    depth[60:85, 80:115] = 0.4
    T = jsynth.orbit_poses((0.5, 0, 0.05), 5)[2].astype(np.float32)
    K = np.array([[110.0, 0, w / 2], [0, 110.0, h / 2], [0, 0, 1]])
    for centre in ((0.5, 0.0, 0.05), (0.2, 0.3, 0.0)):
        np.testing.assert_array_equal(tseg.duplicate_prune(ids, depth, T, K, centre),
                                      jseg.duplicate_prune(ids, depth, T, K, centre))
    np.testing.assert_array_equal(tseg.disconnected_prune(ids), jseg.disconnected_prune(ids))
    np.testing.assert_array_equal(tseg.remove_components_at_edges(ids > 0),
                                  jseg.remove_components_at_edges(ids > 0))


# ---------------------------------------------------------------- captioner


def _caption_backend(imgs):
    return [f"{im.shape[0]}x{im.shape[1]} {int(im.astype(np.int64).sum()) % 9973}" for im in imgs]


def _container_scene(h=120, w=160):
    rng = np.random.default_rng(5)
    rgbs = rng.integers(0, 256, (3, h, w, 3), dtype=np.uint8)
    masks = np.zeros((3, h, w), np.uint8)
    masks[:, 20:60, 20:70] = 1             # a plain object
    masks[:, 60:110, 90:150] = 2           # a container: a ring with a hole
    masks[:, 75:95, 105:135] = 0
    masks[:, 78:92, 108:132] = 3           # its contents
    scene = np.zeros((3, h, w), np.uint8)
    scene[:, :, :5] = 255
    return rgbs, masks, scene


@pytest.mark.parametrize("multi_view,topdown", [(False, True), (True, False), (True, True)])
def test_captioner_matches_reference(multi_view, topdown, tmp_path):
    rgbs, masks, scene = _container_scene()
    got = {}
    for tag, mod, lmod in (("jax", jcap, jllm), ("torch", tcap, tllm)):
        lm = lmod.LangModel(cache_path="", backend=lambda p, t: "an aggregated caption")
        cap = mod.Captioner(topdown=topdown, cache_path=str(tmp_path / f"{tag}.json"),
                            backend=_caption_backend)
        got[tag] = cap.caption_objs(4, rgbs, masks, lm, scene, topdown=topdown,
                                    multi_view=multi_view)
    (ja, jt), (ta, tt) = got["jax"], got["torch"]
    assert ta == ja and ta[0] == "__background__" and len(ta) == 4
    assert filecmp.cmp(str(tmp_path / "jax.json"), str(tmp_path / "torch.json"), shallow=False)
    assert len(tt) == len(jt)
    for a, b in zip(tt, jt):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    # The cache replays.
    cap = tcap.Captioner(topdown=topdown, read_cache=True, cache_path=str(tmp_path / "torch.json"))
    assert cap.caption_objs(4, rgbs, masks, None, scene, topdown)[0] == ta


@pytest.mark.parametrize("call", ["backend", "captioner"])
def test_blip2_defaults_to_the_gpu(call, monkeypatch):
    """BLIP-2 loads on CUDA unless the caller names a device: with no GPU
    the default raises the device error before transformers is imported
    (an import of it would raise ImportError here)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default is valid here")
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(RuntimeError, match="no GPU is available"):
        if call == "backend":
            tcap.blip2_backend()
        else:
            tcap.Captioner(topdown=True).caption([np.zeros((4, 4, 3), np.uint8)])
    assert tseg.Segmentor().device is None
    with pytest.raises(ImportError):
        tcap.blip2_backend(device="cpu")
