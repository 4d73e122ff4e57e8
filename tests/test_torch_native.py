"""The port's native ingest (``native/``, built by ``build.load_native``
from the port's copy of d2r_native.cpp with the host compiler and zlib)
byte for byte against the port's numpy codec (``utils/png.py``), the JAX
package's native bindings and PIL: 8-bit RGB, RGBA and grey and 16-bit
grey PNGs, PIL's adaptive filters and every one of the five filter types
(Paeth included); the encoder's round trip and its bytes against the JAX
package's; the RGB-D batch ingest against per-frame decoding; and the
loader, which takes the native ingest first and records which path decoded
the frames (a scan the native ingest does not take goes to the codec with a
warning)."""

import os
import shutil

import numpy as np
import pytest
from PIL import Image

from dream2real_tpu import native as jnative
from dream2real_tpu_torch import build, native
from dream2real_tpu_torch.cfg import Config
from dream2real_tpu_torch.data import synth as tsynth
from dream2real_tpu_torch.data.loader import D2RDataLoader
from dream2real_tpu_torch.utils import png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _arrays(rng):
    return [
        rng.integers(0, 256, (37, 53, 3), dtype=np.uint8),
        rng.integers(0, 256, (16, 24, 4), dtype=np.uint8),
        rng.integers(0, 256, (9, 7), dtype=np.uint8),
        rng.integers(0, 65536, (20, 30), dtype=np.uint16),
    ]


def test_the_library_builds_from_the_ports_source():
    lib = native.get_lib()
    assert lib is build.load_native()
    assert os.path.dirname(lib._name) == str(build.NATIVE_DIR)
    assert build.NATIVE_SRC.parent.parent.name == "dream2real_tpu_torch"


def test_decode_matches_codec_pil_and_jax(tmp_path, rng):
    for k, arr in enumerate(_arrays(rng)):
        for ftype in ("pil", 0, 1, 2, 3, 4):
            p = str(tmp_path / f"a{k}_{ftype}.png")
            if ftype == "pil":
                Image.fromarray(arr).save(p)  # PIL picks a filter a row
            else:
                png.write_png(p, arr, filter_type=ftype)
            got = native.png_read(p)
            assert got.dtype == arr.dtype and got.shape == arr.shape
            assert got.tobytes() == png.read_png(p).tobytes() == arr.tobytes()
            assert got.tobytes() == jnative.png_read(p).tobytes()


def test_encode_roundtrip_and_bytes_match_jax(tmp_path, rng):
    for k, arr in enumerate(_arrays(rng)):
        a, b = str(tmp_path / f"t{k}.png"), str(tmp_path / f"j{k}.png")
        assert native.png_write(a, arr) and jnative.png_write(b, arr)
        assert open(a, "rb").read() == open(b, "rb").read()
        assert png.read_png(a).tobytes() == arr.tobytes()
        np.testing.assert_array_equal(np.asarray(Image.open(a)), arr)
    assert not native.png_write(str(tmp_path / "f.png"), np.zeros((4, 4), np.float32))
    assert not native.png_write(str(tmp_path / "g.png"), np.zeros((4, 4, 2), np.uint16))
    (tmp_path / "bad.png").write_bytes(b"not a png")
    assert native.png_read(str(tmp_path / "bad.png")) is None


def test_rgbd_ingest_matches_codec_and_jax(tmp_path, rng):
    d = str(tmp_path)
    os.makedirs(f"{d}/images")
    os.makedirs(f"{d}/depth")
    h, w, n = 18, 26, 3
    rgbs = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    depths_mm = rng.integers(0, 65536, (n, h, w), dtype=np.uint16)
    for i in range(n):
        png.write_png(f"{d}/images/rgb_{i:04d}.png", rgbs[i], filter_type=4)
        Image.fromarray(depths_mm[i]).save(f"{d}/depth/depth_{i:04d}.png")
    rgb, depth = native.load_rgbd_dataset(d, n, h, w)
    jrgb, jdepth = jnative.load_rgbd_dataset(d, n, h, w)
    codec = depths_mm.astype(np.float32) / 1000.0  # the loader's numpy path
    assert rgb.tobytes() == rgbs.tobytes() == jrgb.tobytes()
    assert depth.dtype == np.float32 and depth.tobytes() == codec.tobytes() == jdepth.tobytes()
    assert native.load_rgbd_dataset(d, n + 1, h, w) is None  # a frame missing
    assert native.load_rgbd_dataset(d, n, h, w + 1) is None  # another size


def test_loader_takes_the_native_ingest_first(tmp_path):
    d = str(tmp_path / "scan")
    tsynth.write_dataset(d, n_views=3, h=36, w=64)
    cfg_path = os.path.join(ROOT, "configs", "synth_demo.json")
    cfg = Config(cfg_path, d)
    cfg.height, cfg.width = 36, 64
    loader = D2RDataLoader(cfg, device="cpu")
    rgb, depth, poses = loader.load_rgbds()
    assert loader.decoder == "native"
    want_rgb = png.read_pngs([os.path.join(d, "images", f"rgb_{i:04d}.png") for i in range(3)])
    want_d = png.read_pngs([os.path.join(d, "depth", f"depth_{i:04d}.png") for i in range(3)])
    assert rgb.tobytes() == np.ascontiguousarray(want_rgb[..., :3]).tobytes()
    assert depth.tobytes() == (want_d.astype(np.float32) / 1000.0).tobytes()
    # RGBA frames: the codec decodes the scan, and says so.
    for i in range(3):
        path = os.path.join(d, "images", f"rgb_{i:04d}.png")
        img = png.read_png(path)
        png.write_png(path, np.concatenate(
            [img, np.full(img.shape[:2] + (1,), 255, np.uint8)], -1))
    other = D2RDataLoader(cfg, device="cpu")
    with pytest.warns(UserWarning, match="numpy codec"):
        rgb2, depth2, _ = other.load_rgbds()
    assert other.decoder == "numpy"
    assert rgb2.tobytes() == rgb.tobytes() and depth2.tobytes() == depth.tobytes()
    shutil.rmtree(d)
