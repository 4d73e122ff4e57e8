"""Build and load the hand-written CUDA kernels under ``csrc/`` and the
native ingest under ``native/``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with nvcc into
``build/kernels/<name>-<hash>.so`` at the root of the checkout, keyed by a
hash of its source and flags, so a fresh checkout builds everything on first
use and a changed source rebuilds. ``native/d2r_native.cpp`` (the PNG codec
and the RGB-D ingest, host code) compiles the same way with the host C++
compiler and zlib into ``build/native/``. Loaded through ctypes. Nothing
here runs at import time: the CPU tests import every module without a
compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
SOURCES = ("march", "attention", "train")
# No --use_fast_math: the march's sin/cos arguments reach 2^9*pi rad, where
# the fast intrinsics are wrong, and fast math flushes the denormals that the
# clamp softmax exp(min(s, 70) - 70) produces for logits below about -17.
# The flags link the CUDA runtime only. attention.cu's TMA tensor maps need one
# function of libcuda (cuTensorMapEncodeTiled); it fetches that entry point at
# run time through cudaGetDriverEntryPoint, so no -lcuda here. The `a` of sm_90a
# is what wgmma needs.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

NATIVE_SRC = Path(__file__).resolve().parent / "native" / "d2r_native.cpp"
NATIVE_DIR = BUILD_DIR.parent / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    for hdr in sorted(CSRC.glob("*.cuh")):
        src += hdr.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def _start(name: str):
    """Start nvcc for one source unless its library is already built.
    Returns (target, process or None)."""
    out = _target(name)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, (proc, tmp)


def _finish(name: str, out: Path, pending) -> None:
    if pending is None:
        return
    proc, tmp = pending
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent build never loads a partial .so


def build_all() -> float:
    """Compile every kernel source in parallel (one nvcc each); returns the
    wall seconds. Already-built libraries are reused."""
    t0 = time.perf_counter()
    started = {name: _start(name) for name in SOURCES}
    for name, (out, pending) in started.items():
        _finish(name, out, pending)
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output (ptxas register/shared-memory report) of the last build."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        out, pending = _start(name)
        _finish(name, out, pending)
        lib = ctypes.CDLL(str(out))
        _LIBS[name] = lib
    return lib


def load_native() -> ctypes.CDLL:
    """The native ingest's library, built on first use with the host C++
    compiler (``$CXX``, else c++ or g++) and ``-lz`` into
    ``build/native/d2r_native-<hash>.so``. Raises when it cannot be built."""
    lib = _LIBS.get("native")
    if lib is not None:
        return lib
    key = hashlib.sha256(NATIVE_SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    out = NATIVE_DIR / f"d2r_native-{key}.so"
    if not out.exists():
        cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
        if cxx is None:
            raise RuntimeError("no host C++ compiler: the native ingest cannot be built")
        NATIVE_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(NATIVE_SRC), "-lz"],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"the native ingest failed to build:\n{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    _LIBS["native"] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch function."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed with cudaError {err}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
