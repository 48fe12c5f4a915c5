"""Build directory and the nvcc build of the port's hand-written CUDA kernels.

Each kernel source under ``csrc/`` exposes a plain C interface.  It is
compiled on first use with nvcc into a shared library in the git-ignored
``_build/`` directory, keyed on a hash of the source and the flags, and
loaded with ctypes.  Nothing here runs at import time, and nothing falls
back: a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")

# sm_90a (Hopper).  -fmad=false: no mul+add contraction, so the kernel's
# float arithmetic rounds exactly like the elementwise torch twin (and the
# IEEE division stays correctly rounded: no --use_fast_math).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIBS = {}
# per kernel library: seconds the nvcc build took in this process (0.0 when
# it was already built) and the compiler's register/shared-memory report
build_seconds = {}
build_log = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): the "
                           "port's kernels are built with nvcc at first use")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _so_path(name: str):
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR,
                             f"lib{name}-{digest.hexdigest()[:16]}.so")


def _build(names) -> None:
    """Run one nvcc per missing library, all at once; raise on a failure.
    Caller holds _LOCK."""
    procs = []
    t0 = time.perf_counter()
    for name in names:
        src, so = _so_path(name)
        if os.path.exists(so):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        procs.append((name, src, so, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, src, so, tmp, proc in procs:
        out, err = proc.communicate()
        build_seconds[name] = time.perf_counter() - t0
        build_log[name] = err
        if proc.returncode != 0:
            failed.append(f"nvcc failed to build {src}:\n{out}{err}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))


def build_kernel_libs(names) -> None:
    """Build every named ``csrc/<name>.cu`` not yet built, one nvcc each,
    in parallel (``build_seconds`` then holds each build's wall time from
    the common start)."""
    with _LOCK:
        _build([n for n in names if n not in _LIBS])


def load_kernel_lib(name: str) -> ctypes.CDLL:
    """Build (once per source hash) and load ``csrc/<name>.cu``."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        _build([name])
        build_seconds.setdefault(name, 0.0)
        lib = ctypes.CDLL(_so_path(name)[1])
        _LIBS[name] = lib
        return lib
