"""ctypes binding to the native C++ cluster-BVH builder.

Compiles the port's own ``native/cluster_bvh.cpp`` (a verbatim copy of the
JAX package's, pinned by tests/test_torch_host.py) on first use (g++,
cached as a shared object in the port's git-ignored build directory, never
next to the source).  ``load()`` returns None when no toolchain is
available; callers fall back to the NumPy builder with identical semantics.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

from ..build import BUILD_DIR

_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), os.pardir, "native")
_SRC = os.path.abspath(os.path.join(_NATIVE_DIR, "cluster_bvh.cpp"))
_SO = os.path.join(BUILD_DIR, "libcluster_bvh.so")

ABI_VERSION = 1


def _compile() -> bool:
    if not os.path.exists(_SRC):
        return False
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return True
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"   # concurrent builders: atomic rename
    try:
        subprocess.run(
            ["g++", "-O3", "-fPIC", "-std=c++17", "-shared", "-o", tmp, _SRC],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def load():
    """Return the loaded CDLL with argtypes set, or None."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("RUSTRAY_NO_NATIVE") == "1":
            return None
        if not _compile():
            return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        try:
            if lib.rr_abi_version() != ABI_VERSION:
                return None
        except AttributeError:
            return None
        c_float_p = ctypes.POINTER(ctypes.c_float)
        c_int_p = ctypes.POINTER(ctypes.c_int)
        lib.rr_build_clusters.argtypes = [
            c_float_p, ctypes.c_int, c_int_p, ctypes.c_int, ctypes.c_int,
            c_int_p, c_float_p, c_int_p, ctypes.c_int]
        lib.rr_build_clusters.restype = ctypes.c_int
        _LIB = lib
        return _LIB
