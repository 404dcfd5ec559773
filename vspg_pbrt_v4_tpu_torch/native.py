"""ctypes binding of the repository's native helper library's binned-SAH
BVH build (``native/bvh_builder.cpp``).

This package's own binding (the JAX package's ``native.py`` returns JAX
arrays). It loads the committed ``native/libvspg_native.so``; where that
does not load, it builds a copy of its own from that source with g++
into ``vspg_pbrt_v4_tpu_torch/build/`` (git-ignored). It never writes into
``native/``. Callers fall back to numpy when neither loads
(``ops/bvh.build_bvh`` stays the reference). Returns numpy arrays; nothing
happens at import.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parent.parent
_NATIVE_DIR = _REPO / "native"
_SOURCES = ("bvh_builder.cpp",)
_OWN_SO = Path(__file__).resolve().parent / "build" / "libvspg_native.so"
_lib = None
_tried = False


def _build_own():
    """Compile the library's sources into this package's build directory;
    the path, or None without g++ or on a failed build."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    _OWN_SO.parent.mkdir(parents=True, exist_ok=True)
    try:
        subprocess.run([gxx, "-O3", "-fPIC", "-shared", "-std=c++17",
                        *(str(_NATIVE_DIR / s) for s in _SOURCES), "-o",
                        str(_OWN_SO)], check=True, capture_output=True,
                       timeout=120)
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired):
        return None
    return _OWN_SO


def _bind(path):
    lib = ctypes.CDLL(str(path))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    lib.vspg_build_bvh.restype = ctypes.c_int32
    lib.vspg_build_bvh.argtypes = [f32p, f32p, ctypes.c_int32, ctypes.c_int32,
                                   f32p, f32p, i32p, i32p, i32p, i32p]
    return lib


def _load():
    global _lib, _tried
    if not _tried:
        _tried = True
        try:
            _lib = _bind(_NATIVE_DIR / "libvspg_native.so")
        except OSError:
            own = _build_own()
            try:
                _lib = None if own is None else _bind(own)
            except OSError:
                _lib = None
    return _lib


def available():
    """Whether the native library loads (or could be built)."""
    return _load() is not None


def build_bvh_native(prim_bmin, prim_bmax, max_leaf=4):
    """Native binned-SAH build over primitive bounds (P, 3): the arrays
    (bmin, bmax, right, start, count, prim_ids) of ``ops/bvh.build_bvh``'s
    layout as numpy, or None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    pmin = np.ascontiguousarray(prim_bmin, np.float32)
    pmax = np.ascontiguousarray(prim_bmax, np.float32)
    n = pmin.shape[0]
    cap = max(2 * n, 1)
    bmin = np.empty((cap, 3), np.float32)
    bmax = np.empty((cap, 3), np.float32)
    right = np.empty(cap, np.int32)
    start = np.empty(cap, np.int32)
    count = np.empty(cap, np.int32)
    order = np.empty(max(n, 1), np.int32)
    n_nodes = lib.vspg_build_bvh(pmin, pmax, n, max_leaf, bmin, bmax, right,
                                 start, count, order)
    return (bmin[:n_nodes], bmax[:n_nodes], right[:n_nodes],
            start[:n_nodes], count[:n_nodes], order)

