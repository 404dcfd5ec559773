"""Build and load the CUDA kernels of ``csrc/``.

At first use, ``nvcc`` compiles ``csrc/*.cu`` for ``sm_90a`` into one shared
library with a plain C interface under ``vspg_pbrt_v4_tpu_torch/build/``
(git-ignored); it rebuilds when a source is newer than the library. The
library is bound with ctypes, every pointer and the stream as
``c_void_p``. Nothing happens at import: the CPU tests import this module
on machines with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
LIB_PATH = BUILD_DIR / "libvolpath_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lib = None
# seconds the last nvcc run of this process took (0.0 before any)
last_build_seconds = 0.0


def _nvcc():
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def build(force=False):
    """Compile the library if it is missing or older than a source."""
    global last_build_seconds
    cu, cuh = _sources()
    newest = max(p.stat().st_mtime for p in cu + cuh)
    if (not force and LIB_PATH.exists()
            and LIB_PATH.stat().st_mtime >= newest):
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, cu)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError("nvcc failed:\n" + " ".join(cmd) + "\n"
                           + res.stdout + res.stderr)
    os.replace(tmp, LIB_PATH)  # atomic: concurrent loaders see old or new
    last_build_seconds = time.perf_counter() - t0
    return LIB_PATH


def load():
    """The bound library, built first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    lib.volpath_homog_launch.argtypes = [p, p, p, i, i, u, f, p]
    lib.volpath_homog_launch.restype = i
    lib.volpath_grid_launch.argtypes = [p, p, p, p, p, i, i, u, f, i, p]
    lib.volpath_grid_launch.restype = i
    _lib = lib
    return lib
