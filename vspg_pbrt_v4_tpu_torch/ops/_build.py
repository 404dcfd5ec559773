"""Build and load the CUDA kernels of ``csrc/``.

At first use, ``nvcc`` compiles each ``csrc/*.cu`` for ``sm_90a`` into an
object file, one process per source, all started together, and links them
into one shared library with a plain C interface under
``vspg_pbrt_v4_tpu_torch/build/`` (git-ignored); it rebuilds when a source
is newer than the library. The library is bound with ctypes, every pointer
and the stream as ``c_void_p``. Nothing happens at import: the CPU tests
import this module on machines with no ``nvcc``.
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
              "-O3", "-Xcompiler", "-fPIC"]
# Per-source flags. The VSPG kernel rounds as its plain version's separate
# PyTorch ops do: contracting a*b+c into one FMA changes the rounding, and
# its long branchy walks then diverge on about 1% of pixels. Every source
# builds at ptxas -O3: the grid kernel's per-pixel design lost whole warps'
# later samples at -O1 to -O3 (CUDA 12.9) in its triangle builds, which
# therefore built at -O0 until its (pixel, sample) item design
# (csrc/volpath_grid.cuh), which chip_smoke.py holds per item and per pixel
# at 4 spp and more.
SOURCE_FLAGS = {"vspg.cu": ["-fmad=false"]}

_lib = None
# seconds the last build of this process took (0.0 before any), and what
# ptxas reported when it was asked to (``build(verbose=True)``)
last_build_seconds = 0.0
last_build_log = ""


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


def _run_all(cmds):
    """Run the commands at once; raise with the output of the first that
    fails. Returns their joined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, o in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + " ".join(c) + "\n" + o)
    return "".join(outs)


def build(force=False, verbose=False):
    """Compile the library if it is missing or older than a source;
    verbose=True also asks ptxas for registers and spills per kernel."""
    global last_build_seconds, last_build_log
    cu, cuh = _sources()
    newest = max(p.stat().st_mtime for p in cu + cuh)
    if (not force and LIB_PATH.exists()
            and LIB_PATH.stat().st_mtime >= newest):
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmpdir = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        nvcc = _nvcc()
        extra = ["-Xptxas", "-v"] if verbose else []
        objs = [str(Path(tmpdir) / (p.stem + ".o")) for p in cu]
        t0 = time.perf_counter()
        log = _run_all([[nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(p.name, []),
                         *extra, "-c", "-o", o, str(p)]
                        for p, o in zip(cu, objs)])
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, LIB_PATH)  # atomic: concurrent loaders see old or new
        last_build_seconds = time.perf_counter() - t0
        last_build_log = log
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return LIB_PATH


# the grid kernel's three instantiations (csrc/volpath_grid*.cu), one
# launch and one info entry point each
GRID_NAMES = ("grid", "grid_tris", "grid_mesh")
_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
# argument types of each C entry point (all return an int CUDA error code)
SIGNATURES = {
    "volpath_homog_launch": [_P, _P, _P, _I, _I, _U, _F, _P],
    **{f"volpath_{g}_launch": [_P] * 9 + [_I, _I, _I, _U] + [_I] * 5 + [_P]
       for g in GRID_NAMES},
    **{f"volpath_{g}_info": [_I, _I, _I, _P] for g in GRID_NAMES},
    "vspg_render_launch": [_P] * 15 + [_I] * 4 + [_U] + [_I] * 6 + [_P],
    "vspg_render_info": [_I] * 5 + [_P],
    "vspg_reduce_launch": [_P] * 4 + [_I, _I, _I, _F, _I, _I, _P],
    "vspg_record_launch": [_P] * 13 + [_I, _I, _U, _F] + [_I] * 6 + [_P],
    "path_surface_launch": [_P, _P, _P, _I, _I, _U, _F, _I, _I, _P],
    "gather_launch": [_P, _P, _I, _I, _I, _I, _I, _P],
}


def bind(path, names=tuple(SIGNATURES)):
    """The shared library at `path`, its entry points `names` typed."""
    lib = ctypes.CDLL(str(path))
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = SIGNATURES[name]
        fn.restype = _I
    return lib


def load():
    """The bound library, built first if needed."""
    global _lib
    if _lib is None:
        _lib = bind(build())
    return _lib
