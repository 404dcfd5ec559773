#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root: ``python3 chip_smoke.py``. It builds the
kernels of ``vspg_pbrt_v4_tpu_torch/csrc`` with nvcc (phase 2 prints every
kernel's registers and spills by name), checks each against its plain
PyTorch version and in a furnace, then renders the bench scenes at bench
size through ``render_persistent(backend="auto")`` (phase 6: the fogbox at
256x256x64 and at 1920x1088x16, bench_config5b's wave, through B1; cloud64
through B2a), checks that each main path went through its kernel (one
item launch and one reduce a chunk of samples, and nothing else), and
holds each kernel's bench-size image against its plain version pixel for
pixel at the same shape, spp and seed, and B1's sums of each group of
samples against its plain per-sample version's. Phase 7 does the same for
the VSP-guided path:
the VSPG kernel's record and render variants (RIS and MIS) against their
plain versions, a guided furnace, and ``render_vspg`` on the bench's pyro
cloud at 256^2 (48 training waves, then 64 frozen spp), its time split by
CUDA events around each kernel launch. Phase 8 does it for the NDS/NDS+
arm: the NDS and NDS+ variants against their plain versions, an NDS
furnace, ``render_vspg`` under NDS (record kernel, then render kernel) and
under NDS+ (torch waves, then the render kernel with the TrBuffer), and
the kernel's frozen render against the torch wave's. Phase 9 does it for
the teaser class (the bench's 48 machine triangles of glass, metal and
diffuse parts in the pyro cloud): the grid kernel's and the VSPG kernel's
triangle instantiations against their plain versions, a teaser furnace,
``render_persistent`` at 1920x1088 and ``render_vspg`` at 128^2 on the
machines, and the VSPG kernel's frozen render against the torch wave's,
also with rough surfaces. Phase 10 does it for the mesh class (the bench's
3072-triangle PLY machines in the pyro cloud, walked through their BVH):
the grid kernel's mesh build against its plain version, a mesh furnace and
``render_persistent`` at 1920x1088. Phase 11 does it for the Cornell
surface class in vacuum (bench_config6): the surface kernel (B5) against
its plain versions per pixel and per group of samples on three scenes, a
floor furnace, and ``render_persistent`` on the Cornell box at 256x256x64
(per pixel and per group at that shape) against the torch wavefront's
mean. B1 and B5 run items of one pixel and a group of samples on
persistent blocks; each prints its grid, registers, spills, group and
chunks beside its time and the one-thread-a-pixel design's.
Phase 12 does it for the adaptive guiding field (the VSPG kernel's
two-stage coarse-cell -> leaf lookup): the record and render variants
against their plain versions on refined fields, an adaptive furnace,
``render_vspg`` on the pyro cloud at 256^2 with 1024 extra leaves, its
time split into the kernels, the refinement and the rest, the render
kernel on its inputs beside the uniform field of phase 7c, and the frozen
render against the torch wave's. Phase 13 runs M, the gather
microbenchmark: both table placements bit for bit against their plain
version, then its slope timing at C = 32, 256 and 2048. Phase 14 holds
the render kernel's register budget: render-only builds of vspg.cu at 2, 3
and 4 minimum blocks an SM, timed in turns on phases 7c's and 9d's inputs,
also with each item's cap cut to one sample's budget (a time only: that
cap changes the image); then the iteration cap's rule on the same inputs
with max_events cut to 1 at 16 spp, where the cap cuts samples in many
pixels, against the per-pixel plain version on a crop. Phase 15 holds the
grid kernel's register budget and warp vote: each grid source built alone
at 2, 3 and 4 minimum blocks an SM, and with its vote flipped, timed in
turns on the main paths' inputs of phases 6, 9c and 10c. Phase 16, run
before 14, drives scene files through the port's own parser, builder and
CLI (``python -m vspg_pbrt_v4_tpu_torch``): the fog box through the CLI
against the API bit for bit, the parsed fog against the same fog as one
box through B1, the Cornell box (spheres, an area light), and a guided
fog box with an emissive quad, storing then loading its guiding cache,
against the same scene under volpath. Phase 17, run after 16, drives the
repo's VSPG scene file and the modules around it: ``scenes/cloud_vspg.pbrt``
(the procedural cloud, the U-Net ISGB denoiser) through the CLI as shipped
and wound outward, against volpath; ``guidedvolpath`` (RIS, MIS) and
``guidedpath`` through the CLI, each equal to ``render_guided`` bit for
bit and within 4 standard errors of volpath; ``render_vspg`` with the
U-Net through B4a and B3a against the à-trous filter; and the U-Net's
update on the card twice and on the CPU. Phase 18, run after 17, drives
the port on several devices and the scene header: the dry run of
``vspg_pbrt_v4_tpu_torch.parallel.dryrun`` in an NCCL world of one rank a
card (the four sharded entry points), B3a, B3b and B3d at 256^2 x 64 as four
row blocks with pixel bases, stitched equal to the unsharded render bit
for bit, and the CLI on scene texts with the samplers, filters and
cameras the port once refused. Phase 19, run after 18, drives the other
media at the sizes their users render: a 256^3 cloud written as a NanoVDB
file and read back bit for bit, that file through the CLI against B2a on
the same density in one box and under guidedvolpathvspg; a
64^3 RGB grid against the same density as a grid medium, and an emissive
RGB slab against its analytic radiance; the earth medium with a PNG
heightmap under volpath and guidedvolpathvspg; and a CLI render with a
PIZ EXR as its MSE reference. Phase 20, run after 19, drives the other
lights and the light samplers at the sizes their users render: a scene
with a spot, goniometric, projection and distant light, a 2048x1024
lat-long image environment and a blackbody area light through the CLI;
a goniometric light with a constant image against a point light, and a
constant image environment against the constant one; a ceiling of 4096
emissive triangles and 16 point lights under the BVH light sampler
against the power sampler; a room lit through a window by a 1024^2 image
environment with and without a portal, and filled with fog under the
guided integrators; and the fog box and the pyro cloud with a distant
light added, which no kernel serves, through ``render_persistent`` and
``render_vspg`` with no kernel launch. The grid kernel (B2a-c) runs
(pixel, sample) items too:
9a and 10a hold B2b and B2c per item against the plain per-item version
at 4 spp, printing the items the kernel reads as 0 (a lost sample), and
every B2b/B2c image check uses the mesh bar (0.9999 of pixels). Every
render check against the plain version runs at least ITEMS_PER_THREAD
items a thread, and each render launch of a main path prints its grid,
registers, spills, items at the cap and its time beside the earlier one.
The record kernel (B4a-d) runs its pixels on persistent blocks: every
record check runs at least ITEMS_PER_THREAD pixels a thread and holds the
image and every record row bit for bit, each record launch of a main path
prints the same and its time by CUDA events around the launch, and every
main path holds 0 render items and 0 record lanes at the iteration cap.
Every line with a number names the card and its power limit. Any failure raises and exits
non-zero; the last line, printed only after every phase passed, is
``{"ok": true, "device": {...}}``. Imports no JAX.
"""

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch


def _card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def _parity(k, p):
    """(fraction of pixels within 1e-3 relative or 1e-5 absolute, relative
    difference of the means, max abs difference) of two images."""
    diff = (k - p).abs()
    rel = diff / p.abs().clamp(min=1e-12)
    ok = ((rel < 1e-3) | (diff < 1e-5)).all(-1)
    mean_rel = abs(k.mean().item() - p.mean().item()) / abs(p.mean().item())
    return ok.float().mean().item(), mean_rel, diff.max().item()


# Peak rates of one H100 SXM at its 700 W limit: HBM bytes per second
# (NVIDIA's data sheet), and per pipe of 132 SMs at the 1.98 GHz boost
# clock, FP32 instructions (add, multiply or FMA: 128 lanes an SM, the data
# sheet's 67 TFLOP/s when an FMA counts as two operations) and MUFU
# special-function results (16 an SM).
HBM_BYTES_PER_S = 3.35e12
FP32_INSTR_PER_S = 132 * 128 * 1.98e9
MUFU_PER_S = 132 * 16 * 1.98e9
# (FP32 operations, MUFU operations) per unit of work the plain versions
# count, counted by hand from the kernel sources, so estimates: an add,
# multiply, min/max or compare-select counts one FP32 operation; a
# division, square root, exp or log counts one MUFU operation and one FP32
# operation (its range reduction and Newton steps are not counted); sin
# and cos count one FP32 operation; the integer RNG and index arithmetic
# are not counted. "fma": the source is built with FMA contraction, so a
# multiply and an add may issue as one instruction.
OPS = {
    "volpath_homog": {"fma": True, "events": (220, 30)},
    "volpath_grid": {"fma": True, "events": (170, 30),
                     "flight_steps": (90, 13), "shadow_steps": (100, 20)},
    # with triangles: a ray-triangle test (the Moller-Trumbore sweep, one
    # division) and a surface event (frame, BSDF value, pdf and sample,
    # light pick, Fresnel)
    "volpath_grid_tris": {"fma": True, "events": (170, 30),
                          "flight_steps": (90, 13), "shadow_steps": (100, 20),
                          "tri_tests": (30, 1), "surface_events": (400, 40)},
    # the mesh class: each closest-hit or shadow query (three reciprocals)
    # walks the BVH: a node visit (the slab test: six subtractions and
    # multiplies, min/max per axis and across, the widening, three
    # compares) and a leaf triangle test (the ray-triangle test)
    "volpath_grid_mesh": {"fma": True, "events": (170, 30),
                          "flight_steps": (90, 13), "shadow_steps": (100, 20),
                          "surface_events": (400, 40), "queries": (6, 3),
                          "node_visits": (25, 0), "leaf_tests": (30, 1)},
    # lane-iterations (box test, deferred roulette, eight draws), walk and
    # shadow steps (cell exit, eight-corner trilerp, mode update), scatter
    # vertices (field query, HG product, NEE pick, RIS or MIS direction)
    # and walk-start field queries (secondary VSP); built with -fmad=false
    "vspg": {"fma": False, "iters": (60, 4), "steps": (180, 14),
             "scatters": (740, 140), "queries": (225, 30),
             # NDS: majorant-OD prepass steps (cell exit, no density) and
             # ODS candidate draws (truncated exponential, four expm1, two
             # log1p, the renormalisations)
             "pre_steps": (60, 4), "draws": (40, 9),
             # with triangles: a ray-triangle test and a surface event
             # (classification, frame, field query of the surface half,
             # cosine product, guided draw, Fresnel or VNDF lobe)
             "tri_tests": (30, 1), "surface_events": (900, 150)},
    # B5 (path_surface.cu): a lane-iteration (escape or emission with MIS,
    # the radiance scrub and commit), a closest-hit triangle test and a
    # shadow-sweep test (the Moller-Trumbore formula, one reciprocal), a
    # shading iteration (hit point and frame, one NEE light sample with its
    # square root and reciprocals, the MIS weight, the cosine bounce and
    # its frame, roulette) and a camera sample (the pinhole ray, two
    # normalisations)
    "path_surface": {"fma": True, "iters": (30, 4), "tri_tests": (56, 1),
                     "shadow_tests": (54, 1), "shades": (155, 9),
                     "samples": (60, 3)},
}


def _bound_ms(name, counts, scale, nbytes):
    """(least time in ms, what binds it, the three times in ms): the
    largest of nbytes over the HBM rate, the counted FP32 work over the
    FP32 instruction rate (half of it where FMAs fuse pairs) and the
    counted MUFU work over the MUFU rate, the work times `scale`."""
    units = [k for k in OPS[name] if k != "fma"]
    fp32 = sum(OPS[name][k][0] * counts.get(k, 0) for k in units) * scale
    mufu = sum(OPS[name][k][1] * counts.get(k, 0) for k in units) * scale
    instr = fp32 / 2 if OPS[name]["fma"] else fp32
    t = {"bytes": nbytes / HBM_BYTES_PER_S, "fp32": instr / FP32_INSTR_PER_S,
         "mufu": mufu / MUFU_PER_S}
    binds = max(t, key=t.get)
    return (t[binds] * 1e3, "bytes" if binds == "bytes" else "operations",
            {k: round(v * 1e3, 4) for k, v in t.items()})


_T0 = time.perf_counter()


def _at():
    """Seconds since the script started, for the phase lines."""
    return f"at {time.perf_counter() - _T0:.1f} s"


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _events_best_of_3(fn):
    """Best device time in ms of 3 warm runs of `fn`, by CUDA events."""
    fn()
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def _rows_parity(label, rec_k, rec_p, tag):
    """Print and check the fraction of lanes with every record row of a
    record kernel within 1e-3 (or 1e-5 absolute) of its plain version's;
    returns the max abs difference."""
    rk, rp = rec_k.permute(2, 0, 1), rec_p.permute(2, 0, 1)
    diff = (rk - rp).abs().reshape(rk.shape[0], -1)
    ok = ((diff <= 1e-3 * rp.abs().reshape(diff.shape)) | (diff <= 1e-5))
    frac = ok.all(-1).float().mean().item()
    surf = int(((rec_p[7] > 0) & (rec_p[18] < 0.5)).sum())
    print(f"{label}: {frac:.5f} of lanes with every record row within "
          f"1e-3, max abs diff {diff.max().item():.3e} "
          f"({int((rec_p[7] > 0).sum())} valid slots, {surf} at "
          f"surfaces) {tag}", flush=True)
    assert frac >= 0.98, (label, frac)
    return diff.max().item()


def _guided_furnace(dev):
    """The guided furnaces' scene: a 16^3 scattering-only ball (albedo 1,
    g 0.3) in a box under a constant env of 0.7, whose image is 0.7 under
    any guiding distribution."""
    from vspg_pbrt_v4_tpu_torch.models.integrators import volpath
    from vspg_pbrt_v4_tpu_torch.models.lights import Lights
    from vspg_pbrt_v4_tpu_torch.models.materials import Materials
    from vspg_pbrt_v4_tpu_torch.models.media import GridMedium, Media
    from vspg_pbrt_v4_tpu_torch.models.shapes import Geometry

    x = np.linspace(-1, 1, 16)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    dens = np.clip(1.0 - np.sqrt(X**2 + Y**2 + Z**2), 0, 1).astype(
        np.float32) * 3.0
    gm = GridMedium.make(dens, [0.0] * 3, [2.0] * 3, (-1, -1, -1),
                         (1, 1, 1), g=0.3, maj_res=8, device=dev)
    return volpath.Scene(
        Geometry.build(boxes=[dict(bmin=(-1, -1, -1), bmax=(1, 1, 1),
                                   mat=-1, light=-1, med_in=0, med_out=-1)],
                       device=dev),
        Materials.build([], device=dev), Media.make(grids=(gm,), device=dev),
        Lights.make(env_L=[0.7] * 3, world_radius=100.0, device=dev))


def _best_of_3(fn):
    """Best wall time of 3 warm runs, each bracketed by synchronize."""
    fn()
    torch.cuda.synchronize()
    best, out = float("inf"), None
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best, out


# The render variant's checks against its plain version run at least this
# many items a thread: its per-lane item loop has the shape in which ptxas
# -O1 to -O3 lost warps' later samples in the grid kernel (ROADMAP.md
# section C 1), which a check with fewer items a thread would not see.
ITEMS_PER_THREAD = 4
# B3's times at the main path's shapes with one thread a pixel, before the
# render kernel ran (pixel, sample) items (PERF.md section 6; NVIDIA H100
# 80GB HBM3, 700.00 W), printed beside the new ones
EARLIER_MS = {"vspg_render": 392.691, "vspg_render_nds": 288.537,
              "vspg_render_ndsp": 297.334, "vspg_render_tris": 410.355,
              "vspg_render_adaptive": 384.801}
# B2a-c's times at the main path's shapes with one thread a pixel, before
# the grid kernel ran (pixel, sample) items (PERF.md section 6; NVIDIA H100
# 80GB HBM3, 700.00 W; B2b and B2c built at ptxas -O0 then; B2a's and
# B2b's taken by the host's clock around a synchronised call, B2c's by CUDA
# events, as every grid time is now)
EARLIER_MS.update(volpath_grid=18.829, volpath_grid_tris=243.842,
                  volpath_grid_mesh=328.892)
# B4's times at the main path's shapes with one thread a pixel on
# (npix + 127) / 128 blocks, before its pixels ran on persistent blocks
# (PERF.md section 6; NVIDIA H100 80GB HBM3, 700.00 W; the host's clock
# around a synchronised call, best of 3)
EARLIER_MS.update(vspg_record=5.669, vspg_record_nds=2.041,
                  vspg_record_tris=4.252, vspg_record_adaptive=5.856)
# B1's and B5's times at the main paths' shapes with one thread a pixel,
# before they ran work items (PERF.md section 6; NVIDIA H100 80GB
# HBM3, 700.00 W), printed beside the new ones, and how each was taken
EARLIER_MS.update({"volpath_homog fogbox": 0.990,
                   "volpath_homog fogbox 1080p": 3.879,
                   "path_surface": 1.357})
EARLIER_NOTE = {"volpath_homog fogbox": "the host's clock around a "
                "synchronised call",
                "volpath_homog fogbox 1080p": "CUDA events, "
                "vspg_pbrt_v4_tpu_torch/benchmarks/group_items.py --turns",
                "path_surface": "CUDA events"}
# ptxas's registers and spill bytes of the shipped build's VSPG kernels, by
# (record, ris, method, tris), and of its grid kernels, by (geometry mode,)
# (phase 2)
PTXAS = {}
PTXAS_GRID = {}
# every kernel's, by _kernel_label (phase 2)
PTXAS_ALL = {}
VSPG_ENTRY = r"vspg_kernelILb(\d)ELb(\d)ELi(\d)ELb(\d)E"
GRID_ENTRY = r"volpath_grid_kernelILi(\d)E"
# the grid kernel's sources, by kernels-line name, and the minimum blocks an
# SM of the builds that phase 15 times (its register-budget sweep; each
# source is also timed with its warp vote, VOLPATH_GRID_VOTE, flipped)
GRID_SOURCES = {"volpath_grid": "volpath_grid.cu",
                "volpath_grid_tris": "volpath_grid_tris.cu",
                "volpath_grid_mesh": "volpath_grid_mesh.cu"}
GRID_SWEEP = (2, 3, 4)
# phase 15 times a build only while the script has run less than this
SWEEP_UNTIL_S = 1100.0
# each grid kernel's main-path inputs (constants, spp), kept by phases 6,
# 9c and 10c for phase 15
GRID_CELLS = {}
# the render-only builds of vspg.cu that phase 14 times: (minimum blocks an
# SM of the render instantiations, extra nvcc flags)
SWEEP = {f"min{k}": [f"-DVSPG_RENDER_MIN_BLOCKS={k}",
                     f"-DVSPG_RENDER_TRIS_MIN_BLOCKS={k}"] for k in (2, 3, 4)}
RENDER_NAMES = ("vspg_render_launch", "vspg_render_info",
                "vspg_reduce_launch")


def _ptxas_table(log, entry=VSPG_ENTRY):
    """{key: {"regs", "stack", "st", "ld"}} of the kernels whose mangled
    name matches `entry` in an ``-Xptxas -v`` log, keyed by its groups as
    ints: (record, ris, method, tris) of the VSPG kernels, (geometry mode,)
    of the grid kernels (GRID_ENTRY)."""
    import re

    rows, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = re.search(entry, m.group(1))
            continue
        if cur is None:
            continue
        key = tuple(int(x) for x in cur.groups())
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            rows.setdefault(key, {}).update(
                stack=int(m.group(1)), st=int(m.group(2)),
                ld=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rows.setdefault(key, {})["regs"] = int(m.group(1))
    return rows


def _kernel_label(mangled):
    """A kernel's name and template arguments, e.g. ``vspg_kernel<1,0,0,0>``,
    from its mangled name (the length-prefixed identifier ending in
    ``_kernel`` and the integer template arguments after it)."""
    import re

    i = 0
    while i < len(mangled):
        m = re.match(r"(\d+)", mangled[i:])
        if m is None:
            i += 1
            continue
        start = i + len(m.group(1))
        name = mangled[start:start + int(m.group(1))]
        i = start + len(name)
        if re.fullmatch(r"[A-Za-z_]\w*_kernel", name):
            rest = mangled[i:]
            args = []
            if rest.startswith("I"):
                args = re.findall(r"L\w(-?\d+)E", rest[:rest.find("EE") + 2])
            return name + (f"<{','.join(args)}>" if args else "")
    return mangled


def _ptxas_rows(log):
    """[(label, {"regs", "stack", "st", "ld"})] of every entry function in
    an ``-Xptxas -v`` log, in its order (``_kernel_label``)."""
    import re

    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {}
            rows.append((_kernel_label(m.group(1)), cur))
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), st=int(m.group(2)),
                       ld=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["regs"] = int(m.group(1))
            cur = None
    return rows


def _lowest_priority():
    """Run a build started beside the checks at the lowest CPU priority:
    the plain versions are bound by the host's dispatch, and the builds
    would take their cores."""
    import os

    os.nice(19)


# the builds started beside the checks and the CLI runs, stopped when the
# script ends
BACKGROUND = []


def _background(cmd):
    """Start a build beside the checks, at the lowest CPU priority, in a
    process group of its own (nvcc's compilers are its children)."""
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            preexec_fn=_lowest_priority,
                            start_new_session=True)
    BACKGROUND.append(proc)
    return proc


def _render_variant_cmd(out, flags):
    """The nvcc command that builds vspg.cu's render entry points alone
    (-DVSPG_RENDER_ONLY) with the extra nvcc `flags` into the shared
    library `out`, printing ptxas's registers and spills."""
    from vspg_pbrt_v4_tpu_torch.ops import _build

    return [_build._nvcc(), *_build.NVCC_FLAGS, "-DVSPG_RENDER_ONLY",
            *flags, "-Xptxas", "-v", "-shared", "-o", str(out),
            str(_build.CSRC / "vspg.cu")]


def _grid_variant_cmd(out, src, blocks, vote):
    """The nvcc command that builds one grid source alone at `blocks`
    minimum blocks an SM and warp vote `vote` into the shared library
    `out`, printing ptxas's registers and spills."""
    from vspg_pbrt_v4_tpu_torch.ops import _build

    return [_build._nvcc(), *_build.NVCC_FLAGS,
            f"-DVOLPATH_GRID_MIN_BLOCKS={blocks}",
            f"-DVOLPATH_GRID_VOTE={vote}", "-Xptxas", "-v",
            "-shared", "-o", str(out), str(_build.CSRC / src)]


def _shipped_grid_build(src):
    """The (minimum blocks an SM, warp vote) that grid source `src` ships
    with."""
    import re

    from vspg_pbrt_v4_tpu_torch.ops import _build

    text = (_build.CSRC / src).read_text()
    return tuple(int(re.search(rf"#define {m} (\d+)", text).group(1))
                 for m in ("VOLPATH_GRID_MIN_BLOCKS", "VOLPATH_GRID_VOTE"))


def _grid_items_check(label, c, spp, seed, tag, plain_items=None):
    """The grid kernel's per-item radiances on a grid cut to
    ITEMS_PER_THREAD or more items a thread against the plain per-item
    version at the same spp and seed (`plain_items`, computed when None):
    at least 0.9999 of items within 1e-3 relative or 1e-5 absolute. Prints
    the items the kernel reads as 0 where the plain version does not (a
    lost sample). Returns the plain items and the max abs difference."""
    from vspg_pbrt_v4_tpu_torch.ops import volpath_kernels as vk

    n = c.nx * c.ny * spp
    blocks = _check_blocks(n)
    k = vk.grid_items(c, seed, 0, spp, blocks=blocks)
    p = (vk.render_grid_items_plain(c, spp, seed) if plain_items is None
         else plain_items)
    torch.cuda.synchronize()
    diff = (k - p).abs()
    ok = ((diff <= 1e-3 * p.abs()) | (diff <= 1e-5)).all(-1)
    frac = ok.float().mean().item()
    zero = int(((k == 0).all(-1) & (p != 0).any(-1)).sum())
    bad = torch.nonzero(~ok.reshape(-1))[:, 0]
    first = ("none" if bad.numel() == 0 else
             f"(pixel {int(bad[0]) % (c.nx * c.ny)}, sample "
             f"{int(bad[0]) // (c.nx * c.ny)})")
    print(f"{label} per item ({blocks} blocks, {n / (blocks * 128):.1f} "
          f"items a thread): {frac:.6f} of {n} items within 1e-3, max abs "
          f"diff {diff.max().item():.3e}, {zero} items the kernel reads as 0 "
          f"where the plain version does not, first item off the bar "
          f"{first} {tag}", flush=True)
    assert frac >= 0.9999, (label, frac, zero, first)
    return p, diff.max().item()


def _grid_report(label, name, c, ms, bound, tag):
    """Print a grid render's persistent grid, the shipped build's registers
    and spills, its time beside the earlier one and its share of its
    bound; returns them as keys of its kernels-line entry."""
    from vspg_pbrt_v4_tpu_torch.ops import volpath_kernels as vk

    grid = vk.grid_info(c)
    geom = 0 if c.tris is None else (1 if c.nodes is None else 2)
    pt = PTXAS_GRID.get((geom,), {})
    chunks = -(-GRID_CELLS[name][1] // vk.chunk_samples(
        c.nx * c.ny, GRID_CELLS[name][1]))
    print(f"{label} {name} items: {grid['blocks']} blocks ({grid['per_sm']} "
          f"an SM on {grid['sms']} SMs), {grid['regs']} registers a thread, "
          f"spill stores {pt.get('st')} / loads {pt.get('ld')} bytes, "
          f"{grid['local_bytes']} bytes local, {chunks} chunks of samples; "
          f"{ms:.3f} ms against {EARLIER_MS[name]:.3f} ms before the "
          f"redesign ({EARLIER_MS[name] / ms:.3f}x); bound {bound:.4f} ms, "
          f"the kernel at {bound / ms:.5f} of it {tag}", flush=True)
    return dict(grid=[grid["blocks"], grid["per_sm"]], regs=grid["regs"],
                spill_bytes=pt.get("st"), chunks=chunks)


# The parity checks at 64^2 (7a, 8a, 9a, 12a) run with max_events cut to
# this (bench: 256): a pixel's cap of PARITY_EVENTS * 12 iterations a
# sample. A plain version steps its lanes in lockstep until the longest
# path ends, 20-45 ms of host dispatch an iteration, so the cap bounds its
# time (each check prints its lockstep iterations and seconds); kernel
# and plain version cap the same paths, and the pixels at the cap are
# held against the plain version's. The main paths' checks (7c, 8, 9d,
# 12c) run at the bench's max_events. Cut from 32 to 8 to make room for
# phase 19.
PARITY_EVENTS = 8


def _with_max_events(c, n):
    """Kernel constants `c` with max_events set to n."""
    from vspg_pbrt_v4_tpu_torch.ops.volpath_kernels import I_MAX_EVENTS

    ic = c.iconst.clone()
    ic[I_MAX_EVENTS] = n
    return dataclasses.replace(c, iconst=ic)


def _check_blocks(n_items):
    """Persistent blocks that give each thread of a check at least
    ITEMS_PER_THREAD items."""
    return max(1, n_items // (128 * ITEMS_PER_THREAD))


def _render_check(label, c, g, ftab, itab, spp, seed, check_parity,
                  counts=None, plain=None):
    """The render kernel on a grid cut to ITEMS_PER_THREAD or more items a
    thread against its per-pixel plain version at the same spp and seed
    (`counts` gathers the plain version's work); at 1 spp its items at the
    cap must be the plain version's pixels at the cap. `plain`, at 1 spp:
    (image, seconds) of the record check's plain run at the same seed,
    whose work `counts` holds. A training wave draws the render's paths,
    so train_wave_plain's image is render_vspg_plain's at 1 spp bit for
    bit (tests/test_torch_vspg_items.py), and one plain run serves both
    kernels. Returns (max abs difference, the plain version's seconds,
    items at the cap)."""
    from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk

    n = c.nx * c.ny * spp
    blocks = _check_blocks(n)
    k, cap = sk.render_vspg_items(c, g, ftab, itab, spp, seed, blocks=blocks)
    counts = {} if counts is None else counts
    if plain is not None:
        assert spp == 1, spp
        p, t_p = plain
    else:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = sk.render_vspg_plain(c, g, ftab, itab, spp, seed, counts)
        torch.cuda.synchronize()
        t_p = time.perf_counter() - t0
    at_cap = int(cap)
    max_abs = check_parity(
        f"{label} ({blocks} blocks, {n / (blocks * 128):.1f} items a thread, "
        f"{at_cap} items at the cap; plain {t_p:.1f} s"
        + (f", {counts['lockstep_iters']} lockstep iterations)"
           if "lockstep_iters" in counts else ")"), "vspg", k, p)
    if spp == 1:
        assert at_cap == counts["capped"], (label, at_cap, counts["capped"])
    return max_abs, t_p, at_cap


def _render_report(label, name, c, g, ms, bound, at_cap, tag):
    """Print a render launch's grid, the shipped build's registers and
    spills, its items at the cap, its time beside the earlier one and its
    share of its bound; returns them as keys of its kernels-line entry."""
    from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk

    grid = sk.render_grid(c, g)
    pt = PTXAS.get((0, int(g.ris), int(g.method), int(c.n_tri > 0)), {})
    print(f"{label} render launch: {grid['blocks']} blocks ({grid['per_sm']} "
          f"an SM on {grid['sms']} SMs), {grid['regs']} registers a thread, "
          f"spill stores {pt.get('st')} / loads {pt.get('ld')} bytes, "
          f"{at_cap} items at the cap; {ms:.3f} ms against "
          f"{EARLIER_MS[name]:.3f} ms before the redesign "
          f"({EARLIER_MS[name] / ms:.3f}x); bound {bound:.4f} ms, the kernel "
          f"at {bound / ms:.5f} of it {tag}", flush=True)
    return dict(grid=[grid["blocks"], grid["per_sm"]], regs=grid["regs"],
                spill_bytes=pt.get("st"), items_at_cap=at_cap)


def _main_path_calls(fn):
    """Run `fn` (one main-path call) from reset VSPG launch counters, with
    CUDA events around each kernel call and the render calls' items and the
    record launches' pixels at the cap gathered; returns (fn's result,
    seconds, launches, ms by variant, render items at the cap, record lanes
    at the cap summed over the waves)."""
    from vspg_pbrt_v4_tpu_torch.ops import volpath_kernels as vk
    from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk

    for counter in (vk.LAUNCHES, sk.LAUNCHES):
        for key in counter:
            counter[key] = 0
    sk.LAUNCH_EVENTS, sk.AT_CAP, sk.RECORD_AT_CAP = [], [], []
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        t_call = time.perf_counter() - t0
    finally:
        events, sk.LAUNCH_EVENTS = sk.LAUNCH_EVENTS, None
        caps, sk.AT_CAP = sk.AT_CAP, None
        rec_caps, sk.RECORD_AT_CAP = sk.RECORD_AT_CAP, None
    launches = dict(sk.LAUNCHES)
    assert all(v == 0 for v in vk.LAUNCHES.values()), vk.LAUNCHES
    # one event pair a kernel call; a render call at these sizes is one
    # chunk: one item kernel and one reduce
    renders = sum(v for k, v in launches.items()
                  if k.startswith("vspg_render"))
    assert launches["vspg_reduce"] == renders == len(caps), (launches, caps)
    assert len(events) == sum(launches.values()) - renders, (len(events),
                                                             launches)
    records = sum(v for k, v in launches.items()
                  if k.startswith("vspg_record"))
    assert len(rec_caps) == records, (launches, len(rec_caps))
    k_ms = {name: 0.0 for name in sk.LAUNCHES}
    for name, start, end in events:
        k_ms[name] += start.elapsed_time(end)
    return (out, t_call, launches, k_ms, sum(int(x) for x in caps),
            sum(int(x) for x in rec_caps))


def _launch_ms(fn):
    """Best of 3 warm runs of `fn`: the device ms of its VSPG kernel
    launches, by the wrappers' CUDA events around each launch
    (vspg_kernels.LAUNCH_EVENTS), and the host's seconds around the
    synchronised call; returns (ms, seconds, fn's result)."""
    from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk

    out = fn()
    best, best_s = float("inf"), float("inf")
    for _ in range(3):
        sk.LAUNCH_EVENTS = []
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            best_s = min(best_s, time.perf_counter() - t0)
            events = sk.LAUNCH_EVENTS
        finally:
            sk.LAUNCH_EVENTS = None
        best = min(best, sum(s.elapsed_time(e) for _, s, e in events))
    return best, best_s, out


def _record_check(label, c, g, ftab, itab, seed, check_parity, tag,
                  counts=None):
    """The record kernel on a grid cut to ITEMS_PER_THREAD or more pixels
    a thread (so that its lanes take several pixels from the counter)
    against train_wave_plain at the same seed: the image at the vspg bar,
    every record row at _rows_parity's, and the share of lanes whose image
    and every record row are bit for bit the plain version's (asserted 1);
    its pixels at the cap must be the plain version's (`counts` gathers the
    plain version's work). Returns (max abs row difference, the plain
    version's seconds, pixels at the cap, the plain version's record and
    image)."""
    from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk

    npix = c.nx * c.ny
    blocks = _check_blocks(npix)
    k, rk, cap = sk.train_wave_items(c, g, ftab, itab, seed, 6,
                                     blocks=blocks)
    counts = {} if counts is None else counts
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p, rp = sk.train_wave_plain(c, g, ftab, itab, seed, 6, counts)
    torch.cuda.synchronize()
    t_p = time.perf_counter() - t0
    at_cap = int(cap)
    same = ((k == p).all(-1).reshape(-1)
            & (rk == rp).all(0).all(0)).float().mean().item()
    check_parity(f"{label} image ({blocks} blocks, "
                 f"{npix / (blocks * 128):.1f} pixels a thread, {at_cap} "
                 f"pixels at the cap, {same:.5f} of lanes bit for bit in "
                 f"the image and every record row; plain {t_p:.1f} s, "
                 f"{counts['lockstep_iters']} lockstep iterations)", "vspg",
                 k, p)
    max_rec = _rows_parity(f"{label} rows", rk, rp, tag)
    assert at_cap == counts["capped"], (label, at_cap, counts["capped"])
    assert same == 1.0, (label, same)
    return max_rec, t_p, at_cap, rp, p


def _pair_check(label, name, c, g, ftab, itab, seed, check_parity, tag,
                counts=None, render_spp=None):
    """The record kernel (`name` the record's, e.g. "vspg_record_tris")
    and the render kernel at 1 spp, both against one plain run at the same
    seed (_record_check, then _render_check on its image); with
    `render_spp`, the render kernel at that many samples a pixel too,
    against a render_vspg_plain run of its own (its later samples and the
    ordered per-sample sum). `label` names the phase and case. Returns (max
    abs row difference, max abs image difference of the render at 1 spp,
    the plain run's seconds, the record's pixels at the cap, the plain
    version's record)."""
    counts = {} if counts is None else counts
    res = f"{c.nx}x{c.ny}x1"
    render = label.format(name.replace("record", "render"))
    max_rec, t_p, cap, rp, p = _record_check(
        f"{label.format(name)} {res}", c, g, ftab, itab, seed, check_parity,
        tag, counts)
    max_ren = _render_check(f"{render} {res}", c, g, ftab, itab, 1, seed,
                            check_parity, counts, plain=(p, t_p))[0]
    if render_spp is not None:
        _render_check(f"{render} {c.nx}x{c.ny}x{render_spp}", c, g, ftab,
                      itab, render_spp, seed, check_parity)
    return max_rec, max_ren, t_p, cap, rp


def _record_report(label, name, c, g, ms, wall_ms, bound, at_cap, counts,
                   tag):
    """Print a record launch's persistent grid, the shipped build's
    registers and spills, its pixels at the cap, its time beside the
    earlier one, its share of its bound and the longest path's iterations
    (the plain version's lockstep iterations, `counts`) with the kernel's
    time over them; returns them as keys of its kernels-line entry."""
    from vspg_pbrt_v4_tpu_torch.ops import volpath_kernels as vk
    from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk

    grid = sk.render_grid(c, g, variant="record")
    pt = PTXAS.get((1, int(g.ris), int(g.method), int(c.n_tri > 0)), {})
    longest = counts["lockstep_iters"]
    print(f"{label} record launch: {grid['blocks']} blocks "
          f"({grid['per_sm']} an SM on {grid['sms']} SMs), {grid['regs']} "
          f"registers a thread, spill stores {pt.get('st')} / loads "
          f"{pt.get('ld')} bytes, {at_cap} pixels at the cap; {ms:.3f} ms "
          f"by CUDA events around the launch ({wall_ms:.3f} ms the "
          f"synchronised call) against {EARLIER_MS[name]:.3f} ms before the "
          f"redesign (the call, {EARLIER_MS[name] / wall_ms:.3f}x); bound "
          f"{bound:.4f} ms, the kernel at {bound / ms:.5f} of it; the "
          f"longest path {longest} iterations of the cap's "
          f"{int(c.iconst[vk.I_MAX_EVENTS]) * 12}, the kernel "
          f"{ms * 1e3 / longest:.3f} us an iteration of it {tag}",
          flush=True)
    return dict(grid=[grid["blocks"], grid["per_sm"]], regs=grid["regs"],
                spill_bytes=pt.get("st"), call_ms=wall_ms,
                lanes_at_cap=at_cap,
                longest_path_iters=longest)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from vspg_pbrt_v4_tpu_torch.models.film import RGBFilm
    from vspg_pbrt_v4_tpu_torch.models.integrators import volpath
    from vspg_pbrt_v4_tpu_torch.models.lights import Lights
    from vspg_pbrt_v4_tpu_torch.models.materials import Materials
    from vspg_pbrt_v4_tpu_torch.models.media import GridMedium, Media
    from vspg_pbrt_v4_tpu_torch.models.shapes import Geometry
    from vspg_pbrt_v4_tpu_torch.ops import _build
    from vspg_pbrt_v4_tpu_torch.ops import volpath_kernels as vk

    dev = "cuda"
    card = _card()
    tag = f"[{card}]"
    print(f"phase 1 card: {card}", flush=True)

    # the VSPG kernel is shipped without FMA contraction, for parity with
    # its plain version; a render-only build with it, started alongside the
    # package's, times what that costs (phase 7c)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fma_lib = _build.BUILD_DIR / "libvspg_fma.so"
    with subprocess.Popen(
            _render_variant_cmd(fma_lib, []), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
            preexec_fn=_lowest_priority) as fma_build:
        _build.build(force=True, verbose=True)
        fma_log = fma_build.communicate()[0]
    assert fma_build.returncode == 0, fma_log
    _build.load()
    print(f"phase 2 build: nvcc {_build.last_build_seconds:.2f} s {tag}",
          flush=True)
    # every kernel's registers and spills, labelled by its name and
    # template arguments
    for label, v in _ptxas_rows(_build.last_build_log):
        PTXAS_ALL[label] = v
        print(f"phase 2 ptxas {label}: {v.get('regs')} registers, "
              f"{v.get('stack')} bytes stack frame, {v.get('st')} bytes spill "
              f"stores, {v.get('ld')} bytes spill loads {tag}", flush=True)
    PTXAS.update(_ptxas_table(_build.last_build_log))
    PTXAS_GRID.update(_ptxas_table(_build.last_build_log, GRID_ENTRY))
    assert len(PTXAS_GRID) == 3, PTXAS_GRID
    # phase 14's render-only builds of vspg.cu (the register-budget sweep)
    # compile while phases 3-13 run
    variants = {}
    for name, flags in SWEEP.items():
        out = _build.BUILD_DIR / f"libvspg_{name}.so"
        variants[name] = (_background(
            _render_variant_cmd(out, ["-fmad=false", *flags])), out)
    # phase 15's builds of each grid source at 2, 3 and 4 minimum blocks
    # with its shipped vote, and at its shipped budget with the vote flipped
    # (the shipped build is the package's own)
    for name, src in GRID_SOURCES.items():
        k0, v0 = _shipped_grid_build(src)
        for k, v in [(k, v0) for k in GRID_SWEEP] + [(k0, 1 - v0)]:
            if (k, v) == (k0, v0):
                continue
            out = _build.BUILD_DIR / f"lib{name}_min{k}_vote{v}.so"
            variants[name, k, v] = (_background(
                _grid_variant_cmd(out, src, k, v)), out)

    bench_cfg = volpath.VolPathConfig(max_depth=32, max_events=128,
                                      max_collisions=2048)
    plain = {"homog": vk.render_homog_plain, "grid": vk.render_grid_plain}

    def consts(scene, res, cfg=bench_cfg):
        c = vk.extract_constants(scene, vk.bench_camera(res, device=dev),
                                 RGBFilm.make((res, res), device=dev), cfg)
        assert c is not None, "bench scene not of a kernel's class"
        return c

    fog = vk.make_fog_box_scene(device=dev)
    cloud = vk.make_cloud64_scene(device=dev)

    # kernel against its plain version: least fraction of pixels within 1e-3
    # relative (or 1e-5 absolute), largest relative difference of the means;
    # the grid walk branches on more float compares, so it flips more pixels
    # (B2a: "grid"; B2b and B2c: "mesh", 0.9999 and 1e-5)
    tol = {"homog": (0.99, 1e-3), "grid": (0.98, 2e-3), "vspg": (0.98, 2e-3),
           "mesh": (0.9999, 1e-5), "surface": (0.99, 1e-3)}

    def check_parity(label, kind, k, p):
        frac, mean_rel, max_abs = _parity(k, p)
        print(f"{label}: {frac:.5f} of pixels within 1e-3, mean rel diff "
              f"{mean_rel:.3e}, max abs diff {max_abs:.3e} {tag}", flush=True)
        min_frac, mean_tol = tol[kind]
        assert frac >= min_frac and mean_rel <= mean_tol, (label, frac,
                                                          mean_rel)
        return max_abs

    # ---- phases 3-4: a quick first check of each kernel ---------------------
    for phase, kind, scene, spp in ((3, "homog", fog, 16),
                                    (4, "grid", cloud, 8)):
        c = consts(scene, 64)
        k = vk.render(c, spp, 11)
        p = plain[kind](c, spp, 11)
        torch.cuda.synchronize()
        check_parity(f"phase {phase} parity {kind} 64x64x{spp}", kind, k, p)

    # ---- phase 5: furnaces -------------------------------------------------
    fog_f = volpath.make_fog_box_scene([0.0] * 3, [1.0] * 3, g=0.0,
                                       env_L=[0.7] * 3, device=dev)
    img = vk.render(consts(fog_f, 64), 64, 1)
    m_fog = img.mean().item()
    x = np.linspace(-1, 1, 16)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    dens = np.clip(1.0 - np.sqrt(X**2 + Y**2 + Z**2), 0, 1).astype(
        np.float32) * 3.0
    gm = GridMedium.make(dens, [0.0] * 3, [2.0] * 3, (-1, -1, -1), (1, 1, 1),
                         g=0.0, maj_res=8, device=dev)
    cloud_f = volpath.Scene(
        Geometry.build(boxes=[dict(bmin=(-1, -1, -1), bmax=(1, 1, 1), mat=-1,
                                   light=-1, med_in=0, med_out=-1)],
                       device=dev),
        Materials.build([], device=dev), Media.make(grids=(gm,), device=dev),
        Lights.make(env_L=[0.6] * 3, world_radius=100.0, device=dev))
    img = vk.render(consts(cloud_f, 64, volpath.VolPathConfig(
        max_depth=16, max_events=64)), 64, 1)
    m_cloud = img.mean().item()
    print(f"phase 5 furnaces: fog mean {m_fog:.5f} (0.7 within 1%), cloud "
          f"mean {m_cloud:.5f} (0.6 within 2.5%) {tag}", flush=True)
    assert abs(m_fog - 0.7) / 0.7 < 0.01, m_fog
    # paths deeper than max_depth=16 hold ~1.2% of the furnace energy
    assert abs(m_cloud - 0.6) / 0.6 < 0.025, m_cloud

    kernels = _phase6(dev, tag, check_parity, bench_cfg, fog, cloud)

    print(f"phase 6 done {_at()}", flush=True)
    # each plain VSPG version steps every lane in lockstep (10-50 s a call
    # at 64^2 and more at 256^2), so the parity renders are cut to fit the
    # script in its 1200 s
    print("cuts: the parity checks of 7a, 8a, 9a and 12a at max_events "
          f"{PARITY_EVENTS} (bench: 256; 32 before phase 19); the render "
          "checks of 7a, 8a, 9a "
          "and 12a at 64x64x1 on their record checks' plain runs, as the 1 "
          "spp checks of 7c, 8 (NDS), 9d and 12c (was a plain run of their "
          "own), 7a's, 8a's and 9a's also at 64x64x2 on a plain run of "
          "their own (64x64x4 before); 8a NDS-RIS "
          "and NDS+-MIS only (was all four); 14b at 16 spp "
          "(was 64); NDS+ training 3 torch waves (bench: 48); phase 6 plain "
          "versions timed once (was best of 3); 10c's plain version on a "
          "256x128 crop of the 1920x1088x8 main path; 17a "
          f"scenes/cloud_vspg.pbrt at {P17_CLOUD_SPP} spp (was 8) and "
          f"maxdepth {P17_CLOUD_DEPTH} (the file's 32 and 32), 17b at "
          f"{P17_GUIDED_SPP} spp (was 8), 17c {P17_UNET_WAVES} training "
          f"waves + {P17_UNET_FROZEN} frozen spp (7c: 48 + 64; was 16 + 16), "
          f"17d at {P17_DENOISE_STEPS} steps (was 4 and 48, 4 and 16 "
          "before phase 21); 18b's plain "
          f"check of one block at 1 spp and max_events {PARITY_EVENTS} "
          "(bench: 256; 32 before phase 19); 18c's CLI renders at 64x64x16; "
          f"19's CLI renders at {P19_SPP} spp (was 16, 8 before phase "
          "21); phase 20's CLI renders and pairs at "
          f"{P20_SPP} spp (16 before phase 21); "
          f"20a's API pairs at {P20_PAIR_RES}^2 x {P20_SPP}; 20b as two "
          f"{P20_SPP // 2}-spp renders a sampler; 20e at {P20_PAIR_RES}^2 x "
          f"{P20_SPP // 2} (the fog box; phase 6: 256^2 x 64) and "
          f"{P20_VSPG_RES}^2 with {P20_VSPG_WAVES} training waves + "
          f"{P20_VSPG_WAVES} spp (the pyro cloud; 7c: 256^2, 48 + 64); "
          f"21c's gate renders at {P21_GATE_RES}^2, 1 spp, max_events 4",
          flush=True)
    k7, inputs7, route7 = _phase7(dev, tag, check_parity, fma_lib)
    kernels += k7
    print(f"phase 7 done {_at()}", flush=True)
    k8, inputs8 = _phase8(dev, tag, check_parity)
    kernels += k8
    print(f"phase 8 done {_at()}", flush=True)
    k9, inputs9 = _phase9(dev, tag, check_parity)
    kernels += k9
    print(f"phase 9 done {_at()}", flush=True)
    b2b_ms = next(k["ms"] for k in kernels if k["name"] == "volpath_grid_tris")
    kernels += _phase10(dev, tag, check_parity, b2b_ms)
    print(f"phase 10 done {_at()}", flush=True)
    kernels += _phase11(dev, tag, check_parity)
    print(f"phase 11 done {_at()}", flush=True)
    t12 = time.perf_counter()
    k12, inputs12 = _phase12(dev, tag, check_parity, inputs7)
    kernels += k12
    print(f"phase 12 done {_at()}, the phase {time.perf_counter() - t12:.1f} "
          "s", flush=True)
    t13 = time.perf_counter()
    kernels += _phase13(dev, tag)
    print(f"phase 13 done {_at()}, the phase {time.perf_counter() - t13:.1f} "
          "s", flush=True)
    _phase16(dev, tag)
    _phase17(dev, tag)
    _phase18(dev, tag, check_parity, kernels,
             {"vspg_render": inputs7, "vspg_render_nds": inputs8,
              "vspg_render_adaptive": inputs12}, route7)
    _phase19(dev, tag)
    _phase20(dev, tag)
    _phase21(dev, tag)
    t14 = time.perf_counter()
    _phase14(dev, tag, inputs7, inputs9, variants, check_parity)
    print(f"phase 14 done {_at()}, the phase {time.perf_counter() - t14:.1f} "
          "s", flush=True)
    t15 = time.perf_counter()
    _phase15(tag, variants, check_parity)
    print(f"phase 15 done {_at()}, the phase {time.perf_counter() - t15:.1f} "
          "s", flush=True)

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _group_check(label, kind, c, spp, group, check_parity):
    """B1's item sums in groups of `group` samples, or B5's per-sample
    radiances (`group` 1), on a grid cut to ITEMS_PER_THREAD or more items
    a thread against the plain per-sample version's group sums, at the
    kernel's bar; returns the max abs difference."""
    from vspg_pbrt_v4_tpu_torch.ops import surface_kernels as pk
    from vspg_pbrt_v4_tpu_torch.ops import volpath_kernels as vk

    n = c.nx * c.ny * -(-spp // group)
    blocks = _check_blocks(n)
    if kind == "homog":
        k = vk.homog_items(c, 5, 0, spp, group, blocks=blocks)
        p = vk.group_sums_plain(vk.render_homog_items_plain(c, spp, 5),
                                group)
    else:
        assert group == 1, group
        k = pk.surface_items(c, 5, 0, spp, blocks=blocks)
        p = pk.render_surface_items_plain(c, spp, 5)
    torch.cuda.synchronize()
    return check_parity(f"{label} per group of {group} samples ({blocks} "
                        f"blocks, {n / (blocks * 128):.1f} items a thread; "
                        "fractions of items)", kind, k, p)


def _group_report(label, name, kind, c, spp, ms, tag):
    """Print B1's or B5's grid, group, chunks, the shipped build's
    registers and spills; returns them as keys of its kernels-line
    entry."""
    from vspg_pbrt_v4_tpu_torch.ops import surface_kernels as pk
    from vspg_pbrt_v4_tpu_torch.ops import volpath_kernels as vk

    grid = (vk.homog_info(c) if kind == "homog" else pk.surface_info(c))
    npix = c.nx * c.ny
    group = (vk.group_size(npix, spp, grid["threads"]) if kind == "homog"
             else 1)
    chunks = -(-spp // vk.chunk_samples(npix, spp, group))
    label_k = ("volpath_homog_kernel" if kind == "homog" else
               f"path_surface_kernel<{int(c.has_point)},{int(c.has_env)}>")
    pt = PTXAS_ALL.get(label_k, {})
    print(f"{label} {name} items: {grid['blocks']} blocks ({grid['per_sm']} "
          f"an SM on {grid['sms']} SMs), {grid['regs']} registers a thread, "
          f"spill stores {pt.get('st')} / loads {pt.get('ld')} bytes, "
          f"{grid['local_bytes']} bytes local, groups "
          f"of {group} samples, {chunks} chunks; {ms:.4f} ms against "
          f"{EARLIER_MS[name]:.3f} ms for one thread a pixel "
          f"({EARLIER_NOTE[name]}) {tag}", flush=True)
    return dict(grid=[grid["blocks"], grid["per_sm"]], regs=grid["regs"],
                spill_bytes=pt.get("st"), K=group, chunks=chunks)


def _phase6(dev, tag, check_parity, cfg, fog, cloud):
    """Phase 6, the baseline arm's main paths at bench size through
    render_persistent: the fogbox at 256x256x64 (bench_config1) and at
    1920x1088x16 (bench_config5b's wave), both B1, and cloud64 at
    256x256x32 (B2a). For each: every launch count set to 0 just before
    one call and read just after (one item launch and one reduce a
    chunk), the call's time, the kernel's by CUDA events, the main path's
    image against the kernel's and two launches against each other bit for
    bit, the per-pixel plain version at the same shape (its counts give
    the bound), and for B1 each group's sum against the plain per-sample
    version's. Returns the kernels-line entries of B1 (with the 1080p
    wave's numbers) and B2a."""
    from vspg_pbrt_v4_tpu_torch.models.cameras import PerspectiveCamera
    from vspg_pbrt_v4_tpu_torch.models.film import RGBFilm
    from vspg_pbrt_v4_tpu_torch.models.integrators import volpath
    from vspg_pbrt_v4_tpu_torch.ops import surface_kernels as pk
    from vspg_pbrt_v4_tpu_torch.ops import volpath_kernels as vk
    from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk
    from vspg_pbrt_v4_tpu_torch.utils import transform as tr

    plain = {"homog": vk.render_homog_plain, "grid": vk.render_grid_plain}
    wave = PerspectiveCamera.make(
        tr.look_at((0, 0, -4), (0, 0, 0), (0, 1, 0), device=dev), 35.0,
        (1920, 1088), device=dev)
    cells = (("homog", "fogbox", fog, vk.bench_camera(256, device=dev), 64),
             ("homog", "fogbox 1080p", fog, wave, 16),
             ("grid", "cloud64", cloud, vk.bench_camera(256, device=dev),
              32))
    entries = {}
    for kind, name, scene, cam, spp in cells:
        nx, ny = cam.resolution
        film = RGBFilm.make((nx, ny), device=dev)
        c = vk.extract_constants(scene, cam, film, cfg)
        assert c is not None and c.kind == kind, name
        npix = nx * ny

        def run(scene=scene, cam=cam, film=film, spp=spp):
            return volpath.render_persistent(
                scene, cam, film, spp=spp, cfg=cfg, seed=5, backend="auto",
                device=dev)

        for counter in (vk.LAUNCHES, sk.LAUNCHES, pk.LAUNCHES):
            for key in counter:
                counter[key] = 0
        img = run()
        torch.cuda.synchronize()
        launches = {k: v for counter in (vk.LAUNCHES, sk.LAUNCHES,
                                         pk.LAUNCHES)
                    for k, v in counter.items() if v}
        group = (vk.group_size(npix, spp, vk.homog_info(c)["threads"])
                 if kind == "homog" else 1)
        chunks = -(-spp // vk.chunk_samples(npix, spp, group))
        assert launches == {kind: chunks, "vspg_reduce": chunks}, (
            name, launches)
        t_main, _ = _best_of_3(run)
        k_ms = _events_best_of_3(lambda: vk.render(c, spp, 5))
        k_img = vk.render(c, spp, 5)
        # the main path's image is the kernel's, and two launches agree
        assert torch.equal(img, k_img), name
        assert torch.equal(vk.render(c, spp, 5), k_img), name
        # the plain version timed once (it repeats the kernel's arithmetic
        # lane by lane and is no yardstick of speed)
        counts = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p_img = plain[kind](c, spp, 5, counts)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
        max_abs = check_parity(f"phase 6 parity {name} {nx}x{ny}x{spp}",
                               kind, k_img, p_img)
        if kind == "homog":
            max_abs = max(max_abs, _group_check(
                f"phase 6 {name} {nx}x{ny}x{spp}", kind, c, spp, group,
                check_parity))
        mean = img.mean().item()
        paths = npix * spp
        print(f"phase 6 {name} {nx}x{ny}x{spp} via render_persistent: "
              f"{paths / t_main / 1e6:.2f} Mpaths/s ({t_main * 1e3:.3f} ms "
              f"the call), kernel {paths / k_ms / 1e3:.2f} Mpaths/s "
              f"({k_ms:.4f} ms by CUDA events), plain "
              f"{paths / t_plain / 1e6:.3f} Mpaths/s ({t_plain * 1e3:.1f} "
              f"ms), mean {mean:.5f}, launches {launches} {tag}", flush=True)
        assert tuple(img.shape) == (ny, nx, 3)
        assert bool(torch.isfinite(img).all()) and mean > 0
        nbytes = _nbytes(c.fconst, c.iconst, k_img) + (
            _nbytes(c.density, c.majorant) if kind == "grid" else 0)
        bound, bound_by, pipes = _bound_ms(f"volpath_{kind}", counts, 1.0,
                                           nbytes)
        print(f"phase 6 {name} bound {bound:.4f} ms ({bound_by}; ms by "
              f"pipe {pipes}), kernel at {bound / k_ms:.4f} of it; counted "
              f"work {counts} {tag}", flush=True)
        if kind == "grid":
            GRID_CELLS["volpath_grid"] = (c, spp)
            extra = _grid_report("phase 6", "volpath_grid", c, k_ms, bound,
                                 tag)
        else:
            extra = _group_report("phase 6", f"volpath_homog {name}", kind,
                                  c, spp, k_ms, tag)
        entries[name] = dict(
            name=f"volpath_{kind}", route="cuda",
            source=f"vspg_pbrt_v4_tpu_torch/csrc/volpath_{kind}.cu",
            replaces=("vspg_pbrt_v4_tpu/ops/pallas_volpath.py:1045"
                      if kind == "homog" else
                      "vspg_pbrt_v4_tpu/ops/pallas_volpath.py:1380"),
            launches=launches[kind], max_abs_err=max_abs, ms=k_ms,
            plain_ms=t_plain * 1e3, bound_ms=bound,
            bound_pipe=max(pipes, key=pipes.get), bound_by=bound_by,
            library_ms=None, **extra)
    # B1's entry: the 256^2 x 64 main path, with the 1080p wave beside it
    b1 = entries["fogbox"]
    b1["wave_1080p"] = {k: entries["fogbox 1080p"][k] for k in (
        "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "grid", "K",
        "chunks")}
    return [b1, entries["cloud64"]]


def _phase7(dev, tag, check_parity, fma_lib):
    """Phase 7, the VSP-guided path: B4a and B3a against their plain
    versions in both direction modes (RIS, MIS), a guided furnace, then
    ``render_vspg`` on the bench's pyro cloud at 256^2. `fma_lib` is
    vspg.cu built with FMA contraction, timed against the shipped build.
    Returns the two kernels' entries of the kernels line, the render
    kernel's inputs at the main path's shape (phase 12 times B3d beside
    them) and the main path's (scene, camera, film, cfg, gopt, vopt,
    field, isgb) (phase 18a renders them sharded)."""
    from vspg_pbrt_v4_tpu_torch.models.film import RGBFilm
    from vspg_pbrt_v4_tpu_torch.models.integrators import guided_volpath
    from vspg_pbrt_v4_tpu_torch.models.integrators import volpath, vspg
    from vspg_pbrt_v4_tpu_torch.ops import _build
    from vspg_pbrt_v4_tpu_torch.ops import volpath_kernels as vk
    from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk

    # the configuration of bench.py's two VSPG cells (bench_config3/4)
    cfg = volpath.VolPathConfig(max_depth=64, max_events=256,
                                max_collisions=4096)
    gopt = guided_volpath.GuidingOptions(field_res=8, record_depth=6,
                                         min_train_weight=16.0,
                                         train_waves=48)
    vopt = vspg.VSPGOptions(vsp_criterion="contribution")
    pyro = sk.make_pyro64_scene(device=dev)

    def view(res):
        return (vk.bench_camera(res, device=dev),
                RGBFilm.make((res, res), device=dev))

    def trained(scene, res, waves, seed, vopt=vopt):
        cam, film = view(res)
        _, field, isgb = vspg.render_vspg(
            scene, cam, film, spp=waves, cfg=cfg,
            gopt=gopt._replace(train_waves=waves), vopt=vopt, seed=seed,
            device=dev)
        return field, isgb

    def inputs(scene, res, field, isgb, vopt=vopt, gopt=gopt):
        cam, film = view(res)
        return sk.kernel_inputs(scene, cam, film, cfg, gopt, vopt, field,
                                isgb)

    # ---- 7a: parity at 64^2 on a field trained by 4 kernel waves, in the
    # RIS variants (the main path's) and the MIS variants --------------------
    field, isgb = trained(pyro, 64, 4, 1)
    for mode in ("ris", "mis"):
        c, g, ftab, itab = inputs(pyro, 64, field, isgb,
                                  gopt=gopt._replace(mode=mode))
        assert g.ris == (mode == "ris")
        c = _with_max_events(c, PARITY_EVENTS)
        _pair_check(f"phase 7a parity {{}} ({mode})", "vspg_record", c, g,
                    ftab, itab, 21, check_parity, tag, render_spp=2)

    # ---- 7b: furnace (albedo 1): any guiding distribution keeps it exact --
    furnace = _guided_furnace(dev)
    f_field, f_isgb = trained(furnace, 64, 8, 3)
    assert f_field.iteration > 0 and f_isgb.ready
    m_f = sk.render_vspg_kernel(*inputs(furnace, 64, f_field, f_isgb), 64,
                                9).mean().item()
    print(f"phase 7b furnace: guided render mean {m_f:.5f} (0.7 within 3%), "
          f"field trained {f_field.iteration} waves {tag}", flush=True)
    assert abs(m_f - 0.7) / 0.7 < 0.03, m_f

    # ---- 7c: the main path at bench size ----------------------------------
    res, n_train, n_frozen = 256, 48, 64
    cam, film = view(res)
    npix = res * res
    # CUDA events around each kernel call of this call split its time (a
    # render call: the counters' memsets, the item kernel and the reduce)
    (img, field, isgb), t_main, launches, k_ms, cap_main, rcap_main = (
        _main_path_calls(lambda: vspg.render_vspg(
            pyro, cam, film, spp=n_train + n_frozen, cfg=cfg, gopt=gopt,
            vopt=vopt, seed=5, spp_per_pass=1, device=dev)))
    mean = img.mean().item()
    print(f"phase 7c render_vspg pyro64 {res}x{res} {n_train} training "
          f"waves + {n_frozen} frozen spp: {t_main:.3f} s, mean {mean:.5f}, "
          f"field iteration {field.iteration}, isgb ready {isgb.ready}, "
          f"launches {launches}, render items at the cap {cap_main}, record "
          f"lanes at the cap {rcap_main} (over the {n_train} waves) {tag}",
          flush=True)
    assert cap_main == 0 and rcap_main == 0, (cap_main, rcap_main)
    assert field.iteration == n_train and isgb.ready
    assert launches == dict({k: 0 for k in sk.LAUNCHES},
                            vspg_record=n_train, vspg_render=1,
                            vspg_reduce=1), launches
    assert tuple(img.shape) == (res, res, 3)
    assert bool(torch.isfinite(img).all()) and mean > 0
    rest_ms = t_main * 1e3 - k_ms["vspg_record"] - k_ms["vspg_render"]
    print(f"phase 7c split of that call: record kernel "
          f"{k_ms['vspg_record']:.3f} ms in {launches['vspg_record']} "
          f"launches ({k_ms['vspg_record'] / launches['vspg_record']:.3f} "
          f"ms each), render call {k_ms['vspg_render']:.3f} ms (the item "
          f"kernel and the reduce, {k_ms['vspg_render'] / (t_main * 1e3):.4f}"
          f" of the call), the rest (tables, propagate, EM, ISGB, launch "
          f"gaps) {rest_ms:.3f} ms of {t_main * 1e3:.3f} ms {tag}",
          flush=True)

    # the frozen render alone, through the main path's entry point
    def frozen(vopt, field, isgb):
        return vspg.render_vspg(pyro, cam, film, spp=n_frozen, cfg=cfg,
                                gopt=gopt, vopt=vopt, seed=7, field=field,
                                isgb=isgb, train=False, device=dev)[0]

    t_frozen, _ = _best_of_3(lambda: frozen(vopt, field, isgb))
    print(f"phase 7c frozen render {res}x{res}x{n_frozen} (contribution): "
          f"{npix * n_frozen / t_frozen / 1e6:.3f} Mpaths/s "
          f"({t_frozen * 1e3:.2f} ms) {tag}", flush=True)

    # each variant alone at the main path's shapes, and its plain version
    c, g, ftab, itab = inputs(pyro, res, field, isgb)
    ms_rk, t_rk, (img_rk, _) = _launch_ms(
        lambda: sk.train_wave_kernel(c, g, ftab, itab, 31, 6))
    # both variants against one plain run at 1 spp (its counts bound both)
    counts_r = {}
    max_rec, max_ren, t_rp, _, _ = _pair_check(
        "phase 7c parity {}", "vspg_record", c, g, ftab, itab, 31,
        check_parity, tag, counts_r)
    counts, t_p2 = counts_r, t_rp
    t_k64, k64 = _best_of_3(
        lambda: sk.render_vspg_kernel(c, g, ftab, itab, n_frozen, 11))
    # the same launch from the build with FMA contraction, then the shipped
    # build again, on the same inputs
    lib_fma = _build.bind(fma_lib, RENDER_NAMES)
    t_fma, (k64_fma, _) = _best_of_3(
        lambda: sk.render_vspg_items(c, g, ftab, itab, n_frozen, 11,
                                     lib=lib_fma))
    t_k64b, _ = _best_of_3(
        lambda: sk.render_vspg_kernel(c, g, ftab, itab, n_frozen, 11))
    frac_fma, mean_fma, _ = _parity(k64_fma, k64)
    print(f"phase 7c vspg_render {res}x{res}x{n_frozen} built with FMA "
          f"contraction {t_fma * 1e3:.3f} ms against the shipped -fmad=false "
          f"build {t_k64 * 1e3:.3f} ms before it and {t_k64b * 1e3:.3f} ms "
          f"after; its image: {frac_fma:.5f} of pixels within 1e-3 of the "
          f"shipped one, mean rel diff {mean_fma:.3e} {tag}", flush=True)
    spp_plain = 1  # keeps the plain version within a minute at 256^2
    t_k2, _ = _best_of_3(
        lambda: sk.render_vspg_kernel(c, g, ftab, itab, spp_plain, 11))
    print(f"phase 7c vspg_render kernel {res}x{res}x{n_frozen} "
          f"{t_k64 * 1e3:.3f} ms ({npix * n_frozen / t_k64 / 1e6:.3f} "
          f"Mpaths/s); at {spp_plain} spp kernel {t_k2 * 1e3:.3f} ms, plain "
          f"{t_p2 * 1e3:.1f} ms; counted work at {spp_plain} spp {counts} "
          f"{tag}", flush=True)
    print(f"phase 7c vspg_record kernel {res}x{res}x1 {ms_rk:.3f} ms (the "
          f"call {t_rk * 1e3:.3f} ms), plain {t_rp * 1e3:.1f} ms; counted "
          f"work {counts_r} {tag}", flush=True)

    # the variance-criterion cell (bench_config4): its own 48-wave training,
    # then its frozen render
    vopt_v = vspg.VSPGOptions(vsp_criterion="variance")
    field_v, isgb_v = trained(pyro, res, n_train, 5, vopt_v)
    t_fv, img_v = _best_of_3(lambda: frozen(vopt_v, field_v, isgb_v))
    assert field_v.iteration == n_train and isgb_v.ready
    assert bool(torch.isfinite(img_v).all()) and img_v.mean().item() > 0
    print(f"phase 7c frozen render {res}x{res}x{n_frozen} (variance): "
          f"{npix * n_frozen / t_fv / 1e6:.3f} Mpaths/s "
          f"({t_fv * 1e3:.2f} ms), mean {img_v.mean().item():.5f} {tag}",
          flush=True)

    src = "vspg_pbrt_v4_tpu_torch/csrc/vspg.cu"
    rep = "vspg_pbrt_v4_tpu/ops/pallas_vspg.py:241"
    ins_bytes = _nbytes(c.fconst, c.iconst, g.fconst, g.iconst, c.density,
                        c.majorant, ftab, itab)
    b_ren, by_ren, p_ren = _bound_ms("vspg", counts, n_frozen / spp_plain,
                                     ins_bytes + _nbytes(img))
    b_rec, by_rec, p_rec = _bound_ms(
        "vspg", counts_r, 1.0, ins_bytes + _nbytes(img)
        + sk.REC_ROWS * gopt.record_depth * npix * 4)
    print(f"phase 7c bounds: vspg_render {b_ren:.4f} ms ({by_ren}; ms by "
          f"pipe {p_ren}), kernel at {b_ren / (t_k64 * 1e3):.5f} of it; "
          f"vspg_record {b_rec:.4f} ms ({by_rec}; ms by pipe {p_rec}), "
          f"kernel at {b_rec / ms_rk:.5f} of it {tag}", flush=True)
    extra = _render_report("phase 7c", "vspg_render", c, g, t_k64 * 1e3,
                           b_ren, cap_main, tag)
    extra_r = _record_report("phase 7c", "vspg_record", c, g, ms_rk,
                             t_rk * 1e3, b_rec, rcap_main, counts_r, tag)
    return [
        dict(name="vspg_render", route="cuda", source=src, replaces=rep,
             launches=launches["vspg_render"], max_abs_err=max_ren,
             ms=t_k64 * 1e3, plain_ms=t_p2 * 1e3, bound_ms=b_ren,
             bound_pipe=max(p_ren, key=p_ren.get),
             bound_by=by_ren, library_ms=None, plain_spp=spp_plain, **extra),
        _reduce_entry(dev, npix, n_frozen,
                      n_frozen * int(c.iconst[vk.I_MAX_EVENTS]) * 12,
                      launches["vspg_reduce"], tag),
        dict(name="vspg_record", route="cuda", source=src, replaces=rep,
             launches=launches["vspg_record"], max_abs_err=max_rec,
             ms=ms_rk, plain_ms=t_rp * 1e3, bound_ms=b_rec,
             bound_pipe=max(p_rec, key=p_rec.get),
             bound_by=by_rec, library_ms=None, **extra_r),
    ], (c, g, ftab, itab), (pyro, cam, film, cfg, gopt, vopt, field, isgb)


def _reduce_entry(dev, npix, spp, max_iters, launches, tag):
    """The ordered sum (vspg_reduce) alone at the main path's shape and
    iteration cap, on a numpy-seeded (spp, npix, 3) radiance scratch and
    item iteration counts that bring about half the pixels past the cap
    (a few items stopped at it): bit for bit against its plain version,
    timed by CUDA events beside the plain version and, for scale, one
    torch.sum of the radiances (without the cap: no PyTorch call computes
    this function, so the entry has no library time); its kernels-line
    entry."""
    from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk

    rng = np.random.default_rng(12)
    L = torch.as_tensor(rng.lognormal(-3.0, 2.0, (spp, npix, 3)).astype(
        np.float32), device=dev)
    n_it = rng.integers(1, 2 * max_iters // spp, (spp, npix))
    n_it[rng.integers(0, spp, 64), rng.integers(0, npix, 64)] = max_iters + 1
    n_it = torch.as_tensor(n_it.astype(np.int32), device=dev)
    scale = 1.0 / spp
    k = sk.reduce_samples(L, n_it, max_iters, scale)
    t0 = time.perf_counter()
    p = sk.reduce_samples_plain(L, n_it, max_iters, scale)
    torch.cuda.synchronize()
    t_p = time.perf_counter() - t0
    same = torch.equal(k, p)
    cut = int((n_it.to(torch.int64).sum(0) > max_iters).sum())
    ms = _events_best_of_3(lambda: sk.reduce_samples(L, n_it, max_iters,
                                                     scale))
    sum_ms = _events_best_of_3(lambda: torch.sum(L, 0))
    # radiances and counts read once, the image and the carried counts
    # written once
    nbytes = _nbytes(L, n_it, k, k)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * L.numel() / FP32_INSTR_PER_S * 1e3
    bound = max(t_bytes, t_ops)
    by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"phase 7c vspg_reduce {spp}x{npix}x3 at a cap of {max_iters} "
          f"iterations ({cut} of {npix} pixels cut): bit for bit with its "
          f"plain version {same}; kernel {ms:.4f} ms, plain "
          f"{t_p * 1e3:.3f} ms, torch.sum without the cap {sum_ms:.4f} ms; "
          f"bound {bound:.4f} ms ({by}: {nbytes} bytes {t_bytes:.4f} ms, "
          f"{L.numel()} adds and as many count adds {t_ops:.5f} ms), kernel "
          f"at {bound / ms:.4f} of it {tag}", flush=True)
    assert same and 0 < cut < npix, (same, cut)
    return dict(name="vspg_reduce", route="cuda",
                source="vspg_pbrt_v4_tpu_torch/csrc/vspg.cu",
                replaces="vspg_pbrt_v4_tpu/ops/pallas_vspg.py:241",
                launches=launches, max_abs_err=(k - p).abs().max().item(),
                ms=ms, plain_ms=t_p * 1e3, bound_ms=bound, bound_by=by,
                bound_pipe="bytes" if by == "bytes" else "fp32",
                library_ms=None)


def _phase8(dev, tag, check_parity):
    """Phase 8, the NDS/NDS+ arm of the VSP-guided path: B4b and B3b
    against their plain versions (NDS and NDS+, RIS and MIS; NDS+ with a
    TrBuffer that varies per pixel), an NDS furnace, ``render_vspg`` on the
    pyro cloud at 256^2 under NDS (record kernel, then render kernel) and
    under NDS+ (torch waves, then the render kernel with the TrBuffer), and
    the kernel's frozen render against the torch wave's at 128^2 x 64 spp.
    Returns the kernels-line entries of B3b (NDS and NDS+, one each)
    and B4b, and the NDS render kernel's inputs at the main path's shape
    (phase 18 renders them in row blocks)."""
    from vspg_pbrt_v4_tpu_torch.models.film import RGBFilm
    from vspg_pbrt_v4_tpu_torch.models.integrators import guided_volpath
    from vspg_pbrt_v4_tpu_torch.models.integrators import volpath, vspg
    from vspg_pbrt_v4_tpu_torch.ops import volpath_kernels as vk
    from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk

    cfg = volpath.VolPathConfig(max_depth=64, max_events=256,
                                max_collisions=4096)
    gopt = guided_volpath.GuidingOptions(field_res=8, record_depth=6,
                                         min_train_weight=16.0,
                                         train_waves=48)
    v_res = vspg.VSPGOptions(vsp_criterion="contribution")
    v_nds = v_res._replace(sampling_method="nds")
    v_ndsp = v_res._replace(sampling_method="nds+")
    pyro = sk.make_pyro64_scene(device=dev)

    def view(res):
        return (vk.bench_camera(res, device=dev),
                RGBFilm.make((res, res), device=dev))

    def trained(scene, res, waves, seed, vopt):
        cam, film = view(res)
        _, field, isgb = vspg.render_vspg(
            scene, cam, film, spp=waves, cfg=cfg,
            gopt=gopt._replace(train_waves=waves), vopt=vopt, seed=seed,
            device=dev)
        return field, isgb

    def inputs(scene, res, field, isgb, vopt, gopt=gopt, tr=None):
        cam, film = view(res)
        return sk.kernel_inputs(scene, cam, film, cfg, gopt, vopt, field,
                                isgb, tr)

    def tr_buffer(res):
        """A TrBuffer varying per pixel in [0.3, 1], numpy-seeded."""
        rng = np.random.default_rng(8)
        return torch.as_tensor(rng.uniform(0.3, 1.0, (res * res, 3)).astype(
            np.float32), device=dev)

    # ---- 8a: parity at 64^2 on a field trained by 4 NDS kernel waves ------
    # NDS under RIS and NDS+ under MIS (both pairings run in
    # tests/test_torch_cuda.py)
    field, isgb = trained(pyro, 64, 4, 1, v_nds)
    for vopt, mode in ((v_nds, "ris"), (v_ndsp, "mis")):
        name = f"{vopt.sampling_method} {mode}"
        c, g, ftab, itab = inputs(pyro, 64, field, isgb, vopt,
                                  gopt._replace(mode=mode), tr_buffer(64))
        assert itab.shape[0] == (6 if vopt.sampling_method == "nds+"
                                 else 3)
        c = _with_max_events(c, PARITY_EVENTS)
        counts = {}
        _pair_check(f"phase 8a parity {{}} ({name})", "vspg_record", c, g,
                    ftab, itab, 21, check_parity, tag, counts, render_spp=2)
        assert counts["pre_steps"] > 0 and counts["draws"] > 0, counts

    # ---- 8b: furnace (albedo 1) under NDS ----------------------------------
    furnace = _guided_furnace(dev)
    f_field, f_isgb = trained(furnace, 64, 8, 3, v_nds)
    assert f_field.iteration > 0 and f_isgb.ready
    m_f = sk.render_vspg_kernel(*inputs(furnace, 64, f_field, f_isgb, v_nds),
                                64, 9).mean().item()
    print(f"phase 8b furnace: NDS render mean {m_f:.5f} (0.7 within 3%), "
          f"field trained {f_field.iteration} waves {tag}", flush=True)
    assert abs(m_f - 0.7) / 0.7 < 0.03, m_f

    # ---- 8c: the NDS main path at bench size -------------------------------
    res, n_train, n_frozen = 256, 48, 64
    cam, film = view(res)
    npix = res * res

    def main_path(vopt, waves, seed):
        """One render_vspg call from reset counters, split by CUDA events
        around each kernel call: (image, field, isgb, launches, seconds,
        kernel ms by variant, render items at the cap, record lanes at the
        cap over the waves)."""
        (img, field, isgb), t_call, launches, k_ms, cap, rcap = (
            _main_path_calls(lambda: vspg.render_vspg(
                pyro, cam, film, spp=waves + n_frozen, cfg=cfg,
                gopt=gopt._replace(train_waves=waves), vopt=vopt, seed=seed,
                spp_per_pass=1, device=dev)))
        assert field.iteration == waves and isgb.ready
        assert tuple(img.shape) == (res, res, 3)
        assert bool(torch.isfinite(img).all()) and img.mean().item() > 0
        return img, field, isgb, launches, t_call, k_ms, cap, rcap

    img, field_n, isgb_n, launches_n, t_n, k_n, cap_n, rcap_n = main_path(
        v_nds, n_train, 5)
    assert launches_n == dict({k: 0 for k in sk.LAUNCHES},
                              vspg_record=n_train, vspg_render=1,
                              vspg_reduce=1), launches_n
    rest = t_n * 1e3 - k_n["vspg_record"] - k_n["vspg_render"]
    print(f"phase 8c render_vspg nds pyro64 {res}x{res} {n_train} training "
          f"waves + {n_frozen} frozen spp: {t_n:.3f} s, mean "
          f"{img.mean().item():.5f}, launches {launches_n}, render items at "
          f"the cap {cap_n}, record lanes at the cap {rcap_n} (over the "
          f"{n_train} waves); split: record kernel {k_n['vspg_record']:.3f} "
          f"ms ({k_n['vspg_record'] / n_train:.3f} ms each), render call "
          f"{k_n['vspg_render']:.3f} ms "
          f"({k_n['vspg_render'] / (t_n * 1e3):.4f} of the call), the rest "
          f"(tables, propagate, EM, ISGB, launch "
          f"gaps) {rest:.3f} ms {tag}", flush=True)
    assert cap_n == 0 and rcap_n == 0, (cap_n, rcap_n)

    # ---- 8d: the NDS+ main path: torch waves, then the render kernel -------
    # the training waves are cut from 48 to a fixed 3, so that the call
    # fits in ~20 s (a torch wave took 2.7-7.2 s at 256^2 on an H100) and
    # the script, phase 9 included, inside its 1200 s
    n_plus = 3
    print(f"phase 8d NDS+ training cut to {n_plus} torch waves (bench: "
          f"{n_train}) {tag}", flush=True)
    seen = {}
    render_kernel = sk.render_vspg_kernel

    def spy(c, g, ftab, itab, spp, seed):
        seen["inputs"] = (c, g, ftab, itab)
        return render_kernel(c, g, ftab, itab, spp, seed)

    sk.render_vspg_kernel = spy
    try:
        img_p, _, _, launches_p, t_p, k_p, cap_p, rcap_p = main_path(
            v_ndsp, n_plus, 6)
    finally:
        sk.render_vspg_kernel = render_kernel
    assert launches_p == dict({k: 0 for k in sk.LAUNCHES},
                              vspg_render=1, vspg_reduce=1), launches_p
    inputs_p = seen["inputs"]
    tr = inputs_p[3][3:]
    assert inputs_p[3].shape[0] == 6 and bool(torch.isfinite(tr).all())
    assert bool(((tr >= 0) & (tr <= 1)).all()) and bool((tr < 1).any())
    rest_p = t_p * 1e3 - k_p["vspg_render"]
    print(f"phase 8d render_vspg nds+ pyro64 {res}x{res} {n_plus} training "
          f"waves + {n_frozen} frozen spp: {t_p:.3f} s, mean "
          f"{img_p.mean().item():.5f}, launches {launches_p}, render items "
          f"at the cap {cap_p}, ISGB rows "
          f"{inputs_p[3].shape[0]}, TrBuffer mean {tr.mean().item():.5f} min "
          f"{tr.min().item():.5f}; split: render kernel "
          f"{k_p['vspg_render']:.3f} ms, torch waves and the rest "
          f"{rest_p:.3f} ms ({rest_p / n_plus:.1f} ms a wave) {tag}",
          flush=True)
    assert cap_p == 0 and rcap_p == 0, (cap_p, rcap_p)

    # ---- 8e: the kernel's frozen render against the torch wave's ----------
    res_e, spp_e = 128, 64
    cam_e, film_e = view(res_e)
    field_e, isgb_e = trained(pyro, res_e, n_train, 7, v_res)
    for vopt in (v_res, v_nds):
        imgs = {}
        for backend in ("auto", "torch"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            imgs[backend] = vspg.render_vspg(
                pyro, cam_e, film_e, spp=spp_e, cfg=cfg, gopt=gopt,
                vopt=vopt, seed=11 if backend == "auto" else 12,
                spp_per_pass=spp_e, field=field_e, isgb=isgb_e, train=False,
                backend=backend, device=dev)[0]
            torch.cuda.synchronize()
            imgs[backend + "_s"] = time.perf_counter() - t0
        k_img, t_img = imgs["auto"], imgs["torch"]
        assert bool(torch.isfinite(t_img).all())
        diff = (k_img - t_img).mean(-1).reshape(-1).double()
        err = (diff.std() / np.sqrt(diff.numel())).item()
        m_k, m_t = k_img.mean().item(), t_img.mean().item()
        print(f"phase 8e frozen {vopt.sampling_method} {res_e}x{res_e}x"
              f"{spp_e}: kernel mean {m_k:.6f} ({imgs['auto_s']:.2f} s), "
              f"torch wave mean {m_t:.6f} ({imgs['torch_s']:.2f} s), "
              f"difference {m_k - m_t:+.6f} = "
              f"{(m_k - m_t) / err:+.2f} standard errors of the per-pixel "
              f"differences (bound 4) {tag}", flush=True)
        assert abs(m_k - m_t) <= 4.0 * err, (m_k, m_t, err)

    # ---- each NDS variant alone at the main path's shapes ------------------
    c, g, ftab, itab = inputs(pyro, res, field_n, isgb_n, v_nds)
    ms_rk, t_rk, (img_rk, _) = _launch_ms(
        lambda: sk.train_wave_kernel(c, g, ftab, itab, 11, 6))
    counts_r = {}
    max_rec, t_rp, _, _, img_rp = _record_check(
        f"phase 8 parity vspg_record (nds) {res}x{res}x1", c, g, ftab, itab,
        11, check_parity, tag, counts_r)
    src = "vspg_pbrt_v4_tpu_torch/csrc/vspg.cu"
    rep = "vspg_pbrt_v4_tpu/ops/pallas_vspg.py:241"

    def render_alone(method, c, g, ftab, itab, launches, cap, counts=None,
                     plain=None):
        """The render variant alone on one main path's inputs (`cap`: that
        call's items at the cap): 64 spp and 1 spp timed, held against its
        plain version at 1 spp (`plain` and `counts`: the record check's
        run on these inputs, as _render_check takes them), and bound by the
        plain version's counted work; its kernels-line entry."""
        t_k64, k64 = _best_of_3(
            lambda: sk.render_vspg_kernel(c, g, ftab, itab, n_frozen, 11))
        t_k1, _ = _best_of_3(
            lambda: sk.render_vspg_kernel(c, g, ftab, itab, 1, 11))
        counts = {} if counts is None else counts
        max_ren, t_p1, _ = _render_check(
            f"phase 8 parity vspg_render ({method}) {res}x{res}x1, "
            f"{itab.shape[0]} ISGB rows", c, g, ftab, itab, 1, 11,
            check_parity, counts, plain)
        b_ren, by_ren, p_ren = _bound_ms(
            "vspg", counts, n_frozen,
            _nbytes(c.fconst, c.iconst, g.fconst, g.iconst, c.density,
                    c.majorant, ftab, itab, k64))
        print(f"phase 8 vspg_render ({method}) kernel {res}x{res}x{n_frozen} "
              f"{t_k64 * 1e3:.3f} ms ({npix * n_frozen / t_k64 / 1e6:.3f} "
              f"Mpaths/s); at 1 spp kernel {t_k1 * 1e3:.3f} ms, plain "
              f"{t_p1 * 1e3:.1f} ms; counted work at 1 spp {counts}; bound "
              f"{b_ren:.4f} ms ({by_ren}; ms by pipe {p_ren}), kernel at "
              f"{b_ren / (t_k64 * 1e3):.5f} of it {tag}", flush=True)
        name = "vspg_render_" + method.replace("+", "p")
        extra = _render_report(f"phase 8 ({method})", name, c, g,
                               t_k64 * 1e3, b_ren, cap, tag)
        return dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=launches, max_abs_err=max_ren, ms=t_k64 * 1e3,
                    plain_ms=t_p1 * 1e3, bound_pipe=max(p_ren, key=p_ren.get),
                    bound_ms=b_ren, bound_by=by_ren, library_ms=None,
                    plain_spp=1, **extra)

    b_rec, by_rec, p_rec = _bound_ms(
        "vspg", counts_r, 1.0,
        _nbytes(c.fconst, c.iconst, g.fconst, g.iconst, c.density, c.majorant,
                ftab, itab, img_rk)
        + sk.REC_ROWS * gopt.record_depth * npix * 4)
    print(f"phase 8 vspg_record (nds) kernel {res}x{res}x1 "
          f"{ms_rk:.3f} ms (the call {t_rk * 1e3:.3f} ms), plain "
          f"{t_rp * 1e3:.1f} ms; counted work {counts_r}; bound "
          f"{b_rec:.4f} ms ({by_rec}; ms by pipe {p_rec}), kernel at "
          f"{b_rec / ms_rk:.5f} of it {tag}", flush=True)
    extra_r = _record_report("phase 8 (nds)", "vspg_record_nds", c, g,
                             ms_rk, t_rk * 1e3, b_rec, rcap_n, counts_r, tag)
    inputs_n = (c, g, ftab, itab)
    return [
        render_alone("nds", c, g, ftab, itab, launches_n["vspg_render"],
                     cap_n, counts_r, (img_rp, t_rp)),
        # NDS+ on the inputs its main path gave the kernel: the field its
        # torch waves trained and the 6-row ISGB table with their TrBuffer
        render_alone("nds+", *inputs_p, launches_p["vspg_render"], cap_p),
        dict(name="vspg_record_nds", route="cuda", source=src, replaces=rep,
             launches=launches_n["vspg_record"], max_abs_err=max_rec,
             ms=ms_rk, plain_ms=t_rp * 1e3, bound_ms=b_rec,
             bound_pipe=max(p_rec, key=p_rec.get),
             bound_by=by_rec, library_ms=None, **extra_r),
    ], inputs_n


def _phase9(dev, tag, check_parity):
    """Phase 9, the teaser class: the bench's 48 machine triangles (glass,
    metal, diffuse) in the pyro cloud. 9a holds B2b (volpath_grid_tris)
    and B3c/B4c (vspg_render_tris, vspg_record_tris) against their plain
    versions; 9b is a teaser furnace; 9c renders the volpath teaser cell
    through render_persistent at 1920x1088 x 8 spp, 9d the VSPG teaser cell
    through render_vspg at 128^2 (48 training waves, 64 frozen spp); 9e
    holds the frozen B3c render against the torch wave. Returns the three
    kernels' entries of the kernels line and 9d's render inputs (phase 14
    times B3c on them)."""
    from vspg_pbrt_v4_tpu_torch.models.cameras import PerspectiveCamera
    from vspg_pbrt_v4_tpu_torch.models.film import RGBFilm
    from vspg_pbrt_v4_tpu_torch.models.integrators import guided_volpath
    from vspg_pbrt_v4_tpu_torch.models.integrators import volpath, vspg
    from vspg_pbrt_v4_tpu_torch.models.lights import Lights
    from vspg_pbrt_v4_tpu_torch.models.materials import Materials
    from vspg_pbrt_v4_tpu_torch.models.media import GridMedium, Media
    from vspg_pbrt_v4_tpu_torch.models.shapes import Geometry
    from vspg_pbrt_v4_tpu_torch.ops import volpath_kernels as vk
    from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk
    from vspg_pbrt_v4_tpu_torch.utils import transform as tr

    # the configurations of bench.py's teaser lines: bench_config5m (the
    # volpath arm) and bench_config5v (the VSPG arm, its round-5 options)
    cfg_m = volpath.VolPathConfig(max_depth=24, max_events=128)
    cfg_v = volpath.VolPathConfig(max_depth=48, max_events=256,
                                  max_collisions=4096)
    gopt = guided_volpath.GuidingOptions(mode="mis", field_res=8,
                                         record_depth=6,
                                         min_train_weight=16.0,
                                         train_waves=48)
    vopt = vspg.VSPGOptions(vsp_criterion="contribution")
    machines = {m: vk.make_machines_scene(materials=m, device=dev)
                for m in ("smooth", "rough", "checker")}
    src_g = "vspg_pbrt_v4_tpu_torch/csrc/volpath_grid_tris.cu"
    src_v = "vspg_pbrt_v4_tpu_torch/csrc/vspg.cu"

    def view(res):
        return (vk.bench_camera(res, device=dev),
                RGBFilm.make((res, res), device=dev))

    def trained(scene, res, waves, seed, gopt=gopt):
        cam, film = view(res)
        _, field, isgb = vspg.render_vspg(
            scene, cam, film, spp=waves, cfg=cfg_v,
            gopt=gopt._replace(train_waves=waves), vopt=vopt, seed=seed,
            device=dev)
        return field, isgb

    def inputs(scene, res, field, isgb, vopt=vopt, gopt=gopt):
        cam, film = view(res)
        return sk.kernel_inputs(scene, cam, film, cfg_v, gopt, vopt, field,
                                isgb)

    # ---- 9a: parity ---------------------------------------------------------
    # B2b at 128^2 x 4 on the machines, with each material variant, at the
    # mesh bar; on the smooth machines (where the per-pixel -O3 build lost
    # warp 146 from its third sample on) per item too, and the image against
    # the ordered sum of the plain items
    cam, film = view(128)
    for name, scene in machines.items():
        c = vk.extract_constants(scene, cam, film, cfg_m)
        assert c.n_tri == 48
        k = vk.render(c, 4, 13)
        if name == "smooth":
            items, _ = _grid_items_check(
                "phase 9a parity volpath_grid_tris (smooth) 128x128x4", c, 4,
                13, tag)
            p = sk.reduce_samples_plain(items, None, 0, c.imaging_ratio / 4)
            p = p.reshape(k.shape)
        else:
            p = vk.render_grid_plain(c, 4, 13)
        torch.cuda.synchronize()
        check_parity(f"phase 9a parity volpath_grid_tris ({name}) 128x128x4",
                     "mesh", k, p)
    # B4c and B3c at 64^2 on a field trained by 8 kernel waves. Each plain
    # version takes 15-40 s here (it steps every lane in lockstep), so three
    # variants cover RIS and MIS, resampling and NDS, smooth and rough
    # surfaces; 9d holds the fourth pairing (smooth, MIS, resampling) at
    # the main path's shape
    fields = {name: trained(machines[name], 64, 8, 1)
              for name in ("smooth", "rough")}
    for name, mode, method in (("smooth", "ris", "nds"),
                               ("rough", "ris", "resampling"),
                               ("rough", "mis", "nds")):
        label = f"{name} {mode} {method}"
        c, g, ftab, itab = inputs(
            machines[name], 64, *fields[name],
            vopt._replace(sampling_method=method), gopt._replace(mode=mode))
        assert c.n_tri == 48 and g.n_tri == 48
        c = _with_max_events(c, PARITY_EVENTS)
        counts = {}
        _pair_check(f"phase 9a parity {{}} ({label})", "vspg_record_tris",
                    c, g, ftab, itab, 21, check_parity, tag, counts,
                    render_spp=2)
        assert counts["surface_events"] > 0, counts
    print(f"phase 9a done {_at()} {tag}", flush=True)

    # ---- 9b: teaser furnace -------------------------------------------------
    # energy-conserving surfaces (albedo-1 diffuse and mirror, glass) in a
    # scattering-only medium under a constant env of 0.7: the image is 0.7
    # but for the energy of paths deeper than max_depth 64
    x = np.linspace(-1, 1, 16)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    dens = np.clip(1.0 - np.sqrt(X**2 + Y**2 + Z**2), 0, 1).astype(
        np.float32) * 3.0
    gm = GridMedium.make(dens, [0.0] * 3, [2.0] * 3, (-1, -1, -1),
                         (1, 1, 1), g=0.3, maj_res=8, device=dev)
    furnace = volpath.Scene(
        Geometry.build(
            [dict(bmin=(-1, -1, -1), bmax=(1, 1, 1), mat=-1, light=-1,
                  med_in=0, med_out=-1)], vk.machine_tris(), device=dev),
        Materials.build([dict(type=0, albedo=(1.0,) * 3),
                         dict(type=2, eta=1.5),
                         dict(type=1, albedo=(1.0,) * 3)], device=dev),
        Media.make(grids=(gm,), device=dev),
        Lights.make(env_L=[0.7] * 3, world_radius=100.0, device=dev))
    cfg_f = volpath.VolPathConfig(max_depth=64, max_events=256)
    cam, film = view(64)
    m_g = vk.render(vk.extract_constants(furnace, cam, film, cfg_f), 64,
                    3).mean().item()
    f_field, f_isgb = trained(furnace, 64, 8, 3)
    c, g, ftab, itab = inputs(furnace, 64, f_field, f_isgb)
    m_v = sk.render_vspg_kernel(c, g, ftab, itab, 64, 9).mean().item()
    print(f"phase 9b teaser furnace: volpath_grid_tris mean {m_g:.5f}, "
          f"vspg_render_tris mean {m_v:.5f} (0.7 within 3%), field trained "
          f"{f_field.iteration} waves, {_at()} {tag}", flush=True)
    assert abs(m_g - 0.7) / 0.7 < 0.03 and abs(m_v - 0.7) / 0.7 < 0.03, \
        (m_g, m_v)

    # ---- 9c: the volpath teaser cell ----------------------------------------
    # bench_config5m with the 48-triangle proxy in place of the PLY mesh
    # (phase 10c renders the mesh): 1920x1088 x 8 spp
    nx, ny, spp_m = 1920, 1088, 8
    cam_m = PerspectiveCamera.make(
        tr.look_at((0, 0, -4), (0, 0, 0), (0, 1, 0), device=dev), 35.0,
        (nx, ny), device=dev)
    film_m = RGBFilm.make((nx, ny), device=dev)
    scene = machines["smooth"]

    def teaser_call():
        return volpath.render_persistent(scene, cam_m, film_m, spp=spp_m,
                                         cfg=cfg_m, seed=5, backend="auto",
                                         device=dev)

    for counter in (vk.LAUNCHES, sk.LAUNCHES):
        for key in counter:
            counter[key] = 0
    img = teaser_call()
    torch.cuda.synchronize()
    launches_m = dict(vk.LAUNCHES)
    launches_r = dict(sk.LAUNCHES)
    # one item launch and one ordered reduce a chunk of samples
    chunks = -(-spp_m // vk.chunk_samples(nx * ny, spp_m))
    assert launches_m == dict({k: 0 for k in vk.LAUNCHES},
                              grid_tris=chunks), launches_m
    assert launches_r == dict({k: 0 for k in sk.LAUNCHES},
                              vspg_reduce=chunks), launches_r
    t_call, _ = _best_of_3(teaser_call)
    c = vk.extract_constants(scene, cam_m, film_m, cfg_m)
    GRID_CELLS["volpath_grid_tris"] = (c, spp_m)
    t_k = _events_best_of_3(lambda: vk.render(c, spp_m, 5)) / 1e3
    k_img = vk.render(c, spp_m, 5)
    assert torch.equal(img, k_img)
    assert tuple(img.shape) == (ny, nx, 3) and bool(torch.isfinite(img).all())
    # the plain version at 1 spp on the same inputs (a minute at 8)
    k1 = vk.render(c, 1, 5)
    counts_m = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p1 = vk.render_grid_plain(c, 1, 5, counts_m)
    torch.cuda.synchronize()
    t_p1 = time.perf_counter() - t0
    max_m = check_parity(f"phase 9c parity volpath_grid_tris {nx}x{ny}x1",
                         "mesh", k1, p1)
    b_m, by_m, pipes_m = _bound_ms(
        "volpath_grid_tris", counts_m, spp_m,
        _nbytes(c.fconst, c.iconst, c.density, c.majorant, c.tris, c.mats,
                k_img))
    mpaths = nx * ny * spp_m / t_call / 1e6
    print(f"phase 9c volpath teaser machines pyro64 {nx}x{ny}x{spp_m} via "
          f"render_persistent: call {t_call * 1e3:.3f} ms ({mpaths:.3f} "
          f"Mpaths/s), kernel {t_k * 1e3:.3f} ms, mean "
          f"{img.mean().item():.5f}, launches {launches_m['grid_tris']} "
          f"item and {launches_r['vspg_reduce']} reduce, two runs equal; "
          f"plain at 1 spp {t_p1 * 1e3:.1f} ms, counted work at 1 spp "
          f"{counts_m}; bound {b_m:.4f} ms ({by_m}; ms by pipe {pipes_m}), "
          f"kernel at {b_m / (t_k * 1e3):.5f} of it, {_at()} {tag}",
          flush=True)
    extra_g = _grid_report("phase 9c", "volpath_grid_tris", c, t_k * 1e3,
                           b_m, tag)

    # ---- 9d: the VSPG teaser cell -------------------------------------------
    # bench_config5v: 128^2, 48 training waves through B4c, 64 frozen spp
    # through B3c, MIS and the contribution criterion
    res, n_train, n_frozen = 128, 48, 64
    cam, film = view(res)
    npix = res * res
    (img, field, isgb), t_v, launches_v, k_ms, cap_v, rcap_v = (
        _main_path_calls(lambda: vspg.render_vspg(
            scene, cam, film, spp=n_train + n_frozen, cfg=cfg_v, gopt=gopt,
            vopt=vopt, seed=5, spp_per_pass=1, device=dev)))
    assert launches_v == dict({k: 0 for k in sk.LAUNCHES},
                              vspg_record_tris=n_train,
                              vspg_render_tris=1, vspg_reduce=1), launches_v
    assert field.iteration == n_train and isgb.ready
    assert tuple(img.shape) == (res, res, 3)
    assert bool(torch.isfinite(img).all()) and img.mean().item() > 0
    rest = t_v * 1e3 - k_ms["vspg_record_tris"] - k_ms["vspg_render_tris"]
    n_surf = int((field.surface.stats_w.sum(-1) > 8.0).sum())
    print(f"phase 9d render_vspg teaser machines pyro64 {res}x{res} "
          f"{n_train} training waves + {n_frozen} frozen spp: {t_v:.3f} s, "
          f"mean {img.mean().item():.5f}, launches {launches_v}, render "
          f"items at the cap {cap_v}, record lanes at the cap {rcap_v} (over "
          f"the {n_train} waves), surface cells with data {n_surf}; "
          f"split: record kernel {k_ms['vspg_record_tris']:.3f} ms "
          f"({k_ms['vspg_record_tris'] / n_train:.3f} ms each), render call "
          f"{k_ms['vspg_render_tris']:.3f} ms "
          f"({k_ms['vspg_render_tris'] / (t_v * 1e3):.4f} of the call), the "
          f"rest (tables, propagate, EM, ISGB, launch gaps) {rest:.3f} ms "
          f"{tag}", flush=True)
    assert cap_v == 0 and rcap_v == 0, (cap_v, rcap_v)
    # each variant alone on the main path's inputs, and its plain version
    c, g, ftab, itab = inputs(scene, res, field, isgb)
    ms_rk, t_rk, (img_rk, _) = _launch_ms(
        lambda: sk.train_wave_kernel(c, g, ftab, itab, 31, 6))
    counts_r = {}
    max_rec, max_ren, t_rp, _, _ = _pair_check(
        "phase 9d parity {}", "vspg_record_tris", c, g, ftab, itab, 31,
        check_parity, tag, counts_r)
    counts, t_p1v = counts_r, t_rp
    t_k64, k64 = _best_of_3(
        lambda: sk.render_vspg_kernel(c, g, ftab, itab, n_frozen, 11))
    inputs9 = (c, g, ftab, itab)
    ins = _nbytes(c.fconst, c.iconst, g.fconst, g.iconst, c.density,
                  c.majorant, ftab, itab, c.tris, c.mats)
    b_ren, by_ren, p_ren = _bound_ms("vspg", counts, n_frozen,
                                     ins + _nbytes(k64))
    b_rec, by_rec, p_rec = _bound_ms(
        "vspg", counts_r, 1.0,
        ins + _nbytes(img_rk) + sk.REC_ROWS * gopt.record_depth * npix * 4)
    print(f"phase 9d vspg_render_tris kernel {res}x{res}x{n_frozen} "
          f"{t_k64 * 1e3:.3f} ms ({npix * n_frozen / t_k64 / 1e6:.3f} "
          f"Mpaths/s), plain at 1 spp {t_p1v * 1e3:.1f} ms, counted work at 1 "
          f"spp {counts}, bound {b_ren:.4f} ms ({by_ren}; ms by pipe "
          f"{p_ren}), kernel at {b_ren / (t_k64 * 1e3):.5f} of it; "
          f"vspg_record_tris kernel {res}x{res}x1 {ms_rk:.3f} ms (the call "
          f"{t_rk * 1e3:.3f} ms), plain {t_rp * 1e3:.1f} ms, counted work "
          f"{counts_r}, bound {b_rec:.4f} ms ({by_rec}; ms by pipe "
          f"{p_rec}), kernel at {b_rec / ms_rk:.5f} of it, {_at()} {tag}",
          flush=True)
    extra = _render_report("phase 9d", "vspg_render_tris", c, g,
                           t_k64 * 1e3, b_ren, cap_v, tag)
    extra_r = _record_report("phase 9d", "vspg_record_tris", c, g, ms_rk,
                             t_rk * 1e3, b_rec, rcap_v, counts_r, tag)

    # ---- 9e: the kernel's frozen render against the torch wave's ----------
    # both unbiased on the same field: their means agree within Monte Carlo
    # error; with rough surfaces too (guided in the torch wave, unguided in
    # the kernel: means only)
    res_e, spp_e = 64, 64
    cam_e, film_e = view(res_e)
    for name in ("smooth", "rough"):
        scene_e = machines[name]
        field_e, isgb_e = trained(scene_e, res_e, n_train, 7)
        imgs = {}
        for backend in ("auto", "torch"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            imgs[backend] = vspg.render_vspg(
                scene_e, cam_e, film_e, spp=spp_e, cfg=cfg_v, gopt=gopt,
                vopt=vopt, seed=11 if backend == "auto" else 12,
                spp_per_pass=spp_e, field=field_e, isgb=isgb_e, train=False,
                backend=backend, device=dev)[0]
            torch.cuda.synchronize()
            imgs[backend + "_s"] = time.perf_counter() - t0
        k_img, t_img = imgs["auto"], imgs["torch"]
        assert bool(torch.isfinite(t_img).all())
        diff = (k_img - t_img).mean(-1).reshape(-1).double()
        err = (diff.std() / np.sqrt(diff.numel())).item()
        m_k, m_t = k_img.mean().item(), t_img.mean().item()
        print(f"phase 9e frozen teaser ({name}) {res_e}x{res_e}x{spp_e}: "
              f"kernel mean {m_k:.6f} ({imgs['auto_s']:.2f} s), torch wave "
              f"mean {m_t:.6f} ({imgs['torch_s']:.2f} s), difference "
              f"{m_k - m_t:+.6f} = {(m_k - m_t) / err:+.2f} standard errors "
              f"of the per-pixel differences (bound 4), {_at()} {tag}",
              flush=True)
        assert abs(m_k - m_t) <= 4.0 * err, (name, m_k, m_t, err)

    rep_g = "vspg_pbrt_v4_tpu/ops/pallas_volpath.py:1380"
    rep_v = "vspg_pbrt_v4_tpu/ops/pallas_vspg.py:241"
    return [
        dict(name="volpath_grid_tris", route="cuda", source=src_g,
             replaces=rep_g, launches=launches_m["grid_tris"],
             max_abs_err=max_m, ms=t_k * 1e3, plain_ms=t_p1 * 1e3,
             bound_pipe=max(pipes_m, key=pipes_m.get),
             bound_ms=b_m, bound_by=by_m, library_ms=None, plain_spp=1,
             call_ms=t_call * 1e3, **extra_g),
        dict(name="vspg_render_tris", route="cuda", source=src_v,
             replaces=rep_v, launches=launches_v["vspg_render_tris"],
             max_abs_err=max_ren, ms=t_k64 * 1e3, plain_ms=t_p1v * 1e3,
             bound_pipe=max(p_ren, key=p_ren.get),
             bound_ms=b_ren, bound_by=by_ren, library_ms=None, plain_spp=1,
             **extra),
        dict(name="vspg_record_tris", route="cuda", source=src_v,
             replaces=rep_v, launches=launches_v["vspg_record_tris"],
             max_abs_err=max_rec, ms=ms_rk, plain_ms=t_rp * 1e3,
             bound_pipe=max(p_rec, key=p_rec.get),
             bound_ms=b_rec, bound_by=by_rec, library_ms=None, **extra_r),
    ], inputs9


def _phase10(dev, tag, check_parity, b2b_ms):
    """Phase 10, the mesh class: the bench's 3072-triangle PLY machines in
    the pyro cloud (bench_config5m). 10a holds B2c (volpath_grid_mesh)
    against its plain version, whose closest hit is a brute-force sweep of
    every triangle; 10b is a mesh furnace; 10c renders the cell through
    render_persistent at 1920x1088 x 8 spp, with the BVH's host build time
    and B2c's bound. `b2b_ms` is phase 9c's 48-triangle B2b time. Returns
    B2c's entry of the kernels line."""
    from vspg_pbrt_v4_tpu_torch.models.cameras import PerspectiveCamera
    from vspg_pbrt_v4_tpu_torch.models.film import RGBFilm
    from vspg_pbrt_v4_tpu_torch.models.integrators import volpath
    from vspg_pbrt_v4_tpu_torch.models.lights import Lights
    from vspg_pbrt_v4_tpu_torch.models.materials import Materials
    from vspg_pbrt_v4_tpu_torch.models.media import GridMedium, Media
    from vspg_pbrt_v4_tpu_torch.models.shapes import Geometry, build_tri_bvh
    from vspg_pbrt_v4_tpu_torch.ops import volpath_kernels as vk
    from vspg_pbrt_v4_tpu_torch.ops.bvh import bvh_traverse
    from vspg_pbrt_v4_tpu_torch.ops.intersect import ray_triangle
    from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk
    from vspg_pbrt_v4_tpu_torch.utils import transform as tr

    cfg = volpath.VolPathConfig(max_depth=24, max_events=128)
    nx, ny, spp = 1920, 1088, 8

    def view(w, h, fov):
        cam = PerspectiveCamera.make(
            tr.look_at((0, 0, -4), (0, 0, 0), (0, 1, 0), device=dev), fov,
            (w, h), device=dev)
        return cam, RGBFilm.make((w, h), device=dev)

    t0 = time.perf_counter()
    mesh = vk.make_machines_scene(mesh=True, device=dev)
    t_scene = time.perf_counter() - t0
    g = mesh.geometry
    assert g.n_tri == 3072 and g.tri_bvh is not None

    # ---- 10a: parity at the bench camera's aspect, and at 4 spp: the -O3
    # builds of B2b and B2c lost warps' samples from the third on (ROADMAP
    # C 1) -----------------------------------------------------------------
    # The 480x272x1 run also keeps the query rays of its plain version
    # (closest hits cut at the wall; shadow rays of the lanes with a light
    # sample, cut at the light) for 10c's bound.
    counts, rays = {}, {"_grid_event": [], "_nee": []}
    tri_hit = vk._tri_hit

    def keep_rays(tab, o, d, t_max):
        caller = sys._getframe(1)
        who = caller.f_code.co_name
        live = caller.f_locals["ok"] if who == "_nee" else slice(None)
        rays[who].append((o[live], d[live], t_max[live]))
        return tri_hit(tab, o, d, t_max)

    for name, (w, h), spp_a, fov in (("smooth", (480, 272), 1, 35.0),
                                     ("smooth", (128, 128), 4, 30.0),
                                     ("rough", (64, 64), 4, 30.0)):
        scene = (mesh if name == "smooth" else
                 vk.make_machines_scene(mesh=True, materials=name,
                                        device=dev))
        c = vk.extract_constants(scene, *view(w, h, fov), cfg)
        assert c.n_tri == 3072 and c.nodes is not None
        k = vk.render(c, spp_a, 5)
        first = not counts
        vk._tri_hit = keep_rays if first else tri_hit
        try:
            if name == "smooth" and spp_a == 4:
                # per item too where the per-pixel -O3 build lost warps
                items, max_i = _grid_items_check(
                    f"phase 10a parity volpath_grid_mesh (smooth) {w}x{h}x4",
                    c, 4, 5, tag)
                p = sk.reduce_samples_plain(items, None, 0,
                                            c.imaging_ratio / 4)
                p = p.reshape(k.shape)
            else:
                p = vk.render_grid_plain(c, spp_a, 5,
                                         counts if first else None)
        finally:
            vk._tri_hit = tri_hit
        torch.cuda.synchronize()
        max_abs = check_parity(f"phase 10a parity volpath_grid_mesh ({name}) "
                               f"{w}x{h}x{spp_a}", "mesh", k, p)
        if first:
            c_a, max_a = c, max_abs
    print(f"phase 10a plain version (brute force over 3072 triangles) "
          f"{c_a.nx}x{c_a.ny}x1 counted work {counts}, {_at()} {tag}",
          flush=True)

    # ---- 10b: mesh furnace: a white diffuse mesh in a scattering-only
    # cloud under a constant env of 0.7 -------------------------------------
    x = np.linspace(-1, 1, 16)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    dens = np.clip(1.0 - np.sqrt(X**2 + Y**2 + Z**2), 0, 1).astype(
        np.float32) * 3.0
    gm = GridMedium.make(dens, [0.0] * 3, [2.0] * 3, (-1, -1, -1),
                         (1, 1, 1), g=0.3, maj_res=8, device=dev)
    white = [dict(t, mat=0) for t in vk.machine_mesh_tris()]
    furnace = volpath.Scene(
        Geometry.build([dict(bmin=(-1, -1, -1), bmax=(1, 1, 1), mat=-1,
                             light=-1, med_in=0, med_out=-1)], white,
                       device=dev),
        Materials.build([dict(type=0, albedo=(1.0,) * 3)], device=dev),
        Media.make(grids=(gm,), device=dev),
        Lights.make(env_L=[0.7] * 3, world_radius=100.0, device=dev))
    cfg_f = volpath.VolPathConfig(max_depth=64, max_events=256)
    c_f = vk.extract_constants(furnace, vk.bench_camera(64, device=dev),
                               RGBFilm.make((64, 64), device=dev), cfg_f)
    assert c_f.nodes is not None
    m_f = vk.render(c_f, 64, 3).mean().item()
    print(f"phase 10b mesh furnace: volpath_grid_mesh mean {m_f:.5f} (0.7 "
          f"within 3%) {tag}", flush=True)
    assert abs(m_f - 0.7) / 0.7 < 0.03, m_f

    # ---- 10c: the volpath mesh cell (bench_config5m) ------------------------
    p0, p1, p2 = (t.cpu().numpy() for t in (g.tri_p0, g.tri_p1, g.tri_p2))
    t_bvh = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        bvh, builder = build_tri_bvh(p0, p1, p2, device="cpu")
        t_bvh = min(t_bvh, time.perf_counter() - t0)
    cam, film = view(nx, ny, 35.0)

    def call():
        return volpath.render_persistent(mesh, cam, film, spp=spp, cfg=cfg,
                                         seed=5, backend="auto", device=dev)

    for counter in (vk.LAUNCHES, sk.LAUNCHES):
        for key in counter:
            counter[key] = 0
    img = call()
    torch.cuda.synchronize()
    launches = dict(vk.LAUNCHES)
    launches_r = dict(sk.LAUNCHES)
    # one item launch and one ordered reduce a chunk of samples
    chunks = -(-spp // vk.chunk_samples(nx * ny, spp))
    assert launches == dict({k: 0 for k in vk.LAUNCHES},
                            grid_mesh=chunks), launches
    assert launches_r == dict({k: 0 for k in sk.LAUNCHES},
                              vspg_reduce=chunks), launches_r
    assert tuple(img.shape) == (ny, nx, 3) and bool(torch.isfinite(img).all())
    assert img.mean().item() > 0
    t_call, _ = _best_of_3(call)
    c = vk.extract_constants(mesh, cam, film, cfg)
    GRID_CELLS["volpath_grid_mesh"] = (c, spp)
    k_ms = _events_best_of_3(lambda: vk.render(c, spp, 5))
    assert torch.equal(img, vk.render(c, spp, 5))
    # B2c at the main path's 8 spp on its own inputs, against its plain
    # version on a crop over the machines (whole warps of 32 pixels)
    x0, y0, cw, ch = 832, 480, 256, 128
    yy, xx = torch.meshgrid(torch.arange(y0, y0 + ch, device=dev),
                            torch.arange(x0, x0 + cw, device=dev),
                            indexing="ij")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = vk.render_grid_plain(c, spp, 5, pixels=(yy * nx + xx).reshape(-1))
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    crop = (slice(y0, y0 + ch), slice(x0, x0 + cw))
    max_c = check_parity(f"phase 10c parity volpath_grid_mesh {cw}x{ch} "
                         f"crop of {nx}x{ny}x{spp}", "mesh", img[crop],
                         p[crop])
    # the bound: the plain version's counted work at 480x272x1 scaled to
    # the cell's paths; the BVH work is that of the very queries that run
    # made (closest hit cut at the wall, shadow rays cut at the light),
    # walked by the torch traversal, closest-hit and first-hit as the
    # kernel walks them (an estimate: another shape and spp)
    def closest_walk(o, d, t_max, walk):
        def leaf(pid, m, t_best, k):
            hit, t = ray_triangle(o, d, t_best, g.tri_p0[pid],
                                  g.tri_p1[pid], g.tri_p2[pid])[:2]
            return torch.where(m & hit, t, t_best), k
        bvh_traverse(g.tri_bvh, o, d, t_max, leaf, None, counts=walk)

    walks = {"_grid_event": {}, "_nee": {}}
    for who, walk in walks.items():
        o, d, t_max = (torch.cat(x) for x in zip(*rays[who]))
        if who == "_nee":
            g.intersect_p(o, d, t_max, counts=walk)
        else:
            closest_walk(o, d, t_max, walk)
    n_q = {"_grid_event": counts["tri_queries"],
           "_nee": counts["shadow_queries"]}
    assert all(sum(x[0].shape[0] for x in rays[w]) == n_q[w] for w in n_q)
    per_q = {w: {k: v / n_q[w] for k, v in walks[w].items()} for w in walks}
    work = dict(counts, queries=n_q["_grid_event"] + n_q["_nee"],
                **{k: walks["_grid_event"].get(k, 0) + walks["_nee"].get(k, 0)
                   for k in ("node_visits", "leaf_tests")})
    scale = nx * ny * spp / (c_a.nx * c_a.ny)
    bound, bound_by, pipes = _bound_ms(
        "volpath_grid_mesh", work, scale,
        _nbytes(c.fconst, c.iconst, c.density, c.majorant, c.tris, c.nodes,
                c.mats, img))
    print(f"phase 10c volpath mesh machines pyro64 {nx}x{ny}x{spp} via "
          f"render_persistent: call {t_call * 1e3:.3f} ms "
          f"({nx * ny * spp / t_call / 1e6:.3f} Mpaths/s), kernel "
          f"{k_ms:.3f} ms by CUDA events ({nx * ny * spp / k_ms / 1e3:.3f} "
          f"Mpaths/s), mean {img.mean().item():.5f}, launches "
          f"{launches['grid_mesh']} item and {launches_r['vspg_reduce']} "
          f"reduce, two runs equal; 3072 triangles, BVH of "
          f"{bvh.n_nodes} nodes built on the host by the {builder} builder "
          f"in {t_bvh * 1e3:.3f} ms (the scene in {t_scene * 1e3:.1f} ms); "
          f"a closest-hit query walks "
          f"{per_q['_grid_event'].get('node_visits', 0):.2f} nodes and tests "
          f"{per_q['_grid_event'].get('leaf_tests', 0):.2f} triangles, a "
          f"shadow query {per_q['_nee'].get('node_visits', 0):.2f} and "
          f"{per_q['_nee'].get('leaf_tests', 0):.2f}, on average; plain "
          f"version on the crop {t_plain * 1e3:.1f} ms; "
          f"bound {bound:.4f} ms ({bound_by}; ms by pipe {pipes}, an "
          f"estimate), kernel at {bound / k_ms:.5f} of it; phase 9c's "
          f"48-triangle B2b {b2b_ms:.3f} ms at the same shape, {_at()} {tag}",
          flush=True)
    extra = _grid_report("phase 10c", "volpath_grid_mesh", c, k_ms, bound,
                         tag)
    return [dict(name="volpath_grid_mesh", route="cuda",
                 source="vspg_pbrt_v4_tpu_torch/csrc/volpath_grid_mesh.cu",
                 replaces="vspg_pbrt_v4_tpu/ops/pallas_volpath.py:1380",
                 launches=launches["grid_mesh"],
                 max_abs_err=max(max_a, max_c, max_i),
                 ms=k_ms, plain_ms=t_plain * 1e3, bound_ms=bound,
                 bound_pipe=max(pipes, key=pipes.get),
                 bound_by=bound_by, library_ms=None, plain_spp=spp,
                 plain_shape=f"{cw}x{ch} crop of {nx}x{ny}",
                 call_ms=t_call * 1e3, **extra)]


def _phase11(dev, tag, check_parity):
    """Phase 11, the Cornell surface class in vacuum (bench_config6). 11a
    holds B5 (path_surface) against its per-pixel plain version and its
    (pixel, sample) items against the per-sample plain version on three
    scenes at
    4 spp (the grid header's -O3 builds lost warps from the third sample
    on); 11b is a floor furnace; 11c renders the bench line through
    render_persistent at 256x256x64 (every launch count set to 0 just
    before: one item launch and one reduce a chunk), holds it per pixel
    and per item against the plain versions at that shape, and checks
    the kernel's mean against the torch wavefront's. Returns B5's entry of
    the kernels line."""
    from vspg_pbrt_v4_tpu_torch.models.integrators import volpath
    from vspg_pbrt_v4_tpu_torch.ops import surface_kernels as pk
    from vspg_pbrt_v4_tpu_torch.ops import volpath_kernels as vk
    from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk

    cfg = volpath.VolPathConfig(max_depth=8, max_events=24)
    cornell = volpath.make_cornell_box_scene(device=dev)

    # ---- 11a: parity on the bench box, the box with every light type of
    # the class, and the floor, at 128x128x4 ---------------------------------
    res_a, spp_a = 128, 4
    max_a = 0.0
    for name, scene, eye, at in (
            ("cornell", cornell, pk.CORNELL_EYE, pk.CORNELL_AT),
            ("cornell lit", pk.make_cornell_lit_scene(device=dev),
             pk.CORNELL_EYE, pk.CORNELL_AT),
            ("floor", pk.make_floor_scene(device=dev), pk.FLOOR_EYE,
             pk.FLOOR_AT)):
        c = pk.extract_constants(scene, *pk.cornell_view(res_a, res_a, eye,
                                                         at, device=dev), cfg)
        assert c is not None, name
        k = pk.render_surface(c, spp_a, 5)
        p = pk.render_surface_plain(c, spp_a, 5)
        torch.cuda.synchronize()
        max_a = max(max_a, check_parity(
            f"phase 11a parity path_surface ({name}) {res_a}x{res_a}x{spp_a}",
            "surface", k, p))
        # per (pixel, sample) item
        max_a = max(max_a, _group_check(
            f"phase 11a path_surface ({name}) {res_a}x{res_a}x{spp_a}",
            "surface", c, spp_a, 1, check_parity))

    # ---- 11b: floor furnace: albedo (0.7, 0.5, 0.3) under a unit env ------
    res, spp = 256, 64
    c_f = pk.extract_constants(
        pk.make_floor_scene(device=dev),
        *pk.cornell_view(res, res, pk.FLOOR_EYE, pk.FLOOR_AT, device=dev), cfg)
    m_f = pk.render_surface(c_f, spp, 3).reshape(-1, 3).mean(0).tolist()
    print(f"phase 11b floor furnace {res}x{res}x{spp}: path_surface mean "
          f"{[round(v, 5) for v in m_f]} (0.7, 0.5, 0.3 within 1%) {tag}",
          flush=True)
    assert all(abs(m - a) / a < 0.01 for m, a in zip(m_f, (0.7, 0.5, 0.3))), \
        m_f

    # ---- 11c: the bench line path_cornell_surface_256x256x64spp -----------
    cam, film = pk.cornell_view(res, res, device=dev)

    def call():
        return volpath.render_persistent(cornell, cam, film, spp=spp, cfg=cfg,
                                         seed=5, lanes_per_pixel=1,
                                         backend="auto", device=dev)

    for counter in (vk.LAUNCHES, sk.LAUNCHES, pk.LAUNCHES):
        for key in counter:
            counter[key] = 0
    img = call()
    torch.cuda.synchronize()
    launches = {k: v for counter in (vk.LAUNCHES, sk.LAUNCHES, pk.LAUNCHES)
                for k, v in counter.items() if v}
    c = pk.extract_constants(cornell, cam, film, cfg)
    group = 1
    chunks = -(-spp // vk.chunk_samples(res * res, spp, group))
    # one item launch and one reduce a chunk, and nothing else
    assert launches == {"surface": chunks, "vspg_reduce": chunks}, launches
    assert tuple(img.shape) == (res, res, 3)
    assert bool(torch.isfinite(img).all()) and img.mean().item() > 0
    t_call, _ = _best_of_3(call)
    k_ms = _events_best_of_3(lambda: pk.render_surface(c, spp, 5))
    # the main path's image is the kernel's, and two launches agree
    assert torch.equal(img, pk.render_surface(c, spp, 5))
    assert torch.equal(img, pk.render_surface(c, spp, 5))
    # the plain version at the bench shape on the same inputs, timed once
    counts = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = pk.render_surface_plain(c, spp, 5, counts)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    max_c = check_parity(f"phase 11c parity path_surface {res}x{res}x{spp}",
                         "surface", img, p)
    max_c = max(max_c, _group_check(
        f"phase 11c path_surface {res}x{res}x{spp}", "surface", c, spp,
        group, check_parity))
    bound, bound_by, pipes = _bound_ms(
        "path_surface", counts, 1.0, _nbytes(c.fconst, c.tris, img))
    paths = res * res * spp
    print(f"phase 11c cornell surface {res}x{res}x{spp} via "
          f"render_persistent: call {t_call * 1e3:.3f} ms "
          f"({paths / t_call / 1e6:.3f} Mpaths/s), kernel {k_ms:.4f} ms by "
          f"CUDA events ({paths / k_ms / 1e3:.3f} Mpaths/s), mean "
          f"{img.mean().item():.5f}, launches {launches}; plain "
          f"version {t_plain * 1e3:.1f} ms; counted work {counts}; bound "
          f"{bound:.4f} ms ({bound_by}; ms by pipe {pipes}), kernel at "
          f"{bound / k_ms:.4f} of it, {_at()} {tag}", flush=True)

    # the kernel's mean against the torch wavefront's (each on its own
    # random stream and constants): Monte Carlo agreement
    res_e = 64
    cam_e, film_e = pk.cornell_view(res_e, res_e, device=dev)
    imgs = {}
    for backend, seed in (("auto", 11), ("torch", 12)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        imgs[backend] = volpath.render_persistent(
            cornell, cam_e, film_e, spp=spp, cfg=cfg, seed=seed,
            lanes_per_pixel=1, backend=backend, device=dev)
        torch.cuda.synchronize()
        imgs[backend + "_s"] = time.perf_counter() - t0
    k_img, t_img = imgs["auto"], imgs["torch"]
    assert bool(torch.isfinite(t_img).all())
    diff = (k_img - t_img).mean(-1).reshape(-1).double()
    err = (diff.std() / np.sqrt(diff.numel())).item()
    m_k, m_t = k_img.mean().item(), t_img.mean().item()
    print(f"phase 11c cornell {res_e}x{res_e}x{spp}: kernel mean {m_k:.6f} "
          f"({imgs['auto_s']:.2f} s), torch wavefront mean {m_t:.6f} "
          f"({imgs['torch_s']:.2f} s), difference {m_k - m_t:+.6f} = "
          f"{(m_k - m_t) / err:+.2f} standard errors of the per-pixel "
          f"differences (bound 4), {_at()} {tag}", flush=True)
    assert abs(m_k - m_t) <= 4.0 * err, (m_k, m_t, err)
    extra = _group_report("phase 11c", "path_surface", "surface", c, spp,
                          k_ms, tag)
    return [dict(name="path_surface", route="cuda",
                 source="vspg_pbrt_v4_tpu_torch/csrc/path_surface.cu",
                 replaces="vspg_pbrt_v4_tpu/ops/pallas_surface.py:195",
                 launches=launches["surface"], max_abs_err=max(max_a, max_c),
                 ms=k_ms, plain_ms=t_plain * 1e3, bound_ms=bound,
                 bound_pipe=max(pipes, key=pipes.get), bound_by=bound_by,
                 library_ms=None, **extra)]



def _phase12(dev, tag, check_parity, uniform_inputs):
    """Phase 12, the adaptive guiding field (B3d/B4d: the VSPG kernel's
    two-stage coarse-cell -> leaf lookup). 12a holds the record and render
    variants against their plain versions on refined fields (resampling
    RIS and MIS, NDS, the teaser machines); 12b is a guided furnace on an
    adaptive field; 12c runs the main path, ``render_vspg`` on the pyro
    cloud at 256^2 with 1024 extra leaves, split into the kernels, the
    refinement and the rest, and times B3d on its inputs beside B3a on
    phase 7c's uniform field (`uniform_inputs`); 12d holds the kernel's
    frozen render against the torch wave's. Returns the two adaptive
    kernels' entries of the kernels line and B3d's inputs at the main
    path's shape (phase 18 renders them in row blocks)."""
    from vspg_pbrt_v4_tpu_torch.models.film import RGBFilm
    from vspg_pbrt_v4_tpu_torch.models.guiding import field as gfield
    from vspg_pbrt_v4_tpu_torch.models.integrators import guided_volpath
    from vspg_pbrt_v4_tpu_torch.models.integrators import volpath, vspg
    from vspg_pbrt_v4_tpu_torch.ops import volpath_kernels as vk
    from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk

    # phase 7c's configuration (bench_config3) with the adaptive field on:
    # 1024 extra leaves (twice the 512 coarse cells), refinement at the
    # default threshold 256, at most 16 splits a wave
    cfg = volpath.VolPathConfig(max_depth=64, max_events=256,
                                max_collisions=4096)
    gopt = guided_volpath.GuidingOptions(field_res=8, record_depth=6,
                                         min_train_weight=16.0,
                                         train_waves=48, adaptive_extra=1024,
                                         refine_threshold=256.0)
    # the short trainings of 12a/12b refine from a mass of 16 (the JAX
    # package's kernel test), so that cells split within 4-8 waves
    gopt_short = gopt._replace(refine_threshold=16.0)
    vopt = vspg.VSPGOptions(vsp_criterion="contribution")
    C = 8 ** 3
    pyro = sk.make_pyro64_scene(device=dev)

    def view(res):
        return (vk.bench_camera(res, device=dev),
                RGBFilm.make((res, res), device=dev))

    def trained(scene, res, waves, seed, gopt=gopt_short, cfg=cfg):
        cam, film = view(res)
        _, field, isgb = vspg.render_vspg(
            scene, cam, film, spp=waves, cfg=cfg,
            gopt=gopt._replace(train_waves=waves), vopt=vopt, seed=seed,
            device=dev)
        assert field.n_leaves > C, ("no cell was refined", field.n_leaves)
        return field, isgb

    def inputs(scene, res, field, isgb, vopt=vopt, gopt=gopt, cfg=cfg):
        cam, film = view(res)
        return sk.kernel_inputs(scene, cam, film, cfg, gopt, vopt, field,
                                isgb)

    def child_lanes(field, rec):
        """Fraction of lanes with a recorded vertex in a refined cell's
        child leaf."""
        pos = rec[0:3].permute(2, 1, 0)  # (npix, D, 3)
        leaf = field.cell_id(pos)
        hit = ((leaf >= C) & (rec[7].T > 0)).any(-1)
        return hit.float().mean().item()

    # ---- 12a: parity on refined fields at 64^2 -----------------------------
    machines = vk.make_machines_scene(device=dev)
    cfg_t = volpath.VolPathConfig(max_depth=48, max_events=256,
                                  max_collisions=4096)
    field_c, isgb_c = trained(pyro, 64, 4, 1)
    field_t, isgb_t = trained(machines, 64, 4, 1, cfg=cfg_t)
    print(f"phase 12a refined fields: cloud {field_c.n_leaves} leaves "
          f"({int(field_c.refined.sum())} cells split), machines "
          f"{field_t.n_leaves} ({int(field_t.refined.sum())}) {tag}",
          flush=True)
    for label, scene, fld, mode, method in (
            ("ris", pyro, (field_c, isgb_c), "ris", "resampling"),
            ("mis", pyro, (field_c, isgb_c), "mis", "resampling"),
            ("nds ris", pyro, (field_c, isgb_c), "ris", "nds"),
            ("machines ris", machines, (field_t, isgb_t), "ris",
             "resampling")):
        c, g, ftab, itab = inputs(
            scene, 64, *fld, vopt._replace(sampling_method=method),
            gopt._replace(mode=mode), cfg_t if scene is machines else cfg)
        assert g.cells is not None and ftab.shape[1] == C + 1024
        c = _with_max_events(c, PARITY_EVENTS)
        counts = {}
        rec_p = _pair_check(f"phase 12a parity {{}} ({label})",
                            "vspg_record_adaptive", c, g, ftab, itab, 21,
                            check_parity, tag, counts)[4]
        lanes = child_lanes(fld[0], rec_p)
        share = counts["child_scatters"] / max(counts["scatters"], 1)
        print(f"phase 12a ({label}): {lanes:.4f} of record lanes reach a "
              f"refined cell's child leaf; {share:.4f} of the render's "
              f"scatter vertices resolve to one ({counts['child_scatters']} "
              f"of {counts['scatters']}) {tag}", flush=True)
        assert lanes > 0 and counts["child_scatters"] > 0
    print(f"phase 12a done {_at()} {tag}", flush=True)

    # ---- 12b: furnace (albedo 1) with the adaptive field -------------------
    furnace = _guided_furnace(dev)
    f_field, f_isgb = trained(furnace, 64, 8, 3)
    m_f = sk.render_vspg_kernel(*inputs(furnace, 64, f_field, f_isgb), 64,
                                9).mean().item()
    print(f"phase 12b furnace: adaptive guided render mean {m_f:.5f} (0.7 "
          f"within 3%), field trained {f_field.iteration} waves, "
          f"{f_field.n_leaves} leaves {tag}", flush=True)
    assert abs(m_f - 0.7) / 0.7 < 0.03, m_f

    # ---- 12c: the main path at bench size -----------------------------------
    res, n_train, n_frozen = 256, 48, 64
    cam, film = view(res)
    npix = res * res
    for counter in (vk.LAUNCHES, sk.LAUNCHES):
        for key in counter:
            counter[key] = 0
    refine_s = []
    refine = gfield.refine_field

    def timed_refine(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = refine(*a, **kw)
        torch.cuda.synchronize()
        refine_s.append(time.perf_counter() - t0)
        return out

    gfield.refine_field = timed_refine
    try:
        (img, field, isgb), t_main, launches, k_ms, cap_main, rcap_main = (
            _main_path_calls(lambda: vspg.render_vspg(
                pyro, cam, film, spp=n_train + n_frozen, cfg=cfg, gopt=gopt,
                vopt=vopt, seed=5, spp_per_pass=1, device=dev)))
    finally:
        gfield.refine_field = refine
    assert launches == dict({k: 0 for k in sk.LAUNCHES},
                            vspg_record_adaptive=n_train,
                            vspg_render_adaptive=1, vspg_reduce=1), launches
    assert field.iteration == n_train and isgb.ready
    assert field.n_leaves > C, field.n_leaves
    assert tuple(img.shape) == (res, res, 3)
    assert bool(torch.isfinite(img).all()) and img.mean().item() > 0
    rec_ms, ren_ms = k_ms["vspg_record_adaptive"], k_ms["vspg_render_adaptive"]
    ref_ms = sum(refine_s) * 1e3
    rest_ms = t_main * 1e3 - rec_ms - ren_ms
    print(f"phase 12c render_vspg adaptive pyro64 {res}x{res} {n_train} "
          f"training waves + {n_frozen} frozen spp: {t_main:.3f} s, mean "
          f"{img.mean().item():.5f}, {field.n_leaves} leaves after training "
          f"({int(field.refined.sum())} of {C} cells split), launches "
          f"{launches}, render items at the cap {cap_main}, record lanes at "
          f"the cap {rcap_main} (over the {n_train} waves) {tag}", flush=True)
    assert cap_main == 0 and rcap_main == 0, (cap_main, rcap_main)
    print(f"phase 12c split of that call: record kernel {rec_ms:.3f} ms in "
          f"{n_train} launches ({rec_ms / n_train:.3f} ms each), render "
          f"call {ren_ms:.3f} ms ({ren_ms / (t_main * 1e3):.4f} of the call), "
          f"the rest {rest_ms:.3f} ms of "
          f"{t_main * 1e3:.3f} ms, of it refine_field {ref_ms:.3f} ms in "
          f"{len(refine_s)} calls ({ref_ms / max(len(refine_s), 1):.3f} ms "
          f"a wave) {tag}", flush=True)

    # B3d on this call's inputs beside B3a on phase 7c's uniform field, in
    # turns, then each variant against its plain version at 1 spp
    c, g, ftab, itab = inputs(pyro, res, field, isgb)
    inputs_ad = (c, g, ftab, itab)
    t_ad, t_un = [], []
    for first in (True, False):
        order = ((t_ad, (c, g, ftab, itab)), (t_un, uniform_inputs))
        for acc, args in (order if first else order[::-1]):
            acc.append(_best_of_3(lambda args=args: sk.render_vspg_kernel(
                *args, n_frozen, 11))[0])
    t_k64, t_u64 = min(t_ad), min(t_un)
    print(f"phase 12c vspg_render {res}x{res}x{n_frozen}: adaptive field "
          f"{t_k64 * 1e3:.3f} ms ({npix * n_frozen / t_k64 / 1e6:.3f} "
          f"Mpaths/s), phase 7c's uniform field {t_u64 * 1e3:.3f} ms, in "
          f"turns {[round(t * 1e3, 3) for t in t_ad]} / "
          f"{[round(t * 1e3, 3) for t in t_un]} {tag}", flush=True)
    # the two fields' paths differ; the switch's own cost: phase 7c's
    # inputs with the switch on and an identity indirection (no cell
    # refined), which reads the same leaves and draws the same image
    c7, g7, ftab7, itab7 = uniform_inputs
    ident = torch.zeros((3, C), dtype=torch.int32, device=dev)
    ident[0] = torch.arange(C, device=dev)
    gi7 = g7.iconst.clone()
    gi7[sk.GI_NEXTRA] = 1
    g_id = dataclasses.replace(g7, iconst=gi7, cells=ident)
    t_sw, t_off = [], []
    for first in (True, False):
        order = ((t_off, g7), (t_sw, g_id))
        for acc, gg in (order if first else order[::-1]):
            acc.append(_best_of_3(lambda gg=gg: sk.render_vspg_kernel(
                c7, gg, ftab7, itab7, n_frozen, 11)))
    assert torch.equal(t_sw[0][1], t_off[0][1])
    sw_ms, off_ms = (min(t for t, _ in v) * 1e3 for v in (t_sw, t_off))
    print(f"phase 12c the adaptive switch alone on phase 7c's inputs at "
          f"{res}x{res}x{n_frozen} (identity indirection, the same image): "
          f"{sw_ms:.3f} ms against {off_ms:.3f} ms without, "
          f"{(sw_ms / off_ms - 1) * 100:+.2f}%, in turns "
          f"{[round(t * 1e3, 3) for t, _ in t_off]} / "
          f"{[round(t * 1e3, 3) for t, _ in t_sw]} {tag}", flush=True)
    t_k1, _ = _best_of_3(lambda: sk.render_vspg_kernel(c, g, ftab, itab, 1,
                                                       11))
    ms_rk, t_rk, (img_rk, _) = _launch_ms(
        lambda: sk.train_wave_kernel(c, g, ftab, itab, 31, 6))
    counts_r = {}
    max_rec, max_ren, t_rp, _, _ = _pair_check(
        "phase 12c parity {}", "vspg_record_adaptive", c, g, ftab, itab, 31,
        check_parity, tag, counts_r)
    counts, t_p1 = counts_r, t_rp
    ins_bytes = _nbytes(c.fconst, c.iconst, g.fconst, g.iconst, g.cells,
                        c.density, c.majorant, ftab, itab)
    b_ren, by_ren, p_ren = _bound_ms("vspg", counts, n_frozen,
                                     ins_bytes + _nbytes(img))
    b_rec, by_rec, p_rec = _bound_ms(
        "vspg", counts_r, 1.0, ins_bytes + _nbytes(img)
        + sk.REC_ROWS * gopt.record_depth * npix * 4)
    print(f"phase 12c vspg_render_adaptive at 1 spp kernel "
          f"{t_k1 * 1e3:.3f} ms, plain {t_p1 * 1e3:.1f} ms; counted work "
          f"{counts}; bound at {n_frozen} spp {b_ren:.4f} ms ({by_ren}; ms "
          f"by pipe {p_ren}), kernel at {b_ren / (t_k64 * 1e3):.5f} of it "
          f"{tag}", flush=True)
    print(f"phase 12c vspg_record_adaptive kernel {res}x{res}x1 "
          f"{ms_rk:.3f} ms a wave (the call {t_rk * 1e3:.3f} ms), plain "
          f"{t_rp * 1e3:.1f} ms; counted work {counts_r}; bound "
          f"{b_rec:.4f} ms ({by_rec}; ms by pipe {p_rec}), kernel at "
          f"{b_rec / ms_rk:.5f} of it {tag}", flush=True)
    extra = _render_report("phase 12c", "vspg_render_adaptive", c, g,
                           t_k64 * 1e3, b_ren, cap_main, tag)
    extra_r = _record_report("phase 12c", "vspg_record_adaptive", c, g,
                             ms_rk, t_rk * 1e3, b_rec, rcap_main, counts_r,
                             tag)

    # ---- 12d: the kernel's frozen render against the torch wave's ---------
    res_e, spp_e = 128, 64
    cam_e, film_e = view(res_e)
    field_e, isgb_e = trained(pyro, res_e, n_train, 7, gopt)
    imgs = {}
    for backend in ("auto", "torch"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        imgs[backend] = vspg.render_vspg(
            pyro, cam_e, film_e, spp=spp_e, cfg=cfg, gopt=gopt, vopt=vopt,
            seed=11 if backend == "auto" else 12, spp_per_pass=spp_e,
            field=field_e, isgb=isgb_e, train=False, backend=backend,
            device=dev)[0]
        torch.cuda.synchronize()
        imgs[backend + "_s"] = time.perf_counter() - t0
    k_img, t_img = imgs["auto"], imgs["torch"]
    assert bool(torch.isfinite(t_img).all())
    diff = (k_img - t_img).mean(-1).reshape(-1).double()
    err = (diff.std() / np.sqrt(diff.numel())).item()
    m_k, m_t = k_img.mean().item(), t_img.mean().item()
    print(f"phase 12d frozen adaptive {res_e}x{res_e}x{spp_e} "
          f"({field_e.n_leaves} leaves): kernel mean {m_k:.6f} "
          f"({imgs['auto_s']:.2f} s), torch wave mean {m_t:.6f} "
          f"({imgs['torch_s']:.2f} s), difference {m_k - m_t:+.6f} = "
          f"{(m_k - m_t) / err:+.2f} standard errors of the per-pixel "
          f"differences (bound 4) {tag}", flush=True)
    assert abs(m_k - m_t) <= 4.0 * err, (m_k, m_t, err)

    src = "vspg_pbrt_v4_tpu_torch/csrc/vspg.cu"
    rep = "vspg_pbrt_v4_tpu/ops/pallas_vspg.py:241"
    return [
        dict(name="vspg_render_adaptive", route="cuda", source=src,
             replaces=rep, launches=launches["vspg_render_adaptive"],
             max_abs_err=max_ren, ms=t_k64 * 1e3, plain_ms=t_p1 * 1e3,
             bound_ms=b_ren, bound_pipe=max(p_ren, key=p_ren.get),
             bound_by=by_ren, library_ms=None, plain_spp=1,
             uniform_field_ms=t_u64 * 1e3, switch_off_ms=off_ms,
             switch_on_ms=sw_ms, **extra),
        dict(name="vspg_record_adaptive", route="cuda", source=src,
             replaces=rep, launches=launches["vspg_record_adaptive"],
             max_abs_err=max_rec, ms=ms_rk, plain_ms=t_rp * 1e3,
             bound_ms=b_rec, bound_pipe=max(p_rec, key=p_rec.get),
             bound_by=by_rec, library_ms=None, **extra_r),
    ], inputs_ad


def _phase14(dev, tag, inputs7, inputs9, variants, check_parity):
    """Phase 14, the VSPG kernel's register budgets and its iteration cap.
    14a: the render-only builds of vspg.cu at 2, 3 and 4 minimum blocks an
    SM (`variants`, started after phase 2; ptxas's registers and spills of
    each) time B3a on phase 7c's inputs and B3c on phase 9d's at 64 spp in
    turns, each image held bit for bit against the shipped build's, and
    again with max_events cut to max_events / spp, which caps each item at
    one sample's budget and so leaves out the capped items' long tails (a
    time only: the pixel's cap then cuts samples, and the image differs).
    14b: on the same inputs with max_events cut to 1 (a pixel's cap of 192
    iterations at 16 spp, which cuts samples in many pixels), the kernel at
    16 spp and ITEMS_PER_THREAD items a thread against its per-pixel plain
    version on a crop of two rows through the image's middle."""
    from vspg_pbrt_v4_tpu_torch.ops import _build
    from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk
    from vspg_pbrt_v4_tpu_torch.ops.volpath_kernels import I_MAX_EVENTS

    libs = {}
    for name, (proc, out) in variants.items():
        if name not in SWEEP:  # phase 15's grid builds
            continue
        log = proc.communicate()[0]
        assert proc.returncode == 0, (name, log[-4000:])
        libs[name] = _build.bind(out, RENDER_NAMES)
        for key, v in sorted(_ptxas_table(log).items()):
            print(f"phase 14a ptxas {name} ris={key[1]} method={key[2]} "
                  f"tris={key[3]}: {v.get('regs')} registers, "
                  f"{v.get('stack')} bytes stack frame, {v.get('st')} bytes "
                  f"spill stores, {v.get('ld')} bytes spill loads {tag}",
                  flush=True)

    n_frozen = 64
    cells = (("B3a", inputs7), ("B3c", inputs9))
    for label, (c, g, ftab, itab) in cells:
        ref, ref_cap = sk.render_vspg_items(c, g, ftab, itab, n_frozen, 11)
        c1 = _with_max_events(c, max(1, int(c.iconst[I_MAX_EVENTS])
                                    // n_frozen))
        cap_iters = (int(c.iconst[I_MAX_EVENTS]) * n_frozen * 12,
                     int(c1.iconst[I_MAX_EVENTS]) * n_frozen * 12)
        times = {(k, cut): [] for k in SWEEP for cut in (0, 1)}
        same, caps = {}, {}
        for order in (list(SWEEP), list(SWEEP)[::-1]):
            for k in order:
                for cut, cc in ((0, c), (1, c1)):
                    t, (img, cap) = _best_of_3(
                        lambda k=k, cc=cc: sk.render_vspg_items(
                            cc, g, ftab, itab, n_frozen, 11, lib=libs[k]))
                    times[k, cut].append(round(t * 1e3, 3))
                    same[k, cut] = (img == ref).all(-1).float().mean().item()
                    caps[k, cut] = int(cap)
        for k in SWEEP:
            grid = sk.render_grid(c, g, lib=libs[k])
            print(f"phase 14a sweep {label} {c.nx}x{c.ny}x{n_frozen} {k}: "
                  f"{grid['blocks']} blocks ({grid['per_sm']} an SM), "
                  f"{grid['regs']} registers, {grid['local_bytes']} bytes "
                  f"local a thread; at the pixel's cap of {cap_iters[0]} "
                  f"iterations {min(times[k, 0]):.3f} ms (turns "
                  f"{times[k, 0]}), {caps[k, 0]} items at the cap, "
                  f"{same[k, 0]:.6f} of pixels bit for bit the shipped "
                  f"build's; with a cap of {cap_iters[1]} (one sample's "
                  f"budget an item; time only) {min(times[k, 1]):.3f} ms "
                  f"(turns {times[k, 1]}), {caps[k, 1]} items at the cap "
                  f"{tag}", flush=True)
            assert same[k, 0] == 1.0 and caps[k, 0] == int(ref_cap), (label,
                                                                     k)

    # 14b: the cap's rule where it binds
    spp_b = 16
    for label, (c, g, ftab, itab) in cells:
        c1 = _with_max_events(c, 1)
        n = c.nx * c.ny * spp_b
        blocks = _check_blocks(n)
        k, cap = sk.render_vspg_items(c1, g, ftab, itab, spp_b, 13,
                                      blocks=blocks)
        crop = torch.arange((c.ny // 2) * c.nx, (c.ny // 2 + 2) * c.nx,
                            device=dev)
        counts = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = sk.render_vspg_plain(c1, g, ftab, itab, spp_b, 13, counts,
                                 pixels=crop)
        torch.cuda.synchronize()
        t_p = time.perf_counter() - t0
        kc = k.reshape(-1, 3)[crop]
        exact = (kc == p).all(-1).float().mean().item()
        check_parity(
            f"phase 14b parity {label} vspg_render {c.nx}x{c.ny}x{spp_b} "
            f"at a pixel cap of {spp_b * 12} iterations, rows "
            f"{c.ny // 2}-{c.ny // 2 + 1} ({blocks} blocks, "
            f"{n / (blocks * 128):.1f} items a thread; {int(cap)} items at "
            f"the cap in the image, {counts['capped']} of the crop's "
            f"{crop.numel()} pixels cut by the cap; {exact:.5f} of them bit "
            f"for bit; plain {t_p:.1f} s)", "vspg", kc.reshape(1, -1, 3),
            p.reshape(1, -1, 3))
        assert int(cap) > 0 and counts["capped"] > 0, (label, int(cap),
                                                       counts)


def _phase15(tag, variants, check_parity):
    """Phase 15, the grid kernel's register budget and warp vote: each grid
    source built alone at 2, 3 and 4 minimum blocks an SM with its shipped
    vote, and at its shipped budget with the vote flipped (`variants`,
    started after phase 2, ptxas's registers and spills of each; the
    shipped build is the package's, phase 2), renders its main path's
    inputs (phases 6, 9c and 10c) in turns, best of 3 by CUDA events, each
    image held against the shipped build's (the mesh bar, and the share of
    pixels bit for bit). Runs while the script stays under SWEEP_UNTIL_S
    seconds and prints every cut."""
    from vspg_pbrt_v4_tpu_torch.ops import _build
    from vspg_pbrt_v4_tpu_torch.ops import volpath_kernels as vk

    libs, ship = {}, {}  # the shipped build: the package's (None)
    for name, src in GRID_SOURCES.items():
        ship[name] = (name, *_shipped_grid_build(src))
        libs[ship[name]] = None
    for key, (proc, out) in variants.items():
        if key in SWEEP:  # phase 14's VSPG builds
            continue
        log = proc.communicate()[0]
        assert proc.returncode == 0, (key, log[-4000:])
        name, k, v = key
        stem = name[len("volpath_"):]
        libs[key] = _build.bind(out, (f"volpath_{stem}_launch",
                                      f"volpath_{stem}_info"))
        for (geom,), row in _ptxas_table(log, GRID_ENTRY).items():
            print(f"phase 15 ptxas {name} min{k} vote{v} (geometry {geom}): "
                  f"{row.get('regs')} registers, {row.get('stack')} bytes "
                  f"stack frame, {row.get('st')} bytes spill stores, "
                  f"{row.get('ld')} bytes spill loads {tag}", flush=True)
    libs = dict(sorted(libs.items()))
    times, shipped = {}, {}
    for name, (c, spp) in GRID_CELLS.items():
        shipped[name] = vk.render(c, spp, 5)
    for order in (list(libs), list(libs)[::-1]):
        for key in order:
            if time.perf_counter() - _T0 > SWEEP_UNTIL_S:
                print(f"phase 15 cut: {key[0]} min{key[1]} vote{key[2]}, "
                      f"turn {len(times.get(key, [])) + 1} ({_at()}, past "
                      f"{SWEEP_UNTIL_S} s)", flush=True)
                continue
            c, spp = GRID_CELLS[key[0]]
            times.setdefault(key, []).append(round(_events_best_of_3(
                lambda: vk.render_grid(c, spp, 5, lib=libs[key])), 3))
    for key, t in times.items():
        name, k, v = key
        c, spp = GRID_CELLS[name]
        img = vk.render_grid(c, spp, 5, lib=libs[key])
        grid = vk.grid_info(c, lib=libs[key])
        same = (img == shipped[name]).all(-1).float().mean().item()
        check_parity(f"phase 15 {name} min{k} vote{v} {c.nx}x{c.ny}x{spp} "
                     f"against the shipped build ({same:.6f} of pixels bit "
                     "for bit)", "mesh", img, shipped[name])
        print(f"phase 15 sweep {name} {c.nx}x{c.ny}x{spp} min{k} vote{v}"
              f"{' (shipped)' if key == ship[name] else ''}: "
              f"{grid['blocks']} blocks ({grid['per_sm']} an SM), "
              f"{grid['regs']} registers, {grid['local_bytes']} bytes local "
              f"a thread; {min(t):.3f} ms (turns {t}) {tag}", flush=True)
    for name, key in ship.items():
        flip = (*key[:2], 1 - key[2])
        if key in times and flip in times:
            t0, t1 = min(times[key]), min(times[flip])
            print(f"phase 15 vote {name}: shipped vote{key[2]} {t0:.3f} ms, "
                  f"vote{flip[2]} {t1:.3f} ms ({100 * (t1 / t0 - 1):+.1f}%) "
                  f"{tag}", flush=True)


# M's integer work per lookup, counted by hand from
# csrc/gather_microbench.cu: the word, cell and lane masks and shifts (4),
# the address (2), the float-to-int conversion (1), the two wrapping adds
# (2), the hash (two shifts, two xors, a multiply: 5); the float add of
# the sum is one FP32 operation. Hopper issues 64 INT32 operations a cycle
# an SM (NVIDIA's Hopper architecture white paper).
GATHER_INT_OPS = 14
INT32_PER_S = 132 * 64 * 1.98e9


def _phase13(dev, tag):
    """Phase 13, M: the gather microbenchmark. Both table placements
    against the plain version, bit for bit, for block 0 (the TPU kernel's
    result) and every block of a full card; then its driver ``run``, the
    JAX file's slope timing, at C = 32, 256 and 2048 with one block and
    with a full card. Returns the two placements' entries of the kernels
    line."""
    from vspg_pbrt_v4_tpu_torch.benchmarks import gather_microbench as gm

    full = 132 * 8  # eight 1024-lane blocks on each of the 132 SMs
    for C in (32, 256):
        table = torch.as_tensor(gm.make_table(C), device=dev)
        p = gm.gather_plain(table, 3, C, 64, full)
        p1 = gm.gather_plain(table, 3, C, 64, 1)
        assert torch.equal(p[:1], p1)
        for variant in gm.VARIANTS:
            k = gm.gather(table, 3, C, 64, full, variant)
            k1 = gm.gather(table, 3, C, 64, 1, variant)
            torch.cuda.synchronize()
            same = torch.equal(k, p) and torch.equal(k1, p1)
            print(f"phase 13 parity gather_{variant} C={C} 64 events: block "
                  f"0 and all {full} blocks bit for bit: {same} {tag}",
                  flush=True)
            assert same, (variant, C)
    for key in gm.LAUNCHES:
        gm.LAUNCHES[key] = 0
    print(f"phase 13 gather microbenchmark (E_LO={gm.E_LO}, E_HI={gm.E_HI}, "
          f"best of 5 by CUDA events; every lookup waits for the previous "
          f"one, so the slope is a latency) {tag}", flush=True)
    timed = {}
    for variant in gm.VARIANTS:
        for C in (32, 256, 2048):
            if variant == "shared" and C > gm.MAX_SHARED_C:
                print(f"phase 13 gather_shared C={C}: cut, the {C * 512} "
                      f"byte table exceeds a block's shared memory {tag}",
                      flush=True)
                continue
            for blocks in (1, full):
                us, rate, ms_hi = gm.run(variant, C, blocks=blocks,
                                         device=dev)
                timed[variant, C, blocks] = ms_hi
                # one block: the slope is one lane's dependent-lookup
                # latency; a full card: its lookups per second
                print(f"phase 13 gather_{variant} C={C} blocks={blocks}: "
                      f"{us:.4f} us per event"
                      + (f" per block, {us * 1e3:.1f} ns per dependent lookup"
                         if blocks == 1 else "")
                      + f", {rate:.2f} Mlookups/s {tag}", flush=True)
    launches = dict(gm.LAUNCHES)
    assert all(v > 0 for v in launches.values()), launches
    entries = []
    for variant, C in (("global", 2048), ("shared", 256)):
        # the entry's shape: the TPU kernel's (one block) at E_HI events
        table = torch.as_tensor(gm.make_table(C), device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = gm.gather_plain(table, 2, C, gm.E_HI, 1)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
        k = gm.gather(table, 2, C, gm.E_HI, 1, variant)
        gm.LAUNCHES["gather_" + variant] -= 1  # a comparison launch
        torch.cuda.synchronize()
        assert torch.equal(k, p), variant
        lookups = gm.SUB * gm.LANES * gm.E_HI
        t_bytes = (C * gm.LANES * 4 + gm.SUB * gm.LANES * 4) / HBM_BYTES_PER_S
        t_ops = lookups * GATHER_INT_OPS / INT32_PER_S
        bound = max(t_bytes, t_ops) * 1e3
        by = "bytes" if t_bytes >= t_ops else "operations"
        ms = timed[variant, C, 1]
        print(f"phase 13 gather_{variant} C={C} 1 block x {gm.E_HI} events: "
              f"kernel {ms:.4f} ms, plain {t_plain * 1e3:.1f} ms, bound "
              f"{bound:.6f} ms ({by}: table and output bytes "
              f"{t_bytes * 1e3:.6f} ms, integer ops {t_ops * 1e3:.6f} ms), "
              f"kernel at {bound / ms:.5f} of it: the chain of dependent "
              f"loads makes it a latency measurement {tag}", flush=True)
        entries.append(dict(
            name=f"gather_{variant}", route="cuda",
            source="vspg_pbrt_v4_tpu_torch/csrc/gather_microbench.cu",
            replaces="benchmarks/gather_microbench.py:45",
            launches=launches["gather_" + variant], max_abs_err=0.0, ms=ms,
            plain_ms=t_plain * 1e3, bound_ms=bound, bound_by=by,
            bound_pipe="bytes" if by == "bytes" else "int32",
            library_ms=None, shape=f"C={C}, 1 block, {gm.E_HI} events",
            full_card_ms=timed[variant, C, full]))
    return entries


# phase 16's guided scene: scenes/fogbox.pbrt with the paper's integrator
# and a 0.2-wide emissive quad in the fog, facing the camera
VSPG_INTEGRATOR = ('Integrator "guidedvolpathvspg" "integer maxdepth" [32] '
                   '"string isgbdenoiser" "atrous"')
EMISSIVE_QUAD = """
AttributeBegin
  MediumInterface "fog" "fog"
  AreaLightSource "diffuse" "rgb L" [4 4 4]
  Material "diffuse" "rgb reflectance" [0.5 0.5 0.5]
  Shape "trianglemesh"
    "point3 P" [-0.1 -0.5 0  0.1 -0.5 0  0.1 -0.3 0  -0.1 -0.3 0]
    "integer indices" [0 2 1  0 3 2]
AttributeEnd
"""


def _outward(text):
    """`text` with every triangle's corners in the other order. The
    shipped fog box winds its interface inward, so under pbrt's
    MediumInterface rule (the inside medium lies opposite the normal) its
    fog fills everything outside the cube, in both packages; wound outward,
    the fog fills the cube, as in B1's box."""
    import re

    def flip(m):
        v = m.group(2).split()
        return m.group(1) + "  ".join(
            f"{v[i]} {v[i + 2]} {v[i + 1]}" for i in range(0, len(v), 3)) + "]"

    return re.sub(r'("integer indices"\s*\[)([^\]]*)\]', flip, text)


def _cli(args, label, tag):
    """Run ``python -m vspg_pbrt_v4_tpu_torch`` on `args` from the
    repository root; returns (image, the --stats record, seconds)."""
    return _cli_wait(_cli_start(args), args, label, tag)


def _cli_start(args):
    """Start the CLI on `args` from the repository root, with --stats."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, "-m", "vspg_pbrt_v4_tpu_torch", *args, "--stats",
         "--quiet"], cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    BACKGROUND.append(proc)  # stopped with the builds if the script fails
    return proc, time.perf_counter()


def _cli_wait(started, args, label, tag):
    """Wait for a CLI run of `_cli_start`; returns (image, the --stats
    record with the run's standard output under "stdout", seconds with the
    interpreter's start)."""
    from vspg_pbrt_v4_tpu_torch.utils.image import read_image

    proc, t0 = started
    out, err = proc.communicate(timeout=600)
    dt = time.perf_counter() - t0
    assert proc.returncode == 0, (label, err[-3000:])
    stats = json.loads(err.strip().splitlines()[-1])
    stats["stdout"] = out
    img = read_image(args[args.index("--outfile") + 1])
    assert np.isfinite(img).all(), label
    print(f"phase {label}: {stats['seconds']:.2f} s in the CLI "
          f"({dt:.2f} s with the interpreter's start), parse and build "
          f"{stats['build_seconds']:.4f} s, {stats['mpaths_per_s']:.4f} "
          f"Mpaths/s, {stats['spp']} spp at {stats['resolution']}, device "
          f"{stats['device']}, mean {img.mean():.6f} {tag}", flush=True)
    assert stats["device"] == "cuda", stats
    return img, stats, dt


def _z(a, b):
    """(difference of the image means, the same in standard errors of the
    per-pixel differences)."""
    diff = (np.asarray(a, np.float64) - np.asarray(b, np.float64)).mean(-1)
    err = diff.std() / np.sqrt(diff.size)
    return diff.mean(), diff.mean() / err


def _phase16(dev, tag):
    """Scene files through the port's own parser, builder and CLI: (a) the
    fog box through ``python -m vspg_pbrt_v4_tpu_torch`` against
    ``build_render_setup`` + ``volpath.render`` in this process, bit for
    bit; (b) the parsed fog against the same fog as one box through
    ``render_persistent`` (B1) within 4 standard errors; (c) the Cornell box (spheres, an area
    light) through the CLI, its walls on their sides; (d) the fog box with
    an emissive quad under ``guidedvolpathvspg`` through the CLI, storing
    then loading a guiding cache, within 4 standard errors of the same
    scene under volpath. (b) and (d) wind the fog box's interface outward
    (``_outward``). The CLI processes that wait on no other run at once,
    beside this process's own renders."""
    import os
    import tempfile

    from vspg_pbrt_v4_tpu_torch.models.integrators import volpath
    from vspg_pbrt_v4_tpu_torch.models.shapes import Geometry
    from vspg_pbrt_v4_tpu_torch.ops import volpath_kernels as vk
    from vspg_pbrt_v4_tpu_torch.scene import (build_render_setup,
                                              parse_pbrt_file,
                                              parse_pbrt_string)

    t16 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    fogbox = os.path.join(root, "scenes", "fogbox.pbrt")
    with tempfile.TemporaryDirectory() as tmp:
        with open(fogbox) as f:
            fog_text = _outward(f.read())
        # (d)'s scenes: the guided scene (the fog wound outward, so that the
        # quad is in the fog) and the same scene under volpath
        body = "\n".join(ln for ln in fog_text.splitlines()
                         if not ln.startswith("Integrator")) + EMISSIVE_QUAD
        scenes = {}
        for name, integ in (("vspg", VSPG_INTEGRATOR),
                            ("volpath", 'Integrator "volpath" '
                                        '"integer maxdepth" [32]')):
            scenes[name] = os.path.join(tmp, f"quad_{name}.pbrt")
            with open(scenes[name], "w") as f:
                f.write(integ + "\n" + body)
        cache = os.path.join(tmp, "field.npz")

        def vspg_args(label, extra, seed):
            return [scenes["vspg"], "--spp", "16", "--seed", str(seed),
                    "--outfile", os.path.join(tmp, f"vspg_{label}.exr"),
                    *extra]

        runs = {
            "16a fogbox": [fogbox, "--spp", "16", "--outfile",
                           os.path.join(tmp, "fogbox.exr")],
            "16c cornell": [os.path.join(root, "scenes", "cornell.pbrt"),
                            "--outfile", os.path.join(tmp, "cornell.exr")],
            "16d vspg store guiding cache": vspg_args(
                "store", ["--store-guiding-cache", cache], 1),
            "16d volpath": [scenes["volpath"], "--spp", "16", "--seed", "3",
                            "--outfile",
                            os.path.join(tmp, "quad_volpath.exr")]}
        started = {label: _cli_start(args) for label, args in runs.items()}

        def wait(label):
            return _cli_wait(started[label], runs[label],
                             f"{label}, {len(runs)} CLI processes at once",
                             tag)[0]

        # (a) the real entry point against the API on the same seed
        t0 = time.perf_counter()
        setup = build_render_setup(parse_pbrt_file(fogbox), spp_override=16,
                                   device=dev)
        t_build = time.perf_counter() - t0
        img_api = volpath.render(setup.scene, setup.camera, setup.film,
                                 spp=16, cfg=volpath.VolPathConfig(
                                     max_depth=32), seed=0, spp_per_pass=4,
                                 device=dev)
        where = img_api.device
        img_api = img_api.cpu().numpy()
        img_cli = wait("16a fogbox")
        same = np.array_equal(img_cli, img_api)
        print(f"phase 16a fogbox: the CLI's image and build_render_setup + "
              f"volpath.render's (built in {t_build:.4f} s, tensors on "
              f"{where}) equal bit for bit: {same} {tag}", flush=True)
        assert same and where.type == "cuda"

        # (b) the fog wound outward (so that it fills the cube) through the
        # parser, the builder and volpath.render, against the same fog as
        # one box through B1
        fog_in = build_render_setup(parse_pbrt_string(fog_text),
                                    spp_override=16, device=dev)
        img_tri = volpath.render(fog_in.scene, fog_in.camera, fog_in.film,
                                 spp=16, cfg=volpath.VolPathConfig(
                                     max_depth=32), seed=4, spp_per_pass=4,
                                 device=dev).cpu().numpy()
        box = Geometry.build(boxes=[dict(bmin=(-1, -1, -1), bmax=(1, 1, 1),
                                         mat=-1, light=-1, med_in=0,
                                         med_out=-1)], device=dev)
        fog_box = dataclasses.replace(fog_in.scene, geometry=box)
        for key in vk.LAUNCHES:
            vk.LAUNCHES[key] = 0
        img_b1 = volpath.render_persistent(
            fog_box, fog_in.camera, fog_in.film, spp=64,
            cfg=volpath.VolPathConfig(max_depth=32), seed=5, device=dev)
        torch.cuda.synchronize()
        launches = dict(vk.LAUNCHES)
        assert launches["homog"] >= 1 and launches["grid"] == 0, launches
        d, z = _z(img_b1.cpu().numpy(), img_tri)
        print(f"phase 16b fogbox as one box via render_persistent (B1 "
              f"launches {launches['homog']}) at 64 spp against the parsed "
              f"fog box wound outward at 16 spp: means "
              f"{img_b1.mean().item():.6f} and {img_tri.mean():.6f}, "
              f"difference {d:+.6f} = {z:+.2f} standard errors (bound 4); "
              f"the shipped winding, fog outside the cube, reads "
              f"{img_cli.mean():.6f} {tag}", flush=True)
        assert abs(z) <= 4.0, z

        # (c) the Cornell box through the CLI at the file's own size
        img_c = wait("16c cornell")
        ny, nx = img_c.shape[:2]
        rows = slice(ny // 4, 3 * ny // 4)
        left = img_c[rows, nx // 16:nx * 5 // 16].mean((0, 1))
        right = img_c[rows, nx * 11 // 16:nx * 15 // 16].mean((0, 1))
        print(f"phase 16c cornell walls: left {left.round(4).tolist()} "
              f"(green), right {right.round(4).tolist()} (red) {tag}",
              flush=True)
        assert right[0] > right[1] and left[1] > left[0], (left, right)

        # (d) the guided scene storing, then loading its guiding cache,
        # against the same scene under volpath
        imgs = {"store": wait("16d vspg store guiding cache")}
        assert os.path.exists(cache)
        imgs["load"] = _cli(vspg_args("load", ["--load-guiding-cache", cache],
                                      2), "16d vspg load guiding cache",
                            tag)[0]
        img_v = wait("16d volpath")
        for label in ("store", "load"):
            d, z = _z(imgs[label], img_v)
            print(f"phase 16d vspg ({label}) against volpath with the "
                  f"emissive quad: means {imgs[label].mean():.6f} and "
                  f"{img_v.mean():.6f}, difference {d:+.6f} = {z:+.2f} "
                  f"standard errors (bound 4) {tag}", flush=True)
            assert abs(z) <= 4.0, (label, z)
    dt = time.perf_counter() - t16
    print(f"phase 16 done {_at()}, the phase {dt:.1f} s", flush=True)


# phase 17's depths, cut to fit the phase in about 100 s (printed in the
# cuts line) and leave room for phase 18: 17a's spp and path depth (the
# file's 32 and 32), 17b's spp, 17c's training waves and frozen spp (phase
# 7c's 48 and 64), 17d's U-Net training steps
P17_CLOUD_SPP, P17_CLOUD_DEPTH = 4, 8
P17_GUIDED_SPP = 4
P17_UNET_WAVES, P17_UNET_FROZEN = 8, 8
P17_DENOISE_STEPS = (4, 8)


def _volpath_text(text):
    """A scene text with its Integrator directive, and the parameter lines
    that continue it, replaced by volpath's."""
    import re

    return re.sub(r'^Integrator "[a-z]+"[^\n]*(\n[ \t]+"[^\n]*)*',
                  'Integrator "volpath" "integer maxdepth" [32]', text,
                  count=1, flags=re.M)


def _phase17(dev, tag):
    """The paper's scene file and the modules around it on the card:
    (a) ``scenes/cloud_vspg.pbrt`` (the procedural cloud, the U-Net ISGB
    denoiser) through the CLI at its own 128^2, as shipped (its cube wound
    inward, so the cloud lies outside it and renders as empty space) and
    wound outward under ``guidedvolpathvspg``, against the outward file
    under ``volpath.render`` within 4 standard errors; (b)
    ``guidedvolpath`` (RIS and MIS) on phase 16d's fog box with its
    emissive quad and ``guidedpath`` on the Cornell box through the CLI,
    each equal to ``render_guided`` in this process bit for bit and within
    4 standard errors of volpath; (c) ``render_vspg`` on pyro64 at 256^2
    with the U-Net through B4a and B3a against the same call with the
    à-trous filter, each ISGB update timed by CUDA events, and the à-trous
    call again, bit for bit; (d) the U-Net's ``train_and_denoise`` at
    256^2, width 12, 4 and 48 steps, on the card twice and on the CPU,
    same inputs and weights."""
    import copy
    import os
    import tempfile

    from vspg_pbrt_v4_tpu_torch.models.film import RGBFilm
    from vspg_pbrt_v4_tpu_torch.models.guiding import denoiser as dn
    from vspg_pbrt_v4_tpu_torch.models.guiding import isgb as gisgb
    from vspg_pbrt_v4_tpu_torch.models.integrators import guided_volpath
    from vspg_pbrt_v4_tpu_torch.models.integrators import volpath, vspg
    from vspg_pbrt_v4_tpu_torch.ops import volpath_kernels as vk
    from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk
    from vspg_pbrt_v4_tpu_torch.scene import (build_render_setup,
                                              parse_pbrt_file)

    t17 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        def write(name, text):
            path = os.path.join(tmp, name)
            with open(path, "w") as f:
                f.write(text)
            return path

        def exr(name):
            return os.path.join(tmp, name + ".exr")

        # ---- 17a: the VSPG scene file at its own size ----------------------
        shipped = os.path.join(root, "scenes", "cloud_vspg.pbrt")
        with open(shipped) as f:
            out_text = _outward(f.read())
        cut = ["--spp", str(P17_CLOUD_SPP), "--maxdepth",
               str(P17_CLOUD_DEPTH)]
        outward = write("cloud_out.pbrt", out_text)
        # both CLI processes at once, beside this process's volpath render
        args_ship = [shipped, *cut, "--outfile", exr("shipped")]
        args_unet = [outward, *cut, "--seed", "1", "--outfile",
                     exr("cloud_unet")]
        run_ship, run_unet = _cli_start(args_ship), _cli_start(args_unet)
        # the same file under volpath, in this process
        spp_vol = P17_CLOUD_SPP // 2
        setup = build_render_setup(parse_pbrt_file(outward),
                                   spp_override=spp_vol, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img_vol = volpath.render(
            setup.scene, setup.camera, setup.film, spp=spp_vol,
            cfg=volpath.VolPathConfig(max_depth=P17_CLOUD_DEPTH), seed=2,
            spp_per_pass=spp_vol, device=dev).cpu().numpy()
        t_vol = time.perf_counter() - t0
        img_ship = _cli_wait(run_ship, args_ship, "17a cloud_vspg.pbrt as "
                             "shipped, two CLI processes at once", tag)[0]
        img_unet, st_unet, _ = _cli_wait(
            run_unet, args_unet, "17a cloud_vspg.pbrt wound outward "
            "(guidedvolpathvspg, unet), two CLI processes at once", tag)
        assert st_unet["resolution"] == [128, 128], st_unet
        d, z = _z(img_unet, img_vol)
        d_c, z_c = _z(img_vol, img_ship)
        print(f"phase 17a the cloud wound outward: guidedvolpathvspg with "
              f"the U-Net mean {img_unet.mean():.6f} against volpath's "
              f"{img_vol.mean():.6f} ({spp_vol} spp, {t_vol:.2f} s through "
              f"volpath.render), "
              f"difference {d:+.6f} = {z:+.2f} standard errors (bound 4); "
              f"as shipped (no cloud in the cube) the mean reads "
              f"{img_ship.mean():.6f}, the cloud moves it {d_c:+.6f} = "
              f"{z_c:+.2f} standard errors {tag}", flush=True)
        assert abs(z) <= 4.0, z
        assert abs(z_c) > 8.0, z_c

        # ---- 17b: the guided integrators through the CLI ------------------
        def body(name):
            # the file without its (one-line) Integrator directive
            with open(os.path.join(root, "scenes", name)) as f:
                return "\n".join(ln for ln in f.read().splitlines()
                                 if not ln.startswith("Integrator"))

        fog_body = _outward(body("fogbox.pbrt")) + EMISSIVE_QUAD
        cases = (("guidedvolpath", "ris", fog_body, 32),
                 ("guidedvolpath", "mis", fog_body, 32),
                 ("guidedpath", "ris", body("cornell.pbrt"), 8))
        spp_b = P17_GUIDED_SPP
        runs = []
        for name, mode, text, depth in cases:
            head = (f'Integrator "{name}" "integer maxdepth" [{depth}] '
                    f'"string guidingtype" "{mode}"\n')
            path = write(f"{name}_{mode}.pbrt", head + text)
            args = [path, "--spp", str(spp_b), "--seed", "1", "--outfile",
                    exr(f"{name}_{mode}")]
            runs.append((name, mode, depth, path, args, _cli_start(args)))
        # the three CLI processes run at once; render_guided after them
        clis = [_cli_wait(started, args, f"17b {name} ({mode}), three CLI "
                          "processes at once", tag)[0]
                for name, mode, _, _, args, started in runs]
        for (name, mode, depth, path, _, _), img_cli in zip(runs, clis):
            setup = build_render_setup(parse_pbrt_file(path),
                                       spp_override=spp_b, device=dev)
            per_pass = min(4, spp_b)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img_api, field = guided_volpath.render_guided(
                setup.scene, setup.camera, setup.film, spp=spp_b,
                cfg=volpath.VolPathConfig(max_depth=depth),
                gopt=guided_volpath.GuidingOptions(mode=mode), seed=1,
                camera_medium=setup.camera_medium, spp_per_pass=per_pass,
                device=dev)
            torch.cuda.synchronize()
            t_api = time.perf_counter() - t0
            img_api = img_api.cpu().numpy()
            same = np.array_equal(img_cli, img_api)
            ref = volpath.render(setup.scene, setup.camera, setup.film,
                                 spp=4 * spp_b, cfg=volpath.VolPathConfig(
                                     max_depth=depth), seed=3,
                                 spp_per_pass=8, device=dev).cpu().numpy()
            d, z = _z(img_api, ref)
            waves = spp_b // per_pass
            nx, ny = setup.film.resolution
            print(f"phase 17b {name} ({mode}) {nx}x{ny}x{spp_b}: "
                  f"render_guided {t_api:.3f} s ({t_api / waves:.3f} s a wave "
                  f"of {per_pass} spp, {waves} waves, {field.iteration} "
                  f"training updates), the CLI's image equal to it bit for "
                  f"bit: {same}; mean {img_api.mean():.6f} against volpath's "
                  f"{ref.mean():.6f} at {4 * spp_b} spp, difference "
                  f"{d:+.6f} = {z:+.2f} standard errors (bound 4) {tag}",
                  flush=True)
            assert same and abs(z) <= 4.0, (name, mode, same, z)
            assert field.iteration > 0, field.iteration

    # ---- 17c: the U-Net between the record waves of the kernel route -----
    cfg = volpath.VolPathConfig(max_depth=64, max_events=256,
                                max_collisions=4096)
    n_train, n_frozen = P17_UNET_WAVES, P17_UNET_FROZEN
    gopt = guided_volpath.GuidingOptions(field_res=8, record_depth=6,
                                         min_train_weight=16.0,
                                         train_waves=n_train)
    pyro = sk.make_pyro64_scene(device=dev)
    res = 256
    cam, film = vk.bench_camera(res, device=dev), RGBFilm.make((res, res),
                                                              device=dev)
    update = gisgb.isgb_update
    imgs = {}
    for name in ("unet", "atrous"):
        vopt = vspg.VSPGOptions(vsp_criterion="contribution", denoiser=name)
        updates = []

        def timed_update(buf):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = update(buf)
            end.record()
            updates.append((start, end))
            return out

        gisgb.isgb_update = timed_update
        try:
            (img, field, isgb), t_call, launches, k_ms, cap, rcap = (
                _main_path_calls(lambda: vspg.render_vspg(
                    pyro, cam, film, spp=n_train + n_frozen, cfg=cfg,
                    gopt=gopt, vopt=vopt, seed=5, spp_per_pass=1,
                    device=dev)))
        finally:
            gisgb.isgb_update = update
        ms = [s.elapsed_time(e) for s, e in updates]
        imgs[name] = img.cpu().numpy()
        print(f"phase 17c render_vspg pyro64 {res}x{res} {n_train} training "
              f"waves + {n_frozen} frozen spp with the {name} denoiser: "
              f"{t_call:.3f} s, mean {imgs[name].mean():.6f}, launches "
              f"{launches}, B4a {k_ms['vspg_record']:.3f} ms in "
              f"{launches['vspg_record']} launches, B3a (item kernel and "
              f"reduce) {k_ms['vspg_render']:.3f} ms, render items at the "
              f"cap {cap}, record lanes at the cap {rcap}; {len(ms)} ISGB "
              f"updates by CUDA events: {[round(m, 3) for m in ms]} ms "
              f"{tag}", flush=True)
        assert isgb.denoiser == name and isgb.ready
        assert (name == "unet") == (isgb.net is not None)
        assert launches == dict({k: 0 for k in sk.LAUNCHES},
                                vspg_record=n_train, vspg_render=1,
                                vspg_reduce=1), launches
        assert cap == 0 and rcap == 0, (cap, rcap)
        assert np.isfinite(imgs[name]).all() and imgs[name].mean() > 0
        assert len(ms) == sum(1 for w in vopt.isgb_update_waves
                              if w <= n_train)
    d, z = _z(imgs["unet"], imgs["atrous"])
    # the guiding modules' scatter-adds take a fixed order on the card
    # (utils/math.index_sum), so the whole call gives the same bits again
    again = vspg.render_vspg(
        pyro, cam, film, spp=n_train + n_frozen, cfg=cfg, gopt=gopt,
        vopt=vspg.VSPGOptions(vsp_criterion="contribution"), seed=5,
        spp_per_pass=1, device=dev)[0].cpu().numpy()
    same = np.array_equal(again, imgs["atrous"])
    print(f"phase 17c the U-Net against the à-trous filter: difference "
          f"{d:+.6f} = {z:+.2f} standard errors (bound 4); the à-trous call "
          f"again equal bit for bit: {same} {tag}", flush=True)
    assert abs(z) <= 4.0 and same, (z, same)

    # ---- 17d: the U-Net's update on the card and on the CPU ---------------
    rng = np.random.default_rng(17)
    n = 256

    def img(*c):
        return rng.uniform(0, 2, (n, n) + c).astype(np.float32)

    args = [img(3), rng.integers(0, 3, (n, n)).astype(np.float32), img(3),
            rng.integers(1, 3, (n, n)).astype(np.float32), img(3),
            rng.integers(1, 5, (n, n)).astype(np.float32), img(3), img(3),
            rng.uniform(-1, 1, (n, n)).astype(np.float32)]
    net0 = dn.UNet(width=12)

    def run(device, steps):
        net = copy.deepcopy(net0).to(device)
        tensors = [torch.as_tensor(a, device=device) for a in args]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        _, _, out_c, out_v = dn.train_and_denoise(net, None, *tensors,
                                                  steps=steps)
        end.record()
        torch.cuda.synchronize()
        ms = (start.elapsed_time(end) if device == "cuda"
              else (time.perf_counter() - t0) * 1e3)
        return out_c.cpu().numpy(), out_v.cpu().numpy(), ms

    def share(a, b):
        rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-6)
        return (rel <= 1e-3).reshape(n, n, -1).all(-1).mean()

    for steps in P17_DENOISE_STEPS:
        c1, v1, ms1 = run("cuda", steps)
        c2, v2, ms2 = run("cuda", steps)
        c0, v0, ms_cpu = run("cpu", steps)
        same = np.array_equal(c1, c2) and np.array_equal(v1, v2)
        print(f"phase 17d train_and_denoise {n}x{n}, width 12, {steps} "
              f"steps: card {ms1:.2f} and {ms2:.2f} ms by CUDA events, CPU "
              f"{ms_cpu:.1f} ms; the two card runs equal bit for bit: "
              f"{same}; against the CPU, pixels within 1e-3 relative: "
              f"color {share(c1, c0):.5f}, VSP {share(v1, v0):.5f} {tag}",
              flush=True)
        assert same
        assert np.isfinite(c1).all() and np.isfinite(v1).all()
    print(f"phase 17 done {_at()}, the phase "
          f"{time.perf_counter() - t17:.1f} s", flush=True)


# phase 18c's scene texts: scenes/fogbox.pbrt wound outward (the fog in
# the cube) at 64x64x16, its Sampler, PixelFilter and Camera lines swapped;
# "same" marks a render that estimates what the independent sampler's box-
# filtered pinhole render does (its mean within 3 standard errors of it)
P18_HEADERS = {
    "independent": ('Sampler "independent" "integer pixelsamples" [16]', "",
                    'Camera "perspective" "float fov" [30]', True),
    "zsobol": ('Sampler "zsobol" "integer pixelsamples" [16]', "",
               'Camera "perspective" "float fov" [30]', True),
    "pmj02bn": ('Sampler "pmj02bn" "integer pixelsamples" [16]', "",
                'Camera "perspective" "float fov" [30]', True),
    "gaussian": ('Sampler "independent" "integer pixelsamples" [16]',
                 'PixelFilter "gaussian"',
                 'Camera "perspective" "float fov" [30]', False),
    "thin lens": ('Sampler "independent" "integer pixelsamples" [16]', "",
                  'Camera "perspective" "float fov" [30] '
                  '"float lensradius" [0.2] "float focaldistance" [3]',
                  False),
    "orthographic": ('Sampler "independent" "integer pixelsamples" [16]', "",
                     'Scale 1.2 1.2 1\nCamera "orthographic"', False),
    "realistic": ('Sampler "independent" "integer pixelsamples" [16]', "",
                  'Camera "realistic" "float aperturediameter" [4] '
                  '"float focusdistance" [4]', False),
}
P18_BLOCKS = 4


def _phase18(dev, tag, check_parity, kernels, inputs, route):
    """Phase 18, several devices and the scene header (b first, then a and
    c at once): (a) the dry run of
    ``vspg_pbrt_v4_tpu_torch.parallel.dryrun`` in an NCCL world of
    torch.cuda.device_count() ranks, one a card (one rank on a one-card
    host): the four sharded entry points, the kernel route's launches counted
    around that call alone, its image equal to the unsharded frozen render
    bit for bit; (b) B3a, B3b (NDS) and B3d at the main path's 256^2 x 64
    on phases 7c's, 8's and 12c's inputs as P18_BLOCKS row blocks with
    pixel bases 0, npix/4, ...: the launches of the four blocks from zeroed
    counts, each block's CUDA-event ms, the stitched image equal to the
    unsharded render bit for bit, the last block of B3a against its plain
    version; (c) the CLI on generated scene texts with the samplers,
    filters and cameras of P18_HEADERS, each mean within 3 standard errors
    of the independent/box/pinhole render where it estimates the same, and
    finite. `inputs`: each render variant's (c, g, ftab, itab); the B3
    entries of `kernels` gain their block times. `route`: 7c's (scene,
    camera, film, cfg, gopt, vopt, field, isgb), on which 18a also runs
    ``render_vspg_pallas_sharded`` at the main path's 256^2 x 64 in a world
    of its own, its image equal to 18b's unsharded B3a render bit for
    bit."""
    import os
    import tempfile

    from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk
    from vspg_pbrt_v4_tpu_torch.parallel import dryrun as pdryrun
    from vspg_pbrt_v4_tpu_torch.parallel import mesh

    t18 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))

    # ---- 18b: B3 as row blocks with pixel bases ----------------------------
    spp, seed = 64, 11
    by_name = {k["name"]: k for k in kernels}
    wholes = {}
    for name, (c, g, ftab, itab) in inputs.items():
        whole = wholes[name] = sk.render_vspg_kernel(c, g, ftab, itab, spp,
                                                     seed)
        bases = [mesh.row_block(c, itab, r, P18_BLOCKS)[2]
                 for r in range(P18_BLOCKS)]
        for counter in sk.LAUNCHES:
            sk.LAUNCHES[counter] = 0
        parts = [mesh.render_block(c, g, ftab, itab, r, P18_BLOCKS, spp,
                                   seed) for r in range(P18_BLOCKS)]
        torch.cuda.synchronize()
        launches = {k: v for k, v in sk.LAUNCHES.items() if v}
        kernel = "vspg_render" + ("_adaptive" if name.endswith("adaptive")
                                  else "")
        assert launches == {kernel: P18_BLOCKS,
                            "vspg_reduce": P18_BLOCKS}, launches
        assert sum(int(cap) for _, cap in parts) == 0
        stitched = torch.cat([img for img, _ in parts], 0)
        same = torch.equal(stitched, whole)
        ms = [_events_best_of_3(
            lambda r=r: mesh.render_block(c, g, ftab, itab, r, P18_BLOCKS,
                                          spp, seed))
            for r in range(P18_BLOCKS)]
        ms_whole = _events_best_of_3(
            lambda: sk.render_vspg_kernel(c, g, ftab, itab, spp, seed))
        print(f"phase 18b {name} {c.nx}x{c.ny}x{spp} as {P18_BLOCKS} row "
              f"blocks, pixel bases {bases}: launches {launches}, block ms "
              f"by CUDA events (each with its ISGB columns' slice) "
              f"{[round(m, 3) for m in ms]} (sum {sum(ms):.3f}) against "
              f"{ms_whole:.3f} ms unsharded; stitched image equal to the "
              f"unsharded render bit for bit: {same} {tag}", flush=True)
        assert same, name
        entry = by_name[name]
        entry.update(block_ms=ms, block_launches=launches[kernel])

    # one block of B3a against its plain version, at 1 spp with max_events
    # cut to PARITY_EVENTS: the last block, whose paths are shorter than
    # the middle blocks' (it renders in a quarter of their time; the plain
    # version steps in lockstep until its longest path ends)
    c, g, ftab, itab = inputs["vspg_render"]
    c = _with_max_events(c, PARITY_EVENTS)
    r = P18_BLOCKS - 1
    cb, it, base = mesh.row_block(c, itab, r, P18_BLOCKS)
    k, cap = mesh.render_block(c, g, ftab, itab, r, P18_BLOCKS, 1, seed,
                               blocks=_check_blocks(cb.nx * cb.ny))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    counts = {}
    p = sk.render_vspg_plain(cb, g, ftab, it, 1, seed, counts,
                             pix_base=base)
    t_p = time.perf_counter() - t0
    max_abs = check_parity(
        f"phase 18b parity vspg_render block {r} of {P18_BLOCKS} (pixel base "
        f"{base}) {cb.nx}x{cb.ny}x1, max_events {PARITY_EVENTS} (plain "
        f"{t_p:.1f} s, {counts['lockstep_iters']} lockstep iterations; bit "
        f"for bit: {torch.equal(k, p)}; items at the cap {int(cap)})",
        "vspg", k, p)
    assert int(cap) == counts["capped"], (int(cap), counts["capped"])
    by_name["vspg_render"]["block_max_abs_err"] = max_abs

    # ---- 18a: the four sharded entry points in an NCCL world, in a process of
    # its own beside 18c's CLI processes -----------------------------------
    world = torch.cuda.device_count()
    t0 = time.perf_counter()
    dryrun = subprocess.Popen(
        [sys.executable, "-m", "vspg_pbrt_v4_tpu_torch.parallel.dryrun",
         "--world", str(world), "--res", "128"], cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    BACKGROUND.append(dryrun)  # stopped with the builds if the script fails

    # ---- 18c: the scene header's samplers, filters and cameras -----------
    with open(os.path.join(root, "scenes", "fogbox.pbrt")) as f:
        fog = _outward(f.read())
    with tempfile.TemporaryDirectory() as tmp:
        runs = {}
        for name, (sampler, filt, camera, _) in P18_HEADERS.items():
            text = fog.replace(
                'Sampler "independent" "integer pixelsamples" [16]',
                sampler + "\n" + filt).replace(
                'Camera "perspective" "float fov" [30]', camera)
            path = os.path.join(tmp, name.replace(" ", "_") + ".pbrt")
            with open(path, "w") as f:
                f.write(text)
            args = [path, "--resolution", "64x64", "--seed", "5",
                    "--outfile", path[:-5] + ".exr"]
            runs[name] = (args, _cli_start(args))
        # meanwhile the kernel route through its entry point on 7c's
        # inputs at the main path's 256^2 x 64, in a world of its own
        t_route = time.perf_counter()
        scene, cam, film, cfg, gopt, vopt, field, isgb = route
        img, route_launches = pdryrun.spawn(
            world, "vspg_pbrt_v4_tpu_torch.parallel.dryrun:kernel_route",
            (scene.to("cpu"), cam.to("cpu"), film.to("cpu"), spp, cfg, gopt,
             vopt, field.to("cpu"), isgb.to("cpu")), dict(seed=seed),
            cpu=False, timeout=600)
        t_route = time.perf_counter() - t_route
        imgs = {name: _cli_wait(started, args, f"18c {name}, "
                                f"{len(runs)} CLI processes at once", tag)[0]
                for name, (args, started) in runs.items()}
    out, err = dryrun.communicate(timeout=600)
    for line in out.strip().splitlines():
        print(f"phase 18a {line} {tag}", flush=True)
    assert dryrun.returncode == 0, err[-3000:]
    assert f"dryrun_multichip({world}): ok;" in out, out
    print(f"phase 18a NCCL world of {world} rank(s), one a card: the four "
          f"sharded entry points in {time.perf_counter() - t0:.2f} s with the "
          f"interpreters' start, beside 18c's CLI processes {tag}",
          flush=True)
    same = torch.equal(img, wholes["vspg_render"].cpu())
    print(f"phase 18a render_vspg_pallas_sharded pyro64 "
          f"{film.resolution[0]}x{film.resolution[1]}x{spp} (7c's field) in "
          f"an NCCL world of {world} rank(s): {t_route:.2f} s with the "
          f"interpreters' start, rank 0's launches {route_launches}, image "
          f"equal to the unsharded render bit for bit: {same} {tag}",
          flush=True)
    assert route_launches == {"vspg_render": 1, "vspg_reduce": 1}, \
        route_launches
    assert same
    ref = imgs["independent"]
    for name, (_, _, _, same) in P18_HEADERS.items():
        if name == "independent":
            continue
        d, z = _z(imgs[name], ref)
        print(f"phase 18c {name}: mean {imgs[name].mean():.6f} against the "
              f"independent/box/pinhole render's {ref.mean():.6f}, "
              f"difference {d:+.6f} = {z:+.2f} standard errors"
              + (" (bound 3)" if same else " (another estimand: finite)")
              + f" {tag}", flush=True)
        assert np.isfinite(imgs[name]).all() and imgs[name].mean() > 0
        assert not same or abs(z) <= 3.0, (name, z)
    print(f"phase 18 done {_at()}, the phase "
          f"{time.perf_counter() - t18:.1f} s", flush=True)


# phase 19's sizes, those users of these media render at: 19a's cloud
# sampled at 256^3 into a NanoVDB file, rendered at 256^2 through the
# CLI (maxdepth 16) under volpath and guidedvolpathvspg (P19_SPP // 4
# training waves of 4 spp), B2a on the same density in one box at 16^3
# majorants and 64 spp; 19b's 64^3 RGB grid against the same density as a
# grid medium at 128^2; 19c's earth medium at 256^2. Every CLI render at
# P19_SPP: 4, cut from 16 (and from 8 when phase 21 came) to keep the
# script inside its time
P19_GRID, P19_RES, P19_SPP, P19_DEPTH = 256, 256, 4, 16
P19_B2A_SPP = 64
P19_RGB_GRID, P19_RGB_RES = 64, 128

def _box_shape(lo, hi):
    """The 12 triangles of the box [lo, hi] (3-vectors), wound outward
    (the fog box's corners, in the other order: ``_outward``)."""
    (x0, y0, z0), (x1, y1, z1) = lo, hi
    corners = ((x0, y0, z0), (x1, y0, z0), (x1, y1, z0), (x0, y1, z0),
               (x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1))
    return ('  Shape "trianglemesh" "point3 P" ['
            + "  ".join(" ".join(f"{v:g}" for v in c) for c in corners)
            + ']\n    "integer indices" [0 2 1  0 3 2  4 5 6  4 6 7  0 5 4'
            '  0 1 5  3 6 2  3 7 6  0 7 3  0 4 7  1 6 5  1 2 6]\n')


def _medium_scene(medium, res, spp, lo=(0, 0, 0), hi=(1, 1, 1),
                  integrator='"volpath"',
                  camera='LookAt 0.5 0.5 -2.2  0.5 0.5 0.5  0 1 0\n'
                         'Camera "perspective" "float fov" [30]',
                  lights='LightSource "point" "rgb I" [3 3 3] '
                         '"point3 from" [0.5 1.6 0.2]\n'
                         'LightSource "infinite" "rgb L" [0.15 0.18 0.22]'):
    """A scene text: `medium` (the parameters of MakeNamedMedium "m") inside
    the box [lo, hi] wound outward, under `lights`; `integrator` the
    Integrator directive's name (quoted) and parameters."""
    return (f'Integrator {integrator} "integer maxdepth" [{P19_DEPTH}]\n'
            f'Sampler "independent" "integer pixelsamples" [{spp}]\n'
            f'Film "rgb" "integer xresolution" [{res[0]}] '
            f'"integer yresolution" [{res[1]}]\n{camera}\nWorldBegin\n'
            f'{lights}\nMakeNamedMedium "m" {medium}\nAttributeBegin\n'
            f'  Material "interface"\n  MediumInterface "m" ""\n'
            + _box_shape(lo, hi) + "AttributeEnd\n")


# The guided renders of phase 19 (the torch VSPG wave, the JAX XLA path's
# twin) on the trained resampling route read 0.2-0.8% below volpath on a
# grid cloud, beyond 4 standard errors at these sizes, in both packages
# (ROADMAP.md section C 7; benchmarks/vspg_gap.py). They are held to this
# share of volpath's mean, and their standard errors printed.
P19_GUIDED_REL = 0.01


def _guided_check(label, img, ref, tag):
    """A guidedvolpathvspg CLI render (P19_SPP // 4 training waves of 4
    spp) against the same file's volpath render: finite, its mean within
    P19_GUIDED_REL of volpath's; the difference in standard errors
    printed."""
    d, z = _z(img, ref)
    rel = d / ref.mean()
    print(f"phase {label} under guidedvolpathvspg through the CLI (the "
          f"resampling route, {P19_SPP // 4} training waves of 4 spp): mean "
          f"{img.mean():.6f} against volpath's {ref.mean():.6f}, difference "
          f"{d:+.6f} = {rel:+.4%} = {z:+.2f} standard errors (bound "
          f"{P19_GUIDED_REL:.0%} of the mean; ROADMAP.md section C 7) {tag}",
          flush=True)
    assert np.isfinite(img).all() and abs(rel) <= P19_GUIDED_REL, (label,
                                                                    rel, z)


def _quadrants_z(a, b):
    """_z of each image quadrant."""
    ny, nx = a.shape[:2]
    return [_z(a[ys, xs], b[ys, xs])[1]
            for ys in (slice(0, ny // 2), slice(ny // 2, ny))
            for xs in (slice(0, nx // 2), slice(nx // 2, nx))]


def _phase19(dev, tag):
    """The other media (NanoVDB grid files, RGB grids, the earth medium)
    and the image readers on the card, at the sizes their users render:
    (a) the port's CloudMedium sampled on a 256^3 grid, written with
    ``write_nvdb`` and read back through ``scene.assets.get_volume`` bit
    for bit; a scene file with that ``nanovdb`` medium in a cube wound
    outward through ``python -m vspg_pbrt_v4_tpu_torch`` (volpath, the
    torch wavefront) against B2a's ``render_persistent`` of the same
    density in one box at 16^3 majorants, means and quadrant means within
    4 standard errors; the file under guidedvolpathvspg through the CLI
    (P19_SPP // 4 training waves of 4 spp) within P19_GUIDED_REL of the
    volpath render. No kernel serves a parsed scene (it has no box) or an
    RGB grid or the earth medium, in either package. (b) a 64^3 RGB grid
    whose channels hold a density times a grid medium's sigma, through the
    CLI, within 4
    standard errors of that grid medium's scene; an absorbing, emissive
    RGB slab against the analytic Le (1 - exp(-sigma_a l)) at its centre
    pixels. (c) the earth medium with a heightmap written by
    ``write_png``, through the CLI under volpath and guidedvolpathvspg,
    finite, the guided mean within P19_GUIDED_REL of volpath's. (d) a 64x40 CLI render with
    ``--mse-reference-image tests/data/piz_64x40.exr`` (a PIZ EXR). The
    CLI processes run at once, beside this process's renders."""
    import os
    import tempfile

    from vspg_pbrt_v4_tpu_torch.models.integrators import volpath
    from vspg_pbrt_v4_tpu_torch.models.media import (CloudMedium, GridMedium,
                                                     Media)
    from vspg_pbrt_v4_tpu_torch.models.shapes import Geometry
    from vspg_pbrt_v4_tpu_torch.ops import volpath_kernels as vk
    from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk
    from vspg_pbrt_v4_tpu_torch.scene import (assets, build_render_setup,
                                              parse_pbrt_file)
    from vspg_pbrt_v4_tpu_torch.tools.nvdb import write_nvdb
    from vspg_pbrt_v4_tpu_torch.utils.image import mse, read_image, write_png

    t19 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    secs = {}
    with tempfile.TemporaryDirectory() as tmp:
        def write(name, text):
            path = os.path.join(tmp, name)
            with open(path, "w") as f:
                f.write(text)
            return path

        def exr(name):
            return os.path.join(tmp, name + ".exr")

        # ---- the files: the NanoVDB cloud, the RGB grids, the heightmap --
        t0 = time.perf_counter()
        n = P19_GRID
        cloud = CloudMedium.make(p0=(0, 0, 0), p1=(1, 1, 1), device=dev)
        x = (torch.arange(n, device=dev, dtype=torch.float32) + 0.5) / n
        dens = np.empty((n, n, n), np.float32)
        for i in range(0, n, 16):  # slabs of 16 x 256 x 256 points
            X, Y, Z = torch.meshgrid(x[i:i + 16], x, x, indexing="ij")
            dens[i:i + 16] = cloud.density_at(
                torch.stack([X, Y, Z], -1)).cpu().numpy()
        t_sample = time.perf_counter() - t0
        nvdb = os.path.join(tmp, "cloud.nvdb")
        t0 = time.perf_counter()
        write_nvdb(nvdb, dens, index_origin=(0, 0, 0), voxel_size=1.0 / n)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        back, bmin, bmax = assets.get_volume(nvdb)
        t_read = time.perf_counter() - t0
        same = np.array_equal(back, dens)
        print(f"phase 19a the cloud sampled at {n}^3 on the card in "
              f"{t_sample:.2f} s (mean density {dens.mean():.4f}), written "
              f"as NanoVDB in {t_write:.2f} s ({os.path.getsize(nvdb)} "
              f"bytes), read back through get_volume in {t_read:.2f} s: "
              f"equal bit for bit {same}, bounds {bmin.tolist()} .. "
              f"{bmax.tolist()} {tag}", flush=True)
        assert same and bmin.tolist() == [0, 0, 0] and \
            bmax.tolist() == [1, 1, 1]
        nano = (f'"string type" "nanovdb" "string filename" "{nvdb}" '
                '"rgb sigma_a" [0.3 0.3 0.3] "rgb sigma_s" [1 1.3 1.6] '
                '"float g" [0.4]')
        res = (P19_RES, P19_RES)
        vol_file = write("nanovdb.pbrt", _medium_scene(nano, res, P19_SPP))
        vspg_file = write("nanovdb_vspg.pbrt", _medium_scene(
            nano, res, P19_SPP, integrator='"guidedvolpathvspg"'))

        # 19b: a 64^3 density as an RGB grid (its channels the density
        # times sigma) and as a grid medium with those sigmas
        m = P19_RGB_GRID
        g = np.linspace(-1, 1, m)
        GX, GY, GZ = np.meshgrid(g, g, g, indexing="ij")
        d64 = np.clip(1.0 - np.sqrt(GX**2 + GY**2 + GZ**2), 0, 1).astype(
            np.float32) * (1.0 + 0.5 * np.sin(6 * GX) * np.cos(4 * GY))
        d64 = d64.astype(np.float32)
        sa, ss = np.float32([0.3, 0.2, 0.1]), np.float32([2.0, 3.0, 4.0])

        def floats(a):
            # pbrt's order: x fastest, then y, then z
            return " ".join(f"{v:.6g}" for v in a.transpose(
                2, 1, 0, *range(3, a.ndim)).reshape(-1))

        rgb = (f'"string type" "rgbgrid" "integer nx" [{m}] "integer ny" '
               f'[{m}] "integer nz" [{m}] "point3 p0" [0 0 0] '
               f'"point3 p1" [1 1 1] "float sigma_a" '
               f'[{floats(d64[..., None] * sa)}] "float sigma_s" '
               f'[{floats(d64[..., None] * ss)}]')
        npz = os.path.join(tmp, "d64.npz")
        np.savez(npz, density=d64, bmin=np.zeros(3, np.float32),
                 bmax=np.ones(3, np.float32))
        grid = (f'"string type" "uniformgrid" "string gridfile" "{npz}" '
                f'"rgb sigma_a" [{" ".join(map(str, sa))}] "rgb sigma_s" '
                f'[{" ".join(map(str, ss))}]')
        res_b = (P19_RGB_RES, P19_RGB_RES)
        rgb_file = write("rgb.pbrt", _medium_scene(rgb, res_b, P19_SPP))
        grid_file = write("grid.pbrt", _medium_scene(grid, res_b, P19_SPP))
        # the absorbing, emissive slab over [-1, 1]^2 x [0, 1] seen by an
        # orthographic camera along +z, no light: Le (1 - exp(-sigma_a))
        slab_sa, slab_le = np.float32([0.5, 1.0, 2.0]), np.float32([1, 2, 3])
        k = 4
        slab = (f'"string type" "rgbgrid" "integer nx" [{k}] "integer ny" '
                f'[{k}] "integer nz" [{k}] "point3 p0" [-1 -1 0] '
                f'"point3 p1" [1 1 1] "float sigma_a" '
                f'[{" ".join(map(str, np.tile(slab_sa, k ** 3)))}] '
                f'"float Le" [{" ".join(map(str, np.tile(slab_le, k ** 3)))}]')
        slab_file = write("slab.pbrt", _medium_scene(
            slab, (64, 64), 64, (-1, -1, 0), (1, 1, 1),
            camera='LookAt 0 0 -3  0 0 0  0 1 0\nCamera "orthographic"',
            lights=""))

        # 19c: the earth medium with a generated heightmap
        rng = np.random.default_rng(19)
        hm = np.repeat(rng.uniform(0, 1, (16, 32, 1)), 3, -1)
        hm_png = os.path.join(tmp, "heightmap.png")
        write_png(hm_png, hm)
        earth = ('"string type" "earth" "point3 p0" [-1 -1 -1] "point3 p1" '
                 '[1 1 1] "rgb sigma_a_atmosphere" [0.05 0.05 0.05] '
                 '"rgb sigma_s_atmosphere" [1 1.5 2] "rgb sigma_a_cloud" '
                 '[0.1 0.1 0.1] "rgb sigma_s_cloud" [2 2 2] '
                 '"float innerradius_atmosphere" [0.5] '
                 '"float outerradius_atmosphere" [1] '
                 '"float innerradius_cloud" [0.55] '
                 '"float outerradius_cloud" [0.8] "float decay" [0.15] '
                 '"float rotationy" [30] "float g" [0.3] '
                 f'"string heightmap" "{hm_png}"')
        earth_cam = ('LookAt 0 0 -3.6  0 0 0  0 1 0\n'
                     'Camera "perspective" "float fov" [36]')
        earth_lights = ('LightSource "point" "rgb I" [12 12 12] '
                        '"point3 from" [2 1.5 -1.5]\n'
                        'LightSource "infinite" "rgb L" [0.05 0.05 0.08]')
        earth_files = {
            integ: write(f"earth_{integ}.pbrt", _medium_scene(
                earth, res, P19_SPP, (-1, -1, -1), (1, 1, 1), f'"{integ}"',
                earth_cam, earth_lights))
            for integ in ("volpath", "guidedvolpathvspg")}
        secs["files"] = time.perf_counter() - t19

        # ---- every CLI process at once ------------------------------------
        runs = {
            "19a nanovdb volpath": [vol_file, "--seed", "1", "--outfile",
                                    exr("nanovdb")],
            "19a nanovdb guidedvolpathvspg": [
                vspg_file, "--seed", "9", "--outfile", exr("nanovdb_vspg")],
            "19b rgbgrid": [rgb_file, "--seed", "2", "--outfile",
                            exr("rgb")],
            "19b grid": [grid_file, "--seed", "3", "--outfile", exr("grid")],
            "19b slab": [slab_file, "--seed", "4", "--outfile",
                         exr("slab")],
            "19c earth volpath": [earth_files["volpath"], "--seed", "5",
                                  "--outfile", exr("earth_volpath")],
            "19c earth guidedvolpathvspg": [
                earth_files["guidedvolpathvspg"], "--seed", "6",
                "--outfile", exr("earth_vspg")],
            "19d PIZ reference": [
                os.path.join(root, "scenes", "fogbox.pbrt"), "--resolution",
                "64x40", "--spp", "4", "--outfile", exr("piz"),
                "--mse-reference-image",
                os.path.join(root, "tests", "data", "piz_64x40.exr")]}
        started = {label: _cli_start(args) for label, args in runs.items()}

        def wait(label):
            return _cli_wait(started[label], runs[label],
                             f"{label}, {len(runs)} CLI processes at once",
                             tag)

        # ---- 19a: B2a on the same density in one box -------------------
        t0 = time.perf_counter()
        setup = build_render_setup(parse_pbrt_file(vol_file), device=dev)
        t_build = time.perf_counter() - t0
        fg = setup.scene.media.grids[0]
        assert fg.res == (n, n, n) and fg.maj_res == (64, 64, 64), fg.res
        gm16 = GridMedium.make(dens, fg.sigma_a.cpu().numpy(),
                               fg.sigma_s.cpu().numpy(), (0, 0, 0),
                               (1, 1, 1), g=float(fg.g), maj_res=16,
                               device=dev)
        box = Geometry.build(boxes=[dict(bmin=(0, 0, 0), bmax=(1, 1, 1),
                                         mat=-1, light=-1, med_in=0,
                                         med_out=-1)], device=dev)
        box_scene = dataclasses.replace(setup.scene, geometry=box,
                                        media=Media.make(grids=(gm16,),
                                                         device=dev))
        cfg = volpath.VolPathConfig(max_depth=P19_DEPTH)
        assert vk.extract_constants(setup.scene, setup.camera, setup.film,
                                    cfg) is None  # parsed: no box
        counters = (vk.LAUNCHES, sk.LAUNCHES)
        for counter in counters:
            for key in counter:
                counter[key] = 0
        img_b2a = volpath.render_persistent(
            box_scene, setup.camera, setup.film, spp=P19_B2A_SPP, cfg=cfg,
            seed=7, device=dev)
        torch.cuda.synchronize()
        launches = {k: v for counter in counters for k, v in counter.items()
                    if v}
        assert launches == {"grid": 1, "vspg_reduce": 1}, launches
        ms_b2a = _events_best_of_3(lambda: volpath.render_persistent(
            box_scene, setup.camera, setup.film, spp=P19_B2A_SPP, cfg=cfg,
            seed=7, device=dev))
        img_b2a = img_b2a.cpu().numpy()
        print(f"phase 19a B2a on the file's density in one box ({n}^3, 16^3 "
              f"majorants) {res[0]}x{res[1]}x{P19_B2A_SPP} via "
              f"render_persistent: {ms_b2a:.3f} ms the call by CUDA events, "
              f"launches {launches}, mean {img_b2a.mean():.6f}; the file "
              f"parsed and built in {t_build:.2f} s ({n}^3 grid, 64^3 "
              f"majorants) {tag}", flush=True)

        img_vol, st_vol, _ = wait("19a nanovdb volpath")
        assert st_vol["resolution"] == [P19_RES, P19_RES], st_vol
        d, z = _z(img_b2a, img_vol)
        zq = _quadrants_z(img_b2a, img_vol)
        print(f"phase 19a the NanoVDB file through the CLI (volpath) "
              f"{res[0]}x{res[1]}x{P19_SPP}: mean {img_vol.mean():.6f} "
              f"against B2a's {img_b2a.mean():.6f}, difference {d:+.6f} = "
              f"{z:+.2f} standard errors, quadrants "
              f"{[round(float(v), 2) for v in zq]} (bound 4) {tag}",
              flush=True)
        assert abs(z) <= 4.0 and max(abs(v) for v in zq) <= 4.0, (z, zq)
        img_v = wait("19a nanovdb guidedvolpathvspg")[0]
        _guided_check("19a the NanoVDB file", img_v, img_vol, tag)
        secs["19a"] = time.perf_counter() - t19 - secs["files"]

        # ---- 19b: the RGB grid ------------------------------------------
        t0 = time.perf_counter()
        img_rgb = wait("19b rgbgrid")[0]
        img_grid = wait("19b grid")[0]
        d, z = _z(img_rgb, img_grid)
        print(f"phase 19b the {m}^3 RGB grid (channels the density times "
              f"sigma) through the CLI {res_b[0]}x{res_b[1]}x{P19_SPP}: mean "
              f"{img_rgb.mean():.6f} against the grid medium's "
              f"{img_grid.mean():.6f}, difference {d:+.6f} = {z:+.2f} "
              f"standard errors (bound 4) {tag}", flush=True)
        assert abs(z) <= 4.0 and img_rgb.mean() > 0, z
        img_slab = wait("19b slab")[0]
        centre = img_slab[24:40, 24:40].reshape(-1, 3).astype(np.float64)
        want = (slab_le * (1.0 - np.exp(-slab_sa))).astype(np.float64)
        err = centre.std(0) / np.sqrt(centre.shape[0])
        zs = (centre.mean(0) - want) / np.maximum(err, 1e-12)
        print(f"phase 19b the absorbing, emissive RGB slab (sigma_a "
              f"{slab_sa.tolist()}, Le {slab_le.tolist()}, 1 thick) at its "
              f"16x16 centre pixels: {centre.mean(0).round(5).tolist()} "
              f"against Le (1 - exp(-sigma_a l)) = {want.round(5).tolist()}, "
              f"{zs.round(2).tolist()} standard errors (bound 4) {tag}",
              flush=True)
        assert np.all(np.abs(zs) <= 4.0), zs
        secs["19b"] = time.perf_counter() - t0

        # ---- 19c: the earth medium ----------------------------------------
        t0 = time.perf_counter()
        img_ev = wait("19c earth volpath")[0]
        img_eg = wait("19c earth guidedvolpathvspg")[0]
        assert np.isfinite(img_ev).all() and img_ev.mean() > 0
        _guided_check(f"19c the earth medium with a {hm.shape[1]}x"
                      f"{hm.shape[0]} PNG heightmap", img_eg, img_ev, tag)
        secs["19c"] = time.perf_counter() - t0

        # ---- 19d: a PIZ reference image -----------------------------------
        t0 = time.perf_counter()
        img_p, st_p, _ = wait("19d PIZ reference")
        ref = read_image(os.path.join(root, "tests", "data",
                                      "piz_64x40.exr"))
        line = st_p["stdout"].strip().splitlines()[-1]
        printed = float(line.split(",")[2])
        print(f"phase 19d a 64x40 CLI render with --mse-reference-image "
              f"tests/data/piz_64x40.exr (PIZ, {ref.shape[1]}x{ref.shape[0]}"
              f"): the CLI printed {line!r}, this process reads "
              f"{mse(img_p, ref):.6g} {tag}", flush=True)
        assert line.startswith("MSE,4,") and np.isfinite(printed)
        assert abs(printed - mse(img_p, ref)) <= 1e-5 * mse(img_p, ref)
        secs["19d"] = time.perf_counter() - t0
    print(f"phase 19 seconds: the files {secs['files']:.1f}, 19a "
          f"{secs['19a']:.1f}, then waiting on the CLI: 19b {secs['19b']:.1f}, "
          f"19c {secs['19c']:.1f}, 19d {secs['19d']:.1f} {tag}", flush=True)
    print(f"phase 19 done {_at()}, the phase "
          f"{time.perf_counter() - t19:.1f} s", flush=True)



# Phase 20's sizes: the CLI renders at P20_RES^2 x P20_SPP (20b's as two
# renders of half the samples a sampler, for the per-pixel variance), the
# environment a 2048x1024 lat-long image (1024^2 equal-area once built),
# 20a's API pairs and 20e's fog box at P20_PAIR_RES^2, 20e's pyro cloud at
# P20_VSPG_RES^2 with P20_VSPG_WAVES training waves and as many frozen spp
P20_RES, P20_SPP, P20_DEPTH = 256, 8, 8
P20_PAIR_RES = 128
P20_ENV = (2048, 1024)
P20_CEILING = (64, 32)  # quads: 4096 emissive triangles
P20_VSPG_RES, P20_VSPG_WAVES = 64, 2
# 20a's lane check: every light's sampling on the card against the same
# lights on the CPU (which the tests hold against the JAX package), on
# P20_LANES seeded draws; a lane agrees when every output is within
# rtol/atol (flags and indices equal), and P20_LANE_SHARE of them must
P20_LANES, P20_LANE_RTOL, P20_LANE_ATOL, P20_LANE_SHARE = (
    1 << 16, 1e-4, 1e-5, 0.999)

P20_MAT = 'Material "diffuse" "rgb reflectance" [0.6 0.55 0.5]\n'
# 20e holds the kernel-free route against backend="torch": the film adds a
# pixel's samples with index_add_, which on a card adds in no fixed order,
# so the two images agree to float32 rounding of that sum, not bit for bit
P20_ORDER_REL = 1e-5


def _rel_diff(a, b):
    """Largest |a - b| / max(|b|, 1e-6) over the image."""
    return (torch.abs(a - b) / torch.clamp(torch.abs(b), min=1e-6)).max(
        ).item()


def _quad(corners, flip=False):
    """A trianglemesh line of the quad with `corners` (4 points): the
    triangles 0 1 2 and 0 2 3, wound the other way with `flip`."""
    idx = "0 2 1  0 3 2" if flip else "0 1 2  0 2 3"
    return ('Shape "trianglemesh" "point3 P" ['
            + "  ".join(" ".join(f"{v:g}" for v in c) for c in corners)
            + f'] "integer indices" [{idx}]\n')


def _header(integrator, res, spp, camera, sampler="uniform",
            depth=P20_DEPTH):
    return (f'Integrator "{integrator}" "integer maxdepth" [{depth}] '
            f'"string lightsampler" "{sampler}"\n'
            f'Sampler "independent" "integer pixelsamples" [{spp}]\n'
            f'Film "rgb" "integer xresolution" [{res}] '
            f'"integer yresolution" [{res}]\n{camera}\nWorldBegin\n')


def _sky(w, h):
    """A smooth lat-long sky (h, w, 3) float32: brighter toward the map's
    +z pole and toward phi = pi/2, with no feature sharper than a texel of
    the portal's 128^2 warp."""
    theta = (np.arange(h) + 0.5) / h * np.pi
    phi = (np.arange(w) + 0.5) / w * 2 * np.pi
    ct = np.cos(theta)[:, None, None]
    sp = (np.sin(phi)[None, :, None] * np.sin(theta)[:, None, None])
    img = (np.asarray([0.35, 0.45, 0.7]) * (1.2 + ct)
           + np.asarray([0.5, 0.35, 0.2]) * (1.0 + sp) ** 2)
    return img.astype(np.float32)


# 20a: an open corner (a floor, a back and a left wall) seen from the front
P20_CORNER_CAMERA = ('LookAt 0 2.2 -5.5  0 0.8 0.5  0 1 0\n'
                     'Camera "perspective" "float fov" [45]')
P20_CORNER = (P20_MAT
              + _quad([(-3, 0, -3), (-3, 0, 3), (3, 0, 3), (3, 0, -3)])
              + _quad([(-3, 0, 3), (-3, 3, 3), (3, 3, 3), (3, 0, 3)])
              + _quad([(-3, 0, -3), (-3, 3, -3), (-3, 3, 3), (-3, 0, 3)]))
# 20c and 20d: a closed 4 x 3 x 4 room with a 1.6 x 1.2 window in its +z
# wall, seen from inside; the portal's corners are the window's, its frame's
# z (p1 - p0 cross p3 - p0) pointing out of the room
P20_WINDOW = ((-0.8, 0.8, 2.0), (0.8, 0.8, 2.0), (0.8, 2.0, 2.0),
              (-0.8, 2.0, 2.0))
P20_ROOM_CAMERA = ('LookAt 0 1.5 -1.9  0 0.7 1.2  0 1 0\n'
                   'Camera "perspective" "float fov" [70]')
P20_ROOM = (P20_MAT
            + _quad([(-2, 0, -2), (-2, 0, 2), (2, 0, 2), (2, 0, -2)])
            + _quad([(-2, 3, -2), (2, 3, -2), (2, 3, 2), (-2, 3, 2)])
            + _quad([(-2, 0, -2), (-2, 3, -2), (-2, 3, 2), (-2, 0, 2)])
            + _quad([(2, 0, -2), (2, 0, 2), (2, 3, 2), (2, 3, -2)])
            + _quad([(-2, 0, -2), (2, 0, -2), (2, 3, -2), (-2, 3, -2)])
            + _quad([(-2, 0, 2), (-2, 0.8, 2), (2, 0.8, 2), (2, 0, 2)])
            + _quad([(-2, 2, 2), (-2, 3, 2), (2, 3, 2), (2, 2, 2)])
            + _quad([(-2, 0.8, 2), (-2, 2, 2), (-0.8, 2, 2), (-0.8, 0.8, 2)])
            + _quad([(0.8, 0.8, 2), (0.8, 2, 2), (2, 2, 2), (2, 0.8, 2)]))
P20_FOG = ('MakeNamedMedium "fog" "string type" "homogeneous" "rgb sigma_a" '
           '[0.02 0.02 0.02] "rgb sigma_s" [0.3 0.32 0.35] "float g" [0.3]\n'
           'AttributeBegin\n  Material "interface"\n'
           '  MediumInterface "fog" ""\n'
           + _box_shape((-1.9, 0.02, -1.0), (1.9, 2.9, 1.9))
           + "AttributeEnd\n")


def _many_lights(rng):
    """20b's lights: a ceiling at y = 3 of P20_CEILING quads, 4096 emissive
    triangles facing down in 16 strips of their own radiance, and 16 point
    lights of their own intensity over the floor."""
    nx, nz = P20_CEILING
    xs, zs = np.linspace(-4, 4, nx + 1), np.linspace(-4, 4, nz + 1)
    out = []
    per = nz // 16
    for strip in range(16):
        P, idx = [], []
        for j in range(strip * per, (strip + 1) * per):
            for i in range(nx):
                b = len(P)
                P += [(xs[i], 3, zs[j]), (xs[i + 1], 3, zs[j]),
                      (xs[i + 1], 3, zs[j + 1]), (xs[i], 3, zs[j + 1])]
                idx += [b, b + 1, b + 2, b, b + 2, b + 3]
        L = rng.uniform(0.2, 3.0, 3) * (1.0 if strip % 5 else 6.0)
        out.append('AttributeBegin\n  AreaLightSource "diffuse" "rgb L" ['
                   + " ".join(f"{v:.4f}" for v in L) + ']\n'
                   '  Shape "trianglemesh" "point3 P" ['
                   + " ".join(f"{v:g}" for p in P for v in p)
                   + '] "integer indices" [' + " ".join(map(str, idx))
                   + ']\nAttributeEnd\n')
    for k in range(16):
        p = rng.uniform((-3.5, 0.3, -3.5), (3.5, 1.2, 3.5))
        I_ = rng.uniform(0.1, 1.5, 3)
        out.append('LightSource "point" "rgb I" ['
                   + " ".join(f"{v:.4f}" for v in I_) + '] "point3 from" ['
                   + " ".join(f"{v:.4f}" for v in p) + "]\n")
    return "".join(out)


def _with_distant(scene, dev):
    """`scene` with a distant light added beside its point light and
    constant environment."""
    from vspg_pbrt_v4_tpu_torch.models.lights import Lights

    li = scene.lights
    assert not li.n_area and not li.beyond_kernels
    lights = Lights.make(
        point_p=li.point_p.cpu().numpy() if li.n_point else None,
        point_I=li.point_I.cpu().numpy() if li.n_point else None,
        env_L=li.env_L.cpu().numpy() if li.has_env else None,
        distant_dir=[(0.3, -1.0, 0.2)], distant_L=[(0.6, 0.55, 0.5)],
        world_radius=li.world_radius, device=dev)
    return dataclasses.replace(scene, lights=lights)


def _launch_counts():
    """Every kernel wrapper's launch count, by name."""
    from vspg_pbrt_v4_tpu_torch.ops import surface_kernels, volpath_kernels
    from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels

    return {k: v for c in (volpath_kernels.LAUNCHES, vspg_kernels.LAUNCHES,
                           surface_kernels.LAUNCHES) for k, v in c.items()}


def _zero_launches():
    from vspg_pbrt_v4_tpu_torch.ops import surface_kernels, volpath_kernels
    from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels

    for c in (volpath_kernels.LAUNCHES, vspg_kernels.LAUNCHES,
              surface_kernels.LAUNCHES):
        for k in c:
            c[k] = 0


def _phase20(dev, tag):
    """The other lights and the light samplers on the card, at the sizes
    their users render. (a) A scene file with a spot, a goniometric and a
    projection light (their images PFMs the script writes), a distant
    light, an image environment from a 2048x1024 lat-long PFM (1024^2
    equal-area once built) and a blackbody area light over a floor and two
    walls, through the CLI under volpath at 256^2 x 16; through the API, a
    goniometric light with a constant image against a point light of the
    same I, a spot light whose full-intensity cone holds the whole scene
    against a point light of the same I, and a constant image environment
    against the constant one, each pair's means within 4 standard errors;
    and those lights (a 256x128 sky in place of the large one) under the
    bvh sampler, ``sample``, ``sample_le``, ``le_escaped`` and
    ``pdf_li_escaped`` on the card lane for lane against the same lights
    on the CPU (the spot's cone edge, the projection's and goniometric
    images, the blackbody area light and the BVH descent). (b) A ceiling
    of 4096 emissive triangles and 16 point lights over a floor under the
    bvh light sampler against the power sampler through the CLI, the means
    within 4 standard errors, each sampler's seconds and the ratio of
    their per-pixel variances printed. (c) A room lit through a window by the
    1024^2 image environment, with and without a portal on the window,
    through the CLI: the means within 4 standard errors. (d) That room with
    a box of fog under guidedvolpath and guidedvolpathvspg through the
    CLI, each mean within P19_GUIDED_REL of volpath's. (e) Phase 6's fog
    box and 7c's pyro cloud, each with a distant light added, through
    ``render_persistent`` and ``render_vspg``: no kernel launch (the
    kernels refuse these lights, as the JAX package's gates do), the image
    within P20_ORDER_REL of backend="torch"'s (the film's index_add_ adds
    in no fixed order on a card). The CLI processes run at once, beside
    this process's renders."""
    import os
    import tempfile

    from vspg_pbrt_v4_tpu_torch.models.film import RGBFilm
    from vspg_pbrt_v4_tpu_torch.models.integrators import guided_volpath
    from vspg_pbrt_v4_tpu_torch.models.integrators import volpath, vspg
    from vspg_pbrt_v4_tpu_torch.ops import volpath_kernels as vk
    from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk
    from vspg_pbrt_v4_tpu_torch.scene import (build_render_setup,
                                              parse_pbrt_string)
    from vspg_pbrt_v4_tpu_torch.utils.image import write_pfm

    t20 = time.perf_counter()
    secs = {}
    rng = np.random.default_rng(20)
    with tempfile.TemporaryDirectory() as tmp:
        def write(name, text):
            path = os.path.join(tmp, name)
            with open(path, "w") as f:
                f.write(text)
            return path

        def exr(name):
            return os.path.join(tmp, name + ".exr")

        # ---- the files ---------------------------------------------------
        sky = os.path.join(tmp, "sky.pfm")
        write_pfm(sky, _sky(*P20_ENV))
        gonio = os.path.join(tmp, "gonio.pfm")
        u = (np.arange(64) + 0.5) / 64
        write_pfm(gonio, (0.3 + np.sin(6 * u)[:, None, None] ** 2
                          * np.cos(3 * u)[None, :, None] ** 2
                          * np.ones(3)).astype(np.float32))
        proj = os.path.join(tmp, "proj.pfm")
        write_pfm(proj, rng.uniform(0.1, 1.0, (96, 128, 3)).astype(
            np.float32))
        ones = os.path.join(tmp, "ones.pfm")
        write_pfm(ones, np.ones((32, 32, 3), np.float32))
        const_env = os.path.join(tmp, "const_env.pfm")
        write_pfm(const_env, np.full((32, 64, 3), 0.4, np.float32))
        lights_a = (
            'LightSource "spot" "rgb I" [8 7 6] "point3 from" [1.5 2.5 0] '
            '"point3 to" [1 0 1] "float coneangle" [30] '
            '"float conedeltaangle" [6]\n'
            'AttributeBegin\n  Translate -1 1.8 0.5\n  Rotate 90 1 0 0\n'
            '  LightSource "goniometric" "rgb I" [3 3 3] '
            f'"string filename" "{gonio}"\nAttributeEnd\n'
            'AttributeBegin\n  Translate 0 2.5 1.5\n  Rotate 90 1 0 0\n'
            '  LightSource "projection" "rgb I" [6 6 6] "float fov" [40] '
            f'"string filename" "{proj}"\nAttributeEnd\n'
            'LightSource "distant" "rgb L" [0.8 0.75 0.7] '
            '"point3 from" [-1 3 -2] "point3 to" [0 0 0]\n'
            f'LightSource "infinite" "string filename" "{sky}" '
            '"float scale" [0.5]\n'
            'AttributeBegin\n  AreaLightSource "diffuse" "blackbody L" '
            '[2700]\n  '
            + _quad([(0.5, 1.5, 2.5), (1.5, 1.5, 2.5), (1.5, 2.3, 2.5),
                     (0.5, 2.3, 2.5)], flip=True) + 'AttributeEnd\n')
        all_file = write("all.pbrt", _header(
            "volpath", P20_RES, P20_SPP, P20_CORNER_CAMERA)
            + lights_a + P20_CORNER)
        many = _many_lights(rng)
        many_camera = ('LookAt 0 2.2 -6  0 0 0.5  0 1 0\n'
                       'Camera "perspective" "float fov" [50]')
        many_files = {
            smp: write(f"many_{smp}.pbrt", _header(
                "volpath", P20_RES, P20_SPP // 2, many_camera, smp) + many
                + P20_MAT + _quad([(-4, 0, -4), (-4, 0, 4), (4, 0, 4),
                                   (4, 0, -4)]))
            for smp in ("bvh", "power")}
        portal = (' "point3 portal" ['
                  + "  ".join(" ".join(f"{v:g}" for v in c)
                              for c in P20_WINDOW) + "]")
        env = f'LightSource "infinite" "string filename" "{sky}"'
        room = {name: write(f"room_{name}.pbrt", _header(
            "volpath", P20_RES, P20_SPP, P20_ROOM_CAMERA)
            + env + (portal if name == "portal" else "") + "\n" + P20_ROOM)
            for name in ("env", "portal")}
        fog = {}
        for integ in ("volpath", "guidedvolpath", "guidedvolpathvspg"):
            head = _header(integ, P20_RES, P20_SPP, P20_ROOM_CAMERA)
            if integ == "guidedvolpathvspg":
                head = head.replace('"string lightsampler" "uniform"',
                                    '"string isgbdenoiser" "atrous"')
            fog[integ] = write(f"fog_{integ}.pbrt", head + env + portal
                               + "\n" + P20_ROOM + P20_FOG)
        secs["files"] = time.perf_counter() - t20

        # ---- every CLI process at once ------------------------------------
        runs = {"20a every light": [all_file, "--seed", "1", "--outfile",
                                    exr("all")]}
        for smp in ("bvh", "power"):
            for half in (0, 1):
                runs[f"20b {smp} {half}"] = [
                    many_files[smp], "--seed", str(2 + half), "--outfile",
                    exr(f"many_{smp}_{half}")]
        for name in ("env", "portal"):
            runs[f"20c {name}"] = [room[name], "--seed", "4", "--outfile",
                                   exr(f"room_{name}")]
        for integ in fog:
            runs[f"20d {integ}"] = [fog[integ], "--seed", "5", "--outfile",
                                    exr(f"fog_{integ}")]
        started = {label: _cli_start(args) for label, args in runs.items()}

        def wait(label):
            return _cli_wait(started[label], runs[label],
                             f"{label}, {len(runs)} CLI processes at once",
                             tag)

        # ---- 20a: the API pairs -----------------------------------------
        t0 = time.perf_counter()
        head = _header("volpath", P20_PAIR_RES, P20_SPP, P20_CORNER_CAMERA)
        pairs = {
            "a goniometric light with a constant image against a point "
            "light of the same I": (
                'AttributeBegin\n  Translate 0 1.5 0.5\n  Rotate 40 1 1 0\n'
                '  LightSource "goniometric" "rgb I" [3 3 3] '
                f'"string filename" "{ones}"\nAttributeEnd\n',
                'LightSource "point" "rgb I" [3 3 3] "point3 from" '
                '[0 1.5 0.5]\n'),
            "a spot light whose full-intensity cone holds the whole scene "
            "against a point light of the same I": (
                'LightSource "spot" "rgb I" [3 3 3] "point3 from" '
                '[0 1.5 0.5] "point3 to" [0 0 0.5] "float coneangle" [170] '
                '"float conedeltaangle" [10]\n',
                'LightSource "point" "rgb I" [3 3 3] "point3 from" '
                '[0 1.5 0.5]\n'),
            "a constant image environment against the constant one": (
                f'LightSource "infinite" "string filename" "{const_env}"\n',
                'LightSource "infinite" "rgb L" [0.4 0.4 0.4]\n')}
        # seeds of their own: the spot and the goniometric light stand where
        # the point light does and draw alike, so one seed gives one image
        for i, (what, (text_a, text_b)) in enumerate(pairs.items()):
            imgs = []
            for seed, text in ((6 + 2 * i, text_a), (7 + 2 * i, text_b)):
                setup = build_render_setup(parse_pbrt_string(
                    head + text + P20_CORNER), device=dev)
                imgs.append(volpath.render(
                    setup.scene, setup.camera, setup.film, spp=P20_SPP,
                    cfg=volpath.VolPathConfig(max_depth=P20_DEPTH),
                    seed=seed, spp_per_pass=P20_SPP,
                    device=dev).cpu().numpy())
            d, z = _z(*imgs)
            print(f"phase 20a {what} through build_render_setup + "
                  f"volpath.render {P20_PAIR_RES}^2 x {P20_SPP}: means "
                  f"{imgs[0].mean():.6f} and {imgs[1].mean():.6f}, "
                  f"difference {d:+.6f} = {z:+.2f} standard errors "
                  f"(bound 4) {tag}", flush=True)
            assert np.isfinite(imgs[0]).all() and imgs[0].mean() > 0.01
            assert abs(z) <= 4.0, (what, z)
        secs["20a pairs"] = time.perf_counter() - t0

        # ---- 20a: every light's sampling, the card against the CPU ---------
        t0 = time.perf_counter()
        sky_small = os.path.join(tmp, "sky_small.pfm")
        write_pfm(sky_small, _sky(256, 128))
        lights = build_render_setup(parse_pbrt_string(
            _header("volpath", P20_PAIR_RES, P20_SPP, P20_CORNER_CAMERA,
                    "bvh") + lights_a.replace(sky, sky_small) + P20_CORNER),
            device=dev).scene.lights
        n = P20_LANES
        ref_p = rng.uniform((-3, 0, -3), (3, 3, 3), (n, 3))
        d = rng.normal(size=(n, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        u1 = rng.uniform(0, 1, (2, n))
        u2 = rng.uniform(0, 1, (2, n, 2))
        draws = [x.astype(np.float32) for x in (ref_p, d, *u1, *u2)]
        outs = {}
        for where, lt, on in (("card", lights, dev),
                              ("cpu", lights.to("cpu"), "cpu")):
            p_, d_, us, ul, ua, ub = (torch.from_numpy(x).to(on)
                                      for x in draws)
            s_ = lt.sample(p_, us, ua)
            le = lt.sample_le(us, ul, ua, ub)
            outs[where] = dict(
                {f"sample.{k}": v for k, v in s_._asdict().items()},
                **{f"sample_le[{i}]": v for i, v in enumerate(le)},
                le_escaped=lt.le_escaped(d_, p_),
                pdf_li_escaped=lt.pdf_li_escaped(d_, p_))
        agree = torch.ones(n, dtype=torch.bool)
        worst = {}
        for k, want in outs["cpu"].items():
            got = outs["card"][k].cpu()
            if want.is_floating_point():
                ok = torch.isclose(got, want, rtol=P20_LANE_RTOL,
                                   atol=P20_LANE_ATOL, equal_nan=True)
            else:
                ok = got == want
            ok = ok.reshape(n, -1).all(-1)
            worst[k] = ok.float().mean().item()
            agree &= ok
        share = agree.float().mean().item()
        low = min(worst, key=worst.get)
        picked = torch.bincount(
            outs["card"]["sample.light_idx"].clamp(min=0).cpu()).tolist()
        print(f"phase 20a spot, goniometric, projection, distant, image "
              f"environment and blackbody area lights under the bvh sampler: "
              f"sample, sample_le, le_escaped and pdf_li_escaped on the card "
              f"against the CPU on {n} lanes: {share:.6f} of lanes agree "
              f"within rtol {P20_LANE_RTOL:g} atol {P20_LANE_ATOL:g}, flags "
              f"and indices equal (bound {P20_LANE_SHARE}); least {low} "
              f"{worst[low]:.6f}; lanes by light picked {picked} {tag}",
              flush=True)
        assert share >= P20_LANE_SHARE, (share, worst)
        secs["20a lanes"] = time.perf_counter() - t0

        # ---- 20e: lights no kernel serves ---------------------------------
        t0 = time.perf_counter()
        cfg6 = volpath.VolPathConfig(max_depth=32, max_events=128,
                                     max_collisions=2048)
        res = P20_PAIR_RES
        cam, film = (vk.bench_camera(res, device=dev),
                     RGBFilm.make((res, res), device=dev))
        fogbox = _with_distant(vk.make_fog_box_scene(device=dev), dev)
        assert vk.extract_constants(fogbox, cam, film, cfg6) is None
        _zero_launches()
        img = volpath.render_persistent(fogbox, cam, film,
                                        spp=P20_SPP // 2, cfg=cfg6, seed=8,
                                        device=dev)
        torch.cuda.synchronize()
        launched = {k: v for k, v in _launch_counts().items() if v}
        ref = volpath.render_persistent(fogbox, cam, film, spp=P20_SPP // 2,
                                        cfg=cfg6, seed=8, backend="torch",
                                        device=dev)
        rel = _rel_diff(img, ref)
        print(f"phase 20e phase 6's fog box with a distant light through "
              f"render_persistent {res}^2 x {P20_SPP // 2}: kernel launches "
              f"{launched or 0}, the image against backend='torch': largest "
              f"relative difference {rel:.3e} (bound {P20_ORDER_REL:g}), "
              f"mean {img.mean().item():.6f} {tag}", flush=True)
        assert not launched and rel <= P20_ORDER_REL
        assert bool(torch.isfinite(img).all())
        cfg7 = volpath.VolPathConfig(max_depth=64, max_events=256,
                                     max_collisions=4096)
        gopt = guided_volpath.GuidingOptions(
            field_res=8, record_depth=6, min_train_weight=16.0,
            train_waves=P20_VSPG_WAVES)
        vopt = vspg.VSPGOptions(vsp_criterion="contribution")
        pyro = _with_distant(sk.make_pyro64_scene(device=dev), dev)
        res = P20_VSPG_RES
        cam, film = (vk.bench_camera(res, device=dev),
                     RGBFilm.make((res, res), device=dev))
        images = []
        for backend in ("auto", "torch"):
            _zero_launches()
            sk.LAUNCH_EVENTS = []
            img, field, _ = vspg.render_vspg(
                pyro, cam, film, spp=2 * P20_VSPG_WAVES, cfg=cfg7, gopt=gopt,
                vopt=vopt, seed=9, backend=backend, device=dev)
            torch.cuda.synchronize()
            events, sk.LAUNCH_EVENTS = sk.LAUNCH_EVENTS, None
            launched = {k: v for k, v in _launch_counts().items() if v}
            assert not launched and not events, (backend, launched)
            images.append(img)
        rel = _rel_diff(*images)
        print(f"phase 20e 7c's pyro cloud with a distant light through "
              f"render_vspg(backend='auto') {res}^2, {P20_VSPG_WAVES} "
              f"training waves + {P20_VSPG_WAVES} spp: kernel launches 0, "
              f"kernel events 0, {field.iteration} training updates, the "
              f"image against backend='torch': largest relative difference "
              f"{rel:.3e} (bound {P20_ORDER_REL:g}), mean "
              f"{images[0].mean().item():.6f} {tag}", flush=True)
        assert rel <= P20_ORDER_REL and field.iteration == P20_VSPG_WAVES
        assert bool(torch.isfinite(images[0]).all())
        secs["20e"] = time.perf_counter() - t0

        # ---- 20a: every light through the CLI -----------------------------
        t0 = time.perf_counter()
        img_a, st_a, _ = wait("20a every light")
        assert st_a["resolution"] == [P20_RES, P20_RES], st_a
        assert img_a.mean() > 0.01 and (img_a > 0).mean() > 0.9
        secs["20a CLI"] = time.perf_counter() - t0

        # ---- 20b: the BVH light sampler against the power sampler ----------
        t0 = time.perf_counter()
        got = {}
        for smp in ("bvh", "power"):
            halves = [wait(f"20b {smp} {h}") for h in (0, 1)]
            a, b = (x[0].astype(np.float64) for x in halves)
            got[smp] = ((a + b) / 2, np.mean((a - b) ** 2) / 2,
                        sum(x[1]["seconds"] for x in halves),
                        halves[0][1]["build_seconds"])
        d, z = _z(got["bvh"][0], got["power"][0])
        ratio = got["bvh"][1] / got["power"][1]
        print(f"phase 20b 4096 emissive triangles and 16 point lights "
              f"{P20_RES}^2 x {P20_SPP} (two {P20_SPP // 2}-spp CLI renders a "
              f"sampler): bvh {got['bvh'][2]:.2f} s (parse and build "
              f"{got['bvh'][3]:.2f} s), power {got['power'][2]:.2f} s (parse "
              f"and build {got['power'][3]:.2f} s); means "
              f"{got['bvh'][0].mean():.6f} and {got['power'][0].mean():.6f}, "
              f"difference {d:+.6f} = {z:+.2f} standard errors (bound 4); "
              f"per-pixel variance at {P20_SPP // 2} spp bvh/power "
              f"{ratio:.4f} {tag}", flush=True)
        assert abs(z) <= 4.0 and got["bvh"][0].mean() > 0.01, z
        secs["20b"] = time.perf_counter() - t0

        # ---- 20c: the window, with and without a portal --------------------
        t0 = time.perf_counter()
        img_env, img_portal = (wait(f"20c {n}")[0] for n in ("env",
                                                              "portal"))
        d, z = _z(img_portal, img_env)
        print(f"phase 20c the room lit through its window by the "
              f"{P20_ENV[1]}^2 image environment {P20_RES}^2 x {P20_SPP}: "
              f"with the portal mean {img_portal.mean():.6f}, without "
              f"{img_env.mean():.6f}, difference {d:+.6f} = {z:+.2f} standard "
              f"errors (bound 4) {tag}", flush=True)
        assert abs(z) <= 4.0 and img_env.mean() > 0.01, z
        secs["20c"] = time.perf_counter() - t0

        # ---- 20d: the guided integrators in the fogged room ----------------
        t0 = time.perf_counter()
        img_v = wait("20d volpath")[0]
        assert img_v.mean() > 0.01
        for integ in ("guidedvolpath", "guidedvolpathvspg"):
            img_g = wait(f"20d {integ}")[0]
            d, z = _z(img_g, img_v)
            rel = d / img_v.mean()
            print(f"phase 20d the fogged room through the portal under "
                  f"{integ} through the CLI {P20_RES}^2 x {P20_SPP}: mean "
                  f"{img_g.mean():.6f} against volpath's {img_v.mean():.6f}, "
                  f"difference {d:+.6f} = {rel:+.4%} = {z:+.2f} standard "
                  f"errors (bound {P19_GUIDED_REL:.0%} of the mean; "
                  f"ROADMAP.md section C 7) {tag}", flush=True)
            assert np.isfinite(img_g).all() and abs(rel) <= P19_GUIDED_REL, (
                integ, rel, z)
        secs["20d"] = time.perf_counter() - t0
    print("phase 20 seconds: " + ", ".join(f"{k} {v:.1f}"
                                           for k, v in secs.items())
          + f" {tag}", flush=True)
    print(f"phase 20 done {_at()}, the phase "
          f"{time.perf_counter() - t20:.1f} s", flush=True)



# Phase 21's sizes: 21a's lanes (P21_LANES seeded draws a material or
# texture kind, the card against the CPU; a lane agrees when every output
# is within rtol/atol and its flags are equal, and P21_LANE_SHARE of them
# must), 21b's API pairs at P21_PAIR_RES^2 x P21_PAIR_SPP, 21c's gate
# renders at P21_GATE_RES^2, 21d's CLI renders at P21_RES^2 x P21_SPP
P21_LANES, P21_LANE_RTOL, P21_LANE_ATOL, P21_LANE_SHARE = (
    1 << 16, 1e-4, 1e-5, 0.9999)
# the coats of the smooth plastic (a Trowbridge-Reitz lobe of alpha 0.01,
# the clamp of roughness 0) and of the coated conductor (0.05) turn the
# last-bit differences of the card's and the CPU's sin, cos, sqrt and exp
# in a sampled direction into up to 7e-3 relative of the sample's f and
# pdf (6.5% and 1% of lanes beyond 1e-4 on an NVIDIA H100 80GB HBM3):
# their lanes are held at this rtol
P21_COAT_RTOL = 1e-2
P21_COATS = ("plastic", "coated conductor")
# hair's sampled f chains Mp's exp and log-Bessel terms (an exponent 1/v up
# to 1e5 for a smooth fibre) and the trimmed logistic's inverse (0.05% of
# lanes beyond 1e-4 relative, the 0.9999 quantile 6.1e-4 on an NVIDIA
# H100 80GB HBM3), so its lanes are held at this rtol
P21_HAIR_RTOL = 1e-3
P21_PAIR_RES, P21_PAIR_SPP, P21_DEPTH = 128, 8, 5
P21_GATE_RES = 16
P21_RES, P21_SPP, P21_GUIDED_PASS = 256, 16, 8
P21_IMAGE = 2048  # 21d's imagemap, a common texture size
P21_PTEX = (64, 64, 16)  # 21d's Ptex quad mesh: 64 x 64 faces at 16^2
P21_MERL = (90, 90, 180)  # a MERL file's native table
# 21a's material rows: every kind, a rough dielectric, a smooth plastic
# (its coat's alpha clamped to 0.01) and a mix (resolved by the hit
# position first), a MERL table, hair and subsurface
P21_MATERIALS = {
    "diffuse": [dict(type=0, albedo=(0.6, 0.5, 0.4))],
    "smooth conductor": [dict(type=1, albedo=(0.9, 0.7, 0.4))],
    "rough conductor": [dict(type=1, albedo=(0.9, 0.7, 0.4),
                             roughness=0.25)],
    "smooth dielectric": [dict(type=2, eta=1.5)],
    "rough dielectric": [dict(type=2, eta=1.5, roughness=0.3)],
    "diffuse transmission": [dict(type=3, albedo=(0.6, 0.5, 0.4),
                                  albedo2=(0.2, 0.3, 0.25))],
    "thin dielectric": [dict(type=4, eta=1.5)],
    "plastic": [dict(type=5, albedo=(0.6, 0.3, 0.2), eta=1.5)],
    "coated diffuse": [dict(type=5, albedo=(0.6, 0.3, 0.2), roughness=0.1,
                            eta=1.5)],
    "coated conductor": [dict(type=6, albedo=(0.9, 0.6, 0.3),
                              roughness=0.2, roughness2=0.05, eta=1.5)],
    "mix": [dict(type=1, albedo=(0.9, 0.7, 0.4), roughness=0.2),
            dict(type=5, albedo=(0.2, 0.5, 0.7), roughness=0.2),
            dict(type=7, mix_m1=0, mix_m2=1, mix_amount=0.4)],
    "hair": [dict(type=8, albedo2=(0.42, 0.7, 1.4), eta=1.55,
                  roughness=0.3, roughness2=0.3,
                  mix_amount=float(np.radians(2.0)))],
    "subsurface": [dict(type=9, albedo=(0.8, 0.7, 0.6),
                        albedo2=(0.3, 0.2, 0.1), eta=1.33)],
    "measured": [dict(type=10, meas_id=0)],
    "cooktorrance": [dict(type=11, albedo=(0.65, 0.3, 0.2), eta=1.5,
                          roughness=0.3)],
}
# 21a's texture rows: every kind; the nested ones over a noise and an image
P21_TEXTURES = [
    dict(kind=0, c0=(0.3, 0.4, 0.5)),
    dict(kind=1, c0=(0.9, 0.1, 0.1), c1=(0.1, 0.8, 0.2), uvscale=(6.0, 4.0)),
    dict(kind=2, image_id=0, uvscale=(2.0, 3.0)),
    dict(kind=3, c0=(0.6, 0.5, 0.4), inner=7),
    dict(kind=4, c0=(0.4,) * 3, inner=2, inner2=5),
    dict(kind=5, octaves=8, omega=0.5, scale=3.0),
    dict(kind=6, octaves=5, omega=0.6, scale=4.0),
    dict(kind=7, octaves=6, omega=0.5, scale=2.0, variation=0.5),
    dict(kind=8, c0=(0.2, 0.6, 0.3), c1=(0.9, 0.1, 0.1), uvscale=(6.0, 6.0)),
    dict(kind=9),
    dict(kind=10),
    dict(kind=11, c0=(1, 0, 0), c1=(0, 1, 0), c2=(0, 0, 1), c3=(1, 1, 0),
         uvscale=(2.0, 1.0)),
]


def _write_merl(path, vals):
    """A MERL .binary of the (3, theta_h, theta_d, phi_d) BRDF values
    `vals`, in MERL's scaling of its float64 channels."""
    scale = np.asarray([1 / 1500, 1.15 / 1500, 1.66 / 1500])
    with open(path, "wb") as f:
        f.write(np.asarray(vals.shape[1:], np.int32).tobytes())
        f.write((vals / scale[:, None, None, None]).astype(
            np.float64).tobytes())


def _glossy_brdf(dims, rng):
    """A smooth, mildly glossy BRDF on a MERL grid of `dims` (90 x 90 x 180
    is the format's own): a lobe in theta_h, tinted, with a 5% ripple."""
    theta_h = (np.arange(dims[0]) + 0.5) / dims[0] * (np.pi / 2)
    lobe = (0.2 + 2.0 * np.exp(-(theta_h / 0.3) ** 2)) / np.pi
    ripple = 1.0 + 0.05 * rng.uniform(-1, 1, dims[1:])
    return np.stack([tint * lobe[:, None, None] * ripple
                     for tint in (0.9, 0.6, 0.4)])


def _lanes_agree(card, cpu, rtol=P21_LANE_RTOL):
    """Per lane: every float output of `card` within rtol / P21_LANE_ATOL
    of `cpu`'s, every other output equal. Returns (the lanes' agreement,
    the least share of any one output, the largest relative difference
    of the float outputs and its 0.9999 quantile over the lanes)."""
    n = next(iter(cpu.values())).shape[0]
    agree = torch.ones(n, dtype=torch.bool)
    worst = {}
    rel = torch.zeros(n)
    for k, want in cpu.items():
        got = card[k].cpu()
        if want.is_floating_point():
            ok = torch.isclose(got, want, rtol=rtol, atol=P21_LANE_ATOL,
                               equal_nan=True)
            r = (torch.abs(got - want) / (torch.abs(want) + P21_LANE_ATOL)
                 ).reshape(n, -1).amax(-1)
            rel = torch.maximum(rel, torch.nan_to_num(r))
        else:
            ok = got == want
        ok = ok.reshape(n, -1).all(-1)
        worst[k] = ok.float().mean().item()
        agree &= ok
    return agree, worst, (rel.max().item(), torch.quantile(
        rel, P21_LANE_SHARE).item())


def _phase21(dev, tag):
    """The other materials and textures on the card, at the sizes their
    users render. (a) P21_LANES lanes of every material kind (a rough
    dielectric, a smooth plastic, a mix resolved by the hit position, a
    MERL table at its native 90 x 90 x 180, hair, subsurface) through
    gather_textured, bsdf_f, bsdf_pdf and bsdf_sample, and of every
    texture kind through eval_texture with world positions, on the card
    against the CPU. (b) API renders at P21_PAIR_RES^2: a measured
    Lambertian table against diffuse of the same albedo, mix(A, B, 0.5)
    against the mean of A's and B's renders, a constant imagemap against
    a constant texture of its colour, scale(t, 1) against t, each within 4
    standard errors; the JAX tests' analytic furnaces with their bounds (a
    thin-dielectric pane in a furnace, tests/test_materials_ext.py:141;
    the white subsurface slab, tests/test_bssrdf.py:96). (c) The teaser
    cloud with each new kind in turn and a non-checker texture: no kernel
    launch through render_persistent and render_vspg(backend="auto"), the
    image within P20_ORDER_REL of backend="torch"'s; with kinds 0, 1, 2,
    11 and a checker the kernels still launch (B2b; B3c/B4c untextured).
    (d) A scene file the script writes with every material and texture, a
    2048^2 imagemap, a Ptex mesh of 4096 faces at 16^2 texels and a MERL
    file at its native size, in fog, through the CLI at P21_RES^2 x
    P21_SPP under volpath, guidedvolpath and guidedvolpathvspg (the guided
    ones in P21_GUIDED_PASS-spp waves, the field trained on the first; at
    once, beside b-c): finite, guidedvolpath within 4 standard errors of
    volpath, guidedvolpathvspg within P19_GUIDED_REL of its mean."""
    import os
    import tempfile

    from vspg_pbrt_v4_tpu_torch.models import materials as M
    from vspg_pbrt_v4_tpu_torch.models import textures as T
    from vspg_pbrt_v4_tpu_torch.models.cameras import PerspectiveCamera
    from vspg_pbrt_v4_tpu_torch.models.film import RGBFilm
    from vspg_pbrt_v4_tpu_torch.models.integrators import guided_volpath
    from vspg_pbrt_v4_tpu_torch.models.integrators import volpath, vspg
    from vspg_pbrt_v4_tpu_torch.models.lights import Lights
    from vspg_pbrt_v4_tpu_torch.models.media import Media
    from vspg_pbrt_v4_tpu_torch.models.shapes import Geometry
    from vspg_pbrt_v4_tpu_torch.ops import volpath_kernels as vk
    from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk
    from vspg_pbrt_v4_tpu_torch.scene import (build_render_setup,
                                              parse_pbrt_string)
    from vspg_pbrt_v4_tpu_torch.tools.ptex import write_ptx
    from vspg_pbrt_v4_tpu_torch.utils import transform as tr
    from vspg_pbrt_v4_tpu_torch.utils.image import write_pfm

    t21 = time.perf_counter()
    secs = {}
    rng = np.random.default_rng(21)
    with tempfile.TemporaryDirectory() as tmp:
        def path(name):
            return os.path.join(tmp, name)

        # ---- the files: 21d's scene and what it reads ----------------------
        write_pfm(path("img.pfm"), rng.uniform(
            0.05, 0.95, (P21_IMAGE, P21_IMAGE, 3)).astype(np.float32))
        _write_merl(path("merl.binary"), _glossy_brdf(P21_MERL, rng))
        fx, fz, fres = P21_PTEX
        cols = rng.uniform(0.1, 0.9, (fx * fz, 3)).astype(np.float32)
        grad = np.linspace(0.8, 1.2, fres, dtype=np.float32)
        write_ptx(path("faces.ptx"), [c * grad[:, None, None]
                                      * np.ones((fres, fres, 3), np.float32)
                                      for c in cols], datatype="half")
        write_pfm(path("grey.pfm"), np.full((8, 8, 3), 0.45, np.float32))
        scene_texts = _p21_scene_texts(tmp)
        files = {}
        for integ, text in scene_texts.items():
            files[integ] = path(f"{integ}.pbrt")
            with open(files[integ], "w") as f:
                f.write(text)
        secs["files"] = time.perf_counter() - t21

        # ---- 21a: every material and texture kind, card against CPU --------
        t0 = time.perf_counter()
        n = P21_LANES
        fails = []
        bank = M.load_merl_brdf(path("merl.binary"))[None]
        for name, rows in P21_MATERIALS.items():
            mats = M.Materials.build(rows, bank, device="cpu")
            mid = np.full(n, len(rows) - 1, np.int32)
            draws = [mid, rng.uniform(0, 1, (n, 2)), rng.uniform(-4, 4, (n, 3)),
                     rng.normal(size=(n, 3)), rng.normal(size=(n, 3)),
                     rng.uniform(0, 1, n), rng.uniform(0, 1, (n, 2))]
            for k in (3, 4):
                draws[k] /= np.linalg.norm(draws[k], axis=-1, keepdims=True)
            draws = [x if x.dtype == np.int32 else x.astype(np.float32)
                     for x in draws]
            outs = {}
            for where, mt, on in (("card", mats.to(dev), dev),
                                  ("cpu", mats, "cpu")):
                m_, uv, p_, wo, wi, ul, u2 = (torch.from_numpy(x).to(on)
                                              for x in draws)
                lanes = mt.gather_textured(None, m_, uv, p_)
                bs = M.bsdf_sample(lanes, wo, ul, u2)
                outs[where] = dict(
                    mat_type=lanes.mat_type, f=M.bsdf_f(lanes, wo, wi),
                    pdf=M.bsdf_pdf(lanes, wo, wi),
                    **{f"sample.{k}": v for k, v in bs._asdict().items()})
            rtol = (P21_COAT_RTOL if name in P21_COATS else P21_HAIR_RTOL
                    if name == "hair" else P21_LANE_RTOL)
            agree, worst, (rel_max, rel_q) = _lanes_agree(
                outs["card"], outs["cpu"], rtol)
            share = agree.float().mean().item()
            low = min(worst, key=worst.get)
            valid = outs["cpu"]["sample.valid"].float().mean().item()
            print(f"phase 21a {name}: gather_textured, bsdf_f, bsdf_pdf and "
                  f"bsdf_sample on the card against the CPU on {n} lanes: "
                  f"{share:.6f} agree within rtol {rtol:g} atol "
                  f"{P21_LANE_ATOL:g}, flags equal (bound {P21_LANE_SHARE}); "
                  f"least {low} {worst[low]:.6f}; relative differences: "
                  f"largest {rel_max:.3e}, 0.9999 of lanes within "
                  f"{rel_q:.3e}; sampled valid {valid:.4f} {tag}",
                  flush=True)
            if share < P21_LANE_SHARE:
                fails.append((name, share, worst))
        imgs = [rng.uniform(0, 1, s + (3,)).astype(np.float32)
                for s in ((7, 5), (64, 48))]
        tex = T.Textures.build(P21_TEXTURES, imgs, device="cpu")
        for k, row in enumerate(P21_TEXTURES):
            draws = [np.full(n, k, np.int32),
                     rng.uniform(-2, 2, (n, 2)).astype(np.float32),
                     rng.uniform(-3, 3, (n, 3)).astype(np.float32)]
            outs = {}
            for where, tb, on in (("card", tex.to(dev), dev),
                                  ("cpu", tex, "cpu")):
                t_, uv, p_ = (torch.from_numpy(x).to(on) for x in draws)
                outs[where] = dict(rgb=T.eval_texture(tb, t_, uv, p_))
            agree, _, (rel_max, rel_q) = _lanes_agree(outs["card"],
                                                      outs["cpu"])
            share = agree.float().mean().item()
            print(f"phase 21a texture kind {row['kind']}: eval_texture with "
                  f"world positions on the card against the CPU on {n} "
                  f"lanes: {share:.6f} agree (bound {P21_LANE_SHARE}); "
                  f"relative differences: largest {rel_max:.3e}, 0.9999 of "
                  f"lanes within {rel_q:.3e} {tag}", flush=True)
            if share < P21_LANE_SHARE:
                fails.append((row, share))
        assert not fails, fails
        secs["21a"] = time.perf_counter() - t0
        print(f"phase 21a done {_at()}, {secs['21a']:.1f} s", flush=True)
        # the CLI processes start after 21a, whose CPU half they would slow
        # volpath renders its 16 spp in one pass, the guided integrators in
        # P21_GUIDED_PASS-spp waves: the field trains on the first wave's
        # samples and guides the later waves
        runs = {f"21d {integ}": [
            files[integ], "--seed", str(3 + i), "--outfile",
            path(f"{integ}.exr"), "--spp-per-pass",
            str(P21_SPP if integ == "volpath" else P21_GUIDED_PASS)]
            for i, integ in enumerate(files)}
        started = {label: _cli_start(args) for label, args in runs.items()}

        # ---- 21b: the API pairs and the analytic furnaces ------------------
        t0 = time.perf_counter()
        head = (f'Film "rgb" "integer xresolution" [{P21_PAIR_RES}] '
                f'"integer yresolution" [{P21_PAIR_RES}]\n'
                'LookAt 0 2.5 -4  0 0.3 0.5  0 1 0\n'
                'Camera "perspective" "float fov" [40]\nWorldBegin\n'
                'LightSource "infinite" "rgb L" [0.5 0.55 0.6]\n'
                'LightSource "point" "rgb I" [5 5 5] "point3 from" '
                '[1 3 -1]\n')
        floor = ('Shape "trianglemesh" "point3 P" [-3 0 -3  -3 0 3  3 0 3  '
                 '3 0 -3] "integer indices" [0 1 2  0 2 3] "point2 uv" '
                 '[0 0  0 1  1 1  1 0]\n')
        ball = 'Shape "sphere" "float radius" [0.7]\n'
        lamb = path("lambert.binary")
        _write_merl(lamb, np.full((3, 9, 9, 18), 0.55 / np.pi))
        cfg_b = volpath.VolPathConfig(max_depth=P21_DEPTH)

        def render(body, seed):
            setup = build_render_setup(parse_pbrt_string(head + body),
                                       device=dev)
            return volpath.render(
                setup.scene, setup.camera, setup.film, spp=P21_PAIR_SPP,
                cfg=cfg_b, seed=seed, spp_per_pass=P21_PAIR_SPP,
                device=dev).cpu().numpy()

        tex_a = ('Texture "t" "spectrum" "fbm" "float scale" [3]\n'
                 'Texture "s" "spectrum" "scale" "string tex" "t" '
                 '"rgb scale" [1 1 1]\n')
        pairs = {
            "a measured Lambertian table (a MERL file of albedo 0.55) "
            "against diffuse of albedo 0.55": (
                f'Material "measured" "string filename" "{lamb}"\n' + ball,
                'Material "diffuse" "rgb reflectance" [0.55 0.55 0.55]\n'
                + ball),
            "a constant 8x8 imagemap against a constant texture of its "
            "colour": (
                f'Texture "i" "spectrum" "imagemap" "string filename" '
                f'"{path("grey.pfm")}"\n'
                'Material "diffuse" "texture reflectance" "i"\n' + floor,
                'Texture "c" "spectrum" "constant" "rgb value" '
                '[0.45 0.45 0.45]\n'
                'Material "diffuse" "texture reflectance" "c"\n' + floor),
            "scale(fbm, 1) against fbm": (
                tex_a + 'Material "diffuse" "texture reflectance" "s"\n'
                + floor + ball,
                tex_a + 'Material "diffuse" "texture reflectance" "t"\n'
                + floor + ball)}
        for i, (what, (text_a, text_b)) in enumerate(pairs.items()):
            imgs = [render(text_a, 30 + 2 * i), render(text_b, 31 + 2 * i)]
            d, z = _z(*imgs)
            err = d / z if z else 0.0
            print(f"phase 21b {what}, {P21_PAIR_RES}^2 x {P21_PAIR_SPP}: "
                  f"means {imgs[0].mean():.6f} and {imgs[1].mean():.6f}, "
                  f"difference {d:+.6f}, standard error {err:.6f}, {z:+.2f} "
                  f"standard errors (bound 4) {tag}", flush=True)
            assert np.isfinite(imgs[0]).all() and imgs[0].mean() > 0.01
            assert abs(z) <= 4.0, (what, z)
        named = ('MakeNamedMaterial "a" "string type" "conductor" '
                 '"rgb reflectance" [0.9 0.6 0.3] "float roughness" [0.2]\n'
                 'MakeNamedMaterial "b" "string type" "plastic" '
                 '"rgb reflectance" [0.2 0.5 0.7] "float roughness" [0.1]\n')
        # the ball alone, convex: no path meets it twice, so the mix's
        # image is its parts' mean in expectation (with a floor, a path
        # from A over the floor to B would have no such term)
        img_m = render(named + 'Material "mix" "string materials" ["a" "b"] '
                       '"float amount" [0.5]\n' + ball, 40)
        img_a = render(named + 'NamedMaterial "a"\n' + ball, 41)
        img_b = render(named + 'NamedMaterial "b"\n' + ball, 42)
        d, z = _z(img_m, 0.5 * (img_a + img_b))
        print(f"phase 21b mix(A, B, 0.5) of a rough conductor and a plastic "
              f"against the mean of A's and B's renders, {P21_PAIR_RES}^2 x "
              f"{P21_PAIR_SPP}: means {img_m.mean():.6f} and "
              f"{0.5 * (img_a.mean() + img_b.mean()):.6f}, difference "
              f"{d:+.6f}, standard error {d / z:.6f}, {z:+.2f} standard "
              f"errors (bound 4) {tag}", flush=True)
        assert abs(z) <= 4.0, z
        # the thin-dielectric pane in a furnace (R + T = 1 a sample)
        L0 = 0.8
        pane = [dict(p0=(-3, -3, 0), p1=(3, -3, 0), p2=(3, 3, 0), mat=0),
                dict(p0=(-3, -3, 0), p1=(3, 3, 0), p2=(-3, 3, 0), mat=0)]
        scene = volpath.Scene(
            Geometry.build(triangles=pane, device=dev),
            M.Materials.build([dict(type=M.THIN_DIELECTRIC, eta=1.5)],
                              device=dev), Media.make(device=dev),
            Lights.make(env_L=[L0] * 3, world_radius=50.0, device=dev))
        cam = PerspectiveCamera.make(
            tr.look_at((0, 0, -4), (0, 0, 0), (0, 1, 0), device=dev), 40.0,
            (24, 24), device=dev)
        img = volpath.render(scene, cam, RGBFilm.make((24, 24), device=dev),
                             spp=64, cfg=volpath.VolPathConfig(max_depth=16),
                             seed=3, spp_per_pass=64, device=dev)
        m_thin = img.mean().item()
        # the white subsurface slab (A = 1) in a unit furnace
        slab = [dict(p0=(-8, 0, -8), p1=(8, 0, -8), p2=(8, 0, 8), mat=0),
                dict(p0=(-8, 0, -8), p1=(8, 0, 8), p2=(-8, 0, 8), mat=0)]
        scene = volpath.Scene(
            Geometry.build(triangles=slab, device=dev),
            M.Materials.build([dict(type=M.SUBSURFACE, albedo=(1.0,) * 3,
                                    albedo2=(0.3,) * 3, eta=1.33)],
                              device=dev), Media.make(device=dev),
            Lights.make(env_L=[1.0] * 3, world_radius=100.0, device=dev))
        cam = PerspectiveCamera.make(
            tr.look_at((0, 3, -3), (0, 0, 0), (0, 1, 0), device=dev), 40.0,
            (24, 24), device=dev)
        img_s = volpath.render(scene, cam, RGBFilm.make((24, 24), device=dev),
                               spp=96, cfg=volpath.VolPathConfig(
                                   sss=True, max_depth=16),
                               seed=0, spp_per_pass=96, device=dev)
        m_sss = img_s.mean().item()
        print(f"phase 21b furnaces: a thin-dielectric pane 24^2 x 64 mean "
              f"{m_thin:.5f} ({L0} within 2%), the white subsurface slab "
              f"24^2 x 96 mean {m_sss:.5f} (0.85 to 1.08) {tag}", flush=True)
        assert abs(m_thin - L0) < 0.02 * L0, m_thin
        assert bool(torch.isfinite(img_s).all()) and 0.85 < m_sss < 1.08
        secs["21b"] = time.perf_counter() - t0
        print(f"phase 21b done {_at()}, {secs['21b']:.1f} s", flush=True)

        # ---- 21c: the kernel gates -----------------------------------------
        t0 = time.perf_counter()
        res = P21_GATE_RES
        cam, film = (vk.bench_camera(res, device=dev),
                     RGBFilm.make((res, res), device=dev))
        # a short walk: the route and its image are what is checked
        cfg_c = volpath.VolPathConfig(max_depth=3, max_events=4,
                                      max_collisions=16)
        gopt = guided_volpath.GuidingOptions(field_res=8, record_depth=6,
                                             min_train_weight=16.0,
                                             train_waves=1)
        vopt = vspg.VSPGOptions(vsp_criterion="contribution")
        base = vk.make_machines_scene(device=dev)
        rows = [dict(r) for r in vk.MACHINE_MATERIALS["smooth"]]
        # each kind beyond the kernels' once (the smooth plastic is a
        # coated diffuse row), and a rough dielectric
        cases = {name: (tab[-1], None) for name, tab in P21_MATERIALS.items()
                 if (tab[-1]["type"] not in vk.KERNEL_KINDS
                     or name == "rough dielectric") and name != "plastic"}
        cases["fbm texture"] = (dict(rows[0], albedo_tex=0),
                                dict(kind=5, scale=3.0))
        for name, (row, trow) in cases.items():
            tab = [row] + rows[1:]
            if name == "mix":  # its constituents: the glass and the metal
                tab = [dict(row, mix_m1=1, mix_m2=2)] + rows[1:]
            scene = dataclasses.replace(
                base, materials=M.Materials.build(tab, bank, device=dev),
                textures=(None if trow is None else T.Textures.build(
                    [trow], device=dev)))
            assert vk.extract_constants(scene, cam, film, cfg_c) is None
            got = {}
            for route in ("persistent", "vspg"):
                images = []
                for backend in ("auto", "torch"):
                    _zero_launches()
                    sk.LAUNCH_EVENTS = []
                    if route == "persistent":
                        img = volpath.render_persistent(
                            scene, cam, film, spp=1, cfg=cfg_c, seed=8,
                            backend=backend, device=dev)
                    else:
                        img = vspg.render_vspg(
                            scene, cam, film, spp=1, cfg=cfg_c, gopt=gopt,
                            vopt=vopt, seed=9, backend=backend,
                            device=dev)[0]
                    torch.cuda.synchronize()
                    events, sk.LAUNCH_EVENTS = sk.LAUNCH_EVENTS, None
                    launched = {k: v for k, v in _launch_counts().items()
                                if v}
                    assert not launched and not events, (name, route,
                                                         launched)
                    assert bool(torch.isfinite(img).all())
                    images.append(img)
                got[route] = _rel_diff(*images)
                assert got[route] <= P20_ORDER_REL, (name, route, got)
            print(f"phase 21c teaser cloud with {name}: render_persistent and "
                  f"render_vspg(backend='auto') {res}^2, kernel launches 0, "
                  f"kernel events 0, the images against backend='torch': "
                  f"largest relative differences {got['persistent']:.3e} and "
                  f"{got['vspg']:.3e} (bound {P20_ORDER_REL:g}) {tag}",
                  flush=True)
        for variant, route, want in (
                ("checker", "persistent", {"grid_tris": 1}),
                ("rough", "persistent", {"grid_tris": 1}),
                ("rough", "vspg", {"vspg_record_tris": 1,
                                   "vspg_render_tris": 1})):
            scene = vk.make_machines_scene(materials=variant, device=dev)
            _zero_launches()
            if route == "persistent":
                volpath.render_persistent(scene, cam, film, spp=1,
                                          cfg=cfg_c, seed=8, device=dev)
            else:
                vspg.render_vspg(scene, cam, film, spp=2, cfg=cfg_c,
                                 gopt=gopt, vopt=vopt, seed=9, device=dev)
            torch.cuda.synchronize()
            launched = {k: v for k, v in _launch_counts().items() if v}
            kinds = sorted(int(k) for k in scene.materials.mat_type.tolist())
            print(f"phase 21c teaser cloud with kinds {kinds}"
                  f"{' and a checker' if variant == 'checker' else ''} "
                  f"through render_{route}: launches {launched} {tag}",
                  flush=True)
            assert all(launched.get(k, 0) >= v for k, v in want.items()), (
                variant, route, launched)
        secs["21c"] = time.perf_counter() - t0
        print(f"phase 21c done {_at()}, {secs['21c']:.1f} s", flush=True)

        # ---- 21d: the scene file through the CLI --------------------------
        t0 = time.perf_counter()
        out = {integ: _cli_wait(started[f"21d {integ}"],
                                runs[f"21d {integ}"],
                                f"21d every material and texture under "
                                f"{integ}, {len(runs)} CLI processes at "
                                "once", tag)
               for integ in files}
        img_v = out["volpath"][0]
        assert img_v.mean() > 0.01
        d, z = _z(out["guidedvolpath"][0], img_v)
        print(f"phase 21d guidedvolpath against volpath {P21_RES}^2 x "
              f"{P21_SPP}: means {out['guidedvolpath'][0].mean():.6f} and "
              f"{img_v.mean():.6f}, difference {d:+.6f}, standard error "
              f"{d / z:.6f}, {z:+.2f} standard errors (bound 4) {tag}",
              flush=True)
        assert abs(z) <= 4.0, z
        img_g = out["guidedvolpathvspg"][0]
        d, z = _z(img_g, img_v)
        rel = d / img_v.mean()
        print(f"phase 21d guidedvolpathvspg against volpath {P21_RES}^2 x "
              f"{P21_SPP} (the resampling route, {P21_SPP // P21_GUIDED_PASS}"
              f" waves of {P21_GUIDED_PASS} spp, the field trained on the "
              f"first): means {img_g.mean():.6f} "
              f"and {img_v.mean():.6f}, difference {d:+.6f} = {rel:+.4%} = "
              f"{z:+.2f} standard errors (bound {P19_GUIDED_REL:.0%} of the "
              f"mean; ROADMAP.md section C 7) {tag}", flush=True)
        assert np.isfinite(img_g).all() and abs(rel) <= P19_GUIDED_REL, rel
        secs["21d"] = time.perf_counter() - t0
    print("phase 21 seconds: " + ", ".join(f"{k} {v:.1f}"
                                           for k, v in secs.items())
          + f" {tag}", flush=True)
    print(f"phase 21 done {_at()}, the phase "
          f"{time.perf_counter() - t21:.1f} s", flush=True)


def _p21_scene_texts(tmp):
    """21d's scene under volpath, guidedvolpath and guidedvolpathvspg: a
    floor textured by a mix of the 2048^2 imagemap and a checker, a wall of
    the Ptex quad mesh (one triangle a face), spheres of every material
    and every procedural texture on a 4 x 4 grid, all in a box of fog
    wound outward, under an environment and a point light."""
    import os

    fx, fz, _ = P21_PTEX
    xs, ys = np.linspace(-3, 3, fx + 1), np.linspace(0, 3, fz + 1)
    P, idx = [], []
    for j in range(fz):
        for i in range(fx):
            P += [(xs[i], ys[j], 3), (xs[i + 1], ys[j], 3),
                  (xs[i + 1], ys[j + 1], 3)]
            idx.append(len(P) - 3)
    wall = ('Shape "trianglemesh" "point3 P" ['
            + " ".join(f"{v:g}" for p in P for v in p)
            + '] "integer indices" ['
            + " ".join(f"{b} {b + 1} {b + 2}" for b in idx) + ']\n')
    f = os.path.join
    body = (
        f'Texture "img" "spectrum" "imagemap" "string filename" '
        f'"{f(tmp, "img.pfm")}" "float uscale" [2]\n'
        'Texture "checks" "spectrum" "checkerboard" "float uscale" [8] '
        '"float vscale" [8] "rgb tex1" [0.8 0.8 0.8] "rgb tex2" '
        '[0.2 0.3 0.4]\n'
        'Texture "mixed" "spectrum" "mix" "string tex1" "img" '
        '"string tex2" "checks" "float amount" [0.4]\n'
        'Texture "fbm" "spectrum" "fbm" "float scale" [3]\n'
        'Texture "wrinkled" "spectrum" "wrinkled" "float scale" [4]\n'
        'Texture "windy" "spectrum" "windy"\n'
        'Texture "marble" "spectrum" "marble" "float scale" [2] '
        '"float variation" [0.5]\n'
        'Texture "scaled" "spectrum" "scale" "string tex" "marble" '
        '"rgb scale" [0.6 0.5 0.4]\n'
        'Texture "dots" "spectrum" "dots" "float uscale" [6] '
        '"float vscale" [6] "rgb inside" [0.9 0.1 0.1] "rgb outside" '
        '[0.2 0.6 0.3]\n'
        'Texture "bilerp" "spectrum" "bilerp" "rgb v00" [1 0 0] '
        '"rgb v01" [0 1 0] "rgb v10" [0 0 1] "rgb v11" [1 1 0]\n'
        'Texture "uvt" "spectrum" "uv"\n'
        f'Texture "faces" "spectrum" "ptex" "string filename" '
        f'"{f(tmp, "faces.ptx")}"\n'
        'MakeNamedMaterial "gold" "string type" "conductor" '
        '"rgb reflectance" [0.9 0.7 0.3] "float roughness" [0.1]\n'
        'MakeNamedMaterial "dotted" "string type" "diffuse" '
        '"texture reflectance" "dots"\n'
        'AttributeBegin\n  Material "diffuse" "texture reflectance" '
        '"mixed"\n  Shape "trianglemesh" "point3 P" [-3 0 -3  3 0 -3  '
        '3 0 3  -3 0 3] "integer indices" [0 2 1  0 3 2] "point2 uv" '
        '[0 0  1 0  1 1  0 1]\nAttributeEnd\n'
        'AttributeBegin\n  Material "diffuse" "texture reflectance" '
        '"faces"\n  ' + wall + 'AttributeEnd\n')
    spheres = [
        'Material "thindielectric" "float eta" [1.5]',
        'Material "diffusetransmission" "rgb reflectance" [0.3 0.5 0.2] '
        '"rgb transmittance" [0.4 0.3 0.2]',
        'Material "plastic" "rgb reflectance" [0.6 0.3 0.2] '
        '"float roughness" [0.1]',
        'Material "coatedconductor" "float interface.roughness" [0.05] '
        '"float conductor.roughness" [0.2]',
        'Material "subsurface" "rgb sigma_s" [2 2 2] "rgb sigma_a" '
        '[0.02 0.1 0.4]',
        'Material "hair" "rgb reflectance" [0.6 0.4 0.2]',
        'Material "mix" "string materials" ["gold" "dotted"] '
        '"float amount" [0.5]',
        f'Material "measured" "string filename" "{f(tmp, "merl.binary")}"',
        'Material "dielectric" "float roughness" [0.2] "float eta" [1.4]',
        'Material "cooktorrance" "rgb reflectance" [0.5 0.4 0.3] '
        '"float roughness" [0.3]',
        'Material "diffuse" "texture reflectance" "wrinkled"',
        'Material "diffuse" "texture reflectance" "scaled"',
        'Material "diffuse" "texture reflectance" "windy"',
        'Material "diffuse" "texture reflectance" "bilerp"',
        'Material "diffuse" "texture reflectance" "uvt"',
        'Material "diffuse" "texture reflectance" "fbm"']
    for i, line in enumerate(spheres):
        x, z = -1.2 + 0.8 * (i % 4), -0.6 + 0.8 * (i // 4)
        body += (f"AttributeBegin\n  Translate {x:g} 0.3 {z:g}\n  {line}\n"
                 '  Shape "sphere" "float radius" [0.3]\nAttributeEnd\n')
    body += ('MakeNamedMedium "fog" "string type" "homogeneous" '
             '"rgb sigma_a" [0.01 0.01 0.01] "rgb sigma_s" [0.06 0.07 0.08] '
             '"float g" [0.2]\nAttributeBegin\n  Material "interface"\n'
             '  MediumInterface "fog" ""\n'
             + _box_shape((-3.5, -0.01, -3.5), (3.5, 3.5, 3.49))
             + "AttributeEnd\n")
    camera = ('LookAt 0 4.6 -5.2  0 0.3 0.8  0 1 0\n'
              'Camera "perspective" "float fov" [42]')
    # no point light in the fog: its 1/r^2 near the light made the image's
    # standard error 0.7% of its mean at 256^2 x 16 on an H100
    lights = ('LightSource "infinite" "rgb L" [0.4 0.45 0.5]\n'
              'LightSource "distant" "rgb L" [1.5 1.4 1.3] "point3 from" '
              '[1 3 -2] "point3 to" [0 0 0]\n')
    out = {}
    for integ in ("volpath", "guidedvolpath", "guidedvolpathvspg"):
        head = (f'Integrator "{integ}" "integer maxdepth" [{P21_DEPTH + 3}]'
                + (' "string isgbdenoiser" "atrous"'
                   if integ == "guidedvolpathvspg" else "")
                + f'\nSampler "independent" "integer pixelsamples" '
                f'[{P21_SPP}]\nFilm "rgb" "integer xresolution" [{P21_RES}] '
                f'"integer yresolution" [{P21_RES}]\n{camera}\nWorldBegin\n')
        out[integ] = head + lights + body
    return out

if __name__ == "__main__":
    try:
        rc = main()
    finally:
        import os
        import signal

        for proc in BACKGROUND:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
    sys.exit(rc)
