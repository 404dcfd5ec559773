#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root: ``python3 chip_smoke.py``. It builds the
kernels of ``vspg_pbrt_v4_tpu_torch/csrc`` with nvcc, checks each against
its plain PyTorch version and in a furnace, then renders the two bench
scenes at bench size through ``render_persistent(backend="auto")``,
checks that the main path went through both kernels, and holds each
kernel's bench-size image against its plain version pixel for pixel at the
same shape, spp and seed. Phase 7 does the same for the VSP-guided path:
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
surface class in vacuum (bench_config6): the surface kernel against its
plain version on three scenes, a floor furnace, and ``render_persistent``
on the Cornell box at 256x256x64 against the torch wavefront's mean.
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
cap changes the image); then the iteration cap's rule at 64 spp on the
same inputs with max_events cut to 1, where the cap cuts samples in many
pixels, against the per-pixel plain version on a crop. Phase 15 holds the
grid kernel's register budget and warp vote: each grid source built alone
at 2, 3 and 4 minimum blocks an SM, and with its vote flipped, timed in
turns on the main paths' inputs of phases 6, 9c and 10c. The grid kernel (B2a-c) runs (pixel, sample) items too:
9a and 10a hold B2b and B2c per item against the plain per-item version
at 4 spp, printing the items the kernel reads as 0 (a lost sample), and
every B2b/B2c image check uses the mesh bar (0.9999 of pixels). Every
render check against the plain version runs at least ITEMS_PER_THREAD
items a thread, and each render launch of a main path prints its grid,
registers, spills, items at the cap and its time beside the earlier one.
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
# ptxas's registers and spill bytes of the shipped build's VSPG kernels, by
# (record, ris, method, tris), and of its grid kernels, by (geometry mode,)
# (phase 2)
PTXAS = {}
PTXAS_GRID = {}
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
    chunks = -(-GRID_CELLS[name][1] // vk.grid_chunk_samples(
        c.nx * c.ny, GRID_CELLS[name][1]))
    print(f"{label} {name} items: {grid['blocks']} blocks ({grid['per_sm']} "
          f"an SM on {grid['sms']} SMs), {grid['regs']} registers a thread, "
          f"spill stores {pt.get('st')} / loads {pt.get('ld')} bytes, "
          f"{grid['local_bytes']} bytes local, {chunks} chunks of samples; "
          f"{ms:.3f} ms against {EARLIER_MS[name]:.3f} ms before the "
          f"redesign ({EARLIER_MS[name] / ms:.3f}x); bound {bound:.4f} ms, "
          f"the kernel at {bound / ms:.5f} of it {tag}", flush=True)
    return dict(grid=[grid["blocks"], grid["per_sm"]], regs=grid["regs"],
                spill_bytes=pt.get("st"), earlier_ms=EARLIER_MS[name],
                chunks=chunks)


def _check_blocks(n_items):
    """Persistent blocks that give each thread of a check at least
    ITEMS_PER_THREAD items."""
    return max(1, n_items // (128 * ITEMS_PER_THREAD))


def _render_check(label, c, g, ftab, itab, spp, seed, check_parity,
                  counts=None):
    """The render kernel on a grid cut to ITEMS_PER_THREAD or more items a
    thread against its per-pixel plain version at the same spp and seed
    (`counts` gathers the plain version's work); at 1 spp its items at the
    cap must be the plain version's pixels at the cap. Returns (max abs
    difference, the plain version's seconds, items at the cap)."""
    from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk

    n = c.nx * c.ny * spp
    blocks = _check_blocks(n)
    k, cap = sk.render_vspg_items(c, g, ftab, itab, spp, seed, blocks=blocks)
    counts = {} if counts is None else counts
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = sk.render_vspg_plain(c, g, ftab, itab, spp, seed, counts)
    torch.cuda.synchronize()
    t_p = time.perf_counter() - t0
    at_cap = int(cap)
    max_abs = check_parity(
        f"{label} ({blocks} blocks, {n / (blocks * 128):.1f} items a thread, "
        f"{at_cap} items at the cap)", "vspg", k, p)
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
    CUDA events around each kernel call and the render calls' items at the
    cap gathered; returns (fn's result, seconds, launches, ms by variant,
    items at the cap)."""
    from vspg_pbrt_v4_tpu_torch.ops import volpath_kernels as vk
    from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk

    for counter in (vk.LAUNCHES, sk.LAUNCHES):
        for key in counter:
            counter[key] = 0
    sk.LAUNCH_EVENTS, sk.AT_CAP = [], []
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        t_call = time.perf_counter() - t0
    finally:
        events, sk.LAUNCH_EVENTS = sk.LAUNCH_EVENTS, None
        caps, sk.AT_CAP = sk.AT_CAP, None
    launches = dict(sk.LAUNCHES)
    assert all(v == 0 for v in vk.LAUNCHES.values()), vk.LAUNCHES
    # one event pair a kernel call; a render call at these sizes is one
    # chunk: one item kernel and one reduce
    renders = sum(v for k, v in launches.items()
                  if k.startswith("vspg_render"))
    assert launches["vspg_reduce"] == renders == len(caps), (launches, caps)
    assert len(events) == sum(launches.values()) - renders, (len(events),
                                                             launches)
    k_ms = {name: 0.0 for name in sk.LAUNCHES}
    for name, start, end in events:
        k_ms[name] += start.elapsed_time(end)
    return out, t_call, launches, k_ms, sum(int(x) for x in caps)


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
            stderr=subprocess.STDOUT, text=True) as fma_build:
        _build.build(force=True, verbose=True)
        fma_log = fma_build.communicate()[0]
    assert fma_build.returncode == 0, fma_log
    _build.load()
    print(f"phase 2 build: nvcc {_build.last_build_seconds:.2f} s {tag}",
          flush=True)
    for line in _build.last_build_log.splitlines():
        if ("vspg_kernel" in line or "path_surface" in line
                or "registers" in line or "spill" in line):
            print(f"  ptxas: {line.strip()}", flush=True)
    PTXAS.update(_ptxas_table(_build.last_build_log))
    PTXAS_GRID.update(_ptxas_table(_build.last_build_log, GRID_ENTRY))
    for (geom,), v in sorted(PTXAS_GRID.items()):
        print(f"phase 2 ptxas grid kernel geometry {geom} (-O3): "
              f"{v.get('regs')} registers, {v.get('stack')} bytes stack "
              f"frame, {v.get('st')} bytes spill stores, {v.get('ld')} bytes "
              f"spill loads {tag}", flush=True)
    assert len(PTXAS_GRID) == 3, PTXAS_GRID
    # phase 14's render-only builds of vspg.cu (the register-budget sweep)
    # compile while phases 3-13 run
    variants = {}
    for name, flags in SWEEP.items():
        out = _build.BUILD_DIR / f"libvspg_{name}.so"
        variants[name] = (subprocess.Popen(
            _render_variant_cmd(out, ["-fmad=false", *flags]),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    # phase 15's builds of each grid source at 2, 3 and 4 minimum blocks
    # with its shipped vote, and at its shipped budget with the vote flipped
    # (the shipped build is the package's own)
    for name, src in GRID_SOURCES.items():
        k0, v0 = _shipped_grid_build(src)
        for k, v in [(k, v0) for k in GRID_SWEEP] + [(k0, 1 - v0)]:
            if (k, v) == (k0, v0):
                continue
            out = _build.BUILD_DIR / f"lib{name}_min{k}_vote{v}.so"
            variants[name, k, v] = (subprocess.Popen(
                _grid_variant_cmd(out, src, k, v), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), out)

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

    # ---- phase 6: the main path at bench size -------------------------------
    cells = (("homog", "fogbox", fog, 64), ("grid", "cloud64", cloud, 32))
    res = 256
    cam = vk.bench_camera(res, device=dev)
    film = RGBFilm.make((res, res), device=dev)
    for key in vk.LAUNCHES:
        vk.LAUNCHES[key] = 0
    timed = {}
    for kind, name, scene, spp in cells:
        def run(scene=scene, spp=spp):
            return volpath.render_persistent(
                scene, cam, film, spp=spp, cfg=bench_cfg, seed=5,
                backend="auto", device=dev)
        timed[kind] = _best_of_3(run)
    launches = dict(vk.LAUNCHES)
    assert all(launches[k] > 0 for k in ("homog", "grid")), launches

    kernels = []
    for kind, name, scene, spp in cells:
        t_main, img = timed[kind]
        c = consts(scene, res)
        counts = {}
        ref8 = plain[kind](c, 8, 5, counts)
        t_kernel, k_img = _best_of_3(lambda: vk.render(c, spp, 5))
        if kind == "grid":  # by CUDA events, as the other grid kernels
            GRID_CELLS["volpath_grid"] = (c, spp)
            t_kernel = _events_best_of_3(lambda: vk.render(c, spp, 5)) / 1e3
        # the plain version timed once (it repeats the kernel's arithmetic
        # lane by lane and is no yardstick of speed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p_img = plain[kind](c, spp, 5)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
        # the main path's image is the kernel's (deterministic, same seed)
        assert torch.equal(img, k_img), name
        max_abs = check_parity(f"phase 6 parity {name} {res}x{res}x{spp}",
                               kind, k_img, p_img)
        mean, mean8 = img.mean().item(), ref8.mean().item()
        print(f"phase 6 {name} {res}x{res}x{spp} via render_persistent: "
              f"{res * res * spp / t_main / 1e6:.2f} Mpaths/s, kernel "
              f"{res * res * spp / t_kernel / 1e6:.2f} Mpaths/s "
              f"({t_kernel * 1e3:.3f} ms), plain "
              f"{res * res * spp / t_plain / 1e6:.3f} Mpaths/s "
              f"({t_plain * 1e3:.1f} ms), mean {mean:.5f} vs plain 8 spp "
              f"{mean8:.5f}, launches {launches[kind]} {tag}", flush=True)
        assert tuple(img.shape) == (res, res, 3)
        assert bool(torch.isfinite(img).all()) and mean > 0
        assert abs(mean - mean8) / mean8 < 0.03, (name, mean, mean8)
        # the work of `spp` samples: the 8-spp plain run's counts, scaled
        nbytes = _nbytes(c.fconst, c.iconst, k_img) + (
            _nbytes(c.density, c.majorant) if kind == "grid" else 0)
        bound, bound_by, pipes = _bound_ms(f"volpath_{kind}", counts,
                                           spp / 8, nbytes)
        print(f"phase 6 {name} bound {bound:.4f} ms ({bound_by}; ms by "
              f"pipe {pipes}), kernel at {bound / (t_kernel * 1e3):.4f} of "
              f"it; counted work at 8 spp {counts} {tag}", flush=True)
        extra = ({} if kind == "homog" else _grid_report(
            "phase 6", "volpath_grid", c, t_kernel * 1e3, bound, tag))
        kernels.append(dict(
            name=f"volpath_{kind}", route="cuda",
            source=f"vspg_pbrt_v4_tpu_torch/csrc/volpath_{kind}.cu",
            replaces=("vspg_pbrt_v4_tpu/ops/pallas_volpath.py:1045"
                      if kind == "homog" else
                      "vspg_pbrt_v4_tpu/ops/pallas_volpath.py:1380"),
            launches=launches[kind], max_abs_err=max_abs,
            ms=t_kernel * 1e3, plain_ms=t_plain * 1e3, bound_ms=bound,
            bound_pipe=max(pipes, key=pipes.get),
            bound_by=bound_by, library_ms=None, **extra))

    print(f"phase 6 done {_at()}", flush=True)
    # each plain VSPG version steps every lane in lockstep (10-50 s a call
    # at 64^2 and more at 256^2), so the parity renders are cut to fit the
    # script in its 1200 s
    print("cuts: parity renders 7a/8a 64x64x2 spp, 9a 64x64x1 spp (was "
          "64x64x4); 8a NDS-RIS and NDS+-MIS only (was all four); 12a's "
          "RIS resampling case 64x64x1 (was 64x64x2); NDS+ "
          "training 3 torch waves (bench: 48); phase 6 plain versions timed "
          "once (was best of 3); 10c's plain version on a 256x128 crop of "
          "the 1920x1088x8 main path", flush=True)
    k7, inputs7 = _phase7(dev, tag, check_parity, fma_lib)
    kernels += k7
    print(f"phase 7 done {_at()}", flush=True)
    kernels += _phase8(dev, tag, check_parity)
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
    kernels += _phase12(dev, tag, check_parity, inputs7)
    print(f"phase 12 done {_at()}, the phase {time.perf_counter() - t12:.1f} "
          "s", flush=True)
    t13 = time.perf_counter()
    kernels += _phase13(dev, tag)
    print(f"phase 13 done {_at()}, the phase {time.perf_counter() - t13:.1f} "
          "s", flush=True)
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


def _phase7(dev, tag, check_parity, fma_lib):
    """Phase 7, the VSP-guided path: B4a and B3a against their plain
    versions in both direction modes (RIS, MIS), a guided furnace, then
    ``render_vspg`` on the bench's pyro cloud at 256^2. `fma_lib` is
    vspg.cu built with FMA contraction, timed against the shipped build.
    Returns the two kernels' entries of the kernels line and the render
    kernel's inputs at the main path's shape (phase 12 times B3d beside
    them)."""
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
        img_k, rec_k = sk.train_wave_kernel(c, g, ftab, itab, 21, 6)
        img_p, rec_p = sk.train_wave_plain(c, g, ftab, itab, 21, 6)
        torch.cuda.synchronize()
        check_parity(f"phase 7a parity vspg_record ({mode}) image 64x64x1",
                     "vspg", img_k, img_p)
        rk, rp = rec_k.permute(2, 0, 1), rec_p.permute(2, 0, 1)
        diff = (rk - rp).abs().reshape(rk.shape[0], -1)
        ok = ((diff <= 1e-3 * rp.abs().reshape(diff.shape)) | (diff <= 1e-5))
        frac_rec = ok.all(-1).float().mean().item()
        n_valid = int((rec_p[7] > 0).sum())
        print(f"phase 7a parity vspg_record ({mode}) rows: {frac_rec:.5f} of "
              f"lanes with every record row within 1e-3 ({n_valid} valid "
              f"slots) {tag}", flush=True)
        assert frac_rec >= 0.98, frac_rec
        _render_check(f"phase 7a parity vspg_render ({mode}) 64x64x2", c, g,
                      ftab, itab, 2, 22, check_parity)

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
    (img, field, isgb), t_main, launches, k_ms, cap_main = _main_path_calls(
        lambda: vspg.render_vspg(
            pyro, cam, film, spp=n_train + n_frozen, cfg=cfg, gopt=gopt,
            vopt=vopt, seed=5, spp_per_pass=1, device=dev))
    mean = img.mean().item()
    print(f"phase 7c render_vspg pyro64 {res}x{res} {n_train} training "
          f"waves + {n_frozen} frozen spp: {t_main:.3f} s, mean {mean:.5f}, "
          f"field iteration {field.iteration}, isgb ready {isgb.ready}, "
          f"launches {launches}, render items at the cap {cap_main} {tag}",
          flush=True)
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
    t_rk, (img_rk, _) = _best_of_3(
        lambda: sk.train_wave_kernel(c, g, ftab, itab, 31, 6))
    counts_r = {}
    t0 = time.perf_counter()
    img_rp, _ = sk.train_wave_plain(c, g, ftab, itab, 31, 6, counts_r)
    torch.cuda.synchronize()
    t_rp = time.perf_counter() - t0
    max_rec = check_parity(f"phase 7c parity vspg_record {res}x{res}x1",
                           "vspg", img_rk, img_rp)
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
    counts = {}
    max_ren, t_p2, _ = _render_check(
        f"phase 7c parity vspg_render {res}x{res}x{spp_plain}", c, g, ftab,
        itab, spp_plain, 11, check_parity, counts)
    print(f"phase 7c vspg_render kernel {res}x{res}x{n_frozen} "
          f"{t_k64 * 1e3:.3f} ms ({npix * n_frozen / t_k64 / 1e6:.3f} "
          f"Mpaths/s); at {spp_plain} spp kernel {t_k2 * 1e3:.3f} ms, plain "
          f"{t_p2 * 1e3:.1f} ms; counted work at {spp_plain} spp {counts} "
          f"{tag}", flush=True)
    print(f"phase 7c vspg_record kernel {res}x{res}x1 {t_rk * 1e3:.3f} ms, "
          f"plain {t_rp * 1e3:.1f} ms; counted work {counts_r} {tag}",
          flush=True)

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
          f"kernel at {b_rec / (t_rk * 1e3):.5f} of it {tag}", flush=True)
    extra = _render_report("phase 7c", "vspg_render", c, g, t_k64 * 1e3,
                           b_ren, cap_main, tag)
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
             ms=t_rk * 1e3, plain_ms=t_rp * 1e3, bound_ms=b_rec,
             bound_pipe=max(p_rec, key=p_rec.get),
             bound_by=by_rec, library_ms=None),
    ], (c, g, ftab, itab)


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
    and B4b."""
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
        img_k, rec_k = sk.train_wave_kernel(c, g, ftab, itab, 21, 6)
        img_p, rec_p = sk.train_wave_plain(c, g, ftab, itab, 21, 6)
        torch.cuda.synchronize()
        check_parity(f"phase 8a parity vspg_record ({name}) image "
                     "64x64x1", "vspg", img_k, img_p)
        rk, rp = rec_k.permute(2, 0, 1), rec_p.permute(2, 0, 1)
        diff = (rk - rp).abs().reshape(rk.shape[0], -1)
        ok = ((diff <= 1e-3 * rp.abs().reshape(diff.shape))
              | (diff <= 1e-5))
        frac_rec = ok.all(-1).float().mean().item()
        print(f"phase 8a parity vspg_record ({name}) rows: "
              f"{frac_rec:.5f} of lanes with every record row within "
              f"1e-3, max abs diff {diff.max().item():.3e} "
              f"({int((rec_p[7] > 0).sum())} valid slots) {tag}",
              flush=True)
        assert frac_rec >= 0.98, frac_rec
        counts = {}
        _render_check(f"phase 8a parity vspg_render ({name}) 64x64x2", c, g,
                      ftab, itab, 2, 22, check_parity, counts)
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
        kernel ms by variant, render items at the cap)."""
        (img, field, isgb), t_call, launches, k_ms, cap = _main_path_calls(
            lambda: vspg.render_vspg(
                pyro, cam, film, spp=waves + n_frozen, cfg=cfg,
                gopt=gopt._replace(train_waves=waves), vopt=vopt, seed=seed,
                spp_per_pass=1, device=dev))
        assert field.iteration == waves and isgb.ready
        assert tuple(img.shape) == (res, res, 3)
        assert bool(torch.isfinite(img).all()) and img.mean().item() > 0
        return img, field, isgb, launches, t_call, k_ms, cap

    img, field_n, isgb_n, launches_n, t_n, k_n, cap_n = main_path(
        v_nds, n_train, 5)
    assert launches_n == dict({k: 0 for k in sk.LAUNCHES},
                              vspg_record=n_train, vspg_render=1,
                              vspg_reduce=1), launches_n
    rest = t_n * 1e3 - k_n["vspg_record"] - k_n["vspg_render"]
    print(f"phase 8c render_vspg nds pyro64 {res}x{res} {n_train} training "
          f"waves + {n_frozen} frozen spp: {t_n:.3f} s, mean "
          f"{img.mean().item():.5f}, launches {launches_n}, render items at "
          f"the cap {cap_n}; split: record kernel {k_n['vspg_record']:.3f} "
          f"ms ({k_n['vspg_record'] / n_train:.3f} ms each), render call "
          f"{k_n['vspg_render']:.3f} ms "
          f"({k_n['vspg_render'] / (t_n * 1e3):.4f} of the call), the rest "
          f"(tables, propagate, EM, ISGB, launch "
          f"gaps) {rest:.3f} ms {tag}", flush=True)

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
        img_p, _, _, launches_p, t_p, k_p, cap_p = main_path(v_ndsp, n_plus,
                                                             6)
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
    t_rk, (img_rk, _) = _best_of_3(
        lambda: sk.train_wave_kernel(c, g, ftab, itab, 11, 6))
    counts_r = {}
    t0 = time.perf_counter()
    img_rp, _ = sk.train_wave_plain(c, g, ftab, itab, 11, 6, counts_r)
    torch.cuda.synchronize()
    t_rp = time.perf_counter() - t0
    max_rec = check_parity(f"phase 8 parity vspg_record (nds) {res}x{res}x1",
                           "vspg", img_rk, img_rp)
    src = "vspg_pbrt_v4_tpu_torch/csrc/vspg.cu"
    rep = "vspg_pbrt_v4_tpu/ops/pallas_vspg.py:241"

    def render_alone(method, c, g, ftab, itab, launches, cap):
        """The render variant alone on one main path's inputs (`cap`: that
        call's items at the cap): 64 spp and 1 spp timed, held against its
        plain version at 1 spp, and bound by the plain version's counted
        work; its kernels-line entry."""
        t_k64, k64 = _best_of_3(
            lambda: sk.render_vspg_kernel(c, g, ftab, itab, n_frozen, 11))
        t_k1, _ = _best_of_3(
            lambda: sk.render_vspg_kernel(c, g, ftab, itab, 1, 11))
        counts = {}
        max_ren, t_p1, _ = _render_check(
            f"phase 8 parity vspg_render ({method}) {res}x{res}x1, "
            f"{itab.shape[0]} ISGB rows", c, g, ftab, itab, 1, 11,
            check_parity, counts)
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
          f"{t_rk * 1e3:.3f} ms, plain {t_rp * 1e3:.1f} ms; counted work "
          f"{counts_r}; bound {b_rec:.4f} ms ({by_rec}; ms by pipe {p_rec}), "
          f"kernel at {b_rec / (t_rk * 1e3):.5f} of it {tag}", flush=True)
    return [
        render_alone("nds", c, g, ftab, itab, launches_n["vspg_render"],
                     cap_n),
        # NDS+ on the inputs its main path gave the kernel: the field its
        # torch waves trained and the 6-row ISGB table with their TrBuffer
        render_alone("nds+", *inputs_p, launches_p["vspg_render"], cap_p),
        dict(name="vspg_record_nds", route="cuda", source=src, replaces=rep,
             launches=launches_n["vspg_record"], max_abs_err=max_rec,
             ms=t_rk * 1e3, plain_ms=t_rp * 1e3, bound_ms=b_rec,
             bound_pipe=max(p_rec, key=p_rec.get),
             bound_by=by_rec, library_ms=None),
    ]


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

    def rows_parity(label, rec_k, rec_p):
        return _rows_parity(label, rec_k, rec_p, tag)

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
        img_k, rec_k = sk.train_wave_kernel(c, g, ftab, itab, 21, 6)
        img_p, rec_p = sk.train_wave_plain(c, g, ftab, itab, 21, 6)
        torch.cuda.synchronize()
        check_parity(f"phase 9a parity vspg_record_tris ({label}) image "
                     "64x64x1", "vspg", img_k, img_p)
        rows_parity(f"phase 9a parity vspg_record_tris ({label}) rows",
                    rec_k, rec_p)
        counts = {}
        _render_check(f"phase 9a parity vspg_render_tris ({label}) 64x64x2",
                      c, g, ftab, itab, 2, 22, check_parity, counts)
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
    chunks = -(-spp_m // vk.grid_chunk_samples(nx * ny, spp_m))
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
    (img, field, isgb), t_v, launches_v, k_ms, cap_v = _main_path_calls(
        lambda: vspg.render_vspg(
            scene, cam, film, spp=n_train + n_frozen, cfg=cfg_v, gopt=gopt,
            vopt=vopt, seed=5, spp_per_pass=1, device=dev))
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
          f"items at the cap {cap_v}, surface cells with data {n_surf}; "
          f"split: record kernel {k_ms['vspg_record_tris']:.3f} ms "
          f"({k_ms['vspg_record_tris'] / n_train:.3f} ms each), render call "
          f"{k_ms['vspg_render_tris']:.3f} ms "
          f"({k_ms['vspg_render_tris'] / (t_v * 1e3):.4f} of the call), the "
          f"rest (tables, propagate, EM, ISGB, launch gaps) {rest:.3f} ms "
          f"{tag}", flush=True)
    # each variant alone on the main path's inputs, and its plain version
    c, g, ftab, itab = inputs(scene, res, field, isgb)
    t_rk, (img_rk, rec_rk) = _best_of_3(
        lambda: sk.train_wave_kernel(c, g, ftab, itab, 31, 6))
    counts_r = {}
    t0 = time.perf_counter()
    img_rp, rec_rp = sk.train_wave_plain(c, g, ftab, itab, 31, 6, counts_r)
    torch.cuda.synchronize()
    t_rp = time.perf_counter() - t0
    check_parity(f"phase 9d parity vspg_record_tris {res}x{res}x1 image",
                 "vspg", img_rk, img_rp)
    max_rec = rows_parity(f"phase 9d parity vspg_record_tris {res}x{res}x1 "
                          "rows", rec_rk, rec_rp)
    t_k64, k64 = _best_of_3(
        lambda: sk.render_vspg_kernel(c, g, ftab, itab, n_frozen, 11))
    inputs9 = (c, g, ftab, itab)
    counts = {}
    max_ren, t_p1v, _ = _render_check(
        f"phase 9d parity vspg_render_tris {res}x{res}x1", c, g, ftab, itab,
        1, 11, check_parity, counts)
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
          f"vspg_record_tris kernel {res}x{res}x1 {t_rk * 1e3:.3f} ms, plain "
          f"{t_rp * 1e3:.1f} ms, counted work {counts_r}, bound "
          f"{b_rec:.4f} ms ({by_rec}; ms by pipe {p_rec}), kernel at "
          f"{b_rec / (t_rk * 1e3):.5f} of it, {_at()} {tag}", flush=True)
    extra = _render_report("phase 9d", "vspg_render_tris", c, g,
                           t_k64 * 1e3, b_ren, cap_v, tag)

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
             max_abs_err=max_rec, ms=t_rk * 1e3, plain_ms=t_rp * 1e3,
             bound_pipe=max(p_rec, key=p_rec.get),
             bound_ms=b_rec, bound_by=by_rec, library_ms=None),
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
    chunks = -(-spp // vk.grid_chunk_samples(nx * ny, spp))
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
    holds B5 (path_surface) against its plain version on three scenes at
    4 spp (the grid header's -O3 builds lost warps from the third sample
    on); 11b is a floor furnace; 11c renders the bench line through
    render_persistent at 256x256x64 and checks the kernel's mean against
    the torch wavefront's. Returns B5's entry of the kernels line."""
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
    launches = dict(pk.LAUNCHES)
    assert launches == {"surface": 1}, launches
    assert all(v == 0 for v in vk.LAUNCHES.values()), vk.LAUNCHES
    assert all(v == 0 for v in sk.LAUNCHES.values()), sk.LAUNCHES
    assert tuple(img.shape) == (res, res, 3)
    assert bool(torch.isfinite(img).all()) and img.mean().item() > 0
    t_call, _ = _best_of_3(call)
    c = pk.extract_constants(cornell, cam, film, cfg)
    k_ms = _events_best_of_3(lambda: pk.render_surface(c, spp, 5))
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
    bound, bound_by, pipes = _bound_ms(
        "path_surface", counts, 1.0, _nbytes(c.fconst, c.tris, img))
    paths = res * res * spp
    print(f"phase 11c cornell surface {res}x{res}x{spp} via "
          f"render_persistent: call {t_call * 1e3:.3f} ms "
          f"({paths / t_call / 1e6:.3f} Mpaths/s), kernel {k_ms:.4f} ms by "
          f"CUDA events ({paths / k_ms / 1e3:.3f} Mpaths/s), mean "
          f"{img.mean().item():.5f}, launches {launches['surface']}; plain "
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
    return [dict(name="path_surface", route="cuda",
                 source="vspg_pbrt_v4_tpu_torch/csrc/path_surface.cu",
                 replaces="vspg_pbrt_v4_tpu/ops/pallas_surface.py:195",
                 launches=launches["surface"], max_abs_err=max(max_a, max_c),
                 ms=k_ms, plain_ms=t_plain * 1e3, bound_ms=bound,
                 bound_pipe=max(pipes, key=pipes.get), bound_by=bound_by,
                 library_ms=None)]



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
    kernels' entries of the kernels line."""
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

    def rows_parity(label, rec_k, rec_p):
        return _rows_parity(label, rec_k, rec_p, tag)

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
    for label, scene, fld, mode, method, spp_r in (
            ("ris", pyro, (field_c, isgb_c), "ris", "resampling", 1),
            ("mis", pyro, (field_c, isgb_c), "mis", "resampling", 2),
            ("nds ris", pyro, (field_c, isgb_c), "ris", "nds", 1),
            ("machines ris", machines, (field_t, isgb_t), "ris",
             "resampling", 1)):
        c, g, ftab, itab = inputs(
            scene, 64, *fld, vopt._replace(sampling_method=method),
            gopt._replace(mode=mode), cfg_t if scene is machines else cfg)
        assert g.cells is not None and ftab.shape[1] == C + 1024
        img_k, rec_k = sk.train_wave_kernel(c, g, ftab, itab, 21, 6)
        img_p, rec_p = sk.train_wave_plain(c, g, ftab, itab, 21, 6)
        torch.cuda.synchronize()
        check_parity(f"phase 12a parity vspg_record_adaptive ({label}) image "
                     "64x64x1", "vspg", img_k, img_p)
        rows_parity(f"phase 12a parity vspg_record_adaptive ({label}) rows",
                    rec_k, rec_p)
        counts = {}
        _render_check(f"phase 12a parity vspg_render_adaptive ({label}) "
                      f"64x64x{spp_r}", c, g, ftab, itab, spp_r, 22,
                      check_parity, counts)
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
        (img, field, isgb), t_main, launches, k_ms, cap_main = (
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
          f"{launches}, render items at the cap {cap_main} {tag}", flush=True)
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
    counts = {}
    max_ren, t_p1, _ = _render_check(
        f"phase 12c parity vspg_render_adaptive {res}x{res}x1", c, g, ftab,
        itab, 1, 11, check_parity, counts)
    t_rk, (img_rk, rec_rk) = _best_of_3(
        lambda: sk.train_wave_kernel(c, g, ftab, itab, 31, 6))
    counts_r = {}
    t0 = time.perf_counter()
    img_rp, rec_rp = sk.train_wave_plain(c, g, ftab, itab, 31, 6, counts_r)
    torch.cuda.synchronize()
    t_rp = time.perf_counter() - t0
    check_parity(f"phase 12c parity vspg_record_adaptive {res}x{res}x1 "
                 "image", "vspg", img_rk, img_rp)
    max_rec = rows_parity(f"phase 12c parity vspg_record_adaptive "
                          f"{res}x{res}x1 rows", rec_rk, rec_rp)
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
          f"{t_rk * 1e3:.3f} ms a wave, plain {t_rp * 1e3:.1f} ms; counted "
          f"work {counts_r}; bound {b_rec:.4f} ms ({by_rec}; ms by pipe "
          f"{p_rec}), kernel at {b_rec / (t_rk * 1e3):.5f} of it {tag}",
          flush=True)
    extra = _render_report("phase 12c", "vspg_render_adaptive", c, g,
                           t_k64 * 1e3, b_ren, cap_main, tag)

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
             max_abs_err=max_rec, ms=t_rk * 1e3, plain_ms=t_rp * 1e3,
             bound_ms=b_rec, bound_pipe=max(p_rec, key=p_rec.get),
             bound_by=by_rec, library_ms=None),
    ]


def _phase14(dev, tag, inputs7, inputs9, variants, check_parity):
    """Phase 14, the render kernel's register budget and its iteration cap.
    14a: the render-only builds of vspg.cu at 2, 3 and 4 minimum blocks an
    SM (`variants`, started after phase 2; ptxas's registers and spills of
    each) time B3a on phase 7c's inputs and B3c on phase 9d's at 64 spp in
    turns, each image held bit for bit against the shipped build's, and
    again with max_events cut to max_events / spp, which caps each item at
    one sample's budget and so leaves out the capped items' long tails (a
    time only: the pixel's cap then cuts samples, and the image differs).
    14b: on the same inputs with max_events cut to 1 (a pixel's cap of 768
    iterations at 64 spp, which cuts samples in many pixels), the kernel at
    64 spp and ITEMS_PER_THREAD items a thread against its per-pixel plain
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

    def with_max_events(c, n):
        ic = c.iconst.clone()
        ic[I_MAX_EVENTS] = n
        return dataclasses.replace(c, iconst=ic)

    n_frozen = 64
    cells = (("B3a", inputs7), ("B3c", inputs9))
    for label, (c, g, ftab, itab) in cells:
        ref, ref_cap = sk.render_vspg_items(c, g, ftab, itab, n_frozen, 11)
        c1 = with_max_events(c, max(1, int(c.iconst[I_MAX_EVENTS])
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
    for label, (c, g, ftab, itab) in cells:
        c1 = with_max_events(c, 1)
        n = c.nx * c.ny * n_frozen
        blocks = _check_blocks(n)
        k, cap = sk.render_vspg_items(c1, g, ftab, itab, n_frozen, 13,
                                      blocks=blocks)
        crop = torch.arange((c.ny // 2) * c.nx, (c.ny // 2 + 2) * c.nx,
                            device=dev)
        counts = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = sk.render_vspg_plain(c1, g, ftab, itab, n_frozen, 13, counts,
                                 pixels=crop)
        torch.cuda.synchronize()
        t_p = time.perf_counter() - t0
        kc = k.reshape(-1, 3)[crop]
        exact = (kc == p).all(-1).float().mean().item()
        check_parity(
            f"phase 14b parity {label} vspg_render {c.nx}x{c.ny}x{n_frozen} "
            f"at a pixel cap of {n_frozen * 12} iterations, rows "
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


if __name__ == "__main__":
    sys.exit(main())
