"""B1 (``csrc/volpath_homog.cu``) and B5 (``csrc/path_surface.cu``) on a
card at the main paths' shapes, and the two main-path calls that run them.

Cells: the bench fog at 256x256x64 and at 1920x1088x16 (bench_config1 and
5b's wave), and the bench Cornell box at 256x256x64 (bench_config6). For
one package (``--root``, default this checkout) it times, by CUDA events
(best of 3 warm renders, after a second of renders that lifts the card
from its idle clocks), ``volpath_kernels.render_homog`` and
``surface_kernels.render_surface`` at each cell, and by the host's clock
around a synchronised call (best, quartiles and median of ``--calls``)
the fogbox and Cornell calls of ``volpath.render_persistent`` at
256x256x64 and their ``extract_constants`` (the host's set-up). Only
those entry points are called, so an earlier revision of the package
times the same way.

``--sweep`` (this checkout only) also builds each source alone at ``-D``
*_MIN_BLOCKS 4, 6 and 8 but its shipped value (the package's own build)
with ``-Xptxas -v``, prints registers and spills, and times every build, B1 at
the groups of ``GROUPS`` and at ``volpath_kernels.group_size``'s pick, in
two turns (the second in reverse order). Each image is held against the
package build's at the same group at B1's and B5's bar (0.99 of pixels
within 1e-3 relative or 1e-5 absolute). A build stands in for the
package's entry points of its source while it is timed.

``--turns DIR`` runs the one-package measurement in four processes, on
the package in DIR (for instance a ``git archive`` of an earlier commit),
on this checkout, on this checkout and on DIR again, and prints each
number of the four side by side.

Run on a card from the repository root: ``python -m
vspg_pbrt_v4_tpu_torch.benchmarks.group_items [--root DIR] [--sweep]
[--turns DIR] [--out FILE]``. Prints one JSON line per measurement and,
with ``--out``, writes them all as JSON.
"""

from __future__ import annotations

import argparse
import importlib
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

PKG = "vspg_pbrt_v4_tpu_torch"
MIN_BLOCKS = (4, 6, 8)
# each kernel's source, macro stem, entry points and shipped budget
SOURCES = {"homog": ("volpath_homog.cu", "VOLPATH_HOMOG",
                     ("volpath_homog_launch", "volpath_homog_info"), 8),
           "surface": ("path_surface.cu", "PATH_SURFACE",
                       ("path_surface_launch", "path_surface_info"), 4)}
# B1's groups timed at each cell by --sweep, beside the rule's pick
GROUPS = {"fog 256x256x64": (1, 2, 3, 4, 6, 8, 16),
          "fog 1920x1088x16": (1, 4, 8, 16)}


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0].strip()


def _mod(name):
    return importlib.import_module(f"{PKG}.{name}")


def _warm(fn, seconds=1.0):
    """Run fn for about `seconds`, so that the card leaves its idle clocks
    before anything is timed."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        fn()
        torch.cuda.synchronize()


def _events_best_of_3(fn):
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


def _host_ms(fn, n):
    """Best, first quartile, median and third quartile wall ms of n warm
    calls, each synchronised."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    q1, med, q3 = statistics.quantiles(times, n=4)
    return dict(ms=min(times), q1_ms=q1, median_ms=med, q3_ms=q3)


def cells(dev):
    """{name: (kernel, scene, camera, film, cfg, spp, constants)}."""
    cameras, film_m = _mod("models.cameras"), _mod("models.film")
    volpath, tr = _mod("models.integrators.volpath"), _mod("utils.transform")
    vk, pk = _mod("ops.volpath_kernels"), _mod("ops.surface_kernels")
    out = {}
    fog = vk.make_fog_box_scene(device=dev)
    cfg = volpath.VolPathConfig(max_depth=32, max_events=128,
                                max_collisions=2048)
    wave = cameras.PerspectiveCamera.make(
        tr.look_at((0, 0, -4), (0, 0, 0), (0, 1, 0), device=dev), 35.0,
        (1920, 1088), device=dev)
    for name, cam, spp in (("fog 256x256x64", vk.bench_camera(256,
                                                               device=dev),
                            64),
                           ("fog 1920x1088x16", wave, 16)):
        film = film_m.RGBFilm.make(cam.resolution, device=dev)
        out[name] = ("homog", fog, cam, film, cfg, spp,
                     vk.extract_constants(fog, cam, film, cfg))
    cornell = volpath.make_cornell_box_scene(device=dev)
    cam, film = pk.cornell_view(256, 256, device=dev)
    cfg = volpath.VolPathConfig(max_depth=8, max_events=24)
    out["cornell 256x256x64"] = ("surface", cornell, cam, film, cfg, 64,
                                 pk.extract_constants(cornell, cam, film,
                                                      cfg))
    return out


def _render(kernel, c, spp, group=None):
    if kernel == "homog":
        vk = _mod("ops.volpath_kernels")
        kw = {} if group is None else {"group": group}
        return lambda: vk.render_homog(c, spp, 5, **kw)
    pk = _mod("ops.surface_kernels")
    return lambda: pk.render_surface(c, spp, 5)


def measure(dev, n_calls, card):
    """The one-package records: each cell's kernel, and at 256x256x64 the
    main-path call and its constants' extraction (the host's set-up)."""
    volpath = _mod("models.integrators.volpath")
    mods = {"homog": _mod("ops.volpath_kernels"),
            "surface": _mod("ops.surface_kernels")}
    records = []

    def put(rec):
        records.append(dict(rec, card=card))
        print(json.dumps(records[-1]), flush=True)

    all_cells = cells(dev)
    _warm(_render("homog", all_cells["fog 256x256x64"][-1], 64))
    for name, (kernel, scene, cam, film, cfg, spp, c) in all_cells.items():
        put(dict(cell=name, what=f"render_{kernel}",
                 ms=_events_best_of_3(_render(kernel, c, spp))))
        if "1920" in name:
            continue
        kw = {} if kernel == "homog" else {"lanes_per_pixel": 1}
        put(dict(cell=name, what="render_persistent", calls=n_calls,
                 **_host_ms(lambda: volpath.render_persistent(
                     scene, cam, film, spp=spp, cfg=cfg, seed=5,
                     backend="auto", device=dev, **kw), n_calls)))
        put(dict(cell=name, what="extract_constants", calls=n_calls,
                 **_host_ms(lambda: mods[kernel].extract_constants(
                     scene, cam, film, cfg), n_calls)))
    return records


def _ptxas(log):
    """[(entry, registers, spill store bytes)] of an ``-Xptxas -v`` log."""
    rows, name, st = [], None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, st = m.group(1), None
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            st = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), st))
            name = None
    return rows


def _build_variants():
    """{(kernel, min_blocks): (bound library, ptxas rows)} of each source
    built alone at each swept budget, all at once."""
    _build = _mod("ops._build")
    out_dir = Path(_build.BUILD_DIR) / "group_items"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for kernel, (src, macro, _, shipped) in SOURCES.items():
        for k in (k for k in MIN_BLOCKS if k != shipped):
            lib = out_dir / f"lib_{kernel}_{k}.so"
            procs[kernel, k] = (lib, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS,
                 f"-D{macro}_MIN_BLOCKS={k}", "-Xptxas", "-v", "-shared",
                 "-o", str(lib), str(_build.CSRC / src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    _build.load()
    built = {}
    for key, (lib, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log[-4000:]}")
        built[key] = (_build.bind(lib, SOURCES[key[0]][2]), _ptxas(log))
    return built


class _Overlay:
    """The package's library with one source's entry points taken from
    another build."""

    def __init__(self, base, top, names):
        self._base, self._top, self._names = base, top, names

    def __getattr__(self, name):
        return getattr(self._top if name in self._names else self._base,
                       name)


def sweep(dev, card):
    """The budget and group records of this checkout's two sources."""
    _build = _mod("ops._build")
    vk = _mod("ops.volpath_kernels")
    pk = _mod("ops.surface_kernels")
    built = _build_variants()
    base = _build.load()
    for key, (_, rows) in built.items():
        for entry, regs, st in rows:
            print(f"ptxas {key}: {regs} registers, {st} bytes spill stores "
                  f"({entry[:60]}) [{card}]", flush=True)
    records = []
    for name, (kernel, _, _, _, _, spp, c) in cells(dev).items():
        shipped = SOURCES[kernel][3]
        libs = {shipped: base}
        libs.update({k: _Overlay(base, lib, SOURCES[kernel][2])
                     for (kern, k), (lib, _) in built.items()
                     if kern == kernel})

        def use(k):
            _build._lib = libs[k]

        def info():
            return (vk.homog_info(c) if kernel == "homog"
                    else pk.surface_info(c))

        runs = []  # (min_blocks, group)
        for k in libs:
            use(k)
            if kernel == "surface":
                runs.append((k, None))
                continue
            rule = vk.group_size(c.nx * c.ny, spp, info()["threads"])
            runs += [(k, g) for g in sorted(set(GROUPS[name]) | {rule})]
        use(shipped)
        ref = {g: _render(kernel, c, spp, g)() for _, g in runs}
        times = {}
        for order in (runs, runs[::-1]):
            for k, g in order:
                use(k)
                times.setdefault((k, g), []).append(
                    _events_best_of_3(_render(kernel, c, spp, g)))
        for k, g in runs:
            use(k)
            img = _render(kernel, c, spp, g)()
            grid = info()
            rule = (None if kernel == "surface" else
                    vk.group_size(c.nx * c.ny, spp, grid["threads"]))
            torch.cuda.synchronize()
            diff = (img - ref[g]).abs()
            ok = ((diff <= 1e-3 * ref[g].abs()) | (diff <= 1e-5)).all(-1)
            rec = dict(cell=name, what=f"render_{kernel}", min_blocks=k,
                       group=1 if g is None else g, rule=g == rule,
                       ms=min(times[k, g]), turns=times[k, g],
                       within_bar=ok.float().mean().item(),
                       bit_equal=(img == ref[g]).all(-1).float().mean()
                       .item(), grid=[grid["blocks"], grid["per_sm"]],
                       regs=grid["regs"], local_bytes=grid["local_bytes"],
                       card=card)
            records.append(rec)
            print(json.dumps(rec), flush=True)
            assert rec["within_bar"] >= 0.99, rec
        use(shipped)
    _build._lib = base
    return records


def turns(parent, n_calls, card):
    """The one-package measurement on `parent`, this checkout, this
    checkout and `parent`, each in a process of its own."""
    here = Path(__file__).resolve().parents[2]
    roots = [Path(parent).resolve(), here, here, Path(parent).resolve()]
    runs = []
    for root in roots:
        p = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--root",
             str(root), "--calls", str(n_calls)], capture_output=True,
            text=True, timeout=1800)
        if p.returncode != 0:
            raise RuntimeError(f"{root}: {p.stdout[-2000:]}"
                               f"{p.stderr[-4000:]}")
        runs.append([json.loads(line) for line in p.stdout.splitlines()
                     if line.startswith("{")])
    records = []
    for i, rec in enumerate(runs[0]):
        out = dict(cell=rec["cell"], what=rec["what"], card=card)
        for key in ("ms", "q1_ms", "median_ms", "q3_ms"):
            if key in rec:
                out["parent_" + key] = [runs[0][i][key], runs[3][i][key]]
                out[key] = [runs[1][i][key], runs[2][i][key]]
        records.append(out)
        print(json.dumps(out), flush=True)
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", help="import the package from this directory")
    ap.add_argument("--sweep", action="store_true",
                    help="also sweep the budgets and B1's groups")
    ap.add_argument("--turns", help="time the package in this directory "
                    "and this checkout's in turns")
    ap.add_argument("--calls", type=int, default=200,
                    help="main-path calls timed a cell")
    ap.add_argument("--out", help="write the measurements here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("group_items: needs a CUDA card", file=sys.stderr)
        return 1
    card = _card()
    if args.turns:
        records = turns(args.turns, args.calls, card)
    else:
        root = Path(args.root or Path(__file__).resolve().parents[2])
        sys.path.insert(0, str(root.resolve()))
        assert Path(_mod("ops").__file__).resolve().is_relative_to(
            root.resolve()), "the package was not imported from --root"
        _mod("ops._build").load()
        records = measure("cuda", args.calls, card)
        if args.sweep:
            records += sweep("cuda", card)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
