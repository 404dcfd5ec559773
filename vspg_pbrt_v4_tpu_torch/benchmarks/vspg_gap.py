"""How far ``render_vspg`` reads from ``volpath.render`` on a dense grid
cloud, route by route (ROADMAP.md section C 3).

The cloud is the port's procedural ``CloudMedium`` sampled on an n^3 grid
and written as a NanoVDB file, inside a cube of interface triangles wound
outward, lit by a point light and a constant environment: a scene text
built and rendered as the CLI would. The script renders it with
``volpath.render`` (the delta-tracking reference) and with ``render_vspg``
through the torch wave (the JAX XLA path's twin) four ways: the resampling
route after 4 training waves, the same untrained, with no VSP guiding and
no guided Russian roulette, and NDS after 4 training waves. Each line
prints the mean and its difference from volpath's in standard errors of
the per-pixel differences.

Run on a card from the repository root: ``python -m
vspg_pbrt_v4_tpu_torch.benchmarks.vspg_gap [--sigma-s 5 6 7] [--depth 16]
[--res 128] [--spp 32] [--grid 64]`` (about 11 minutes at the defaults on
an H100); ``--cpu`` rehearses it on the CPU at a tiny size.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

# a cube's 12 triangles over [0, 1]^3, wound outward
_CUBE = ('Shape "trianglemesh" "point3 P" [0 0 0  1 0 0  1 1 0  0 1 0  '
         '0 0 1  1 0 1  1 1 1  0 1 1]\n  "integer indices" [0 2 1  0 3 2  '
         '4 5 6  4 6 7  0 5 4  0 1 5  3 6 2  3 7 6  0 7 3  0 4 7  1 6 5  '
         '1 2 6]\n')


def _card():
    if not torch.cuda.is_available():
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def scene_text(nvdb, sigma_s, res, depth):
    """The cloud file's scene: camera, lights, the medium in the cube."""
    return (f'Integrator "volpath" "integer maxdepth" [{depth}]\n'
            f'Film "rgb" "integer xresolution" [{res}] '
            f'"integer yresolution" [{res}]\n'
            'LookAt 0.5 0.5 -2.2  0.5 0.5 0.5  0 1 0\n'
            'Camera "perspective" "float fov" [30]\nWorldBegin\n'
            'LightSource "point" "rgb I" [3 3 3] "point3 from" [0.5 1.6 0.2]\n'
            'LightSource "infinite" "rgb L" [0.15 0.18 0.22]\n'
            f'MakeNamedMedium "m" "string type" "nanovdb" "string filename" '
            f'"{nvdb}" "rgb sigma_a" [0.2 0.2 0.2] "rgb sigma_s" '
            f'[{" ".join(map(str, sigma_s))}] "float g" [0.4]\n'
            'AttributeBegin\n  Material "interface"\n  MediumInterface "m" ""\n'
            f'  {_CUBE}AttributeEnd\n')


def z_score(a, b):
    """(difference of the image means, the same in standard errors of the
    per-pixel differences)."""
    diff = (np.asarray(a, np.float64) - np.asarray(b, np.float64)).mean(-1)
    return diff.mean(), diff.mean() / (diff.std() / np.sqrt(diff.size))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="vspg_gap")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--sigma-s", type=float, nargs=3, default=[5.0, 6.0, 7.0])
    ap.add_argument("--depth", type=int, nargs="+", default=[16])
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--spp", type=int, default=32)
    ap.add_argument("--grid", type=int, default=64)
    a = ap.parse_args(argv)
    if not a.cpu and not torch.cuda.is_available():
        raise SystemExit("vspg_gap: no CUDA device (--cpu rehearses it)")
    from ..models.integrators import volpath, vspg
    from ..models.integrators.guided_volpath import GuidingOptions
    from ..models.media import CloudMedium
    from ..scene import build_render_setup, parse_pbrt_string
    from ..tools.nvdb import write_nvdb

    dev = "cpu" if a.cpu else "cuda"
    tag = f"[{_card()}]"
    n = a.grid
    cloud = CloudMedium.make(p0=(0, 0, 0), p1=(1, 1, 1), device=dev)
    x = (torch.arange(n, device=dev, dtype=torch.float32) + 0.5) / n
    X, Y, Z = torch.meshgrid(x, x, x, indexing="ij")
    dens = cloud.density_at(torch.stack([X, Y, Z], -1)).cpu().numpy()
    runs = {
        "resampling, 4 training waves": (
            GuidingOptions(train_waves=4), vspg.VSPGOptions()),
        "resampling, untrained": (
            GuidingOptions(train_waves=0), vspg.VSPGOptions()),
        "no VSP guiding, no guided RR, untrained": (
            GuidingOptions(train_waves=0),
            vspg.VSPGOptions(guide_vsp=False, guide_rr=False)),
        "nds, 4 training waves": (
            GuidingOptions(train_waves=4),
            vspg.VSPGOptions(sampling_method="nds")),
    }
    per_pass = min(8, a.spp)
    with tempfile.TemporaryDirectory() as tmp:
        nvdb = os.path.join(tmp, "cloud.nvdb")
        write_nvdb(nvdb, dens, voxel_size=1.0 / n)
        for depth in a.depth:
            st = build_render_setup(parse_pbrt_string(scene_text(
                nvdb, a.sigma_s, a.res, depth)), device=dev)
            cfg = volpath.VolPathConfig(max_depth=depth)
            head = (f"vspg_gap {n}^3 cloud, sigma_s {a.sigma_s}, "
                    f"{a.res}x{a.res}x{a.spp}, maxdepth {depth}")
            t0 = time.perf_counter()
            ref = volpath.render(st.scene, st.camera, st.film, spp=a.spp,
                                 cfg=cfg, seed=1, spp_per_pass=per_pass,
                                 device=dev).cpu().numpy()
            print(f"{head}: volpath.render mean {ref.mean():.6f} "
                  f"({time.perf_counter() - t0:.1f} s) {tag}", flush=True)
            for i, (name, (gopt, vopt)) in enumerate(runs.items()):
                t0 = time.perf_counter()
                img = vspg.render_vspg(
                    st.scene, st.camera, st.film, spp=a.spp, cfg=cfg,
                    gopt=gopt, vopt=vopt, seed=2 + i, spp_per_pass=per_pass,
                    device=dev)[0].cpu().numpy()
                d, z = z_score(img, ref)
                print(f"{head}: render_vspg {name}: mean {img.mean():.6f}, "
                      f"difference {d:+.6f} = {z:+.2f} standard errors "
                      f"({time.perf_counter() - t0:.1f} s) {tag}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
