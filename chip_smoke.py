#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root: ``python3 chip_smoke.py``. It builds the
kernels of ``vspg_pbrt_v4_tpu_torch/csrc`` with nvcc, checks each against
its plain PyTorch version and in a furnace, then renders the two bench
scenes at bench size through ``render_persistent(backend="auto")``,
checks that the main path went through both kernels, and holds each
kernel's bench-size image against its plain version pixel for pixel at the
same shape, spp and seed. Every line with a
number names the card and its power limit. Any failure raises and exits
non-zero; the last line, printed only after every phase passed, is
``{"ok": true, "device": {...}}``. Imports no JAX.
"""

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

    _build.build(force=True)
    _build.load()
    print(f"phase 2 build: nvcc {_build.last_build_seconds:.2f} s {tag}",
          flush=True)

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
    tol = {"homog": (0.99, 1e-3), "grid": (0.98, 2e-3)}

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
        ref8 = plain[kind](c, 8, 5)
        t_kernel, k_img = _best_of_3(lambda: vk.render(c, spp, 5))
        t_plain, p_img = _best_of_3(lambda: plain[kind](c, spp, 5))
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
        kernels.append(dict(
            name=f"volpath_{kind}", route="cuda",
            source=f"vspg_pbrt_v4_tpu_torch/csrc/volpath_{kind}.cu",
            replaces=("vspg_pbrt_v4_tpu/ops/pallas_volpath.py:1045"
                      if kind == "homog" else
                      "vspg_pbrt_v4_tpu/ops/pallas_volpath.py:1380"),
            launches=launches[kind], max_abs_err=max_abs,
            ms=t_kernel * 1e3, plain_ms=t_plain * 1e3))

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
