"""Command-line renderer (counterpart of the JAX package's ``cli.py``).

    python -m vspg_pbrt_v4_tpu_torch scene.pbrt [options]

Parses the scene file, builds it on the card (or on the CPU under
``--cpu``) and renders it with the integrator the file names: ``volpath``
and ``path`` through ``volpath.render`` (``render_progressive`` under
``--time``, ``--checkpoint`` or ``--write-partial-images``),
``guidedpath`` and ``guidedvolpath`` through
``guided_volpath.render_guided``, ``guidedvolpathvspg`` through
``vspg.render_vspg`` (``--guiding-gbuffer`` then also writes the guiding
cache's cell ids as ``<out>_guiding_ids.exr``). The options are the JAX
CLI's; the integrators and options this package does not serve yet exit
with code 1 and a message naming ROADMAP.md §A. There is no silent
fallback: without ``--cpu`` and without a card the CLI exits non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

# integrators the JAX CLI serves and this package does not yet
_UNPORTED_INTEGRATORS = ("ao", "randomwalk", "simplepath", "simplevolpath",
                         "sppm", "lightpath", "bdpt", "mlt")
_UNPORTED_OPTIONS = ("interactive", "display_server", "pixelstats")


def _parser():
    ap = argparse.ArgumentParser(prog="vspg_pbrt_v4_tpu_torch",
                                 description="pbrt+VSPG renderer on CUDA")
    ap.add_argument("scene", help=".pbrt scene file")
    ap.add_argument("--spp", type=int, default=None, help="samples per pixel")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--outfile", default=None)
    ap.add_argument("--resolution", default=None, help="WxH override")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--stats", action="store_true")
    ap.add_argument("--spp-per-pass", type=int, default=4)
    ap.add_argument("--time", type=float, default=None,
                    help="render time budget in seconds (pass loop stops)")
    ap.add_argument("--mse-reference-image", default=None)
    ap.add_argument("--maxdepth", type=int, default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="render on the CPU instead of the card")
    ap.add_argument("--display-server", default=None,
                    help="not ported yet (ROADMAP.md §A 8)")
    ap.add_argument("--write-partial-images", action="store_true")
    ap.add_argument("--checkpoint", default=None,
                    help="npz path: save after the render; resume if it "
                         "exists")
    ap.add_argument("--store-guiding-cache", default=None)
    ap.add_argument("--load-guiding-cache", default=None,
                    help="pre-trained field npz (disables training)")
    ap.add_argument("--guiding-gbuffer", action="store_true",
                    help="guidedvolpathvspg: also write the guiding cache's "
                         "cell ids at each pixel's first hit as "
                         "<out>_guiding_ids.exr")
    ap.add_argument("--pixelstats", action="store_true",
                    help="not ported yet (ROADMAP.md §A 8)")
    ap.add_argument("--log-level", default="warning",
                    choices=["verbose", "warning", "error", "fatal"],
                    help="diagnostic level (util/log.h --log-level)")
    ap.add_argument("--log-file", default=None,
                    help="mirror log lines to a file")
    ap.add_argument("--volMajScale", type=float, default=None,
                    help="global volume majorant scale override "
                         "(options.h:58 volumeMajorantScale)")
    ap.add_argument("--interactive", action="store_true",
                    help="not ported yet (ROADMAP.md §A 8)")
    ap.add_argument("--debugstart", default=None, metavar="X,Y,S",
                    help="deterministically replay one pixel sample and "
                         "print its radiance (cpu/integrators.cpp:77-95)")
    ap.add_argument("--pixelmaterial", default=None, metavar="X,Y",
                    help="trace the center camera ray of pixel (x,y) and "
                         "print every intersection's position, normal, "
                         "material and media (cpu/render.cpp:110-161)")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)

    import torch

    from .utils import log

    log.set_level(args.log_level)
    if args.log_file:
        log.set_file(args.log_file)
    for opt in _UNPORTED_OPTIONS:
        if getattr(args, opt):
            print(f"error: --{opt.replace('_', '-')} is not ported yet "
                  "(ROADMAP.md §A 8)", file=sys.stderr)
            return 1
    if args.cpu:
        device = "cpu"
    elif torch.cuda.is_available():
        device = "cuda"
    else:
        print("error: no CUDA device is available; pass --cpu to render "
              "on the CPU", file=sys.stderr)
        return 1

    from .scene import build_render_setup, parse_pbrt_file
    from .scene.parser import PbrtError

    t0 = time.perf_counter()
    res_override = None
    if args.resolution:
        w, h = args.resolution.lower().split("x")
        res_override = (int(w), int(h))
    try:
        directives = parse_pbrt_file(args.scene)
        setup = build_render_setup(directives, spp_override=args.spp,
                                   res_override=res_override, device=device)
    except (PbrtError, FileNotFoundError, NotImplementedError) as e:
        # util/error.h ErrorExit: '<file>:<line>: error' diagnostic, no
        # traceback
        print(f"error: {e}", file=sys.stderr)
        return 1
    build_s = time.perf_counter() - t0
    if not args.quiet:
        g = setup.scene.geometry
        print(f"[scene] {g.n_tri} tris, {g.n_sph} spheres, "
              f"{setup.scene.lights.n_lights} lights, integrator "
              f"{setup.integrator}, {setup.spp} spp", file=sys.stderr)
    if setup.integrator in _UNPORTED_INTEGRATORS:
        print(f"error: integrator '{setup.integrator}' is not ported yet "
              "(ROADMAP.md §A 8)", file=sys.stderr)
        return 1

    if args.volMajScale is not None:
        # the global majorant override (cmd/pbrt.cpp:208 --volMajScale):
        # every grid's majorant table and every procedural medium's
        # majorant_scale (the cloud's majorant is exact); a majorant is any
        # upper bound, so estimators stay unbiased
        s = float(args.volMajScale)
        media = setup.scene.media
        grids = tuple(dataclasses.replace(gm, majorant=gm.majorant * s)
                      for gm in media.grids)
        procs = tuple(
            dataclasses.replace(pm, majorant_scale=pm.majorant_scale * s)
            if hasattr(pm, "majorant_scale") else pm
            for pm in media.procedurals)
        setup = setup._replace(scene=dataclasses.replace(
            setup.scene, media=dataclasses.replace(
                media, grids=grids, procedurals=procs)))

    if args.pixelmaterial:
        x, y = (int(v) for v in args.pixelmaterial.split(","))
        return _pixel_material_probe(setup, x, y)
    try:
        return _render(args, setup, device, t0, build_s)
    except NotImplementedError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


def _render(args, setup, device, t0, build_s):
    import torch

    from .models.integrators import guided_volpath as gvp
    from .models.integrators import volpath, vspg
    from .scene.parser import ParameterDictionary
    from .utils import log
    from .utils.image import mse as mse_np
    from .utils.image import read_image, write_exr, write_image

    if args.debugstart:
        # single-sample replay: the stateless counter RNG makes any
        # (pixel, sample) pair exactly reproducible in isolation
        x, y, s = (int(v) for v in args.debugstart.split(","))
        scene, camera, film = (setup.scene.to(device),
                               setup.camera.to(device), setup.film.to(device))
        nx, _ = film.resolution
        pid = torch.as_tensor([y * nx + x], device=device)
        st, _ = volpath.start_camera_paths(camera, film, args.seed & 0xFFFFFFFF,
                                           torch.full_like(pid, s), pid,
                                           setup.camera_medium)
        st = volpath.trace_paths(
            scene, volpath.VolPathConfig(max_depth=args.maxdepth or 32), st)
        L = st.L[0].cpu().numpy()
        print(f"[debugstart] pixel ({x},{y}) sample {s}: "
              f"L = ({L[0]:.6g}, {L[1]:.6g}, {L[2]:.6g})")
        return 0

    ip = ParameterDictionary(setup.integrator_params)
    from .models.materials import SUBSURFACE

    # subsurface probe relocation when the scene holds a subsurface row
    cfg = volpath.VolPathConfig(
        max_depth=args.maxdepth or ip.get_int("maxdepth", 32),
        sss=SUBSURFACE in setup.scene.materials.kinds)
    ref = (read_image(args.mse_reference_image)
           if args.mse_reference_image else None)
    mse_log = []
    name = setup.integrator
    spp_per_pass = max(1, min(args.spp_per_pass, setup.spp))
    out = args.outfile or setup.outfile
    if os.path.splitext(out)[1] not in ("", ".exr", ".pfm", ".qoi", ".png"):
        print(f"error: unsupported image extension: {out!r} (supported: "
              ".exr .pfm .qoi .png)", file=sys.stderr)
        return 1

    progressive = (args.time is not None or args.write_partial_images
                   or args.checkpoint)
    if progressive and name in ("volpath", "path"):
        from .utils.checkpoint import load_render_state, save_render_state
        from .utils.progress import ProgressReporter

        resume = None
        if args.checkpoint and os.path.exists(args.checkpoint):
            st0, spp0, _ = load_render_state(args.checkpoint, device)
            resume = (st0, spp0)
            if not args.quiet:
                print(f"[resume] {spp0} spp from {args.checkpoint}",
                      file=sys.stderr)
        reporter = ProgressReporter(
            setup.spp if args.time is None else 0,
            quiet=args.quiet or args.time is not None)
        # CHECK context: a failure mid-render names the pass to replay
        # (CheckCallbackScope pattern, cpu/integrators.cpp:99-104)
        wave_state = {"wave": 0, "spp": 0}
        log.register_check_callback(
            lambda: f"rendering wave {wave_state['wave']} "
                    f"({wave_state['spp']} spp done) - replay with "
                    f"--debugstart x,y,s")

        def cb(wave, spp_done, image_fn):
            wave_state["wave"], wave_state["spp"] = wave, spp_done
            log.verbose("wave %d done (%d spp)", wave, spp_done)
            reporter.count = 0
            reporter.update(spp_done)
            if args.write_partial_images:
                write_exr(f"{out}.partial.exr", image_fn())
            if ref is not None:
                mse_log.append((spp_done, mse_np(image_fn(), ref)))

        img, spp_done, fstate = volpath.render_progressive(
            setup.scene, setup.camera, setup.film, cfg=cfg, seed=args.seed,
            camera_medium=setup.camera_medium, spp_per_pass=spp_per_pass,
            max_spp=setup.spp if args.time is None else 1 << 20,
            time_budget=args.time, sampler=setup.sampler, wave_callback=cb,
            resume_state=resume, device=device)
        if args.checkpoint:
            save_render_state(args.checkpoint, fstate, spp_done, args.seed)
        reporter.done()
        if not args.quiet:
            print(f"[budget] rendered {spp_done} spp", file=sys.stderr)
        setup = setup._replace(spp=spp_done)
    elif name in ("volpath", "path"):
        img = volpath.render(setup.scene, setup.camera, setup.film,
                             spp=setup.spp, cfg=cfg, seed=args.seed,
                             camera_medium=setup.camera_medium,
                             spp_per_pass=spp_per_pass,
                             sampler=setup.sampler, device=device)
    elif name in ("guidedpath", "guidedvolpath"):
        img, _ = gvp.render_guided(
            setup.scene, setup.camera, setup.film, spp=setup.spp, cfg=cfg,
            gopt=_guiding_options(ip), seed=args.seed,
            camera_medium=setup.camera_medium, spp_per_pass=spp_per_pass,
            device=device)
    elif name == "guidedvolpathvspg":
        gopt = _guiding_options(ip)
        method = ip.get_string("vspsamplingmethod", "resampling").lower()
        vopt = vspg.VSPGOptions(
            guide_vsp=ip.get_bool("vspguiding", True),
            guide_primary_vsp=ip.get_bool("vspprimaryguiding", True),
            guide_secondary_vsp=ip.get_bool("vspsecondaryguiding", True),
            # the reference's "nds" + bool collisionProbabilityBias is NDS+
            # (guidedvolpathvspgintegrator.cpp:1293-1300)
            sampling_method=(
                "nds+" if method == "nds" and ip.get_bool(
                    "collisionProbabilityBias", False) else method),
            vsp_mis_ratio=ip.get_float("vspmisratio", 0.5),
            vsp_criterion=ip.get_string("vspcriterion", "variance"),
            guide_rr=ip.get_bool("guidedrr", True),
            denoiser=ip.get_string("isgbdenoiser", "atrous"))
        field0, train = None, True
        if args.load_guiding_cache:
            from .models.guiding.field import load_field

            field0, train = load_field(args.load_guiding_cache, device), False
        img, field, _ = vspg.render_vspg(
            setup.scene, setup.camera, setup.film, spp=setup.spp, cfg=cfg,
            gopt=gopt, vopt=vopt, seed=args.seed,
            camera_medium=setup.camera_medium, spp_per_pass=spp_per_pass,
            field=field0, train=train, backend="auto", device=device)
        if args.store_guiding_cache:
            from .models.guiding.field import save_field

            save_field(field, args.store_guiding_cache)
        if args.guiding_gbuffer:
            from .models.integrators.extras import render_guiding_gbuffer

            gb_rgb, _ = render_guiding_gbuffer(
                setup.scene.to(device), setup.camera.to(device),
                setup.film.to(device), field)
            gb_out = out.rsplit(".", 1)[0] + "_guiding_ids.exr"
            write_exr(gb_out, gb_rgb.cpu().numpy())
            if not args.quiet:
                print(f"[guiding-gbuffer] {gb_out}", file=sys.stderr)
    else:
        print(f"integrator '{name}' not supported; falling back to volpath",
              file=sys.stderr)
        img = volpath.render(setup.scene, setup.camera, setup.film,
                             spp=setup.spp, cfg=cfg, seed=args.seed,
                             spp_per_pass=spp_per_pass, device=device)
    img = img.cpu().numpy()

    dt = time.perf_counter() - t0
    write_image(out, img)
    if ref is not None:
        mse_log.append((setup.spp, mse_np(img, ref)))
        for s, m in mse_log:
            print(f"MSE,{s},{m:.6g}")
    npaths = img.shape[0] * img.shape[1] * setup.spp
    if not args.quiet:
        print(f"[done] {out}  {dt:.1f}s  {npaths / dt / 1e6:.2f} Mpaths/s",
              file=sys.stderr)
    if args.stats:
        print(json.dumps({"seconds": dt, "spp": setup.spp,
                          "resolution": list(img.shape[:2]),
                          "build_seconds": build_s,
                          "mpaths_per_s": npaths / dt / 1e6,
                          "device": str(device)}), file=sys.stderr)
    return 0


def _guiding_options(ip):
    """GuidingOptions from the integrator's scene-file parameters."""
    from .models.integrators.guided_volpath import GuidingOptions

    return GuidingOptions(
        mode=("ris" if ip.get_string("guidingtype", "ris") == "ris"
              else "mis"),
        surface_guiding=ip.get_bool("surfaceguiding", True),
        volume_guiding=ip.get_bool("volumeguiding", True))


def _pixel_material_probe(setup, x, y, max_depth=16):
    """`--pixelmaterial x,y` (cpu/render.cpp:110-161): trace the center
    camera ray of one pixel and print each intersection's world-space
    position, normals, camera distance, material family and parameters
    and interface media. Interface hits (mat_id == -1, pure medium
    boundaries) are reported and skipped through, like the reference's
    'Ignoring interface material' warning."""
    import torch

    from .models import materials as M
    from .ops.intersect import offset_ray_origin

    fam = {M.DIFFUSE: "diffuse", M.CONDUCTOR: "conductor",
           M.DIELECTRIC: "dielectric", M.DIFFUSE_TRANS: "diffusetransmission",
           M.THIN_DIELECTRIC: "thindielectric",
           M.COATED_DIFFUSE: "coateddiffuse",
           M.COATED_CONDUCTOR: "coatedconductor", M.MIX: "mix",
           M.HAIR: "hair", M.SUBSURFACE: "subsurface",
           M.MEASURED: "measured", M.COOK_TORRANCE: "cooktorrance"}
    nx, ny = setup.film.resolution
    if not (0 <= x < nx and 0 <= y < ny):
        print(f"error: pixel ({x},{y}) outside film {nx}x{ny}",
              file=sys.stderr)
        return 1
    camera = setup.camera
    geom = setup.scene.geometry
    dev = geom.tri_p0.device
    p_raster = torch.as_tensor([[x + 0.5, y + 0.5]], device=dev)
    o, d = camera.generate_rays(p_raster, torch.full_like(p_raster, 0.5))[:2]
    cam_o = o[0].cpu().numpy()
    mats = setup.scene.materials
    depth = 1
    any_hit = False
    for _ in range(max_depth):
        h = geom.intersect(o, d, torch.full(o.shape[:-1], torch.inf,
                                            device=dev))
        if not bool(h.hit[0]):
            if not any_hit:
                print("error: no geometry visible at specified pixel.",
                      file=sys.stderr)
                return 1
            break
        any_hit = True
        p, n, ns = (v[0].cpu().numpy() for v in (h.p, h.n, h.ns))
        mid = int(h.mat_id[0])
        mi, mo = int(h.med_in[0]), int(h.med_out[0])
        if mid < 0:
            print(f"(interface hit at t={float(h.t[0]):.6g}, "
                  f"media in/out = {mi}/{mo} — skipping)")
        else:
            dist = float(np.linalg.norm(p - cam_o))
            print(f"Intersection depth {depth}")
            print(f"World-space p: [ {p[0]:.6g}, {p[1]:.6g}, {p[2]:.6g} ]")
            print(f"World-space n: [ {n[0]:.6g}, {n[1]:.6g}, {n[2]:.6g} ]")
            print(f"World-space ns: [ {ns[0]:.6g}, {ns[1]:.6g}, "
                  f"{ns[2]:.6g} ]")
            print(f"Distance from camera: {dist:.6g}")
            kind = int(mats.mat_type[mid])
            alb = mats.albedo[mid].cpu().numpy()
            print(f"Material[{mid}]: {fam.get(kind, f'type{kind}')} "
                  f"albedo=({alb[0]:.4g}, {alb[1]:.4g}, {alb[2]:.4g}) "
                  f"eta={float(mats.eta[mid]):.4g} "
                  f"roughness={float(mats.roughness[mid]):.4g}")
            if mi >= 0 or mo >= 0:
                print(f"MediumInterface: inside={mi} outside={mo}")
            print()
            depth += 1
        # continue straight through (SpawnRay(ray.d), render.cpp:157)
        o = offset_ray_origin(h.p, h.n, d)
    return 0


if __name__ == "__main__":
    sys.exit(main())
