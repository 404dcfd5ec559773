"""A world of processes running the sharded entry points of ``mesh.py``
(counterpart of ``__graft_entry__.dryrun_multichip``).

    python -m vspg_pbrt_v4_tpu_torch.parallel.dryrun --world N --cpu
    python -m vspg_pbrt_v4_tpu_torch.parallel.dryrun [--world N] [--res R]

With ``--cpu`` it starts N gloo ranks on the CPU; without, N NCCL ranks,
one a card (N defaults to the visible cards; NCCL takes no two ranks on
one card). The ranks meet through a ``file://`` store in a temporary
directory, so no network is needed. Each runs one rays-sharded render,
one spp-sharded step, one sharded VSPG training wave and the sharded
kernel route (on the CPU through the kernel's plain version), checks that
the kernel route's image equals the unsharded frozen render float for
float, and the first prints
``dryrun_multichip(N): ok; rays-sharded mean=... vspg-sharded mean=...
vspg-kernel-sharded mean=...``.

``spawn`` runs any function, named "module:function", in such a world
on a job file (the tests hold the sharded entry points against the JAX
package's this way): every rank is a process of its own that imports torch
and this package only. ``kernel_route`` is such a job: the sharded kernel
route with its launches counted.
"""

from __future__ import annotations

import argparse
import importlib
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from . import mesh

_ROOT = Path(__file__).resolve().parents[2]


def demo_scenes(res, device):
    """The dry run's scenes, camera, film and options: the fog box of
    ``__graft_entry__._demo_scene`` for the volpath entry points, an 8^3
    grid cloud in a box under an environment for the VSPG ones."""
    from ..models.cameras import PerspectiveCamera
    from ..models.film import RGBFilm
    from ..models.integrators import guided_volpath as gvp
    from ..models.integrators import volpath
    from ..models.integrators import vspg as vs
    from ..models.lights import Lights
    from ..models.materials import Materials
    from ..models.media import GridMedium, Media
    from ..models.shapes import Geometry
    from ..utils import transform as tr

    fog = volpath.make_fog_box_scene(
        [0.05, 0.05, 0.05], [0.5, 0.6, 0.7], g=0.3,
        env_L=[0.1, 0.12, 0.15], point=((0.0, 0.8, 0.0), (5.0, 5.0, 5.0)),
        device=device)
    camera = PerspectiveCamera.make(
        tr.look_at((0, 0, -4), (0, 0, 0), (0, 1, 0), device=device), 30.0,
        (res, res), device=device)
    film = RGBFilm.make((res, res), device=device)
    n = 8
    x = np.linspace(-1, 1, n, dtype=np.float32)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    dens = (np.clip(1.0 - np.sqrt(X * X + Y * Y + Z * Z), 0, 1)
            .astype(np.float32) * 2.0)
    gm = GridMedium.make(dens, [0.05] * 3, [1.0] * 3, (-1, -1, -1),
                         (1, 1, 1), g=0.2, maj_res=8, device=device)
    cloud = volpath.Scene(
        Geometry.build(boxes=[dict(bmin=(-1, -1, -1), bmax=(1, 1, 1),
                                   mat=-1, light=-1, med_in=0,
                                   med_out=-1)], device=device),
        Materials.build([], device=device),
        Media.make(grids=(gm,), device=device),
        Lights.make(env_L=[0.3] * 3, world_radius=100.0, device=device))
    cfg = volpath.VolPathConfig(max_depth=3, max_events=6)
    gopt = gvp.GuidingOptions(field_res=4, record_depth=2,
                              min_train_weight=1.0)
    return fog, cloud, camera, film, cfg, gopt, vs.VSPGOptions()


def four_entry_points(res=32, *, device):
    """The dry run on each rank: the four sharded entry points on the demo
    scenes. Returns every rank's report, in rank order: the images' means,
    the kernel route's launches (its wrappers' counts around that call
    alone) and whether its image equals the unsharded frozen render float
    for float."""
    from ..ops import vspg_kernels as sk

    rank, world, dev = mesh.default_group(device)
    fog, cloud, camera, film, cfg, gopt, vopt = demo_scenes(res, dev)
    img1 = mesh.render_sharded(fog, camera, film, 1, cfg, 0, device=device)
    img2 = mesh.render_spp_psum(fog, camera, film, 1, cfg, 0, device=device)
    img3, field, isgb = mesh.render_vspg_sharded(
        cloud, camera, film, 1, cfg=cfg, gopt=gopt, vopt=vopt, seed=0,
        spp_per_pass=1, device=device)
    img4, launches = kernel_route(cloud, camera, film, 1, cfg, gopt, vopt,
                                  field, isgb, seed=1, device=device)
    whole = sk.render_frozen(cloud, camera, film, 1, cfg, gopt, vopt, field,
                             isgb, seed=1)
    imgs = (img1, img2, img3, img4)
    report = dict(
        rank=rank, world=world, device=str(dev),
        means=[float(im.mean()) for im in imgs],
        finite=all(bool(torch.isfinite(im).all()) for im in imgs),
        shapes=[tuple(im.shape) for im in imgs],
        field_iteration=int(field.iteration), isgb_ready=bool(isgb.ready),
        kernel_launches=launches,
        kernel_equals_unsharded=bool(torch.equal(img4, whole.cpu())))
    reports = [None] * world
    dist.all_gather_object(reports, report)
    return reports


def kernel_route(*args, device, **kwargs):
    """``mesh.render_vspg_pallas_sharded(*args, **kwargs)`` with the VSPG
    wrappers' launches counted around that call alone: (the whole image,
    on the CPU, {wrapper: launches})."""
    from ..ops import vspg_kernels as sk

    before = dict(sk.LAUNCHES)
    img = mesh.render_vspg_pallas_sharded(*args, device=device, **kwargs)
    if img.is_cuda:
        torch.cuda.synchronize(img.device)
    return img.cpu(), {k: v - before[k] for k, v in sk.LAUNCHES.items()
                       if v != before[k]}


def _run_rank(rank, world, init, cpu, job, out):
    """One rank: join the group, run the job, the first rank saves what it
    returns to `out`."""
    torch.set_num_threads(1)
    backend = "gloo" if cpu else "nccl"
    device = "cpu" if cpu else "cuda"
    if not cpu:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world)
    try:
        spec = torch.load(job, weights_only=False)
        module, attr = spec["fn"].split(":")
        fn = getattr(importlib.import_module(module), attr)
        result = fn(*spec.get("args", ()), device=device,
                    **spec.get("kwargs", {}))
        if rank == 0:
            torch.save(result, out)
    finally:
        dist.destroy_process_group()


def spawn(world, fn, args=(), kwargs=None, cpu=True, timeout=900):
    """Run `fn` ("module:function", e.g.
    "vspg_pbrt_v4_tpu_torch.parallel.mesh:render_sharded") with `args`,
    `kwargs` and `device` on each of `world` ranks, each a process of its
    own (gloo on the CPU or NCCL, one rank a card); returns rank 0's
    result. A rank that fails stops the others and raises."""
    if fn.count(":") != 1:
        raise ValueError(f"spawn takes a \"module:function\", not {fn!r}")
    with tempfile.TemporaryDirectory() as tmp:
        job = Path(tmp) / "job.pt"
        out = Path(tmp) / "out.pt"
        torch.save(dict(fn=fn, args=tuple(args), kwargs=dict(kwargs or {})),
                   job)
        init = (Path(tmp) / "store").as_uri()
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(_ROOT)] + [p for p in env.get("PYTHONPATH", "").split(
                os.pathsep) if p])
        cmd = [sys.executable, "-m", "vspg_pbrt_v4_tpu_torch.parallel.dryrun",
               "--world", str(world), "--init", init, "--job", str(job),
               "--out", str(out)] + (["--cpu"] if cpu else [])
        logs = [Path(tmp) / f"rank{r}.log" for r in range(world)]
        procs = []
        try:
            for r in range(world):
                with open(logs[r], "w") as f:
                    procs.append(subprocess.Popen(
                        cmd + ["--rank", str(r)], env=env, stdout=f,
                        stderr=subprocess.STDOUT))
            # a rank that fails would leave the others waiting in a
            # collective: stop them all at the first failure
            deadline = time.monotonic() + timeout
            while (any(p.poll() is None for p in procs)
                   and not any(p.poll() for p in procs)
                   and time.monotonic() < deadline):
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        bad = [(r, p.returncode) for r, p in enumerate(procs)
               if p.returncode != 0]
        if bad:
            r, rc = bad[0]
            raise RuntimeError(f"rank {r} of {world} exited {rc}:\n"
                               + logs[r].read_text())
        return torch.load(out, weights_only=False)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m "
                                 "vspg_pbrt_v4_tpu_torch.parallel.dryrun")
    ap.add_argument("--world", type=int, default=None,
                    help="ranks (default: 2 on the CPU, the visible cards "
                         "otherwise)")
    ap.add_argument("--cpu", action="store_true",
                    help="gloo ranks on the CPU (default: NCCL on the cards)")
    ap.add_argument("--res", type=int, default=32)
    # one rank of a world that spawn() started
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--job", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.rank is not None:
        _run_rank(a.rank, a.world, a.init, a.cpu, a.job, a.out)
        return 0
    if not a.cpu and not torch.cuda.is_available():
        print("dryrun: no CUDA device (pass --cpu for gloo ranks on the "
              "CPU)", file=sys.stderr)
        return 1
    world = a.world or (2 if a.cpu else torch.cuda.device_count())
    if not a.cpu and world > torch.cuda.device_count():
        print(f"dryrun: {world} NCCL ranks need {world} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 1
    reports = spawn(world, "vspg_pbrt_v4_tpu_torch.parallel.dryrun:"
                    "four_entry_points", (a.res,), cpu=a.cpu)
    # the kernel route launches the item kernel and the reduce once a rank
    # on a card, nothing on the CPU (the plain version)
    want = {} if a.cpu else {"vspg_render": 1, "vspg_reduce": 1}
    for r in reports:
        print(f"dryrun rank {r['rank']} of {world} "
              f"({'gloo' if a.cpu else 'nccl'}, {r['device']}): means "
              f"{[round(m, 5) for m in r['means']]} (rays, spp-psum, vspg, "
              f"vspg-kernel), field iteration {r['field_iteration']}, isgb "
              f"ready {r['isgb_ready']}, kernel route launches "
              f"{r['kernel_launches']}, kernel route equal to the unsharded "
              f"render {r['kernel_equals_unsharded']}", flush=True)
    r = reports[0]
    ok = all(q["finite"] and q["kernel_equals_unsharded"]
             and q["kernel_launches"] == want and q["means"] == r["means"]
             and all(s == (a.res, a.res, 3) for s in q["shapes"])
             for q in reports)
    if not ok:
        print(f"dryrun_multichip({world}): FAILED", file=sys.stderr)
        return 1
    print(f"dryrun_multichip({world}): ok; "
          f"rays-sharded mean={r['means'][0]:.5f} "
          f"vspg-sharded mean={r['means'][2]:.5f} "
          f"vspg-kernel-sharded mean={r['means'][3]:.5f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
