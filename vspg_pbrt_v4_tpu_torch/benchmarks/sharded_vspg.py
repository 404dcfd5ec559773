"""The frozen VSPG render of the bench's pyro64 cell (bench_config3,
chip_smoke.py phase 7c: 256^2, RIS, the contribution criterion, a field
trained by 48 record waves) split by rows over a world of ranks,
``parallel/mesh.render_vspg_pallas_sharded``, against the unsharded
render on one card.

    python -m vspg_pbrt_v4_tpu_torch.benchmarks.sharded_vspg [--world N]
        [--method resampling|nds] [--res R] [--waves W] [--spp S] [--cpu]

Without ``--cpu`` it takes one NCCL rank a card (N defaults to the
visible cards); with it, gloo ranks on the CPU through the render
kernel's plain version (a rehearsal: ``--cpu --world 4 --res 16 --waves
1 --spp 1``). Every rank trains the same field (the guiding modules'
scatter-adds take a fixed order): its field and ISGB tables must equal
rank 0's bit for bit. Then, each the best of 3 after one: every rank's
block alone (``mesh.render_block``, by CUDA events on a card), the whole
sharded call (its tables, the blocks and the gather) by the host's clock
between barriers, and on rank 0 the unsharded ``render_frozen`` (its
tables and the render) by the host's clock too, and its render alone by
CUDA events. The speed-up divides the two host-clock times. The stitched
image must equal the unsharded one float for float. Prints a line a rank
and a summary, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import torch
import torch.distributed as dist

from ..parallel import dryrun, mesh


def _host_best_of_3(fn, cuda):
    """Best ms of 3 runs after one by the host's clock, from a
    synchronised card to a synchronised card."""
    fn()
    best = float("inf")
    for _ in range(3):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def _same_as_rank0(t):
    """Whether this rank's `t` equals rank 0's bit for bit."""
    parts = mesh.gather_rows(t[None])
    return bool(torch.equal(parts[dist.get_rank()], parts[0]))


def _best_of_3(fn, cuda):
    """Best ms of 3 runs after one: CUDA events on a card, else the host's
    clock."""
    fn()
    best = float("inf")
    for _ in range(3):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            best = min(best, start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def job(res, waves, spp, method, *, device):
    """One rank's part; returns every rank's report in rank order."""
    from ..models.film import RGBFilm
    from ..models.integrators import guided_volpath, volpath, vspg
    from ..ops import volpath_kernels as vk
    from ..ops import vspg_kernels as sk

    rank, world, dev = mesh.default_group(device)
    cuda = dev.type == "cuda"
    cfg = volpath.VolPathConfig(max_depth=64, max_events=256,
                                max_collisions=4096)
    gopt = guided_volpath.GuidingOptions(field_res=8, record_depth=6,
                                         min_train_weight=16.0,
                                         train_waves=waves)
    vopt = vspg.VSPGOptions(vsp_criterion="contribution",
                            sampling_method=method)
    pyro = sk.make_pyro64_scene(device=dev)
    cam = vk.bench_camera(res, device=dev)
    film = RGBFilm.make((res, res), device=dev)
    _, field, isgb = vspg.render_vspg(pyro, cam, film, spp=waves, cfg=cfg,
                                      gopt=gopt, vopt=vopt, seed=5,
                                      device=dev)
    c, g, ftab, itab = sk.kernel_inputs(pyro, cam, film, cfg, gopt, vopt,
                                        field, isgb)
    same_field = _same_as_rank0(ftab) and _same_as_rank0(itab)
    base = mesh.row_block(c, itab, rank, world)[2]
    block_ms = _best_of_3(
        lambda: mesh.render_block(c, g, ftab, itab, rank, world, spp, 11),
        cuda)

    def sharded():
        return mesh.render_vspg_pallas_sharded(pyro, cam, film, spp, cfg,
                                               gopt, vopt, field, isgb,
                                               seed=11, device=device)

    img = sharded()
    call_ms = float("inf")
    for _ in range(3):
        dist.barrier()
        t0 = time.perf_counter()
        sharded()
        if cuda:
            torch.cuda.synchronize()
        dist.barrier()
        call_ms = min(call_ms, (time.perf_counter() - t0) * 1e3)
    report = dict(rank=rank, device=str(dev), block_ms=block_ms,
                  pix_base=base, same_field=same_field, call_ms=call_ms)
    if rank == 0:
        def whole():
            return sk.render_frozen(pyro, cam, film, spp, cfg, gopt, vopt,
                                    field, isgb, seed=11)

        report.update(equal=bool(torch.equal(img, whole())),
                      whole_ms=_host_best_of_3(whole, cuda),
                      whole_kernel_ms=_best_of_3(
                          lambda: sk.render_vspg_kernel(c, g, ftab, itab,
                                                        spp, 11), cuda),
                      mean=float(img.mean()))
    reports = [None] * world
    dist.all_gather_object(reports, report)
    return reports


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m vspg_pbrt_v4_tpu_torch.benchmarks.sharded_vspg")
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--method", default="resampling",
                    choices=("resampling", "nds"))
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--waves", type=int, default=48)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--cpu", action="store_true")
    a = ap.parse_args(argv)
    if not a.cpu and not torch.cuda.is_available():
        print("sharded_vspg: no CUDA device", file=sys.stderr)
        return 1
    world = a.world or (2 if a.cpu else torch.cuda.device_count())
    card = "CPU" if a.cpu else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    reports = dryrun.spawn(
        world, "vspg_pbrt_v4_tpu_torch.benchmarks.sharded_vspg:job",
        (a.res, a.waves, a.spp, a.method), cpu=a.cpu, timeout=1800)
    for r in reports:
        print(f"sharded_vspg {a.method} {a.res}x{a.res}x{a.spp} rank "
              f"{r['rank']} of {world} ({r['device']}): its block from pixel "
              f"{r['pix_base']} {r['block_ms']:.3f} ms, the sharded call "
              f"{r['call_ms']:.3f} ms, field and ISGB tables equal to rank "
              f"0's bit for bit: {r['same_field']} [{card}]", flush=True)
    r0 = reports[0]
    slowest = max(r["block_ms"] for r in reports)
    print(f"sharded_vspg {a.method} {a.res}x{a.res}x{a.spp} over {world} "
          f"ranks, by the host's clock with tables: the sharded call "
          f"{r0['call_ms']:.3f} ms against {r0['whole_ms']:.3f} ms unsharded "
          f"on one card ({r0['whole_ms'] / r0['call_ms']:.3f}x); by "
          f"{'the host' if a.cpu else 'CUDA events'}, the render alone: "
          f"the slowest block {slowest:.3f} ms against {r0['whole_kernel_ms']:.3f} ms unsharded "
          f"({r0['whole_kernel_ms'] / slowest:.3f}x); stitched image equal "
          f"to the unsharded render bit for bit: {r0['equal']}; mean "
          f"{r0['mean']:.6f} [{card}]", flush=True)
    ok = r0["equal"] and all(r["same_field"] for r in reports)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
