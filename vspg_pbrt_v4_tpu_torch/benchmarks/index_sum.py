"""The guiding modules' scatter-add on a card: ``utils/math.index_sum``
against ``index_add_`` and the accumulating ``index_put_``.

A VSPG training wave adds its records into the field's cells
(``vmf.em_update``, ``field._update_half``) and its pixels' samples into
the ISGB (``isgb_add_samples``). ``index_add_`` adds on a card in whatever
order its atomics land, so a guided render's bits change from run to run
and the CLI's image cannot equal the API's; ``index_sum`` sorts the lanes
by index and sums each segment with one 1-D ``segment_reduce``.

For each of the training wave's shapes (records into 8^3 cells with 8
lobes, 8 lobes x 3, 3 channels; samples into 256^2 pixels) it checks
three runs of ``index_sum`` for equal bits and times it, ``index_add_``
and ``index_put_(accumulate=True)`` by CUDA events (mean of 20 launches
after one); then it times one ``render_vspg`` call on pyro64 at 256^2
(phase 7c's configuration, ``WAVES`` training waves and 16 frozen spp, the
kernel route) with each of the three in the guiding modules, by the
host's clock around the synchronised call, and checks that two calls
with ``index_sum`` give the same image bits.

Run on a card from the repository root: ``python -m
vspg_pbrt_v4_tpu_torch.benchmarks.index_sum``. Prints one line a
measurement with the card's name and power limit.
"""

from __future__ import annotations

import subprocess
import time

import torch

WAVES = 8
R = 65536 * 6  # a 256^2 training wave's records at record_depth 6


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _add(out, index, src):
    return out.index_add_(0, index, src)


def _put(out, index, src):
    return out.index_put_((index,), src, accumulate=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("index_sum: no CUDA device")
    from ..models.film import RGBFilm
    from ..models.guiding import field, isgb, vmf
    from ..models.integrators import guided_volpath, volpath, vspg
    from ..ops import _build
    from ..ops import volpath_kernels as vk
    from ..ops import vspg_kernels as sk
    from ..utils import math as um

    tag = f"[{_card()}]"
    dev = "cuda"
    gen = torch.Generator().manual_seed(0)
    for name, n, shape in (("records x lobes", 512, (R, 8)),
                           ("records x lobes x 3", 512, (R, 8, 3)),
                           ("records x 3", 512, (R, 3)),
                           ("records", 512, (R,)),
                           ("pixel samples x 3", 65536, (65536, 3))):
        idx = torch.randint(0, n, shape[:1], generator=gen).to(dev)
        src = torch.randn(shape, generator=gen).to(dev)
        runs = [um.index_sum(torch.zeros((n,) + shape[1:], device=dev), idx,
                             src) for _ in range(3)]
        same = all(torch.equal(runs[0], r) for r in runs)
        ms = {}
        for label, fn in (("index_sum", um.index_sum), ("index_add_", _add),
                          ("index_put_", _put)):
            out = torch.zeros((n,) + shape[1:], device=dev)
            fn(out, idx, src)
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            for _ in range(20):
                fn(out, idx, src)
            end.record()
            torch.cuda.synchronize()
            ms[label] = start.elapsed_time(end) / 20
        print(f"{name} {tuple(shape)} into {n} rows: index_sum "
              f"{ms['index_sum']:.4f} ms (three runs equal bit for bit: "
              f"{same}), index_add_ {ms['index_add_']:.4f} ms, index_put_ "
              f"{ms['index_put_']:.4f} ms {tag}", flush=True)
        assert same

    _build.load()
    cfg = volpath.VolPathConfig(max_depth=64, max_events=256,
                                max_collisions=4096)
    gopt = guided_volpath.GuidingOptions(field_res=8, record_depth=6,
                                         min_train_weight=16.0,
                                         train_waves=WAVES)
    vopt = vspg.VSPGOptions(vsp_criterion="contribution")
    pyro = sk.make_pyro64_scene(device=dev)
    cam = vk.bench_camera(256, device=dev)
    film = RGBFilm.make((256, 256), device=dev)

    def call():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = vspg.render_vspg(pyro, cam, film, spp=WAVES + 16, cfg=cfg,
                               gopt=gopt, vopt=vopt, seed=5, device=dev)[0]
        torch.cuda.synchronize()
        return time.perf_counter() - t0, img

    call()  # warm-up
    modules = (field, isgb, vmf)
    try:
        images = []
        for label, fn in (("index_sum", um.index_sum), ("index_add_", _add),
                          ("index_put_", _put), ("index_sum", um.index_sum)):
            for mod in modules:
                mod.index_sum = fn
            t, img = call()
            if label == "index_sum":
                images.append(img)
            print(f"render_vspg pyro64 256x256, {WAVES} training waves + 16 "
                  f"frozen spp, the guiding modules' scatter-adds by "
                  f"{label}: {t:.3f} s, mean {img.mean().item():.6f} {tag}",
                  flush=True)
    finally:
        for mod in modules:
            mod.index_sum = um.index_sum
    same = torch.equal(images[0], images[1])
    print(f"render_vspg with index_sum twice: images equal bit for bit: "
          f"{same} {tag}", flush=True)
    assert same


if __name__ == "__main__":
    main()
