"""Where the U-Net's training on a card parts from the CPU's: rounding or a
fault.

``models/guiding/denoiser.train_and_denoise`` trains the ISGB's U-Net a
few Adam steps and then denoises the buffer. Over many steps the card's
result and the CPU's drift apart. This script runs the same update on the
same seeded inputs and weights three ways, at 1 to 48 steps: on the card
in float32, on the CPU in float32 and on the CPU in float64. For
each float32 run it prints how far its trained parameters and its
denoised colour and VSP map sit from the float64 run's, and how far the
card's sit from the CPU's. If the card and the CPU sit equally far from
float64, and the distance grows smoothly with the steps, the two differ
by rounding alone; a fault (TF32, a non-deterministic algorithm) would
put the card alone far off. Two variants of the card's run bound the
shipped one: cuDNN with TF32 allowed (what such a fault would look like)
and cuDNN off (PyTorch's own convolutions), each against float64.

The inputs are those of ``chip_smoke.py`` phase 17d: a 256^2 buffer of
uniform colours, counts and VSP values from ``numpy.random.default_rng
(17)``, and a width-12 net with its seeded initial weights.

Run on a card from the repository root: ``python -m
vspg_pbrt_v4_tpu_torch.benchmarks.unet_precision``; ``--cpu`` runs the
float32 "card" side on the CPU as well (a rehearsal), ``--res`` and
``--steps`` cut the size. Prints one line a step count with the card's
name and power limit, and the figures as one JSON line last.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import time

import numpy as np
import torch


def _card():
    if not torch.cuda.is_available():
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def inputs(n, seed=17):
    """chip_smoke 17d's buffer: colour halves and the full colour, their
    counts, albedo, normal and the raw VSP map, (n, n[, 3]) float32."""
    rng = np.random.default_rng(seed)

    def img(*c):
        return rng.uniform(0, 2, (n, n) + c).astype(np.float32)

    return [img(3), rng.integers(0, 3, (n, n)).astype(np.float32), img(3),
            rng.integers(1, 3, (n, n)).astype(np.float32), img(3),
            rng.integers(1, 5, (n, n)).astype(np.float32), img(3), img(3),
            rng.uniform(-1, 1, (n, n)).astype(np.float32)]


# the card's convolution settings: the shipped ones (denoiser._conv_mode),
# TF32 allowed, and cuDNN off
VARIANTS = {
    "shipped": None,
    "tf32": dict(enabled=True, benchmark=False, deterministic=True,
                 allow_tf32=True),
    "no_cudnn": dict(enabled=False, benchmark=False, deterministic=True,
                     allow_tf32=False),
}


def run(net0, args, device, dtype, steps, variant="shipped"):
    """(parameters flattened, denoised colour, denoised VSP) as float64
    numpy, and the seconds the update took."""
    from ..models.guiding import denoiser as dn

    flags = VARIANTS[variant]
    if flags is not None:
        shipped = dn._conv_mode
        dn._conv_mode = lambda: torch.backends.cudnn.flags(**flags)
        try:
            return run(net0, args, device, dtype, steps)
        finally:
            dn._conv_mode = shipped
    net = copy.deepcopy(net0).to(device=device, dtype=dtype)
    tensors = [torch.as_tensor(a, device=device).to(dtype) for a in args]
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    net, _, out_c, out_v = dn.train_and_denoise(net, None, *tensors,
                                                steps=steps)
    if device == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    params = torch.cat([p.detach().reshape(-1) for p in net.parameters()])
    return ([x.cpu().double().numpy() for x in (params, out_c, out_v)], dt)


def distance(a, b):
    """Relative L2 distance of `a` from `b`, its largest absolute
    difference, and the share of pixels (last axis together) within 1e-3
    relative (chip_smoke 17d's measure)."""
    rel_l2 = float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))
    max_abs = float(np.abs(a - b).max())
    rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-6)
    if a.ndim >= 2:
        share = float((rel <= 1e-3).reshape(a.shape[0], a.shape[1], -1)
                      .all(-1).mean())
    else:
        share = float((rel <= 1e-3).mean())
    return {"rel_l2": rel_l2, "max_abs": max_abs, "share_1e-3": share}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="unet_precision")
    ap.add_argument("--cpu", action="store_true",
                    help="run the float32 'card' side on the CPU")
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--steps", type=int, nargs="+",
                    default=[1, 2, 4, 8, 16, 32, 48])
    ap.add_argument("--width", type=int, default=12)
    a = ap.parse_args(argv)
    if not a.cpu and not torch.cuda.is_available():
        raise SystemExit("unet_precision: no CUDA device (--cpu rehearses "
                         "it on the CPU)")
    from ..models.guiding import denoiser as dn

    card = _card()
    dev = "cpu" if a.cpu else "cuda"
    args = inputs(a.res)
    net0 = dn.UNet(width=a.width)
    names = ("params", "color", "vsp")
    out = []
    for steps in a.steps:
        f64, t64 = run(net0, args, "cpu", torch.float64, steps)
        c32, t32 = run(net0, args, "cpu", torch.float32, steps)
        g32, tg = run(net0, args, dev, torch.float32, steps)
        g32b, _ = run(net0, args, dev, torch.float32, steps)
        rec = {"steps": steps, "seconds": {"card_f32": tg, "cpu_f32": t32,
                                           "cpu_f64": t64},
               "card_repeat_equal": all(np.array_equal(x, y)
                                        for x, y in zip(g32, g32b))}
        pairs = [("card_f32_vs_f64", (g32, f64)),
                 ("cpu_f32_vs_f64", (c32, f64)),
                 ("card_vs_cpu_f32", (g32, c32))]
        if dev == "cuda":
            for v in ("tf32", "no_cudnn"):
                pairs.append((f"card_{v}_vs_f64",
                              (run(net0, args, dev, torch.float32, steps,
                                   v)[0], f64)))
        for label, (x, y) in pairs:
            rec[label] = {n: distance(u, v)
                          for n, u, v in zip(names, x, y)}
        out.append(rec)
        parts = []
        for label, _ in pairs:
            r = rec[label]
            parts.append(
                f"{label}: params rel L2 {r['params']['rel_l2']:.3e}, "
                f"color rel L2 {r['color']['rel_l2']:.3e} (max abs "
                f"{r['color']['max_abs']:.3e}, within 1e-3 "
                f"{r['color']['share_1e-3']:.5f}), VSP rel L2 "
                f"{r['vsp']['rel_l2']:.3e} (within 1e-3 "
                f"{r['vsp']['share_1e-3']:.5f})")
        print(f"unet_precision {a.res}x{a.res}, width {a.width}, {steps} "
              f"steps ({dev} f32 {tg:.2f} s, CPU f32 {t32:.2f} s, CPU f64 "
              f"{t64:.2f} s; {dev} runs equal bit for bit: "
              f"{rec['card_repeat_equal']}): " + "; ".join(parts)
              + f" [{card}]", flush=True)
    print(json.dumps({"card": card, "device": dev, "res": a.res,
                      "width": a.width, "runs": out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
