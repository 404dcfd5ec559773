"""Microbenchmark M: per-lane dependent gathers from a (C, 128) float32
table (counterpart of the repository's ``benchmarks/gather_microbench.py``,
whose Pallas kernel times two TPU gather strategies).

Per lane of a block of SUB x 128 = 1024 lanes: ``idx = _mix(lane * 131 +
sublane * 7919 + seed)``, then ``events`` times ``v = table[(idx &
(C*128-1)) >> 7 & (C-1), idx & 127]``, ``idx = _mix(idx + int(v) + i)``
and ``acc += v``, in wrapping int32 arithmetic; the (8, 128) accumulators
are the result. Block b runs seed + b, so that ``blocks`` can fill the
card; block 0 is the TPU kernel's result.

On the card ``csrc/gather_microbench.cu`` runs it with the table in one of
two placements: ``global`` (read through the read-only cache, resident in
L2) and ``shared`` (staged in shared memory, C <= 256). Both compute one
function, as the TPU's ``sweep`` and ``matmul_sub`` do, and are held to one
plain version, ``gather_plain``. The wrapper ``gather`` runs the plain
version only for a table on the CPU; on a CUDA table it launches the kernel
or raises. ``LAUNCHES`` counts the launches.

Timing is slope-based, as in the JAX file: t(E_HI) - t(E_LO) over the
event-count difference, best of 5 by CUDA events, so the launch cost
cancels. Every lookup waits for the previous one, so the slope is a
latency: ns per dependent lookup.

Run on a card: ``python -m vspg_pbrt_v4_tpu_torch.benchmarks.gather_microbench
[global|shared ...] [C ...]`` (defaults: both placements, C = 32, 256,
2048).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

SUB = 8  # sublanes of the TPU block: lanes = SUB * 128 = 1024
LANES = 128
E_LO, E_HI = 512, 8192
VARIANTS = ("global", "shared")
# the largest table a block can stage in its 227 KB of shared memory
MAX_SHARED_C = 256
LAUNCHES = {"gather_global": 0, "gather_shared": 0}


def make_table(C):
    """The (C, 128) table of the JAX file's ``_tables``: |N(0, 1)| draws
    from numpy's generator seeded 0, rounded to bf16 (to nearest, ties to
    even) and held as float32."""
    t = np.abs(np.random.default_rng(0).normal(size=(C, LANES))).astype(
        np.float32)
    u = t.view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _wrap(x):
    """int64 tensor -> the int32 value of its low 32 bits, as int64."""
    return ((x + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31


def _mix(x):
    x = _wrap((x ^ (x >> 4)) * 277803737)
    return x ^ (x >> 11)


def gather_plain(table, seed, C, events, blocks=1):
    """Plain PyTorch version of both placements: (blocks, 8, 128) float32.
    int32 arithmetic is carried in int64 and wrapped to 32 bits."""
    _check_args(table, C, events, blocks)
    dev = table.device
    flat = table.reshape(-1)
    lane = torch.arange(LANES, device=dev)[None, None, :]
    subl = torch.arange(SUB, device=dev)[None, :, None]
    blk = torch.arange(blocks, device=dev)[:, None, None]
    idx = _mix(_wrap(lane * 131 + subl * 7919 + int(seed) + blk))
    acc = torch.zeros((blocks, SUB, LANES), dtype=torch.float32, device=dev)
    for i in range(int(events)):
        word = idx & (C * LANES - 1)
        v = flat[((word >> 7) & (C - 1)) * LANES + (word & 127)]
        idx = _mix(_wrap(idx + v.to(torch.int64) + i))
        acc = acc + v
    return acc


def _check_args(table, C, events, blocks):
    if C < 1 or C & (C - 1):
        raise ValueError(f"C must be a power of two, got {C}")
    if tuple(table.shape) != (C, LANES) or table.dtype != torch.float32:
        raise ValueError(f"want a float32 ({C}, {LANES}) table, got "
                         f"{table.dtype} {tuple(table.shape)}")
    if int(events) < 0 or int(blocks) < 1:
        raise ValueError("events must be >= 0 and blocks >= 1")


def gather(table, seed, C, events, blocks=1, variant="global"):
    """M: (blocks, 8, 128) accumulators; the CUDA kernel with the table in
    `variant`'s placement for a table on a card, the plain version for one
    on the CPU."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    _check_args(table, C, events, blocks)
    dev = table.device
    if dev.type == "cpu":
        return gather_plain(table, seed, C, events, blocks)
    if dev.type != "cuda":
        raise ValueError(f"gather: no kernel for device {dev}")
    if not table.is_contiguous():
        raise ValueError("gather: the table must be contiguous")
    if variant == "shared" and C > MAX_SHARED_C:
        raise ValueError(f"a {C} x 128 table does not fit in shared memory "
                         f"(at most C = {MAX_SHARED_C})")
    from ..ops import _build

    lib = _build.load()
    with torch.cuda.device(dev):
        out = torch.empty((blocks, SUB, LANES), dtype=torch.float32,
                          device=dev)
        err = lib.gather_launch(
            table.data_ptr(), out.data_ptr(), int(C), int(events),
            int(seed), int(blocks), int(variant == "shared"),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gather_{variant} launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["gather_" + variant] += 1
    return out


def run(variant, C, reps=5, blocks=1, device="cuda"):
    """The JAX file's slope timing of one placement at table size C on the
    card: prints and returns (us per event per block, Mlookups/s, the best
    E_HI launch in ms)."""
    table = torch.as_tensor(make_table(C), device=device)

    def timed(events):
        out = gather(table, 1, C, events, blocks, variant)
        if not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"gather_{variant}: non-finite result")
        best = float("inf")
        for r in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            gather(table, r + 2, C, events, blocks, variant)
            end.record()
            torch.cuda.synchronize()
            best = min(best, start.elapsed_time(end) * 1e-3)
        return best

    t_hi = timed(E_HI)
    slope = (t_hi - timed(E_LO)) / (E_HI - E_LO)
    us = slope * 1e6
    rate = blocks * SUB * LANES / max(slope, 1e-12) / 1e6
    print(f"{variant:8s} C={C:5d} ({C * LANES:7d} f32) blocks={blocks:5d}  "
          f"{us:9.4f} us/event/block  {rate:10.2f} Mlookups/s", flush=True)
    return us, rate, t_hi * 1e3


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("gather_microbench: no CUDA card")
    variants = [v for v in sys.argv[1:] if not v.isdigit()] or list(VARIANTS)
    sizes = [int(s) for s in sys.argv[1:] if s.isdigit()] or [32, 256, 2048]
    for v in variants:
        for C in sizes:
            if v == "shared" and C > MAX_SHARED_C:
                print(f"{v:8s} C={C:5d}  skipped: {C * LANES * 4} bytes "
                      f"exceed a block's shared memory", flush=True)
                continue
            run(v, C)
