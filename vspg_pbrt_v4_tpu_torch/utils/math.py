"""Scalar math helpers (counterpart of ``vspg_pbrt_v4_tpu/utils/math.py``).

Only the constants, ``safe_*`` helpers and reductions the ported
integrators use.
"""

from __future__ import annotations

import math

import torch

PI = 3.14159265358979323846
INV_PI = 1.0 / PI
INV_4PI = 1.0 / (4.0 * PI)


def sqr(x):
    return x * x


def safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=0.0))


def safe_acos(x):
    return torch.arccos(torch.clamp(x, -1.0, 1.0))


def safe_div(a, b, fill=0.0):
    """a/b with a zero denominator giving `fill`."""
    b_ok = b != 0
    denom = torch.where(b_ok, b, torch.ones_like(b))
    return torch.where(b_ok, a / denom, torch.full_like(denom, fill))


def py_mod(x, y):
    """x mod y with the sign of y, as ``jnp.remainder`` computes it: the
    exact fmod, moved into y's sign where it differs (``torch.remainder``
    divides and rounds instead)."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def int_pow(x, n):
    """x ** n for a positive integer n by the squarings of XLA's
    ``integer_pow`` (binary exponentiation, low bits first), so that the
    product rounds as the JAX package's."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def nanmax(x, dim=-1):
    """Max over `dim` ignoring NaNs (jnp.nanmax)."""
    return torch.where(torch.isnan(x), -torch.inf, x).amax(dim)


def nanmin(x, dim=-1):
    """Min over `dim` ignoring NaNs (jnp.nanmin)."""
    return torch.where(torch.isnan(x), torch.inf, x).amin(dim)


def index_sum(out, index, src):
    """`out` with the rows of `src` added at `index` along dim 0, in place,
    in the same order on every run. On the CPU ``index_add_`` (lane
    order). On a card ``index_add_``'s atomics add in whatever order they
    land, so the lanes are sorted by index (stably) and each column's
    segments summed by one 1-D ``torch.segment_reduce`` (a tree a
    segment): the same bits every run, though not the CPU's."""
    if not out.is_cuda:
        return out.index_add_(0, index, src)
    n, r = out.shape[0], index.shape[0]
    k = math.prod(src.shape[1:])
    # the segment lengths by integer adds, exact in any order; no check
    # that reads anything back, so nothing here waits for the card
    lengths = torch.zeros(n, dtype=torch.int64, device=out.device)
    lengths.index_add_(0, index, torch.ones_like(index))
    cols = src[torch.argsort(index, stable=True)].reshape(r, k).T
    sums = torch.segment_reduce(cols.reshape(-1), "sum",
                                lengths=lengths.repeat(k), unsafe=True)
    return out.add_(sums.reshape(k, n).T.reshape(out.shape))


def difference_of_products(a, b, c, d):
    """a*b - c*d with the JAX package's compensation term (zero without
    an FMA, as on the CPU)."""
    cd = c * d
    return (a * b - cd) + -(c * d - cd)


def quadratic(a, b, c):
    """Roots of a t^2 + b t + c = 0: (has_solution, t0, t1), t0 <= t1; a
    linear equation (a == 0) puts its one root in both slots."""
    disc = difference_of_products(b, b, 4.0 * a, c)
    has = disc >= 0.0
    root = safe_sqrt(disc)
    q = -0.5 * (b + torch.where(b < 0, -root, root))
    t0 = safe_div(q, a, fill=0.0)
    t1 = safe_div(c, q, fill=0.0)
    lin_t = safe_div(-c, b, fill=0.0)
    is_lin = a == 0.0
    tmin, tmax = torch.minimum(t0, t1), torch.maximum(t0, t1)
    return (torch.where(is_lin, b != 0.0, has),
            torch.where(is_lin, lin_t, tmin), torch.where(is_lin, lin_t, tmax))
