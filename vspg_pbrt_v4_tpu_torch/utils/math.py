"""Scalar math helpers (counterpart of ``vspg_pbrt_v4_tpu/utils/math.py``).

Only the constants and ``safe_*`` helpers the ported integrators use.
"""

from __future__ import annotations

import torch

PI = 3.14159265358979323846
INV_PI = 1.0 / PI
INV_4PI = 1.0 / (4.0 * PI)


def sqr(x):
    return x * x


def safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=0.0))


def safe_div(a, b, fill=0.0):
    """a/b with a zero denominator giving `fill`."""
    b_ok = b != 0
    denom = torch.where(b_ok, b, torch.ones_like(b))
    return torch.where(b_ok, a / denom, torch.full_like(denom, fill))


def nanmax(x, dim=-1):
    """Max over `dim` ignoring NaNs (jnp.nanmax)."""
    return torch.where(torch.isnan(x), -torch.inf, x).amax(dim)


def nanmin(x, dim=-1):
    """Min over `dim` ignoring NaNs (jnp.nanmin)."""
    return torch.where(torch.isnan(x), torch.inf, x).amin(dim)
