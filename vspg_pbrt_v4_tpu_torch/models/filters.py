"""Reconstruction filters (counterpart of ``models/filters.py``).

The film importance-samples its pixel filter, as pbrt-v4's FilterSampler
does: the sample's offset is drawn with density proportional to |f| and
its weight is f/p. Box, triangle and the truncated Gaussian are sampled in
closed form with weight 1; Mitchell-Netravali through a host-built 64-bin
table of |f| per axis, with the sign of each bin as the weight. Default
radii and sigma are the JAX package's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.device import OnDevice

_N_TAB = 64
_DEFAULT_RADIUS = {"box": 0.5, "triangle": 2.0, "gaussian": 1.5,
                   "mitchell": 2.0}


def _mitchell_1d(x, b=1.0 / 3.0, c=1.0 / 3.0):
    x = np.abs(2.0 * x)  # pbrt evaluates on x/radius * 2
    return np.where(
        x > 1,
        ((-b - 6 * c) * x**3 + (6 * b + 30 * c) * x**2 + (-12 * b - 48 * c) * x
         + (8 * b + 24 * c)) / 6,
        ((12 - 9 * b - 6 * c) * x**3 + (-18 + 12 * b + 6 * c) * x**2
         + (6 - 2 * b)) / 6,
    ) * (x < 2)


@dataclass(frozen=True)
class Filter(OnDevice):
    kind: str = "box"
    radius: float = 0.5
    sigma: float = 0.5
    table_cdf: torch.Tensor = None  # (N+1,) cdf of |f| over [-r, r], mitchell
    table_sign: torch.Tensor = None  # (N,) sign of f per bin, mitchell

    @staticmethod
    def make(kind="box", radius=None, sigma=0.5, *, device=None):
        """`kind` one of box, triangle, gaussian and mitchell; the Mitchell
        table is built on `device` (the CPU when None)."""
        if kind not in _DEFAULT_RADIUS:
            raise ValueError(f"unknown filter {kind!r}")
        r = float(radius if radius is not None else _DEFAULT_RADIUS[kind])
        cdf = sign = None
        if kind == "mitchell":
            xs = (np.arange(_N_TAB) + 0.5) / _N_TAB * 2 - 1  # [-1,1]
            f = _mitchell_1d(xs)
            c = np.zeros(_N_TAB + 1)
            c[1:] = np.cumsum(np.abs(f))
            c /= c[-1]
            dev = "cpu" if device is None else device
            cdf = torch.as_tensor(c.astype(np.float32), device=dev)
            sign = torch.as_tensor(np.sign(f).astype(np.float32), device=dev)
        return Filter(kind, r, float(sigma), cdf, sign)

    def _sample_1d(self, u):
        if self.kind == "box":
            return (u - 0.5) * 2.0 * self.radius, torch.ones_like(u)
        if self.kind == "triangle":
            take_neg = u < 0.5
            u0 = torch.where(take_neg, 1.0 - 2.0 * u, 2.0 * u - 1.0)
            x = self.radius * (1.0 - torch.sqrt(torch.clamp(1.0 - u0,
                                                            min=0.0)))
            return torch.where(take_neg, -x, x), torch.ones_like(u)
        if self.kind == "gaussian":
            # the Gaussian truncated to [-r, r], by its inverse CDF
            s2 = self.sigma * math.sqrt(2)
            cap = torch.special.erf(torch.tensor(self.radius / s2,
                                                 dtype=torch.float32,
                                                 device=u.device))
            x = s2 * torch.special.erfinv((2 * u - 1) * cap)
            return (torch.clamp(x, -self.radius, self.radius),
                    torch.ones_like(u))
        # mitchell: the tabulated |f|'s inverse CDF and the bin's sign
        idx = torch.clamp(torch.searchsorted(self.table_cdf, u.contiguous(),
                                             right=True) - 1, 0, _N_TAB - 1)
        lo = self.table_cdf[idx]
        hi = self.table_cdf[idx + 1]
        frac = torch.where(hi > lo, (u - lo) / torch.clamp(hi - lo, min=1e-12),
                           0.5)
        x = ((idx + frac) / _N_TAB * 2.0 - 1.0) * self.radius
        return x, self.table_sign[idx]

    def sample(self, u2):
        """u2 (R,2) -> (offset (R,2) from the pixel center, weight (R,))."""
        x, wx = self._sample_1d(u2[..., 0])
        y, wy = self._sample_1d(u2[..., 1])
        return torch.stack([x, y], -1), wx * wy
