"""Lights (counterpart of ``models/lights.py``): point lights and one
constant environment, picked by the uniform light-selection table.

Global light index layout, as in the JAX package: [0, n_point) point |
last: the environment. The other light types are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..utils.device import OnDevice
from ..utils.math import INV_4PI, safe_div
from ..utils.sampling import sample_uniform_sphere
from ..utils.vecmath import dot, normalize


class LightSample(NamedTuple):
    wi: torch.Tensor  # (R,3) direction to the light
    L: torch.Tensor  # (R,3) incident radiance (already /dist^2 for point)
    pdf_dir: torch.Tensor  # (R,) solid-angle pdf of wi given the light
    select_pmf: torch.Tensor  # (R,) probability of having chosen it
    is_delta: torch.Tensor  # (R,) bool
    t_shadow: torch.Tensor  # (R,) shadow-ray length (d normalized)
    valid: torch.Tensor  # (R,) bool


@dataclass(frozen=True)
class Lights(OnDevice):
    point_p: torch.Tensor  # (Lp,3)
    point_I: torch.Tensor  # (Lp,3) intensity
    env_L: torch.Tensor  # (3,) radiance; zeros = no env light
    select_pmf_table: torch.Tensor  # (n_lights,)
    select_cdf: torch.Tensor  # (n_lights,)
    has_env: bool
    world_radius: float  # shadow-ray lengths toward the environment

    @staticmethod
    def make(point_p=None, point_I=None, env_L=None, world_radius=1e4, *,
             device):
        """Uniform light selection over [points..., env]."""
        def arr(x):
            if x is None:
                return np.zeros((0, 3), np.float32)
            return np.atleast_2d(np.asarray(x, np.float32))

        pp, pI = arr(point_p), arr(point_I)
        n = pp.shape[0] + (1 if env_L is not None else 0)
        pmf = np.full(n, 1.0 / n, np.float32) if n else np.zeros(0, np.float32)
        env = (np.zeros(3, np.float32) if env_L is None
               else np.asarray(env_L, np.float32))

        def t(a):
            return torch.as_tensor(a, device=device)

        return Lights(t(pp), t(pI), t(env), t(pmf),
                      t(np.cumsum(pmf).astype(np.float32)),
                      env_L is not None, float(world_radius))

    @property
    def n_point(self):
        return self.point_p.shape[0]

    @property
    def n_lights(self):
        return self.n_point + (1 if self.has_env else 0)

    def sample(self, ref_p, u_select, u2) -> LightSample:
        """Pick a light by the selection table and sample a direction to it
        (every light type evaluated, the chosen one kept per lane)."""
        n = self.n_lights
        R = tuple(ref_p.shape[:-1])
        dev = ref_p.device
        z3 = torch.zeros(R + (3,), device=dev)
        z = torch.zeros(R, device=dev)
        if n == 0:
            f = torch.zeros(R, dtype=torch.bool, device=dev)
            return LightSample(z3, z3, z, z, f, z, f)
        idx = torch.sum((u_select[..., None] >= self.select_cdf).long(), -1)
        idx = torch.clamp(idx, max=n - 1)
        pmf = self.select_pmf_table[idx]
        wi, L, pdf_dir, t_shadow = z3, z3, z, z
        is_delta = torch.zeros(R, dtype=torch.bool, device=dev)
        if self.n_point > 0:
            pi = torch.clamp(idx, 0, self.n_point - 1)
            p_light = self.point_p[pi]
            d = p_light - ref_p
            dist = torch.sqrt(dot(d, d))
            L_p = self.point_I[pi] * safe_div(1.0, dist * dist, 0.0)[..., None]
            sel = idx < self.n_point
            wi = torch.where(sel[..., None], normalize(d), wi)
            L = torch.where(sel[..., None], L_p, L)
            pdf_dir = torch.where(sel, 1.0, pdf_dir)
            is_delta = is_delta | sel
            t_shadow = torch.where(sel, dist, t_shadow)
        if self.has_env:
            sel = idx == (n - 1)
            wi = torch.where(sel[..., None], sample_uniform_sphere(u2), wi)
            L = torch.where(sel[..., None], self.env_L.expand(R + (3,)), L)
            pdf_dir = torch.where(sel, INV_4PI, pdf_dir)
            t_shadow = torch.where(sel, 2.0 * self.world_radius, t_shadow)
        valid = (pdf_dir > 0) & (pmf > 0)
        return LightSample(wi, L, pdf_dir, pmf, is_delta, t_shadow, valid)

    def le_escaped(self, d, o=None):
        """Radiance from the environment along escaped directions d."""
        shape = tuple(d.shape[:-1]) + (3,)
        if not self.has_env:
            return torch.zeros(shape, device=d.device)
        return self.env_L.expand(shape)

    def pdf_li_escaped(self, d, ref_p=None):
        """select_pmf * directional pdf for MIS of escaped rays."""
        if not self.has_env:
            return torch.zeros(d.shape[:-1], device=d.device)
        sel = self.select_pmf_table[self.n_lights - 1]
        return INV_4PI * sel.expand(d.shape[:-1])
