"""Lights (counterpart of ``models/lights.py``): point lights, diffuse
triangle area lights and one constant environment, picked by a selection
table (uniform, or proportional to power).

Global light index layout, the JAX package's without the types this
package lacks: [0, n_point) point | [n_point, +n_area) triangle area
lights | last: the environment. Spot, goniometric, projection and distant
lights, the image environment, portals and the BVH light sampler are not
ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..utils.device import OnDevice
from ..utils.math import INV_4PI, safe_div
from ..utils.sampling import sample_uniform_sphere, sample_uniform_triangle
from ..utils.vecmath import cross, dot, normalize


class LightSample(NamedTuple):
    wi: torch.Tensor  # (R,3) direction to the light
    L: torch.Tensor  # (R,3) incident radiance (already /dist^2 for point)
    pdf_dir: torch.Tensor  # (R,) solid-angle pdf of wi given the light
    select_pmf: torch.Tensor  # (R,) probability of having chosen it
    is_delta: torch.Tensor  # (R,) bool
    t_shadow: torch.Tensor  # (R,) shadow-ray length (d normalized)
    valid: torch.Tensor  # (R,) bool


def _length(v):
    return torch.sqrt(dot(v, v))


def _powers(point_I, area_tris, env_mean, has_env, world_radius):
    """Emitted power of each light in the global index order (the JAX
    package's PowerLightSampler weights)."""
    powers = [4 * np.pi * float(np.mean(i_)) for i_ in point_I]
    for t_ in area_tris:
        e1 = np.asarray(t_["p1"], np.float64) - np.asarray(t_["p0"],
                                                           np.float64)
        e2 = np.asarray(t_["p2"], np.float64) - np.asarray(t_["p0"],
                                                           np.float64)
        area = 0.5 * np.linalg.norm(np.cross(e1, e2))
        two = 2.0 if t_.get("twosided") else 1.0
        powers.append(float(np.mean(t_["L"])) * area * np.pi * two)
    if has_env:
        powers.append(env_mean * 4 * np.pi**2 * world_radius**2)
    return powers


@dataclass(frozen=True)
class Lights(OnDevice):
    point_p: torch.Tensor  # (Lp,3)
    point_I: torch.Tensor  # (Lp,3) intensity
    area_p0: torch.Tensor  # (A,3) triangle area lights (DiffuseAreaLight)
    area_p1: torch.Tensor  # (A,3)
    area_p2: torch.Tensor  # (A,3)
    area_L: torch.Tensor  # (A,3) emitted radiance
    area_twosided: torch.Tensor  # (A,) bool
    env_L: torch.Tensor  # (3,) radiance; zeros = no env light
    select_pmf_table: torch.Tensor  # (n_lights,)
    select_cdf: torch.Tensor  # (n_lights,)
    has_env: bool
    world_radius: float  # shadow-ray lengths toward the environment

    @staticmethod
    def make(point_p=None, point_I=None, env_L=None, world_radius=1e4,
             area_tris=None, sampler="uniform", *, device):
        """Selection over [points..., area lights..., env]. area_tris: list
        of dicts {p0, p1, p2, L, [twosided]}; sampler "uniform" or "power"
        (pmf proportional to emitted power, lightsamplers.h:63)."""
        if sampler == "bvh":
            raise NotImplementedError("the BVH light sampler is not ported "
                                      "yet")
        if sampler not in ("uniform", "power"):
            raise ValueError(f"unknown light sampler {sampler!r}")

        def arr(x):
            if x is None:
                return np.zeros((0, 3), np.float32)
            return np.atleast_2d(np.asarray(x, np.float32))

        pp, pI = arr(point_p), arr(point_I)
        a = list(area_tris or [])

        def corner(key):
            return np.asarray([t_[key] for t_ in a], np.float32).reshape(-1, 3)

        a_two = np.asarray([bool(t_.get("twosided", False)) for t_ in a],
                           bool)
        env = (np.zeros(3, np.float32) if env_L is None
               else np.asarray(env_L, np.float32))
        env_mean = float(np.mean(env)) if env_L is not None else 0.0
        powers = _powers(pI, a, env_mean, env_L is not None, world_radius)
        n = len(powers)
        if n == 0:
            pmf = np.zeros((0,), np.float32)
        elif sampler == "power" and sum(powers) > 0:
            pmf = np.asarray(powers, np.float64)
            pmf = (pmf / pmf.sum()).astype(np.float32)
        else:
            pmf = np.full(n, 1.0 / n, np.float32)

        def t(x):
            return torch.as_tensor(x, device=device)

        return Lights(t(pp), t(pI), t(corner("p0")), t(corner("p1")),
                      t(corner("p2")), t(corner("L")), t(a_two), t(env),
                      t(pmf), t(np.cumsum(pmf).astype(np.float32)),
                      env_L is not None, float(world_radius))

    @property
    def n_point(self):
        return self.point_p.shape[0]

    @property
    def n_area(self):
        return self.area_p0.shape[0]

    @property
    def base_area(self):
        return self.n_point

    @property
    def n_lights(self):
        return self.base_area + self.n_area + (1 if self.has_env else 0)

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
            dist = _length(d)
            L_p = self.point_I[pi] * safe_div(1.0, dist * dist, 0.0)[..., None]
            sel = idx < self.n_point
            wi = torch.where(sel[..., None], normalize(d), wi)
            L = torch.where(sel[..., None], L_p, L)
            pdf_dir = torch.where(sel, 1.0, pdf_dir)
            is_delta = is_delta | sel
            t_shadow = torch.where(sel, dist, t_shadow)
        if self.n_area > 0:
            base = self.base_area
            ai = torch.clamp(idx - base, 0, self.n_area - 1)
            p0, p1, p2 = self.area_p0[ai], self.area_p1[ai], self.area_p2[ai]
            b = sample_uniform_triangle(u2)
            p_l = b[..., 0:1] * p0 + b[..., 1:2] * p1 + b[..., 2:3] * p2
            n_cross = cross(p1 - p0, p2 - p0)
            area2 = _length(n_cross)
            n_l = n_cross * safe_div(1.0, area2, 0.0)[..., None]
            to_l = p_l - ref_p
            dist = _length(to_l)
            wi_a = to_l * safe_div(1.0, dist, 0.0)[..., None]
            cos_l = dot(n_l, -wi_a)
            front = torch.where(self.area_twosided[ai],
                                torch.abs(cos_l) > 1e-7, cos_l > 1e-7)
            # solid-angle pdf = dist^2 / (|cos| * area)
            pdf_a = safe_div(dist * dist, torch.abs(cos_l) * (0.5 * area2),
                             0.0)
            sel = (idx >= base) & (idx < base + self.n_area)
            wi = torch.where(sel[..., None], wi_a, wi)
            L = torch.where((sel & front)[..., None], self.area_L[ai], L)
            pdf_dir = torch.where(sel, torch.where(front, pdf_a, 0.0),
                                  pdf_dir)
            t_shadow = torch.where(sel, dist * (1.0 - 1e-3), t_shadow)
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

    def le_area(self, light_id, wo, n):
        """Emitted radiance toward wo from area light light_id with surface
        normal n at the hit (DiffuseAreaLight::L: one-sided toward n unless
        two-sided)."""
        if self.n_area == 0:
            return torch.zeros(tuple(wo.shape[:-1]) + (3,), device=wo.device)
        ai = torch.clamp(light_id.long(), 0, self.n_area - 1)
        vis = (dot(n, wo) > 0) | self.area_twosided[ai]
        ok = (light_id >= 0) & vis
        return torch.where(ok[..., None], self.area_L[ai], 0.0)

    def pdf_li_area(self, light_id, ref_p, p_hit, n_hit):
        """select_pmf * solid-angle pdf of having sampled the hit point on
        area light light_id from ref_p (MIS at an emissive hit)."""
        if self.n_area == 0:
            return torch.zeros(ref_p.shape[:-1], device=ref_p.device)
        ai = torch.clamp(light_id.long(), 0, self.n_area - 1)
        e1 = self.area_p1[ai] - self.area_p0[ai]
        e2 = self.area_p2[ai] - self.area_p0[ai]
        area = 0.5 * _length(cross(e1, e2))
        to_h = p_hit - ref_p
        dist2 = torch.sum(to_h * to_h, -1)
        wi = to_h * safe_div(1.0, torch.sqrt(dist2), 0.0)[..., None]
        cos_l = torch.abs(dot(n_hit, wi))
        pdf = safe_div(dist2, cos_l * area, 0.0)
        sel_pmf = self.select_pmf_table[torch.clamp(
            self.base_area + ai, 0, max(self.n_lights - 1, 0))]
        return torch.where(light_id >= 0, pdf * sel_pmf, 0.0)
