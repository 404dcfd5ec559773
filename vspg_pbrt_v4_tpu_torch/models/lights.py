"""Lights as stacked arrays and NEE sampling over a wavefront (counterpart
of ``models/lights.py``).

Point, spot (lights.h Spot:811), goniometric (Goniometric:633),
projection (Projection:698) and distant lights, diffuse triangle area
lights, and one environment: uniform, an equal-area image
(ImageInfiniteLight) or either seen through a portal
(``models/portal_light.py``). A light is picked by a selection table
(uniform, or proportional to power) or by the BVH light sampler
(``models/lightsamplers.py``); every light type is evaluated a lane and
the chosen one kept.

Global light index layout: [0, n_point) point | spot | goniometric |
projection | distant | triangle area lights | last: the environment.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple

import numpy as np
import torch

from ..utils.device import OnDevice
from ..utils.math import INV_4PI, PI, safe_div
from ..utils.sampling import (sample_cosine_hemisphere,
                              sample_uniform_disk_concentric,
                              sample_uniform_sphere, sample_uniform_triangle)
from ..utils.vecmath import (coordinate_system, cross, distance, dot,
                             equal_area_sphere_to_square,
                             equal_area_square_to_sphere, length, normalize)


def _frac(x):
    """Cheap decorrelated fraction of a float32 (texel jitter)."""
    return x - torch.floor(x)


class LightSample(NamedTuple):
    wi: torch.Tensor  # (R,3) direction to the light
    L: torch.Tensor  # (R,3) incident radiance (already /dist^2 for point)
    pdf_dir: torch.Tensor  # (R,) solid-angle pdf of wi given the light
    select_pmf: torch.Tensor  # (R,) probability of having chosen it
    is_delta: torch.Tensor  # (R,) bool
    t_shadow: torch.Tensor  # (R,) shadow-ray length (d normalized)
    valid: torch.Tensor  # (R,) bool
    n_light: torch.Tensor = None  # (R,3) emission normal (area lights; else 0)
    area_id: torch.Tensor = None  # (R,) sampled area-light id (-1 otherwise)
    light_idx: torch.Tensor = None  # (R,) global index of the sampled light


def _resampled(items, H, W):
    """Each item's "img" (2-D grey or (h, w, 3)) resampled to (H, W, 3) by
    nearest texel, stacked."""
    out = np.zeros((len(items), H, W, 3), np.float32)
    for i, x in enumerate(items):
        im = np.asarray(x["img"], np.float32)
        if im.ndim == 2:
            im = np.repeat(im[..., None], 3, -1)
        ys = np.arange(H) * im.shape[0] // H
        xs = np.arange(W) * im.shape[1] // W
        out[i] = im[ys][:, xs]
    return out


def _rows(items, key, default=None, shape=(3,)):
    """float32 (len(items), *shape) of item[key]."""
    if not items:
        return np.zeros((0,) + shape, np.float32)
    return np.asarray([x.get(key, default) if default is not None else x[key]
                       for x in items], np.float32).reshape((-1,) + shape)



def equal_area_texel(d, S):
    """(iy, ix) of the texel of an S x S equal-area square map that holds
    the unit directions d."""
    sq = equal_area_sphere_to_square(d)
    ix = torch.clamp((sq[..., 0] * S).to(torch.int64), 0, S - 1)
    iy = torch.clamp((sq[..., 1] * S).to(torch.int64), 0, S - 1)
    return iy, ix

@dataclass(frozen=True)
class Lights(OnDevice):
    point_p: torch.Tensor  # (Lp,3)
    point_I: torch.Tensor  # (Lp,3) intensity
    # spot lights (smoothstep cone falloff)
    spot_p: torch.Tensor  # (Ls,3)
    spot_I: torch.Tensor  # (Ls,3)
    spot_dir: torch.Tensor  # (Ls,3) cone axis (normalized)
    spot_cos_total: torch.Tensor  # (Ls,)
    spot_cos_start: torch.Tensor  # (Ls,)
    # goniophotometric lights: a point light whose angular intensity is an
    # equal-area image in light space
    gonio_p: torch.Tensor  # (Lg,3)
    gonio_I: torch.Tensor  # (Lg,3) intensity scale
    gonio_r: torch.Tensor  # (Lg,3,3) world -> light rotation
    gonio_img: torch.Tensor  # (Lg,S,S,3) equal-area intensity maps
    # projection lights: a point light projecting an image through a square
    # perspective frustum
    proj_p: torch.Tensor  # (Lj,3)
    proj_I: torch.Tensor  # (Lj,3) scale
    proj_r: torch.Tensor  # (Lj,3,3) world -> light rotation (looks along +z)
    proj_img: torch.Tensor  # (Lj,H,W,3)
    proj_tan: torch.Tensor  # (Lj,) tan(fov/2)
    # distant lights
    distant_dir: torch.Tensor  # (Ld,3) direction the light travels
    distant_L: torch.Tensor  # (Ld,3)
    # triangle area lights (DiffuseAreaLight)
    area_p0: torch.Tensor  # (A,3)
    area_p1: torch.Tensor  # (A,3)
    area_p2: torch.Tensor  # (A,3)
    area_L: torch.Tensor  # (A,3) emitted radiance
    area_twosided: torch.Tensor  # (A,) bool
    # the environment: uniform radiance and/or an equal-area image
    env_L: torch.Tensor  # (3,) radiance; zeros = no uniform env
    env_img: torch.Tensor  # (S,S,3) equal-area map (ImageInfiniteLight)
    env_pmf: torch.Tensor  # (S*S,) texel selection pmf
    env_cdf: torch.Tensor  # (S*S,)
    select_pmf_table: torch.Tensor  # (n_lights,)
    select_cdf: torch.Tensor  # (n_lights,)
    has_env: bool
    has_env_img: bool
    world_radius: float  # shadow-ray lengths toward the environment
    # BVH light sampler over the finite lights (sampler "bvh"); None: table
    bvh: object = None
    # the environment seen through a portal (models/portal_light.PortalLight);
    # when set it replaces the environment's sampling and emission
    portal: object = None

    @staticmethod
    def make(point_p=None, point_I=None, distant_dir=None, distant_L=None,
             area_tris=None, env_L=None, env_img=None, world_radius=1e4,
             sampler="uniform", spots=None, gonios=None, projections=None, *,
             device):
        """area_tris: list of dicts {p0, p1, p2, L, [twosided]}; spots:
        list of dicts {p, I, dir, [cos_total], [cos_start]}; gonios: list
        of dicts {p, I, img (S,S,3 equal-area), [rot 3x3]}; projections:
        list of dicts {p, I, img (H,W,3), [fov_deg], [rot]} (the light
        looks along +z in its frame, rot = world -> light); env_img: a
        square equal-area map; sampler "uniform", "power" (pmf
        proportional to emitted power, lightsamplers.h:63) or "bvh"."""
        if sampler not in ("uniform", "power", "bvh"):
            raise ValueError(f"unknown light sampler {sampler!r}")

        def arr(x):
            if x is None:
                return np.zeros((0, 3), np.float32)
            return np.atleast_2d(np.asarray(x, np.float32))

        a = list(area_tris or [])
        a_two = np.asarray([bool(t_.get("twosided", False)) for t_ in a],
                           bool)
        env = (np.zeros(3, np.float32) if env_L is None
               else np.asarray(env_L, np.float32))
        has_env_img = env_img is not None
        if has_env_img:
            ei = np.asarray(env_img, np.float32)
            if ei.shape[0] != ei.shape[1]:
                raise ValueError("an equal-area env map must be square, got "
                                 f"{ei.shape[:2]}")
            lum = ei.mean(-1).reshape(-1).astype(np.float64)
            env_pmf = (lum / max(lum.sum(), 1e-20)).astype(np.float32)
            env_cdf = np.cumsum(env_pmf).astype(np.float32)
            env_mean = float(ei.mean())
        else:
            ei = np.zeros((1, 1, 3), np.float32)
            env_pmf = env_cdf = np.ones(1, np.float32)
            env_mean = float(np.mean(env)) if env_L is not None else 0.0
        gn = list(gonios or [])
        S = max((int(np.asarray(g["img"]).shape[0]) for g in gn), default=1)
        g_img = _resampled(gn, S, S)
        pj = list(projections or [])
        H = max((int(np.asarray(x["img"]).shape[0]) for x in pj), default=1)
        W = max((int(np.asarray(x["img"]).shape[1]) for x in pj), default=1)
        p_img = _resampled(pj, H, W)
        p_tan = np.asarray([np.tan(np.radians(x.get("fov_deg", 90.0)) / 2)
                            for x in pj], np.float32)
        sp = list(spots or [])
        sp_d = np.asarray([np.asarray(s["dir"], np.float64)
                           / np.linalg.norm(s["dir"]) for s in sp],
                          np.float32).reshape(-1, 3)
        sp_ct = np.asarray([s.get("cos_total", np.cos(np.radians(30)))
                            for s in sp], np.float32)
        sp_cs = np.asarray([s.get("cos_start", np.cos(np.radians(25)))
                            for s in sp], np.float32)

        # emitted power of each light in the global index order (the
        # PowerLightSampler weights)
        powers = [4 * np.pi * float(np.mean(i_))
                  for i_ in (point_I if point_I is not None else [])]
        for s in sp:
            powers.append(2 * np.pi * float(np.mean(s["I"]))
                          * (1 - 0.5 * (s.get("cos_total", 0.87)
                                        + s.get("cos_start", 0.9))))
        for g in gn:
            powers.append(4 * np.pi * float(np.mean(g["I"]))
                          * float(np.mean(np.asarray(g["img"]))))
        for x in pj:
            t = np.tan(np.radians(x.get("fov_deg", 90.0)) / 2)
            omega = 4 * np.arctan(t * t)  # square-frustum solid angle
            powers.append(float(omega) * float(np.mean(x["I"]))
                          * float(np.mean(np.asarray(x["img"]))))
        for l_ in (distant_L if distant_L is not None else []):
            # a distant light's power ~ L * the world's disk
            powers.append(float(np.mean(l_)) * np.pi * world_radius**2)
        for t_ in a:
            e1 = (np.asarray(t_["p1"], np.float64)
                  - np.asarray(t_["p0"], np.float64))
            e2 = (np.asarray(t_["p2"], np.float64)
                  - np.asarray(t_["p0"], np.float64))
            area = 0.5 * np.linalg.norm(np.cross(e1, e2))
            two = 2.0 if t_.get("twosided") else 1.0
            powers.append(float(np.mean(t_["L"])) * area * np.pi * two)
        if env_L is not None or has_env_img:
            powers.append(env_mean * 4 * np.pi**2 * world_radius**2)
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

        eye = np.eye(3)
        out = Lights(
            t(arr(point_p)), t(arr(point_I)), t(_rows(sp, "p")),
            t(_rows(sp, "I")), t(sp_d), t(sp_ct), t(sp_cs),
            t(_rows(gn, "p")), t(_rows(gn, "I")),
            t(_rows(gn, "rot", eye, (3, 3))), t(g_img),
            t(_rows(pj, "p")), t(_rows(pj, "I")),
            t(_rows(pj, "rot", eye, (3, 3))), t(p_img), t(p_tan),
            t(arr(distant_dir)), t(arr(distant_L)),
            t(_rows(a, "p0")), t(_rows(a, "p1")), t(_rows(a, "p2")),
            t(_rows(a, "L")), t(a_two), t(env), t(ei), t(env_pmf),
            t(env_cdf), t(pmf), t(np.cumsum(pmf).astype(np.float32)),
            env_L is not None or has_env_img, has_env_img,
            float(world_radius))
        if sampler == "bvh":
            from .lightsamplers import build_light_bvh

            out = replace(out, bvh=build_light_bvh(out))
        return out

    # -- counts and the global index layout -------------------------------
    @property
    def n_point(self):
        return self.point_p.shape[0]

    @property
    def n_spot(self):
        return self.spot_p.shape[0]

    @property
    def n_gonio(self):
        return self.gonio_p.shape[0]

    @property
    def n_proj(self):
        return self.proj_p.shape[0]

    @property
    def n_distant(self):
        return self.distant_dir.shape[0]

    @property
    def n_area(self):
        return self.area_p0.shape[0]

    @property
    def base_gonio(self):
        return self.n_point + self.n_spot

    @property
    def base_proj(self):
        return self.base_gonio + self.n_gonio

    @property
    def base_distant(self):
        return self.base_proj + self.n_proj

    @property
    def base_area(self):
        return self.base_distant + self.n_distant

    @property
    def n_lights(self):
        return self.base_area + self.n_area + (1 if self.has_env else 0)

    @property
    def n_infinite(self):
        """Lights without spatial bounds (distant + env), sampled outside
        the light BVH (BVHLightSampler keeps them apart,
        lightsamplers.h:268-280)."""
        return self.n_distant + (1 if self.has_env else 0)

    @property
    def beyond_kernels(self):
        """True when a light no hand-written kernel shades is present: a
        spot, goniometric, projection or distant light, an image
        environment, a portal or the BVH light sampler (the JAX package's
        kernel gates send all of them to the wavefront)."""
        return bool(self.n_spot or self.n_gonio or self.n_proj
                    or self.n_distant or self.has_env_img
                    or self.portal is not None or self.bvh is not None)

    def _select_bvh(self, ref_p, u_select):
        """BVHLightSampler::Sample's top level (lightsamplers.h:281-329):
        an infinite light uniformly with probability n_inf/(n_inf+1), else
        a descent of the BVH from ref_p."""
        from .lightsamplers import bvh_select

        n_inf = self.n_infinite
        if n_inf == 0:
            idx, pmf, _ = bvh_select(self.bvh, ref_p, u_select)
            return torch.clamp(idx, min=0), pmf
        p_inf = n_inf / (n_inf + 1.0)
        pick_inf = u_select < p_inf
        which = torch.clamp((u_select / p_inf * n_inf).to(torch.int64),
                            max=n_inf - 1)
        idx_inf = torch.where(which < self.n_distant,
                              self.base_distant + which, self.n_lights - 1)
        u_bvh = torch.clamp((u_select - p_inf) / (1 - p_inf), 0.0, 0.9999999)
        idx_b, pmf_b, _ = bvh_select(self.bvh, ref_p, u_bvh)
        idx = torch.where(pick_inf, idx_inf, idx_b)
        pmf = torch.where(pick_inf, p_inf / n_inf, pmf_b * (1 - p_inf))
        return torch.where(pmf > 0, idx, 0), pmf

    # -- textured point-light intensities ---------------------------------
    def _gonio_scale(self, gi, w):
        """Equal-area image lookup of the emission direction w (world) for
        goniometric lights (lights.h Goniometric::I:656)."""
        wl = torch.einsum("...ij,...j->...i", self.gonio_r[gi], w)
        iy, ix = equal_area_texel(normalize(wl), self.gonio_img.shape[1])
        return self.gonio_img[gi, iy, ix]

    def _proj_scale(self, pi, w):
        """Projected-image lookup of the emission direction w (world) for
        projection lights (lights.h Projection::I:737): zero outside the
        square frustum around the light's +z axis."""
        wl = torch.einsum("...ij,...j->...i", self.proj_r[pi], w)
        z = wl[..., 2]
        zs = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
        tanf = torch.clamp(self.proj_tan[pi], min=1e-9)
        u = 0.5 * (wl[..., 0] / zs / tanf + 1.0)
        v = 0.5 * (wl[..., 1] / zs / tanf + 1.0)
        inside = (z > 0) & (u >= 0) & (u < 1) & (v >= 0) & (v < 1)
        H, W = self.proj_img.shape[1], self.proj_img.shape[2]
        ix = torch.clamp((u * W).to(torch.int64), 0, W - 1)
        iy = torch.clamp(((1.0 - v) * H).to(torch.int64), 0, H - 1)
        return torch.where(inside[..., None], self.proj_img[pi, iy, ix], 0.0)

    def _env_texel(self, u2):
        """An equal-area texel by the env pmf, jittered inside: (wi, Le,
        pdf) (ImageInfiniteLight's sampling)."""
        S = self.env_img.shape[0]
        u_flat = torch.clamp(u2[..., 0], 0.0, 0.999999).contiguous()
        ti = torch.clamp(torch.searchsorted(self.env_cdf, u_flat, right=True),
                         0, S * S - 1)
        iy = ti // S
        ix = ti % S
        jx = _frac(u2[..., 1] * 7919.0)
        jy = _frac(u2[..., 1] * 104729.0)
        sq = torch.stack([(ix + jx) / S, (iy + jy) / S], -1)
        # pdf: the texel's pmf times texels a unit solid angle
        pdf = torch.clamp(self.env_pmf[ti] * (S * S) * INV_4PI, min=1e-12)
        return equal_area_square_to_sphere(sq), self.env_img[iy, ix], pdf

    # -- NEE: pick a light and sample a direction to it --------------------
    def sample(self, ref_p, u_select, u2) -> LightSample:
        """Pick a light (selection table or BVH) and sample a direction
        toward it; every light type is evaluated and the chosen one kept
        per lane."""
        n = self.n_lights
        R = tuple(ref_p.shape[:-1])
        dev = ref_p.device
        z3 = torch.zeros(R + (3,), device=dev)
        z = torch.zeros(R, device=dev)
        f = torch.zeros(R, dtype=torch.bool, device=dev)
        if n == 0:
            return LightSample(z3, z3, z, z, f, z, f, z3,
                               torch.full(R, -1, device=dev))
        if self.bvh is not None:
            idx, pmf = self._select_bvh(ref_p, u_select)
        else:
            idx = torch.sum((u_select[..., None] >= self.select_cdf).long(),
                            -1)
            idx = torch.clamp(idx, max=n - 1)
            pmf = self.select_pmf_table[idx]
        wi, L, pdf_dir, t_shadow, n_light = z3, z3, z, z, z3
        is_delta = f
        area_id = torch.full(R, -1, device=dev)

        def point_like(sel, p_light, I_of_wi, wi, L, pdf_dir, is_delta,
                       t_shadow):
            """A delta light at p_light with intensity I_of_wi(wi_l)."""
            dist = distance(p_light, ref_p)
            wi_l = normalize(p_light - ref_p)
            L_l = I_of_wi(wi_l) * safe_div(1.0, dist * dist, 0.0)[..., None]
            return (torch.where(sel[..., None], wi_l, wi),
                    torch.where(sel[..., None], L_l, L),
                    torch.where(sel, 1.0, pdf_dir), is_delta | sel,
                    torch.where(sel, dist, t_shadow))

        state = (wi, L, pdf_dir, is_delta, t_shadow)
        if self.n_point > 0:
            pi = torch.clamp(idx, 0, self.n_point - 1)
            state = point_like(idx < self.n_point, self.point_p[pi],
                               lambda w: self.point_I[pi], *state)
        if self.n_spot > 0:
            si = torch.clamp(idx - self.n_point, 0, self.n_spot - 1)

            def spot_I(w):
                # smoothstep cone falloff (SpotLight::I)
                ct = dot(self.spot_dir[si], -w)
                t = safe_div(ct - self.spot_cos_total[si],
                             self.spot_cos_start[si] - self.spot_cos_total[si])
                fall = torch.clamp(t, 0.0, 1.0)
                fall = fall * fall * (3.0 - 2.0 * fall)
                return self.spot_I[si] * fall[..., None]

            state = point_like((idx >= self.n_point) & (idx < self.base_gonio),
                               self.spot_p[si], spot_I, *state)
        if self.n_gonio > 0:
            gi = torch.clamp(idx - self.base_gonio, 0, self.n_gonio - 1)
            state = point_like(
                (idx >= self.base_gonio) & (idx < self.base_proj),
                self.gonio_p[gi],
                lambda w: self.gonio_I[gi] * self._gonio_scale(gi, -w),
                *state)
        if self.n_proj > 0:
            pj = torch.clamp(idx - self.base_proj, 0, self.n_proj - 1)
            state = point_like(
                (idx >= self.base_proj) & (idx < self.base_distant),
                self.proj_p[pj],
                lambda w: self.proj_I[pj] * self._proj_scale(pj, -w), *state)
        wi, L, pdf_dir, is_delta, t_shadow = state
        if self.n_distant > 0:
            base_d = self.base_distant
            di = torch.clamp(idx - base_d, 0, self.n_distant - 1)
            sel = (idx >= base_d) & (idx < self.base_area)
            wi = torch.where(sel[..., None], -normalize(self.distant_dir[di]),
                             wi)
            L = torch.where(sel[..., None], self.distant_L[di], L)
            pdf_dir = torch.where(sel, 1.0, pdf_dir)
            is_delta = is_delta | sel
            t_shadow = torch.where(sel, 2.0 * self.world_radius, t_shadow)
        if self.n_area > 0:
            base = self.base_area
            ai = torch.clamp(idx - base, 0, self.n_area - 1)
            p0, p1, p2 = self.area_p0[ai], self.area_p1[ai], self.area_p2[ai]
            b = sample_uniform_triangle(u2)
            p_l = b[..., 0:1] * p0 + b[..., 1:2] * p1 + b[..., 2:3] * p2
            n_cross = cross(p1 - p0, p2 - p0)
            area2 = length(n_cross)
            n_l = n_cross * safe_div(1.0, area2, 0.0)[..., None]
            to_l = p_l - ref_p
            dist = length(to_l)
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
            n_light = torch.where(sel[..., None], n_l, n_light)
            area_id = torch.where(sel, ai, area_id)
        if self.has_env:
            sel = idx == (n - 1)
            if self.portal is not None:
                wi_e, L_e, pdf_e, ok_e = self.portal.sample_li(ref_p, u2)
                pdf_e = torch.where(ok_e, torch.clamp(pdf_e, min=1e-12), 0.0)
            elif self.has_env_img:
                wi_e, L_e, pdf_e = self._env_texel(u2)
            else:
                wi_e = sample_uniform_sphere(u2)
                L_e = self.env_L.expand(R + (3,))
                pdf_e = torch.full(R, INV_4PI, device=dev)
            wi = torch.where(sel[..., None], wi_e, wi)
            L = torch.where(sel[..., None], L_e, L)
            pdf_dir = torch.where(sel, pdf_e, pdf_dir)
            t_shadow = torch.where(sel, 2.0 * self.world_radius, t_shadow)
        valid = (pdf_dir > 0) & (pmf > 0)
        return LightSample(wi, L, pdf_dir, pmf, is_delta, t_shadow, valid,
                           n_light, area_id, idx)

    # -- emitted rays for particle tracing (SampleLe) ----------------------
    def sample_le(self, u_select, u_side, u2a, u2b):
        """Sample a light-emitted ray (lights.h SampleLe) over the finite
        emitters (the selection pmf renormalized without the environment).

        Returns (p, d, alpha, n_light, is_area, valid, alpha_pos): alpha
        the particle's initial throughput Le cos / (pmf pdf_pos pdf_dir);
        alpha_pos = Le / (pmf pdf_pos pdf_side) for the light-vertex splat
        of visible area emitters (zero for delta emitters)."""
        n = self.n_lights
        R = tuple(u_select.shape)
        dev = u_select.device
        z3 = torch.zeros(R + (3,), device=dev)
        f = torch.zeros(R, dtype=torch.bool, device=dev)
        n_emit = n - (1 if self.has_env else 0)
        if n == 0 or n_emit == 0:
            return z3, z3, z3, z3, f, f, z3
        pmf_t = self.select_pmf_table[:n_emit]
        pmf_t = pmf_t / torch.clamp(torch.sum(pmf_t), min=1e-20)
        cdf = torch.cumsum(pmf_t, 0)
        idx = torch.sum((u_select[..., None] >= cdf).long(), -1)
        idx = torch.clamp(idx, max=n_emit - 1)
        pmf = torch.clamp(pmf_t[idx], min=1e-20)
        p, d, alpha, alpha_pos, n_l = z3, z3, z3, z3, z3
        is_area, valid = f, f

        def put(sel, p_new, d_new, a_new, p, d, alpha, valid):
            return (torch.where(sel[..., None], p_new, p),
                    torch.where(sel[..., None], d_new, d),
                    torch.where(sel[..., None], a_new, alpha), valid | sel)

        if self.n_point > 0:
            pi = torch.clamp(idx, 0, self.n_point - 1)
            p, d, alpha, valid = put(
                idx < self.n_point, self.point_p[pi],
                sample_uniform_sphere(u2a),
                self.point_I[pi] * (4.0 * PI) / pmf[..., None],
                p, d, alpha, valid)
        if self.n_spot > 0:
            si = torch.clamp(idx - self.n_point, 0, self.n_spot - 1)
            ct_tot = self.spot_cos_total[si]
            cos_t = 1.0 - u2a[..., 0] * (1.0 - ct_tot)
            sin_t = torch.sqrt(torch.clamp(1.0 - cos_t**2, min=0.0))
            phi = 2.0 * PI * u2a[..., 1]
            axis = self.spot_dir[si]
            t1, t2 = coordinate_system(axis)
            d_s = ((torch.cos(phi) * sin_t)[..., None] * t1
                   + (torch.sin(phi) * sin_t)[..., None] * t2
                   + cos_t[..., None] * axis)
            pdf_dir = 1.0 / torch.clamp(2.0 * PI * (1.0 - ct_tot), min=1e-9)
            tt = safe_div(cos_t - ct_tot, self.spot_cos_start[si] - ct_tot)
            fall = torch.clamp(tt, 0.0, 1.0)
            fall = fall * fall * (3.0 - 2.0 * fall)
            p, d, alpha, valid = put(
                (idx >= self.n_point) & (idx < self.base_gonio),
                self.spot_p[si], d_s,
                self.spot_I[si] * fall[..., None] / (pmf * pdf_dir)[..., None],
                p, d, alpha, valid)
        if self.n_gonio > 0:
            gi = torch.clamp(idx - self.base_gonio, 0, self.n_gonio - 1)
            d_g = sample_uniform_sphere(u2b)
            I_g = self.gonio_I[gi] * self._gonio_scale(gi, d_g)
            p, d, alpha, valid = put(
                (idx >= self.base_gonio) & (idx < self.base_proj),
                self.gonio_p[gi], d_g, I_g * (4.0 * PI) / pmf[..., None],
                p, d, alpha, valid)
        if self.n_proj > 0:
            pj = torch.clamp(idx - self.base_proj, 0, self.n_proj - 1)
            tanf = self.proj_tan[pj]
            # uniform on the z = 1 image plane inside the frustum
            x = (2.0 * u2b[..., 0] - 1.0) * tanf
            y = (2.0 * u2b[..., 1] - 1.0) * tanf
            d_l = normalize(torch.stack([x, y, torch.ones_like(x)], -1))
            # light -> world = rot^T (rot is world -> light)
            d_p = torch.einsum("...ji,...j->...i", self.proj_r[pj], d_l)
            # plane pdf 1/(2t)^2 -> solid angle 1/((2t)^2 cos^3)
            cos3 = d_l[..., 2] ** 3
            pdf_dir = 1.0 / torch.clamp((2 * tanf) ** 2 * cos3, min=1e-12)
            I_p = self.proj_I[pj] * self._proj_scale(pj, d_p)
            p, d, alpha, valid = put(
                (idx >= self.base_proj) & (idx < self.base_distant),
                self.proj_p[pj], d_p, I_p / (pmf * pdf_dir)[..., None],
                p, d, alpha, valid)
        if self.n_distant > 0:
            base_d = self.base_distant
            di = torch.clamp(idx - base_d, 0, self.n_distant - 1)
            dd = normalize(self.distant_dir[di])
            t1, t2 = coordinate_system(dd)
            disk = sample_uniform_disk_concentric(u2a) * self.world_radius
            p_d = (-dd * self.world_radius + disk[..., 0:1] * t1
                   + disk[..., 1:2] * t2)
            area_disk = PI * self.world_radius**2
            p, d, alpha, valid = put(
                (idx >= base_d) & (idx < self.base_area), p_d, dd,
                self.distant_L[di] * area_disk / pmf[..., None],
                p, d, alpha, valid)
        if self.n_area > 0:
            base = self.base_area
            ai = torch.clamp(idx - base, 0, self.n_area - 1)
            b = sample_uniform_triangle(u2a)
            p0, p1, p2 = self.area_p0[ai], self.area_p1[ai], self.area_p2[ai]
            p_a = b[..., 0:1] * p0 + b[..., 1:2] * p1 + b[..., 2:3] * p2
            nc = cross(p1 - p0, p2 - p0)
            area2 = length(nc)
            nl = nc * safe_div(1.0, area2, 0.0)[..., None]
            two = self.area_twosided[ai]
            nl = torch.where((two & (u_side < 0.5))[..., None], -nl, nl)
            t1, t2 = coordinate_system(nl)
            dl = sample_cosine_hemisphere(u2b)  # local z-up
            d_a = dl[..., 0:1] * t1 + dl[..., 1:2] * t2 + dl[..., 2:3] * nl
            side_pdf = torch.where(two, 0.5, 1.0)
            # alpha = L cos / (pmf (1/area) (cos/pi) side) = L pi area / ...
            a_val = (self.area_L[ai] * (PI * 0.5 * area2)[..., None]
                     / (pmf * side_pdf)[..., None])
            sel = (idx >= base) & (idx < base + self.n_area)
            p, d, alpha, _ = put(sel, p_a, d_a, a_val, p, d, alpha, valid)
            n_l = torch.where(sel[..., None], nl, n_l)
            alpha_pos = torch.where(
                sel[..., None], self.area_L[ai] * (0.5 * area2)[..., None]
                / (pmf * side_pdf)[..., None], alpha_pos)
            is_area = is_area | sel
            valid = valid | (sel & (area2 > 0))
        return p, d, alpha, n_l, is_area, valid, alpha_pos

    # -- the environment's directions without the selection pmf -----------
    def sample_env_dir(self, u2):
        """A direction toward the environment: (wl, Le, pdf_dir), the image
        environment by its texel pmf (ImageInfiniteLight::SampleLe's
        direction, lights.cpp:1144-1153), the uniform one on the sphere
        (lights.cpp:1042-1046). Not for a portal (callers gate on
        ``portal is None``)."""
        R = tuple(u2.shape[:-1])
        dev = u2.device
        if not self.has_env or self.portal is not None:
            z = torch.zeros(R, device=dev)
            return (torch.zeros(R + (3,), device=dev),
                    torch.zeros(R + (3,), device=dev), z)
        if self.has_env_img:
            return self._env_texel(u2)
        return (sample_uniform_sphere(u2), self.env_L.expand(R + (3,)),
                torch.full(R, INV_4PI, device=dev))

    def env_pdf_dir(self, wl):
        """Solid-angle pdf of ``sample_env_dir`` along wl (toward the
        light), without the selection pmf (BDPT's InfiniteLightDensity
        block, integrators.cpp:2272)."""
        R = tuple(wl.shape[:-1])
        if not self.has_env or self.portal is not None:
            return torch.zeros(R, device=wl.device)
        if self.has_env_img:
            S = self.env_img.shape[0]
            iy, ix = equal_area_texel(wl, self.env_img.shape[0])
            return self.env_pmf[iy * S + ix] * (S * S) * INV_4PI
        return torch.full(R, INV_4PI, device=wl.device)

    # -- escaped rays (the environment) ------------------------------------
    def le_escaped(self, d, o=None):
        """Radiance from the environment along escaped directions d; o the
        escaped rays' origins (a portal tests its window against them)."""
        shape = tuple(d.shape[:-1]) + (3,)
        if not self.has_env:
            return torch.zeros(shape, device=d.device)
        if self.portal is not None:
            return self.portal.le(d, o)
        if self.has_env_img:
            iy, ix = equal_area_texel(d, self.env_img.shape[0])
            return self.env_img[iy, ix]
        return self.env_L.expand(shape)

    def pdf_li_escaped(self, d, ref_p=None):
        """select_pmf * directional pdf for MIS of escaped rays (a portal
        needs the previous scattering vertex ref_p)."""
        R = tuple(d.shape[:-1])
        if not self.has_env:
            return torch.zeros(R, device=d.device)
        if self.bvh is not None:
            n_inf = self.n_infinite
            sel = torch.tensor((n_inf / (n_inf + 1.0)) / n_inf,
                               device=d.device)
        else:
            sel = self.select_pmf_table[self.n_lights - 1]
        if self.portal is not None:
            if ref_p is None:
                ref_p = torch.zeros(R + (3,), device=d.device)
            return self.portal.pdf_li(ref_p, d) * sel
        if self.has_env_img:
            S = self.env_img.shape[0]
            iy, ix = equal_area_texel(d, self.env_img.shape[0])
            return self.env_pmf[iy * S + ix] * (S * S) * INV_4PI * sel
        return INV_4PI * sel.expand(R)

    # -- area lights at a surface hit --------------------------------------
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
        area = 0.5 * length(cross(e1, e2))
        to_h = p_hit - ref_p
        dist2 = torch.sum(to_h * to_h, -1)
        wi = to_h * safe_div(1.0, torch.sqrt(dist2), 0.0)[..., None]
        cos_l = torch.abs(dot(n_hit, wi))
        pdf = safe_div(dist2, cos_l * area, 0.0)
        base = self.base_area
        if self.bvh is not None:
            from .lightsamplers import bvh_pmf

            p_inf = self.n_infinite / (self.n_infinite + 1.0)
            sel_pmf = (1.0 - p_inf) * bvh_pmf(self.bvh, ref_p, base + ai)
        else:
            sel_pmf = self.select_pmf_table[torch.clamp(
                base + ai, 0, max(self.n_lights - 1, 0))]
        return torch.where(light_id >= 0, pdf * sel_pmf, 0.0)
