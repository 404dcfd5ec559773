"""Surface materials and their BSDFs (counterpart of ``models/materials.py``)
as per-lane tensors with masked evaluation, in the local shading frame
(z = shading normal; wo and wi point away from the surface).

Kinds (mat_type), those of the JAX package:
  0 DIFFUSE          albedo (optionally textured)
  1 CONDUCTOR        Schlick F0 = albedo; roughness 0 is a mirror, above
                     it the Trowbridge-Reitz microfacet lobe
  2 DIELECTRIC       eta; roughness 0 is smooth (Fresnel reflect or
                     refract), above it the rough reflection and
                     transmission lobes
  3 DIFFUSE_TRANS    albedo (reflection) and albedo2 (transmission)
  4 THIN_DIELECTRIC  eta, always specular (double-interface Fresnel,
                     straight-through transmission)
  5 COATED_DIFFUSE   albedo base under a dielectric GGX coat (roughness,
                     eta) with reciprocal Fresnel attenuation: the JAX
                     package's closed-form layering, not pbrt's random-walk
                     LayeredBxDF
  6 COATED_CONDUCTOR albedo (base F0) and roughness (base GGX) under a coat
                     of roughness2 and eta, the same layering as 5
  7 MIX              mix_m1 / mix_m2 / mix_amount: resolved to one
                     constituent a hit by a hash of the hit position
  8 HAIR             Chiang et al. 2016 fibres: albedo2 = sigma_a,
                     roughness = beta_m, roughness2 = beta_n,
                     mix_amount = alpha (the scale tilt in radians)
  9 SUBSURFACE       albedo = A, albedo2 = the mean free path, eta; the
                     integrator relocates these lanes (``models/bssrdf.py``)
 10 MEASURED         a Rusinkiewicz (theta_h, theta_d, phi_d) table of
                     ``meas_bank`` picked by meas_id, cosine sampled
 11 COOK_TORRANCE    Fresnel-weighted Trowbridge-Reitz glossy reflection
                     over a (1 - F)-weighted Lambertian base

Every formula keeps the JAX package's operation order, so that the two
packages agree to float rounding. A lane set carries the families its
table holds (``BSDFLanes.kinds``), and the BSDF functions evaluate only
those: every other family's mask is false on every lane, so the result is
the one of evaluating all of them, at a fraction of the kernel launches.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from ..utils.device import OnDevice
from ..utils.math import (INV_PI, PI, int_pow, py_mod, safe_div, safe_sqrt,
                          sqr)
from ..utils.sampling import (cosine_hemisphere_pdf, sample_cosine_hemisphere,
                              sample_uniform_disk_polar)
from ..utils.vecmath import (abs_cos_theta, cross, dot, normalize,
                             same_hemisphere, tan2_theta)

DIFFUSE = 0
CONDUCTOR = 1
DIELECTRIC = 2
DIFFUSE_TRANS = 3
THIN_DIELECTRIC = 4
COATED_DIFFUSE = 5
COATED_CONDUCTOR = 6
MIX = 7
HAIR = 8
SUBSURFACE = 9
MEASURED = 10
COOK_TORRANCE = 11
# a family of ``kinds``, never a row's mat_type: a dielectric row with
# roughness at or above SMOOTH (its rows keep DIELECTRIC)
ROUGH_DIELECTRIC = 100
SMOOTH = 1e-3  # roughness below this is a delta lobe


def families(mat_type, roughness):
    """The families a table of these kinds and roughnesses holds (lists of
    Python numbers). A subsurface row adds the mirror and the Lambertian
    lobes the integrator rewrites its lanes to."""
    fam = {int(k) for k in mat_type}
    if any(int(k) == DIELECTRIC and r >= SMOOTH
           for k, r in zip(mat_type, roughness)):
        fam.add(ROUGH_DIELECTRIC)
    if SUBSURFACE in fam:
        fam |= {DIFFUSE, CONDUCTOR}
    return frozenset(fam)


@dataclass(frozen=True)
class Materials(OnDevice):
    mat_type: torch.Tensor  # (M,) int32
    albedo: torch.Tensor  # (M,3) diffuse reflectance / conductor F0
    eta: torch.Tensor  # (M,) relative IOR
    roughness: torch.Tensor  # (M,) Trowbridge-Reitz alpha
    albedo_tex: torch.Tensor  # (M,) texture id of the albedo, -1 = constant
    albedo2: torch.Tensor  # (M,3) transmission colour / hair sigma_a / mfp
    roughness2: torch.Tensor  # (M,) coat roughness / hair beta_n
    mix_m1: torch.Tensor  # (M,) int32 MIX constituent ids (-1 elsewhere)
    mix_m2: torch.Tensor  # (M,) int32
    mix_amount: torch.Tensor  # (M,) probability of mix_m1 / hair alpha
    meas_id: torch.Tensor  # (M,) int32 measured-table id (-1 = none)
    meas_bank: torch.Tensor = None  # (K,Nh,Nd,Np,3) measured BRDF tables
    # the table's families, computed from its rows
    kinds: frozenset = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "kinds", families(
            self.mat_type.tolist(), self.roughness.tolist()))

    @staticmethod
    def build(mats=(), measured_tables=None, *, device):
        """mats: list of dicts {type, albedo, albedo2, eta, roughness,
        roughness2, albedo_tex, mix_m1, mix_m2, mix_amount, meas_id}, with
        the JAX package's defaults; measured_tables: an optional
        (K,Nh,Nd,Np,3) bank. An empty list gives one black diffuse row so
        that lane gathers stay in range, as in the JAX package."""
        mats = list(mats) or [dict(type=DIFFUSE, albedo=(0.0, 0.0, 0.0))]

        def col(key, default, dtype=torch.float32):
            return torch.as_tensor(
                np.asarray([m.get(key, default) for m in mats],
                           np.float32 if dtype == torch.float32
                           else np.int64), dtype=dtype, device=device)

        i32 = torch.int32
        return Materials(
            col("type", DIFFUSE, i32), col("albedo", (0.5, 0.5, 0.5)),
            col("eta", 1.5), col("roughness", 0.0), col("albedo_tex", -1, i32),
            col("albedo2", (0, 0, 0)), col("roughness2", 0.0),
            col("mix_m1", -1, i32), col("mix_m2", -1, i32),
            col("mix_amount", 0.5), col("meas_id", -1, i32),
            None if measured_tables is None else torch.as_tensor(
                np.asarray(measured_tables, np.float32), device=device))

    @property
    def n(self):
        return self.mat_type.shape[0]

    def resolve_mix(self, mat_id, p=None):
        """MIX rows resolved to a constituent id by a hash of the hit
        position (materials.h MixMaterial::ChooseMaterial): |p| * 65536
        truncated to uint32 words (int64 carriers, exact for |p| < 65536),
        hashed with the row id. One nesting level, as in the JAX
        package."""
        if p is None or MIX not in self.kinds:
            return mat_id
        from ..utils import rng as _rng

        mid = torch.clamp(mat_id, min=0).long()
        is_mix = self.mat_type[mid] == MIX
        bits = (torch.abs(p) * 65536.0).to(torch.int64)
        h = _rng.hash_u32(bits[..., 0], bits[..., 1], bits[..., 2], mid)
        u = h.to(torch.float32) * (1.0 / 4294967296.0)
        chosen = torch.where(u < self.mix_amount[mid], self.mix_m1[mid],
                             self.mix_m2[mid])
        return torch.where(is_mix & (mat_id >= 0),
                           torch.clamp(chosen, min=0).to(mat_id.dtype),
                           mat_id)

    def gather(self, mat_id, p=None):
        mat_id = self.resolve_mix(mat_id, p)
        mid = torch.clamp(mat_id, min=0).long()
        return BSDFLanes(
            self.mat_type[mid], self.albedo[mid], self.eta[mid],
            self.roughness[mid], self.kinds, albedo2=self.albedo2[mid],
            roughness2=self.roughness2[mid], alpha=self.mix_amount[mid],
            h=torch.zeros_like(self.eta[mid]), meas_id=self.meas_id[mid],
            meas_bank=self.meas_bank)

    def gather_textured(self, textures, mat_id, uv, p=None):
        """Gather, then evaluate the albedo texture at the hit uv (and
        world position p, which the noise kinds and the mix hash read).
        The hair cross-section offset h = 2v - 1 rides along."""
        mat_id = self.resolve_mix(mat_id, p)
        lanes = self.gather(mat_id)
        lanes = lanes._replace(h=torch.clamp(2.0 * uv[..., 1] - 1.0,
                                             -0.9995, 0.9995))
        if textures is None:
            return lanes
        from .textures import eval_texture

        tex = self.albedo_tex[torch.clamp(mat_id, min=0).long()]
        tval = eval_texture(textures, tex, uv, p)
        return lanes._replace(albedo=torch.where((tex >= 0)[..., None], tval,
                                                 lanes.albedo))


class BSDFLanes(NamedTuple):
    """Per-lane material parameters. ``kinds`` names the families the lanes
    may hold."""

    mat_type: torch.Tensor  # (R,)
    albedo: torch.Tensor  # (R,3)
    eta: torch.Tensor  # (R,)
    roughness: torch.Tensor  # (R,)
    kinds: frozenset
    albedo2: torch.Tensor = None  # (R,3)
    roughness2: torch.Tensor = None  # (R,) coat roughness
    alpha: torch.Tensor = None  # (R,) hair scale tilt
    h: torch.Tensor = None  # (R,) hair cross-section offset in [-1,1]
    meas_id: torch.Tensor = None  # (R,) measured-table id
    meas_bank: torch.Tensor = None  # shared (K,Nh,Nd,Np,3) bank

    def has(self, *fams):
        return any(f in self.kinds for f in fams)

    def or_zeros(self, name, like):
        v = getattr(self, name)
        return torch.zeros_like(like) if v is None else v

    @property
    def is_specular(self):
        """Delta-only lanes: the smooth conductor and dielectric and the
        thin dielectric. Coated materials keep a non-delta base lobe."""
        smooth = self.roughness < SMOOTH
        return ((smooth & ((self.mat_type == CONDUCTOR)
                           | (self.mat_type == DIELECTRIC)))
                | (self.mat_type == THIN_DIELECTRIC))


class BSDFSample(NamedTuple):
    wi: torch.Tensor  # (R,3) local
    f: torch.Tensor  # (R,3)
    pdf: torch.Tensor  # (R,)
    is_specular: torch.Tensor  # (R,)
    is_transmission: torch.Tensor  # (R,)
    eta: torch.Tensor  # (R,) relative IOR of the event (1 if reflected)
    valid: torch.Tensor  # (R,)


# -- Fresnel -----------------------------------------------------------------


def fresnel_dielectric(cos_i, eta):
    """Exact dielectric Fresnel reflectance (scattering.h FrDielectric);
    cos_i < 0 means the ray leaves the interior, eta = interior/exterior."""
    cos_i = torch.clamp(cos_i, -1.0, 1.0)
    eta_e = torch.where(cos_i < 0, 1.0 / eta, eta)
    ci = torch.abs(cos_i)
    sin2_t = (1.0 - sqr(ci)) / sqr(eta_e)
    cos_t = safe_sqrt(1.0 - sin2_t)
    r_parl = safe_div(eta_e * ci - cos_t, eta_e * ci + cos_t)
    r_perp = safe_div(ci - eta_e * cos_t, ci + eta_e * cos_t)
    F = 0.5 * (sqr(r_parl) + sqr(r_perp))
    return torch.where(sin2_t >= 1.0, 1.0, F)


def fresnel_schlick(cos_i, f0):
    """Schlick's approximation with an RGB F0."""
    m = torch.clamp(1.0 - torch.abs(cos_i), 0.0, 1.0)
    return f0 + (1.0 - f0) * int_pow(m, 5)[..., None]


def refract(wi, n, eta):
    """Refract wi about n (both unit). Returns (ok, wt, eta_used)."""
    cos_i = dot(n, wi)
    flip = cos_i < 0
    eta_e = torch.where(flip, 1.0 / eta, eta)
    n_e = torch.where(flip[..., None], -n, n)
    ci = torch.abs(cos_i)
    sin2_t = torch.clamp(1.0 - sqr(ci), min=0.0) / sqr(eta_e)
    cos_t = safe_sqrt(1.0 - sin2_t)
    wt = -wi / eta_e[..., None] + (ci / eta_e - cos_t)[..., None] * n_e
    return ~(sin2_t >= 1.0), normalize(wt), eta_e


# -- Trowbridge-Reitz microfacet (scattering.h) ------------------------------


def tr_d(wm, alpha):
    """Isotropic Trowbridge-Reitz normal distribution."""
    t2 = tan2_theta(wm)
    c4 = sqr(sqr(wm[..., 2]))
    e = t2 / sqr(alpha)
    return torch.where(torch.isfinite(t2),
                       safe_div(1.0, PI * sqr(alpha) * c4 * sqr(1.0 + e), 0.0),
                       0.0)


def tr_lambda(w, alpha):
    t2 = tan2_theta(w)
    return torch.where(torch.isfinite(t2),
                       0.5 * (safe_sqrt(1.0 + sqr(alpha) * t2) - 1.0), 0.0)


def tr_g1(w, alpha):
    return 1.0 / (1.0 + tr_lambda(w, alpha))


def tr_g(wo, wi, alpha):
    return 1.0 / (1.0 + tr_lambda(wo, alpha) + tr_lambda(wi, alpha))


def tr_d_visible(w, wm, alpha):
    """Visible-normal distribution pdf."""
    return (tr_g1(w, alpha) / torch.clamp(abs_cos_theta(w), min=1e-8)
            * tr_d(wm, alpha) * torch.abs(dot(w, wm)))


def tr_sample_wm(w, alpha, u2):
    """A visible normal (Heitz 2018; scattering.h Sample_wm)."""
    wh = normalize(torch.stack([alpha * w[..., 0], alpha * w[..., 1],
                                w[..., 2]], -1))
    wh = torch.where((wh[..., 2] < 0)[..., None], -wh, wh)
    z = torch.zeros_like(wh)
    t1 = torch.where((wh[..., 2] < 0.999999)[..., None],
                     normalize(cross(z + torch.tensor([0.0, 0.0, 1.0],
                                                      device=w.device), wh)),
                     z + torch.tensor([1.0, 0.0, 0.0], device=w.device))
    t2v = cross(wh, t1)
    p = sample_uniform_disk_polar(u2)
    h = safe_sqrt(1.0 - sqr(p[..., 0]))
    half = (1.0 + wh[..., 2]) / 2.0
    p1y = half * p[..., 1] + (1.0 - half) * h
    pz = safe_sqrt(1.0 - sqr(p[..., 0]) - sqr(p1y))
    nh = p[..., 0:1] * t1 + p1y[..., None] * t2v + pz[..., None] * wh
    return normalize(torch.stack([alpha * nh[..., 0], alpha * nh[..., 1],
                                  torch.clamp(nh[..., 2], min=1e-6)], -1))


def _half_vector(wo, wi):
    wm = normalize(wi + wo)
    return torch.where((wm[..., 2] < 0)[..., None], -wm, wm)


def _reflect(wo, wm):
    return -wo + 2.0 * dot(wo, wm)[..., None] * wm


def _flip_z(w, flip):
    return torch.where(flip[..., None], w * torch.tensor(
        [1.0, 1.0, -1.0], device=w.device), w)


def _only(lanes, *fams):
    """`lanes` whose BSDF functions evaluate only `fams`: on a lane of one
    of them every other family's mask is false, so its f and pdf are the
    same; bsdf_sample's one-sample MIS families read theirs so."""
    return lanes._replace(kinds=frozenset(fams))


def _coat_alphas(lanes):
    """(coat alpha, base alpha) of the coated families."""
    is_cd = lanes.mat_type == COATED_DIFFUSE
    rough2 = lanes.or_zeros("roughness2", lanes.roughness)
    a_coat = torch.clamp(torch.where(is_cd, lanes.roughness, rough2),
                         min=0.01)
    return a_coat, torch.clamp(lanes.roughness, min=0.01)


# -- the BSDF interface (masked over the families) ---------------------------


def bsdf_f(lanes: BSDFLanes, wo, wi):
    """BSDF value f(wo, wi), delta lobes excluded; (R,3)."""
    f = torch.zeros_like(lanes.albedo)
    same = same_hemisphere(wo, wi)
    kind, rough = lanes.mat_type, lanes.roughness
    f = torch.where(((kind == DIFFUSE) & same)[..., None],
                    lanes.albedo * INV_PI, f)
    ones = torch.ones_like(lanes.albedo)
    wm = wi + wo
    wm_ok = torch.sum(wm * wm, -1) > 1e-18
    wm_n = normalize(wm)
    wm_n = torch.where((wm_n[..., 2] < 0)[..., None], -wm_n, wm_n)
    alpha = torch.clamp(rough, min=1e-4)

    if lanes.has(DIFFUSE_TRANS):
        is_dt = kind == DIFFUSE_TRANS
        albedo2 = lanes.or_zeros("albedo2", lanes.albedo)
        f = torch.where((is_dt & same)[..., None], lanes.albedo * INV_PI, f)
        f = torch.where((is_dt & ~same)[..., None], albedo2 * INV_PI, f)

    if lanes.has(CONDUCTOR):
        F = fresnel_schlick(dot(wo, wm_n), lanes.albedo)
        denom = 4.0 * abs_cos_theta(wo) * abs_cos_theta(wi)
        spec = tr_d(wm_n, alpha)[..., None] * F * tr_g(wo, wi, alpha)[..., None]
        spec = spec * safe_div(1.0, denom, 0.0)[..., None]
        is_c = (kind == CONDUCTOR) & (rough >= SMOOTH)
        f = torch.where((is_c & same & wm_ok)[..., None], spec, f)

    if lanes.has(ROUGH_DIELECTRIC):
        is_rd = (kind == DIELECTRIC) & (rough >= SMOOTH)
        eta = lanes.eta
        Fr = fresnel_dielectric(dot(wo, wm_n), eta)
        spec_r = (tr_d(wm_n, alpha) * tr_g(wo, wi, alpha) * Fr
                  * safe_div(1.0, 4.0 * abs_cos_theta(wo) * abs_cos_theta(wi),
                             0.0))
        f = torch.where((is_rd & same)[..., None], spec_r[..., None] * ones,
                        f)
        # transmission (bxdfs.h DielectricBxDF::f)
        etap = torch.where(wo[..., 2] > 0, eta, 1.0 / eta)
        wm_t = wi * etap[..., None] + wo
        wm_tok = torch.sum(wm_t * wm_t, -1) > 1e-18
        wm_t = normalize(wm_t)
        wm_t = torch.where((wm_t[..., 2] < 0)[..., None], -wm_t, wm_t)
        backface = ((dot(wm_t, wi) * wi[..., 2] > 0)
                    | (dot(wm_t, wo) * wo[..., 2] < 0))
        Ft = 1.0 - fresnel_dielectric(dot(wo, wm_t), eta)
        denom_t = sqr(dot(wi, wm_t) + dot(wo, wm_t) / etap)
        spec_t = (tr_d(wm_t, alpha) * Ft * tr_g(wo, wi, alpha)
                  * torch.abs(safe_div(dot(wi, wm_t) * dot(wo, wm_t),
                                       wi[..., 2] * wo[..., 2] * denom_t,
                                       0.0))
                  / sqr(etap))
        f = torch.where((is_rd & ~same & wm_tok & ~backface)[..., None],
                        spec_t[..., None] * ones, f)

    if lanes.has(COATED_DIFFUSE, COATED_CONDUCTOR):
        is_cd = kind == COATED_DIFFUSE
        is_cc = kind == COATED_CONDUCTOR
        a_coat, a_base = _coat_alphas(lanes)
        Fo = fresnel_dielectric(abs_cos_theta(wo), lanes.eta)
        Fi = fresnel_dielectric(abs_cos_theta(wi), lanes.eta)
        denom_l = 4.0 * abs_cos_theta(wo) * abs_cos_theta(wi)
        coat = (tr_d(wm_n, a_coat) * tr_g(wo, wi, a_coat)
                * fresnel_dielectric(dot(wo, wm_n), lanes.eta))
        coat = safe_div(coat, denom_l, 0.0)[..., None] * ones
        atten = ((1.0 - Fo) * (1.0 - Fi))[..., None]
        diff_base = lanes.albedo * INV_PI * atten
        cond_base = (tr_d(wm_n, a_base)[..., None]
                     * fresnel_schlick(dot(wo, wm_n), lanes.albedo)
                     * tr_g(wo, wi, a_base)[..., None]
                     * safe_div(1.0, denom_l, 0.0)[..., None] * atten)
        f = torch.where((is_cd & same & wm_ok)[..., None], coat + diff_base, f)
        f = torch.where((is_cc & same & wm_ok)[..., None], coat + cond_base, f)

    if lanes.has(COOK_TORRANCE):
        a_ct = torch.clamp(rough, min=1e-3)
        F_ct = fresnel_dielectric(dot(wo, wm_n), lanes.eta)
        spec_ct = (tr_d(wm_n, a_ct) * tr_g(wo, wi, a_ct) * F_ct
                   * safe_div(1.0, torch.abs(4.0 * wo[..., 2] * wi[..., 2]),
                              0.0))
        f_ct = (spec_ct[..., None] * ones
                + lanes.albedo * (INV_PI * (1.0 - F_ct))[..., None])
        f = torch.where(((kind == COOK_TORRANCE) & same & wm_ok)[..., None],
                        f_ct, f)

    if lanes.has(HAIR):
        f = torch.where((kind == HAIR)[..., None], hair_f(lanes, wo, wi), f)

    if lanes.meas_bank is not None and lanes.has(MEASURED):
        f = torch.where(((kind == MEASURED) & same)[..., None],
                        measured_f(lanes, wo, wi), f)
    return f


def bsdf_pdf(lanes: BSDFLanes, wo, wi):
    """Sampling pdf of wi given wo (non-delta lobes); (R,)."""
    pdf = torch.zeros_like(wo[..., 0])
    same = same_hemisphere(wo, wi)
    kind, rough = lanes.mat_type, lanes.roughness
    cos_pdf = cosine_hemisphere_pdf(abs_cos_theta(wi))
    pdf = torch.where((kind == DIFFUSE) & same, cos_pdf, pdf)
    wm = _half_vector(wo, wi)
    alpha = torch.clamp(rough, min=1e-4)

    if lanes.has(DIFFUSE_TRANS):
        # half/half hemisphere choice weighted by the albedos' sums
        wr = torch.sum(lanes.albedo, -1)
        wt = torch.sum(lanes.or_zeros("albedo2", lanes.albedo), -1)
        pr = safe_div(wr, wr + wt, 0.5)
        pdf_dt = torch.where(same, pr * cos_pdf, (1.0 - pr) * cos_pdf)
        pdf = torch.where(kind == DIFFUSE_TRANS, pdf_dt, pdf)

    if lanes.has(CONDUCTOR):
        pdf_c = safe_div(tr_d_visible(wo, wm, alpha),
                         4.0 * torch.abs(dot(wo, wm)), 0.0)
        pdf = torch.where((kind == CONDUCTOR) & (rough >= SMOOTH) & same,
                          pdf_c, pdf)

    if lanes.has(ROUGH_DIELECTRIC):
        eta = lanes.eta
        Fr = fresnel_dielectric(dot(wo, wm), eta)
        pdf_rr = safe_div(tr_d_visible(wo, wm, alpha),
                          4.0 * torch.abs(dot(wo, wm)), 0.0) * Fr
        etap = torch.where(wo[..., 2] > 0, eta, 1.0 / eta)
        wm_t = wi * etap[..., None] + wo
        wm_tok = torch.sum(wm_t * wm_t, -1) > 1e-18
        wm_t = normalize(wm_t)
        wm_t = torch.where((wm_t[..., 2] < 0)[..., None], -wm_t, wm_t)
        backface = ((dot(wm_t, wi) * wi[..., 2] > 0)
                    | (dot(wm_t, wo) * wo[..., 2] < 0))
        Ft = 1.0 - fresnel_dielectric(dot(wo, wm_t), eta)
        denom_t = sqr(dot(wi, wm_t) + dot(wo, wm_t) / etap)
        dwm_dwi = safe_div(torch.abs(dot(wi, wm_t)), denom_t, 0.0)
        pdf_tt = tr_d_visible(wo, wm_t, alpha) * dwm_dwi * Ft
        pdf_rd = torch.where(same, pdf_rr,
                             torch.where(wm_tok & ~backface, pdf_tt, 0.0))
        pdf = torch.where((kind == DIELECTRIC) & (rough >= SMOOTH), pdf_rd,
                          pdf)

    if lanes.has(COATED_DIFFUSE, COATED_CONDUCTOR):
        a_coat, a_base = _coat_alphas(lanes)
        p_c = torch.clamp(fresnel_dielectric(abs_cos_theta(wo), lanes.eta),
                          0.1, 0.9)
        pdf_coat = safe_div(tr_d_visible(wo, wm, a_coat),
                            4.0 * torch.abs(dot(wo, wm)), 0.0)
        pdf_base_c = safe_div(tr_d_visible(wo, wm, a_base),
                              4.0 * torch.abs(dot(wo, wm)), 0.0)
        pdf_cd = p_c * pdf_coat + (1 - p_c) * cos_pdf
        pdf_cc = p_c * pdf_coat + (1 - p_c) * pdf_base_c
        pdf = torch.where((kind == COATED_DIFFUSE) & same, pdf_cd, pdf)
        pdf = torch.where((kind == COATED_CONDUCTOR) & same, pdf_cc, pdf)

    if lanes.has(COOK_TORRANCE):
        a_ct = torch.clamp(rough, min=1e-3)
        pr_ct = fresnel_dielectric(abs_cos_theta(wo), lanes.eta)
        pdf_ct = (pr_ct * safe_div(tr_d_visible(wo, wm, a_ct),
                                   4.0 * torch.abs(dot(wo, wm)), 0.0)
                  + (1.0 - pr_ct) * cos_pdf)
        pdf = torch.where((kind == COOK_TORRANCE) & same, pdf_ct, pdf)

    if lanes.has(HAIR):
        pdf = torch.where(kind == HAIR, hair_pdf(lanes, wo, wi), pdf)

    if lanes.meas_bank is not None and lanes.has(MEASURED):
        pdf = torch.where((kind == MEASURED) & same, cos_pdf, pdf)
    return pdf


def bsdf_sample(lanes: BSDFLanes, wo, u_lobe, u2) -> BSDFSample:
    """wi ~ BSDF. Delta lobes return pdf = 1 (the Fresnel pick for the
    dielectrics) and f = weight / |cos wi|, as pbrt: callers scale beta by
    f |cos| / pdf. The rough dielectric, coated and CookTorrance families
    return the whole BSDF's f and pdf at the sampled direction."""
    R = wo.shape[:-1]
    dev = wo.device
    kind, rough, eta = lanes.mat_type, lanes.roughness, lanes.eta
    wi = torch.zeros_like(wo)
    f = torch.zeros_like(lanes.albedo)
    pdf = torch.zeros(R, device=dev)
    ones = torch.ones_like(lanes.albedo)
    is_spec = torch.zeros(R, dtype=torch.bool, device=dev)
    is_trans = torch.zeros(R, dtype=torch.bool, device=dev)
    eta_out = torch.ones(R, device=dev)
    flip = wo[..., 2] < 0  # wo below the surface: sample mirrored

    # diffuse
    is_d = kind == DIFFUSE
    wi_d = _flip_z(sample_cosine_hemisphere(u2), flip)
    pdf_d = cosine_hemisphere_pdf(abs_cos_theta(wi_d))
    wi = torch.where(is_d[..., None], wi_d, wi)
    f = torch.where(is_d[..., None], lanes.albedo * INV_PI, f)
    pdf = torch.where(is_d, pdf_d, pdf)
    valid = is_d & (pdf_d > 0)

    if lanes.has(DIFFUSE_TRANS):
        is_dt = kind == DIFFUSE_TRANS
        albedo2 = lanes.or_zeros("albedo2", lanes.albedo)
        wr = torch.sum(lanes.albedo, -1)
        pr = safe_div(wr, wr + torch.sum(albedo2, -1), 0.5)
        go_reflect = u_lobe < pr
        wi_t = sample_cosine_hemisphere(u2)
        # reflection stays in wo's hemisphere, transmission flips
        sign = torch.where(go_reflect ^ flip, 1.0, -1.0)
        wi_t = wi_t * torch.stack([torch.ones_like(sign),
                                   torch.ones_like(sign), sign], -1)
        pdf_t = (cosine_hemisphere_pdf(abs_cos_theta(wi_t))
                 * torch.where(go_reflect, pr, 1.0 - pr))
        f_t = torch.where(go_reflect[..., None], lanes.albedo,
                          albedo2) * INV_PI
        wi = torch.where(is_dt[..., None], wi_t, wi)
        f = torch.where(is_dt[..., None], f_t, f)
        pdf = torch.where(is_dt, pdf_t, pdf)
        is_trans = is_trans | (is_dt & ~go_reflect)
        valid = valid | (is_dt & (pdf_t > 0))

    # smooth conductor: mirror reflection
    is_c = kind == CONDUCTOR
    smooth_c = is_c & (rough < SMOOTH)
    wi_m = torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], -1)
    f_m = (fresnel_schlick(abs_cos_theta(wo), lanes.albedo)
           * safe_div(1.0, abs_cos_theta(wi_m), 0.0)[..., None])
    wi = torch.where(smooth_c[..., None], wi_m, wi)
    f = torch.where(smooth_c[..., None], f_m, f)
    pdf = torch.where(smooth_c, 1.0, pdf)
    is_spec = is_spec | smooth_c
    valid = valid | (smooth_c & (abs_cos_theta(wo) > 0))

    # rough conductor: visible-normal sample
    alpha = torch.clamp(rough, min=1e-4)
    wo_up = torch.where(flip[..., None], -wo, wo)
    wm = None
    if lanes.has(CONDUCTOR, ROUGH_DIELECTRIC):
        wm = tr_sample_wm(wo_up, alpha, u2)
        wm = torch.where(flip[..., None], -wm, wm)
    if lanes.has(CONDUCTOR):
        rough_c = is_c & ~smooth_c
        wi_r = _reflect(wo, wm)
        wm_up = torch.where(flip[..., None], -wm, wm)
        pdf_r = safe_div(tr_d_visible(wo_up, wm_up, alpha),
                         4.0 * torch.abs(dot(wo, wm)), 0.0)
        f_r = (tr_d(wm_up, alpha)[..., None]
               * fresnel_schlick(dot(wo, wm), lanes.albedo)
               * tr_g(wo_up, torch.where(flip[..., None], -wi_r, wi_r),
                      alpha)[..., None]
               * safe_div(1.0, 4.0 * abs_cos_theta(wo) * abs_cos_theta(wi_r),
                          0.0)[..., None])
        wi = torch.where(rough_c[..., None], wi_r, wi)
        f = torch.where(rough_c[..., None], f_r, f)
        pdf = torch.where(rough_c, pdf_r, pdf)
        valid = valid | (rough_c & same_hemisphere(wo, wi_r) & (pdf_r > 0))

    # smooth dielectric: Fresnel pick of reflection or refraction
    is_di = kind == DIELECTRIC
    if lanes.has(DIELECTRIC):
        smooth_d = is_di & (rough < SMOOTH)
        F = fresnel_dielectric(wo[..., 2], eta)
        refl = u_lobe < F
        n_local = torch.zeros_like(wo) + torch.tensor([0.0, 0.0, 1.0],
                                                      device=dev)
        f_sr = (F * safe_div(1.0, abs_cos_theta(wi_m), 0.0))[..., None] * ones
        ok_t, wi_st, etap = refract(wo, n_local, eta)
        f_st = ((1.0 - F) * safe_div(1.0, abs_cos_theta(wi_st), 0.0)
                / sqr(etap))[..., None] * ones
        sm_valid = torch.where(refl, abs_cos_theta(wo) > 0, ok_t)
        wi = torch.where(smooth_d[..., None],
                         torch.where(refl[..., None], wi_m, wi_st), wi)
        f = torch.where(smooth_d[..., None],
                        torch.where(refl[..., None], f_sr, f_st), f)
        pdf = torch.where(smooth_d, torch.where(refl, F, 1.0 - F), pdf)
        is_spec = is_spec | smooth_d
        is_trans = is_trans | (smooth_d & ~refl)
        eta_out = torch.where(smooth_d & ~refl, etap, eta_out)
        valid = valid | (smooth_d & sm_valid)

    # rough dielectric: visible normal, then a Fresnel lobe choice
    if lanes.has(ROUGH_DIELECTRIC):
        rough_d = is_di & (rough >= SMOOTH)
        refl_rd = u_lobe < fresnel_dielectric(dot(wo, wm), eta)
        ok_rt, wi_rdt, etap_rd = refract(wo, wm, eta)
        wi_rd = torch.where(refl_rd[..., None], _reflect(wo, wm), wi_rdt)
        own = _only(lanes, ROUGH_DIELECTRIC)
        pdf_rd = bsdf_pdf(own, wo, wi_rd)
        wi = torch.where(rough_d[..., None], wi_rd, wi)
        f = torch.where(rough_d[..., None], bsdf_f(own, wo, wi_rd), f)
        pdf = torch.where(rough_d, pdf_rd, pdf)
        is_trans = is_trans | (rough_d & ~refl_rd)
        eta_out = torch.where(rough_d & ~refl_rd, etap_rd, eta_out)
        same_rd = same_hemisphere(wo, wi_rd)
        rd_valid = torch.where(refl_rd, same_rd, ok_rt & ~same_rd)
        valid = valid | (rough_d & rd_valid & (pdf_rd > 0))

    # thin dielectric (bxdfs.h ThinDielectricBxDF::Sample_f)
    if lanes.has(THIN_DIELECTRIC):
        is_td = kind == THIN_DIELECTRIC
        F_td = fresnel_dielectric(abs_cos_theta(wo), eta)
        R_td = torch.where(
            F_td < 1.0,
            F_td + sqr(1.0 - F_td) * F_td / torch.clamp(1.0 - sqr(F_td),
                                                        min=1e-9),
            1.0)
        refl_td = u_lobe < R_td
        wi_td = torch.where(refl_td[..., None], wi_m, -wo)
        w_td = torch.where(refl_td, R_td, 1.0 - R_td)
        f_td = ((w_td * safe_div(1.0, abs_cos_theta(wi_td), 0.0))[..., None]
                * ones)
        wi = torch.where(is_td[..., None], wi_td, wi)
        f = torch.where(is_td[..., None], f_td, f)
        pdf = torch.where(is_td, w_td, pdf)
        is_spec = is_spec | is_td
        is_trans = is_trans | (is_td & ~refl_td)
        # straight through: entering and leaving the slab cancel, eta 1
        valid = valid | (is_td & (w_td > 0) & (abs_cos_theta(wo) > 0))

    # coated diffuse / coated conductor: Fresnel pick of the coat lobe or
    # the base (cosine for diffuse, the base GGX for the conductor)
    if lanes.has(COATED_DIFFUSE, COATED_CONDUCTOR):
        is_cd = kind == COATED_DIFFUSE
        is_coat = is_cd | (kind == COATED_CONDUCTOR)
        a_coat, a_base = _coat_alphas(lanes)
        p_c = torch.clamp(fresnel_dielectric(abs_cos_theta(wo), eta), 0.1,
                          0.9)
        pick_coat = u_lobe < p_c
        wm_c = tr_sample_wm(wo_up, a_coat, u2)
        wm_c = torch.where(flip[..., None], -wm_c, wm_c)
        wm_b = tr_sample_wm(wo_up, a_base, u2)
        wm_b = torch.where(flip[..., None], -wm_b, wm_b)
        wi_base = torch.where(is_cd[..., None], wi_d, _reflect(wo, wm_b))
        wi_l = torch.where(pick_coat[..., None], _reflect(wo, wm_c), wi_base)
        own = _only(lanes, COATED_DIFFUSE, COATED_CONDUCTOR)
        pdf_l = bsdf_pdf(own, wo, wi_l)
        wi = torch.where(is_coat[..., None], wi_l, wi)
        f = torch.where(is_coat[..., None], bsdf_f(own, wo, wi_l), f)
        pdf = torch.where(is_coat, pdf_l, pdf)
        valid = valid | (is_coat & same_hemisphere(wo, wi_l) & (pdf_l > 0))

    # measured: cosine-hemisphere sampling
    if lanes.meas_bank is not None and lanes.has(MEASURED):
        is_meas = kind == MEASURED
        wi = torch.where(is_meas[..., None], wi_d, wi)
        f = torch.where(is_meas[..., None], measured_f(lanes, wo, wi_d), f)
        pdf = torch.where(is_meas, pdf_d, pdf)
        valid = valid | (is_meas & (pdf_d > 0))

    # CookTorrance: Fresnel pick of the glossy or the diffuse lobe; f and
    # pdf are the whole two-lobe mixture (one-sample MIS)
    if lanes.has(COOK_TORRANCE):
        is_ct = kind == COOK_TORRANCE
        a_ct = torch.clamp(rough, min=1e-3)
        pick_gl = u_lobe < fresnel_dielectric(abs_cos_theta(wo), eta)
        wm_ct = tr_sample_wm(wo_up, a_ct, u2)
        wm_ct = torch.where(flip[..., None], -wm_ct, wm_ct)
        wi_ct = torch.where(pick_gl[..., None], _reflect(wo, wm_ct), wi_d)
        own = _only(lanes, COOK_TORRANCE)
        pdf_ct = bsdf_pdf(own, wo, wi_ct)
        wi = torch.where(is_ct[..., None], wi_ct, wi)
        f = torch.where(is_ct[..., None], bsdf_f(own, wo, wi_ct), f)
        pdf = torch.where(is_ct, pdf_ct, pdf)
        valid = valid | (is_ct & same_hemisphere(wo, wi_ct) & (pdf_ct > 0))

    if lanes.has(HAIR):
        is_hair = kind == HAIR
        wi_h, f_h, pdf_h = hair_sample(lanes, wo, u_lobe, u2)
        wi = torch.where(is_hair[..., None], wi_h, wi)
        f = torch.where(is_hair[..., None], f_h, f)
        pdf = torch.where(is_hair, pdf_h, pdf)
        valid = valid | (is_hair & (pdf_h > 0))
    return BSDFSample(wi, f, pdf, is_spec, is_trans, eta_out, valid)


# -- hair fibres (Chiang et al. 2016; bxdfs.cpp HairBxDF) --------------------
# Local frame: x = fibre tangent, z = shading normal; sin(theta) = w.x and
# the azimuth phi = atan2(w.z, w.y).

_P_MAX = 3
_TWO_PI = 2.0 * math.pi


def _bessel_i0(x):
    """Modified Bessel I0 by its series (bxdfs.cpp I0)."""
    x2 = x * x
    term = torch.ones_like(x)
    out = term
    fact = 1.0
    for i in range(1, 10):
        fact *= i
        term = term * x2 / 4.0
        out = out + term / (fact * fact)  # (x^2/4)^i / (i!)^2
    return out


def _log_bessel_i0(x):
    """log I0: the asymptotic expansion above 12, else the series' log."""
    xs = torch.clamp(x, min=1e-6)
    big = x - 0.5 * torch.log(_TWO_PI * xs) + 1.0 / (8.0 * xs)
    small = torch.log(_bessel_i0(torch.clamp(x, max=12.0)))
    return torch.where(x > 12.0, big, small)


def _mp(cos_ti, cos_to, sin_ti, sin_to, v):
    """Longitudinal scattering function (bxdfs.cpp Mp)."""
    v = torch.clamp(v, min=1e-5)
    a = cos_ti * cos_to / v
    b = sin_ti * sin_to / v
    mp_small = torch.exp(_log_bessel_i0(a) - b - 1.0 / v + 0.6931
                         + torch.log(1.0 / (2.0 * v)))
    mp_big = (torch.exp(-b) * _bessel_i0(torch.clamp(a, max=80.0))
              / (torch.sinh(1.0 / v) * 2.0 * v))
    return torch.where(v <= 0.1, mp_small, mp_big)


def _logistic(x, s):
    x = torch.abs(x)
    e = torch.exp(-x / s)
    return e / (s * sqr(1.0 + e))


def _logistic_cdf(x, s):
    """The logistic's cdf; x a tensor or a Python number (divided, not
    multiplied by a reciprocal, as XLA divides)."""
    return 1.0 / (1.0 + torch.exp(torch.div(-x, s)))


def _trimmed_logistic(x, s, a, b):
    return _logistic(x, s) / (_logistic_cdf(b, s) - _logistic_cdf(a, s))


def _sample_trimmed_logistic(u, s, a, b):
    k = _logistic_cdf(b, s) - _logistic_cdf(a, s)
    x = -s * torch.log(1.0 / torch.clamp(u * k + _logistic_cdf(a, s),
                                         min=1e-9) - 1.0)
    return torch.clamp(x, a, b)


def _hair_phi(p, gamma_o, gamma_t):
    return (2.0 * p) * gamma_t - 2.0 * gamma_o + p * PI


def _wrap_pi(x):
    return x - _TWO_PI * torch.round(x / _TWO_PI)


def _hair_derived(lanes, wo):
    """Per-evaluation quantities (bxdfs.cpp HairBxDF's constructor and
    f)."""
    beta_m = torch.clamp(lanes.roughness, 1e-3, 1.0)
    beta_n = torch.clamp(lanes.or_zeros("roughness2", lanes.roughness),
                         1e-3, 1.0)
    h = lanes.or_zeros("h", beta_m)
    eta = lanes.eta
    sigma_a = lanes.or_zeros("albedo2", lanes.albedo)

    v0 = sqr(0.726 * beta_m + 0.812 * sqr(beta_m) + 3.7 * int_pow(beta_m, 20))
    vs = (v0, 0.25 * v0, 4.0 * v0, 4.0 * v0)
    s_az = 0.626657069 * (0.265 * beta_n + 1.194 * sqr(beta_n)
                          + 5.372 * int_pow(beta_n, 22))

    sin_to = torch.clamp(wo[..., 0], -1.0, 1.0)
    cos_to = safe_sqrt(1.0 - sqr(sin_to))
    phi_o = torch.arctan2(wo[..., 2], wo[..., 1])

    gamma_o = torch.arcsin(torch.clamp(h, -1.0, 1.0))
    etap = safe_sqrt(sqr(eta) - sqr(sin_to)) / torch.clamp(cos_to, min=1e-6)
    sin_gt = h / torch.clamp(etap, min=1e-6)
    cos_gt = safe_sqrt(1.0 - sqr(sin_gt))
    gamma_t = torch.arcsin(torch.clamp(sin_gt, -1.0, 1.0))
    sin_tt = sin_to / eta
    cos_tt = safe_sqrt(1.0 - sqr(sin_tt))

    # transmittance of one pass through the fibre
    T = torch.exp(-sigma_a * (2.0 * cos_gt
                              / torch.clamp(cos_tt, min=1e-6))[..., None])

    # the attenuations Ap
    cos_go = safe_sqrt(1.0 - sqr(h))
    f_fres = fresnel_dielectric(cos_to * cos_go, eta)[..., None]
    A = [f_fres * torch.ones_like(T)]
    A.append(sqr(1.0 - f_fres) * T)
    A.append(A[1] * T * f_fres)
    A.append(A[2] * f_fres * T / torch.clamp(1.0 - T * f_fres, min=1e-4))

    # the scale tilt's sin / cos(2^k alpha), k = 0..2
    alpha = lanes.or_zeros("alpha", beta_m)
    s2k = [torch.sin(alpha)]
    c2k = [safe_sqrt(1.0 - sqr(s2k[0]))]
    for _ in range(2):
        s2k.append(2.0 * c2k[-1] * s2k[-1])
        c2k.append(sqr(c2k[-1]) - sqr(s2k[-1]))
    return dict(vs=vs, s_az=s_az, sin_to=sin_to, cos_to=cos_to, phi_o=phi_o,
                gamma_o=gamma_o, gamma_t=gamma_t, T=T, A=A, s2k=s2k, c2k=c2k)


def _hair_tilted(d, p):
    """(sin, |cos|) of theta_o rotated by the p-th scale tilt."""
    sin_to, cos_to = d["sin_to"], d["cos_to"]
    s2k, c2k = d["s2k"], d["c2k"]
    if p == 0:
        s = sin_to * c2k[1] - cos_to * s2k[1]
        c = cos_to * c2k[1] + sin_to * s2k[1]
    elif p == 1:
        s = sin_to * c2k[0] + cos_to * s2k[0]
        c = cos_to * c2k[0] - sin_to * s2k[0]
    elif p == 2:
        s = sin_to * c2k[2] + cos_to * s2k[2]
        c = cos_to * c2k[2] - sin_to * s2k[2]
    else:
        s, c = sin_to, cos_to
    return s, torch.abs(c)


def _hair_ap_pdf(d):
    """The lobe choice's pmf from the Ap's channel means."""
    lum = [torch.mean(a, -1) for a in d["A"]]
    tot = torch.clamp(lum[0] + lum[1] + lum[2] + lum[3], min=1e-9)
    return [l_ / tot for l_ in lum]


def _hair_lobes(lanes, wo, wi, d=None):
    """(d, [Mp], [Np] of lobes 0..2, Mp of the residual lobe); `d` the
    quantities of wo (``_hair_derived``) when known."""
    if d is None:
        d = _hair_derived(lanes, wo)
    sin_ti = torch.clamp(wi[..., 0], -1.0, 1.0)
    cos_ti = safe_sqrt(1.0 - sqr(sin_ti))
    phi = torch.arctan2(wi[..., 2], wi[..., 1]) - d["phi_o"]
    mps, nps = [], []
    for p in range(_P_MAX):
        s_op, c_op = _hair_tilted(d, p)
        mps.append(_mp(cos_ti, c_op, sin_ti, s_op, d["vs"][p]))
        nps.append(_trimmed_logistic(
            _wrap_pi(phi - _hair_phi(p, d["gamma_o"], d["gamma_t"])),
            d["s_az"], -PI, PI))
    mp_max = _mp(cos_ti, d["cos_to"], sin_ti, d["sin_to"], d["vs"][_P_MAX])
    return d, mps, nps, mp_max


def _hair_f_of(d, mps, nps, mp_max, wi):
    fsum = torch.zeros_like(d["T"])
    for p in range(_P_MAX):
        fsum = fsum + (mps[p] * nps[p])[..., None] * d["A"][p]
    fsum = fsum + (mp_max / _TWO_PI)[..., None] * d["A"][_P_MAX]
    return fsum / torch.clamp(torch.abs(wi[..., 2]), min=1e-5)[..., None]


def _hair_pdf_of(d, mps, nps, mp_max, wi):
    ap_pdf = _hair_ap_pdf(d)
    pdf = torch.zeros_like(wi[..., 0])
    for p in range(_P_MAX):
        pdf = pdf + ap_pdf[p] * mps[p] * nps[p]
    return pdf + ap_pdf[_P_MAX] * mp_max / _TWO_PI


def hair_f(lanes, wo, wi):
    """Hair BSDF value (bxdfs.cpp HairBxDF::f); (R,3)."""
    return _hair_f_of(*_hair_lobes(lanes, wo, wi), wi)


def hair_pdf(lanes, wo, wi):
    """Hair sampling pdf (bxdfs.cpp HairBxDF::PDF); (R,)."""
    return _hair_pdf_of(*_hair_lobes(lanes, wo, wi), wi)


def hair_sample(lanes, wo, u_lobe, u2):
    """Sample the hair BSDF (bxdfs.cpp HairBxDF::Sample_f); returns (wi, f,
    pdf). The fourth uniform is the fractional part of u2[..., 0] * 4096,
    as in the JAX package."""
    d = _hair_derived(lanes, wo)
    ap_pdf = _hair_ap_pdf(d)
    c0 = ap_pdf[0]
    c1 = c0 + ap_pdf[1]
    c2 = c1 + ap_pdf[2]
    p_idx = torch.where(u_lobe < c0, 0, torch.where(
        u_lobe < c1, 1, torch.where(u_lobe < c2, 2, 3)))
    u4096 = u2[..., 0] * 4096.0
    u1m = torch.clamp(u4096 - torch.floor(u4096), min=1e-5)
    u1 = torch.clamp(u2[..., 0], min=1e-5)
    u_phi = u2[..., 1]
    cos_phi_m = torch.cos(_TWO_PI * u1m)

    sin_ti = torch.zeros_like(u_lobe)
    cos_ti = torch.zeros_like(u_lobe)
    phi = torch.zeros_like(u_lobe)
    for p in range(_P_MAX + 1):
        sel = p_idx == p
        s_op, c_op = _hair_tilted(d, p)
        v = d["vs"][p]
        cos_t = 1.0 + v * torch.log(torch.clamp(
            u1 + (1.0 - u1) * torch.exp(torch.div(-2.0, torch.clamp(
                v, min=1e-5))), min=1e-12))
        sin_t = safe_sqrt(1.0 - sqr(cos_t))
        s_ti = -cos_t * s_op + sin_t * cos_phi_m * c_op
        c_ti = safe_sqrt(1.0 - sqr(s_ti))
        if p < _P_MAX:
            dphi = (_hair_phi(p, d["gamma_o"], d["gamma_t"])
                    + _sample_trimmed_logistic(u_phi, d["s_az"], -PI, PI))
        else:
            dphi = _TWO_PI * u_phi - PI
        sin_ti = torch.where(sel, s_ti, sin_ti)
        cos_ti = torch.where(sel, c_ti, cos_ti)
        phi = torch.where(sel, dphi, phi)
    phi_i = d["phi_o"] + phi
    wi = torch.stack([sin_ti, cos_ti * torch.cos(phi_i),
                      cos_ti * torch.sin(phi_i)], -1)
    lobes = _hair_lobes(lanes, wo, wi, d)
    return wi, _hair_f_of(*lobes, wi), _hair_pdf_of(*lobes, wi)


def hair_sigma_a_from_reflectance(c, beta_n):
    """RGB reflectance -> fibre absorption (SigmaAFromReflectance), in
    float64 numpy as the JAX package's builder computes it."""
    c = np.clip(np.asarray(c, np.float64), 1e-4, 0.9999)
    denom = (5.969 - 0.215 * beta_n + 2.532 * beta_n**2 - 10.73 * beta_n**3
             + 5.574 * beta_n**4 + 0.245 * beta_n**5)
    return (np.log(c) / denom) ** 2


# -- measured BRDFs (materials.h MeasuredMaterial's role) --------------------


def _rusinkiewicz(wo, wi):
    """(theta_h, theta_d, phi_d) half and difference angles of (wo, wi) in
    the local frame."""
    wh = normalize(wo + wi)
    theta_h = torch.arccos(torch.clamp(wh[..., 2], -1.0, 1.0))
    bi_n = torch.zeros_like(wh) + torch.tensor([0.0, 0.0, 1.0],
                                               device=wh.device)
    t1 = normalize(cross(bi_n, wh) + 1e-12)
    t2 = cross(wh, t1)
    wd = torch.stack([dot(wi, t1), dot(wi, t2), dot(wi, wh)], -1)
    theta_d = torch.arccos(torch.clamp(wd[..., 2], -1.0, 1.0))
    phi_d = py_mod(torch.arctan2(wd[..., 1], wd[..., 0]),
                   torch.tensor(PI, dtype=torch.float32, device=wh.device))
    return theta_h, theta_d, phi_d  # phi_d folded by reciprocity


def measured_f(lanes: BSDFLanes, wo, wi):
    """Trilinear lookup of the measured table; (R,3)."""
    if lanes.meas_bank is None:
        return torch.zeros_like(lanes.albedo)
    bank = lanes.meas_bank
    K, Nh, Nd, Np_ = bank.shape[:4]
    th, td, pd = _rusinkiewicz(wo, wi)
    # the MERL-style square-root warp: resolution near theta_h = 0
    fh = torch.sqrt(torch.clamp(th / (PI / 2), 0.0, 1.0)) * (Nh - 1)
    fd = torch.clamp(td / (PI / 2), 0.0, 1.0) * (Nd - 1)
    fp = torch.clamp(pd / PI, 0.0, 1.0) * (Np_ - 1)
    mid = (torch.zeros_like(lanes.mat_type) if lanes.meas_id is None
           else lanes.meas_id)
    mid = torch.clamp(mid, 0, K - 1).long()

    def tri(f, n):
        i0 = torch.clamp(torch.floor(f).to(torch.int32), 0, n - 1)
        i1 = torch.clamp(i0 + 1, max=n - 1)
        return i0.long(), i1.long(), f - i0

    h0, h1, wh_ = tri(fh, Nh)
    d0, d1, wd_ = tri(fd, Nd)
    p0, p1, wp_ = tri(fp, Np_)
    out = torch.zeros(wo.shape[:-1] + (3,), device=wo.device)
    for hi, hw in ((h0, 1 - wh_), (h1, wh_)):
        for di, dw in ((d0, 1 - wd_), (d1, wd_)):
            for pi, pw in ((p0, 1 - wp_), (p1, wp_)):
                out = out + (hw * dw * pw)[..., None] * bank[mid, hi, di, pi]
    return torch.clamp(out, min=0.0)


def load_merl_brdf(path, out_res=(32, 16, 16)):
    """A MERL .binary BRDF (three int32 dims, then float64 channels scaled
    by 1/1500, 1.15/1500, 1.66/1500) resampled by nearest index to an
    (Nh,Nd,Np,3) float32 table of measured_f's grid."""
    with open(path, "rb") as f:
        dims = np.fromfile(f, np.int32, 3)
        n = int(dims[0] * dims[1] * dims[2])
        data = np.fromfile(f, np.float64, 3 * n)
    th_n, td_n, pd_n = int(dims[0]), int(dims[1]), int(dims[2])
    scale = np.asarray([1.0 / 1500, 1.15 / 1500, 1.66 / 1500])
    vol = np.moveaxis(data.reshape(3, th_n, td_n, pd_n), 0, -1) * scale
    vol = np.maximum(vol, 0.0)
    Nh, Nd, Np_ = out_res
    ih = np.minimum((np.arange(Nh) * th_n) // Nh, th_n - 1)
    idd = np.minimum((np.arange(Nd) * td_n) // Nd, td_n - 1)
    ip = np.minimum((np.arange(Np_) * pd_n) // Np_, pd_n - 1)
    return vol[np.ix_(ih, idd, ip)].astype(np.float32)


def make_lambertian_table(albedo, res=(32, 16, 16)):
    """A measured table of a Lambertian BRDF (for checks)."""
    t = np.empty(tuple(res) + (3,), np.float32)
    t[...] = np.asarray(albedo, np.float32) / np.pi
    return t
