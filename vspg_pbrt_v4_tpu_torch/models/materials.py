"""Surface materials and their BSDFs (counterpart of ``models/materials.py``)
as per-lane tensors with masked evaluation, in the local shading frame
(z = shading normal; wo and wi point away from the surface).

Ported kinds, those of the teaser scene class:
  0 DIFFUSE        albedo (optionally a checker texture)
  1 CONDUCTOR      Schlick F0 = albedo; roughness 0 is a mirror, above it
                   the Trowbridge-Reitz microfacet lobe
  2 DIELECTRIC     eta, smooth only (Fresnel reflect / refract)
 11 COOK_TORRANCE  Fresnel-weighted Trowbridge-Reitz glossy reflection over
                   a (1 - F)-weighted Lambertian base
Every formula keeps the JAX package's operation order, so that the two
packages agree to float rounding. Building a table that holds any other
kind, or a rough dielectric, raises ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..utils.device import OnDevice
from ..utils.math import INV_PI, PI, safe_div, safe_sqrt, sqr
from ..utils.sampling import (cosine_hemisphere_pdf, sample_cosine_hemisphere,
                              sample_uniform_disk_polar)
from ..utils.vecmath import (abs_cos_theta, cross, dot, normalize,
                             same_hemisphere, tan2_theta)

DIFFUSE = 0
CONDUCTOR = 1
DIELECTRIC = 2
COOK_TORRANCE = 11
PORTED_KINDS = (DIFFUSE, CONDUCTOR, DIELECTRIC, COOK_TORRANCE)
SMOOTH = 1e-3  # roughness below this is a delta lobe


@dataclass(frozen=True)
class Materials(OnDevice):
    mat_type: torch.Tensor  # (M,) int32
    albedo: torch.Tensor  # (M,3) diffuse reflectance / conductor F0
    eta: torch.Tensor  # (M,) relative IOR
    roughness: torch.Tensor  # (M,) Trowbridge-Reitz alpha
    albedo_tex: torch.Tensor  # (M,) texture id of the albedo, -1 = constant

    @staticmethod
    def build(mats=(), *, device):
        """mats: list of dicts {type, albedo, eta, roughness, albedo_tex};
        an empty list gives one black diffuse row so that lane gathers stay
        in range, as in the JAX package."""
        mats = list(mats) or [dict(type=DIFFUSE, albedo=(0.0, 0.0, 0.0))]

        def col(key, default, dtype=torch.float32):
            return torch.as_tensor([m.get(key, default) for m in mats],
                                   dtype=dtype, device=device)

        out = Materials(col("type", DIFFUSE, torch.int32),
                        col("albedo", (0.5, 0.5, 0.5)), col("eta", 1.5),
                        col("roughness", 0.0), col("albedo_tex", -1,
                                                   torch.int32))
        out.check_ported()
        return out

    def check_ported(self):
        kinds = self.mat_type.tolist()
        rough = self.roughness.tolist()
        for k, r in zip(kinds, rough):
            if k not in PORTED_KINDS:
                raise NotImplementedError(f"material kind {k} is not ported "
                                          f"(ported: {PORTED_KINDS})")
            if k == DIELECTRIC and r >= SMOOTH:
                raise NotImplementedError("rough dielectrics are not ported")

    @property
    def n(self):
        return self.mat_type.shape[0]

    def gather(self, mat_id):
        mid = torch.clamp(mat_id, min=0).long()
        return BSDFLanes(self.mat_type[mid], self.albedo[mid], self.eta[mid],
                         self.roughness[mid])

    def gather_textured(self, textures, mat_id, uv):
        """Gather, then evaluate the albedo texture at the hit uv."""
        lanes = self.gather(mat_id)
        if textures is None:
            return lanes
        from .textures import eval_texture

        tex = self.albedo_tex[torch.clamp(mat_id, min=0).long()]
        tval = eval_texture(textures, tex, uv)
        return lanes._replace(albedo=torch.where((tex >= 0)[..., None], tval,
                                                 lanes.albedo))


class BSDFLanes(NamedTuple):
    """Per-lane material parameters."""

    mat_type: torch.Tensor  # (R,)
    albedo: torch.Tensor  # (R,3)
    eta: torch.Tensor  # (R,)
    roughness: torch.Tensor  # (R,)

    @property
    def is_specular(self):
        """Delta-only lanes: the smooth conductor and dielectric."""
        return (self.roughness < SMOOTH) & ((self.mat_type == CONDUCTOR)
                                            | (self.mat_type == DIELECTRIC))


class BSDFSample(NamedTuple):
    wi: torch.Tensor  # (R,3) local
    f: torch.Tensor  # (R,3)
    pdf: torch.Tensor  # (R,)
    is_specular: torch.Tensor  # (R,)
    is_transmission: torch.Tensor  # (R,)
    eta: torch.Tensor  # (R,) relative IOR of the event (1 if reflected)
    valid: torch.Tensor  # (R,)


# -- Fresnel -----------------------------------------------------------------


def _pow5(m):
    """m^5 by the squarings of XLA's integer power."""
    m2 = m * m
    return m * (m2 * m2)


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
    return f0 + (1.0 - f0) * _pow5(m)[..., None]


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


# -- the BSDF interface (masked over the ported kinds) -------------------------


def bsdf_f(lanes: BSDFLanes, wo, wi):
    """BSDF value f(wo, wi), delta lobes excluded; (R,3)."""
    f = torch.zeros_like(lanes.albedo)
    same = same_hemisphere(wo, wi)
    kind, rough = lanes.mat_type, lanes.roughness
    f = torch.where(((kind == DIFFUSE) & same)[..., None],
                    lanes.albedo * INV_PI, f)

    # rough conductor
    alpha = torch.clamp(rough, min=1e-4)
    wm = wi + wo
    wm_ok = torch.sum(wm * wm, -1) > 1e-18
    wm_n = normalize(wm)
    wm_n = torch.where((wm_n[..., 2] < 0)[..., None], -wm_n, wm_n)
    F = fresnel_schlick(dot(wo, wm_n), lanes.albedo)
    denom = 4.0 * abs_cos_theta(wo) * abs_cos_theta(wi)
    spec = tr_d(wm_n, alpha)[..., None] * F * tr_g(wo, wi, alpha)[..., None]
    spec = spec * safe_div(1.0, denom, 0.0)[..., None]
    is_c = (kind == CONDUCTOR) & (rough >= SMOOTH)
    f = torch.where((is_c & same & wm_ok)[..., None], spec, f)

    # CookTorrance: glossy dielectric reflection + (1-F) Lambertian base
    a_ct = torch.clamp(rough, min=1e-3)
    F_ct = fresnel_dielectric(dot(wo, wm_n), lanes.eta)
    spec_ct = (tr_d(wm_n, a_ct) * tr_g(wo, wi, a_ct) * F_ct
               * safe_div(1.0, torch.abs(4.0 * wo[..., 2] * wi[..., 2]), 0.0))
    f_ct = (spec_ct[..., None] * torch.ones_like(lanes.albedo)
            + lanes.albedo * (INV_PI * (1.0 - F_ct))[..., None])
    return torch.where(((kind == COOK_TORRANCE) & same & wm_ok)[..., None],
                       f_ct, f)


def bsdf_pdf(lanes: BSDFLanes, wo, wi):
    """Sampling pdf of wi given wo (non-delta lobes); (R,)."""
    pdf = torch.zeros_like(wo[..., 0])
    same = same_hemisphere(wo, wi)
    kind, rough = lanes.mat_type, lanes.roughness
    pdf = torch.where((kind == DIFFUSE) & same,
                      cosine_hemisphere_pdf(abs_cos_theta(wi)), pdf)
    wm = _half_vector(wo, wi)
    alpha = torch.clamp(rough, min=1e-4)
    pdf_c = safe_div(tr_d_visible(wo, wm, alpha), 4.0 * torch.abs(dot(wo, wm)),
                     0.0)
    pdf = torch.where((kind == CONDUCTOR) & (rough >= SMOOTH) & same, pdf_c,
                      pdf)
    a_ct = torch.clamp(rough, min=1e-3)
    pr_ct = fresnel_dielectric(abs_cos_theta(wo), lanes.eta)
    pdf_ct = (pr_ct * safe_div(tr_d_visible(wo, wm, a_ct),
                               4.0 * torch.abs(dot(wo, wm)), 0.0)
              + (1.0 - pr_ct) * cosine_hemisphere_pdf(abs_cos_theta(wi)))
    return torch.where((kind == COOK_TORRANCE) & same, pdf_ct, pdf)


def bsdf_sample(lanes: BSDFLanes, wo, u_lobe, u2) -> BSDFSample:
    """wi ~ BSDF. Delta lobes return pdf = 1 (the Fresnel pick for the
    dielectric) and f = weight / |cos wi|, as pbrt: callers scale beta by
    f |cos| / pdf."""
    R = wo.shape[:-1]
    dev = wo.device
    kind, rough, eta = lanes.mat_type, lanes.roughness, lanes.eta
    wi = torch.zeros_like(wo)
    f = torch.zeros_like(lanes.albedo)
    pdf = torch.zeros(R, device=dev)
    ones = torch.ones_like(lanes.albedo)
    flip = wo[..., 2] < 0  # wo below the surface: sample mirrored

    # diffuse
    is_d = kind == DIFFUSE
    wi_d = _flip_z(sample_cosine_hemisphere(u2), flip)
    pdf_d = cosine_hemisphere_pdf(abs_cos_theta(wi_d))
    wi = torch.where(is_d[..., None], wi_d, wi)
    f = torch.where(is_d[..., None], lanes.albedo * INV_PI, f)
    pdf = torch.where(is_d, pdf_d, pdf)
    valid = is_d & (pdf_d > 0)

    # smooth conductor: mirror reflection
    is_c = kind == CONDUCTOR
    smooth_c = is_c & (rough < SMOOTH)
    wi_m = torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], -1)
    f_m = (fresnel_schlick(abs_cos_theta(wo), lanes.albedo)
           * safe_div(1.0, abs_cos_theta(wi_m), 0.0)[..., None])
    wi = torch.where(smooth_c[..., None], wi_m, wi)
    f = torch.where(smooth_c[..., None], f_m, f)
    pdf = torch.where(smooth_c, 1.0, pdf)
    is_spec = smooth_c
    valid = valid | (smooth_c & (abs_cos_theta(wo) > 0))

    # rough conductor: visible-normal sample
    rough_c = is_c & ~smooth_c
    alpha = torch.clamp(rough, min=1e-4)
    wo_up = torch.where(flip[..., None], -wo, wo)
    wm = tr_sample_wm(wo_up, alpha, u2)
    wm = torch.where(flip[..., None], -wm, wm)
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
    smooth_d = kind == DIELECTRIC
    F = fresnel_dielectric(wo[..., 2], eta)
    refl = u_lobe < F
    n_local = torch.zeros_like(wo) + torch.tensor([0.0, 0.0, 1.0], device=dev)
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
    is_trans = smooth_d & ~refl
    eta_out = torch.where(is_trans, etap, torch.ones(R, device=dev))
    valid = valid | (smooth_d & sm_valid)

    # CookTorrance: Fresnel pick of the glossy or the diffuse lobe; f and
    # pdf are the whole two-lobe mixture (one-sample MIS)
    is_ct = kind == COOK_TORRANCE
    a_ct = torch.clamp(rough, min=1e-3)
    pick_gl = u_lobe < fresnel_dielectric(abs_cos_theta(wo), eta)
    wm_ct = tr_sample_wm(wo_up, a_ct, u2)
    wm_ct = torch.where(flip[..., None], -wm_ct, wm_ct)
    wi_ct = torch.where(pick_gl[..., None], _reflect(wo, wm_ct), wi_d)
    f_ct = bsdf_f(lanes, wo, wi_ct)
    pdf_ct = bsdf_pdf(lanes, wo, wi_ct)
    wi = torch.where(is_ct[..., None], wi_ct, wi)
    f = torch.where(is_ct[..., None], f_ct, f)
    pdf = torch.where(is_ct, pdf_ct, pdf)
    valid = valid | (is_ct & same_hemisphere(wo, wi_ct) & (pdf_ct > 0))
    return BSDFSample(wi, f, pdf, is_spec, is_trans, eta_out, valid)
