"""Subsurface scattering (counterpart of ``models/bssrdf.py``): a separable
BSSRDF with probe-ray exit sampling, as the JAX package redesigns pbrt's
TabulatedBSSRDF (bssrdf.h:135-308) and the integrators' SampleSSS.

- The radial profile is the normalised Burley/Christensen two-exponential
  Sr(r) = (e^{-r/d} + e^{-r/(3d)}) / (8 pi d r), not pbrt's photon-beam
  diffusion tables: closed form and exactly invertible.
- The probe ray runs along the entry shading normal (one axis), not pbrt's
  three-axis, three-channel MIS; the flat-geometry Jacobian applies at the
  exit, and the weight is clamped.

Material rows of kind SUBSURFACE: albedo = the single-scattering albedo
A, albedo2 = the diffusion mean free path d a channel, eta = the
interface's IOR.
"""

from __future__ import annotations

import torch

from ..utils.math import PI, int_pow, safe_div
from ..utils.vecmath import dot

TWO_PI = 6.283185307179586


def burley_s(albedo):
    """The scaling factor s(A) (Christensen-Burley 2015, eq. 6)."""
    return 1.9 - albedo + 3.5 * int_pow(albedo - 0.8, 2)


def sr_area_pdf(r, d):
    """The radial pdf in area measure, 2 pi r Sr(r) = (e^{-r/d} +
    e^{-r/3d}) / (4d), which integrates to 1 over r >= 0."""
    d = torch.clamp(d, min=1e-6)
    return (torch.exp(-r / d) + torch.exp(-r / (3.0 * d))) / (4.0 * d)


def sample_sr(u1, u2, d):
    """r from the two-exponential mixture: weight 1/4 on e^{-r/d}, 3/4 on
    e^{-r/3d}."""
    d = torch.clamp(d, min=1e-6)
    scale = torch.where(u1 >= 0.25, 3.0 * d, d)
    return -scale * torch.log(torch.clamp(u2, min=1e-9))


def fresnel_moment1(eta):
    """The first Fresnel moment's polynomial fit (bssrdf.cpp
    FresnelMoment1)."""
    eta2 = eta * eta
    eta3 = eta2 * eta
    eta4 = eta3 * eta
    eta5 = eta4 * eta
    lo = (0.45966 - 1.73965 * eta + 3.37668 * eta2 - 3.904945 * eta3
          + 2.49277 * eta4 - 0.68441 * eta5)
    hi = (-4.61686 + 11.1136 * eta - 10.4646 * eta2 + 5.11455 * eta3
          - 1.27198 * eta4 + 0.12746 * eta5)
    return torch.where(eta < 1.0, lo, hi)


def sw(cos_theta, eta):
    """The directional entrance / exit factor (SeparableBSSRDF::Sw):
    (1 - Fr(cos)) / (c pi), c = 1 - 2 FresnelMoment1(1/eta)."""
    from .materials import fresnel_dielectric

    c = 1.0 - 2.0 * fresnel_moment1(1.0 / eta)
    return ((1.0 - fresnel_dielectric(cos_theta, eta))
            / torch.clamp(c * PI, min=1e-6))


def sample_exit_point(geometry, p, ns, t1, t2, mat_id, d_hero, u1, u2, u_phi,
                      active):
    """Probe-ray exit sampling: a disk offset in the entry's tangent frame
    at a radius r ~ Sr, then a probe along -ns through the surface; its
    first hit of the same material is the exit. Returns (ok, p_exit,
    n_exit facing ns, r, |cos| at the exit)."""
    r = sample_sr(u1, u2, d_hero)
    r_max = 12.0 * torch.clamp(d_hero, min=1e-6)
    r = torch.minimum(r, r_max)
    phi = TWO_PI * u_phi
    # r_max^2 - r^2 as the JAX package's compiled render computes it: XLA
    # contracts it into fma(r_max, r_max, -(r * r)), the first product
    # exact (here through float64). Where the radius was clamped to r_max
    # that leaves r_max^2's rounding error instead of 0, so the probe
    # starts that far off the surface and finds the exit; without the
    # contraction those lanes (about 1.4% of the transmitted ones) die.
    rm64 = r_max.double()
    h2 = (rm64 * rm64 - (r * r).double()).float()
    h = torch.sqrt(torch.clamp(h2, min=1e-12))
    offset = r[..., None] * (torch.cos(phi)[..., None] * t1
                             + torch.sin(phi)[..., None] * t2)
    o_probe = p + offset + h[..., None] * ns
    d_probe = -ns
    hit = geometry.intersect(o_probe, d_probe, 2.0 * h)
    same = hit.hit & (hit.mat_id == mat_id) & active
    cos_exit = torch.abs(dot(hit.n, d_probe))
    return same, hit.p, torch.where(dot(hit.n, ns)[..., None] < 0, -hit.n,
                                    hit.n), r, cos_exit


def sp_weight(p_entry, p_exit, albedo, d, r_sampled, cos_exit):
    """The estimator's weight Sp / pdf for the perpendicular probe: the
    profile at the true exit distance over the disk pdf at the sampled
    radius and the exit's |cos|, clamped to 4 A."""
    dp = p_exit - p_entry
    r_true = torch.clamp(torch.sqrt(torch.sum(dp * dp, -1)), min=1e-6)
    num = sr_area_pdf(r_true[..., None], d)  # the profile a channel
    den = sr_area_pdf(r_sampled[..., None], torch.mean(d, -1, keepdim=True))
    w = (albedo * safe_div(num, den, 0.0)
         / torch.clamp(cos_exit, min=0.1)[..., None])
    return torch.minimum(torch.clamp(w, min=0.0), 4.0 * albedo + 1e-6)
