"""Sampling warps and the Henyey-Greenstein phase function (counterpart
of ``utils/sampling.py``, only what the ported integrators use)."""

from __future__ import annotations

import torch

from .math import INV_4PI, INV_PI, PI, safe_div, safe_sqrt, sqr
from .vecmath import coordinate_system, spherical_direction


def sample_exponential(u, a):
    """t ~ a exp(-a t) (sampling.h SampleExponential)."""
    return -torch.log1p(-u) / a


def sample_uniform_sphere(u2):
    z = 1.0 - 2.0 * u2[..., 0]
    r = safe_sqrt(1.0 - sqr(z))
    phi = 2.0 * PI * u2[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def sample_uniform_disk_concentric(u2):
    """Shirley's concentric square-to-disk map."""
    ox = 2.0 * u2[..., 0] - 1.0
    oy = 2.0 * u2[..., 1] - 1.0
    zero = (ox == 0) & (oy == 0)
    use_x = torch.abs(ox) > torch.abs(oy)
    r = torch.where(use_x, ox, oy)
    theta = torch.where(use_x, (PI / 4.0) * safe_div(oy, ox),
                        (PI / 2.0) - (PI / 4.0) * safe_div(ox, oy))
    p = r[..., None] * torch.stack([torch.cos(theta), torch.sin(theta)], -1)
    return torch.where(zero[..., None], 0.0, p)


def sample_uniform_disk_polar(u2):
    r = torch.sqrt(u2[..., 0])
    theta = 2.0 * PI * u2[..., 1]
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], -1)


def sample_cosine_hemisphere(u2):
    d = sample_uniform_disk_concentric(u2)
    z = safe_sqrt(1.0 - sqr(d[..., 0]) - sqr(d[..., 1]))
    return torch.stack([d[..., 0], d[..., 1], z], -1)


def sample_uniform_triangle(u2):
    """Barycentrics (b0, b1, b2) uniform on the simplex (sqrt-free
    variant)."""
    u0, u1 = u2[..., 0], u2[..., 1]
    flip = u0 < u1
    b0 = torch.where(flip, u0 / 2.0, u0 - u1 / 2.0)
    b1 = torch.where(flip, u1 - b0, u1 / 2.0)
    return torch.stack([b0, b1, 1.0 - b0 - b1], dim=-1)


def cosine_hemisphere_pdf(cos_theta):
    return cos_theta * INV_PI


def henyey_greenstein(cos_theta, g):
    """HG phase value p(cos θ) (sampling.h HenyeyGreenstein)."""
    g = torch.clamp(g, -0.99, 0.99)
    denom = 1.0 + sqr(g) + 2.0 * g * cos_theta
    return INV_4PI * (1.0 - sqr(g)) * safe_div(1.0, denom * safe_sqrt(denom),
                                               fill=0.0)


def sample_henyey_greenstein(wo, g, u2):
    """wi ~ HG with pbrt's convention (wo points back toward the camera;
    cos θ is measured in the +wo frame). Returns (wi, pdf)."""
    g = torch.clamp(g, -0.99, 0.99)
    u0, u1 = u2[..., 0], u2[..., 1]
    iso = torch.abs(g) < 1e-3
    cos_theta_iso = 1.0 - 2.0 * u0
    sqr_term = safe_div(1.0 - sqr(g), 1.0 + g - 2.0 * g * u0)
    cos_theta_g = -safe_div(1.0 + sqr(g) - sqr(sqr_term), 2.0 * g, fill=0.0)
    cos_theta = torch.where(iso, cos_theta_iso, cos_theta_g)
    sin_theta = safe_sqrt(1.0 - sqr(cos_theta))
    phi = 2.0 * PI * u1
    t1, t2 = coordinate_system(wo)
    local = spherical_direction(sin_theta, cos_theta, phi)
    wi = local[..., 0:1] * t1 + local[..., 1:2] * t2 + local[..., 2:3] * wo
    return wi, henyey_greenstein(cos_theta, g)
