"""Vector geometry over ``(..., 3)`` tensors (counterpart of
``utils/vecmath.py``, only what the ported integrators and media use)."""

from __future__ import annotations

import torch

from .math import PI, safe_acos, safe_div, safe_sqrt, sqr


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def length_squared(v):
    return dot(v, v)


def cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def length(v):
    return torch.sqrt(length_squared(v))


def distance(a, b):
    return length(a - b)


def normalize(v):
    return v * safe_div(1.0, torch.sqrt(dot(v, v)), fill=0.0)[..., None]


def face_forward(n, v):
    """Flip n into the hemisphere of v (pbrt FaceForward)."""
    return torch.where(dot(n, v)[..., None] < 0, -n, n)


def coordinate_system(v):
    """Orthonormal (t1, t2) around unit v (Duff et al. branchless)."""
    z = v[..., 2]
    sign = torch.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + z)
    b = v[..., 0] * v[..., 1] * a
    t1 = torch.stack(
        [1.0 + sign * sqr(v[..., 0]) * a, sign * b, -sign * v[..., 0]], dim=-1)
    t2 = torch.stack([b, sign + sqr(v[..., 1]) * a, -v[..., 1]], dim=-1)
    return t1, t2


def abs_cos_theta(w):
    return torch.abs(w[..., 2])


def tan2_theta(w):
    """tan^2 of the local-frame polar angle; inf at cos = 0."""
    c2 = sqr(w[..., 2])
    return safe_div(torch.clamp(1.0 - c2, min=0.0), c2, fill=torch.inf)


def same_hemisphere(w, wp):
    return w[..., 2] * wp[..., 2] > 0


def spherical_direction(sin_theta, cos_theta, phi):
    sin_theta = torch.clamp(sin_theta, -1.0, 1.0)
    cos_theta = torch.clamp(cos_theta, -1.0, 1.0)
    return torch.stack([sin_theta * torch.cos(phi), sin_theta * torch.sin(phi),
                        cos_theta], dim=-1)


def spherical_theta(v):
    return safe_acos(v[..., 2])


def spherical_phi(v):
    p = torch.atan2(v[..., 1], v[..., 0])
    return torch.where(p < 0, p + 2.0 * PI, p)


def equal_area_square_to_sphere(p):
    """[0, 1]^2 -> unit sphere, Clarberg's low-distortion equal-area map."""
    u = 2.0 * p[..., 0] - 1.0
    v = 2.0 * p[..., 1] - 1.0
    up, vp = torch.abs(u), torch.abs(v)
    sd = 1.0 - (up + vp)
    d = torch.abs(sd)
    r = 1.0 - d
    phi = torch.where(r == 0, 1.0, (vp - up) / torch.where(r == 0, 1.0, r)
                      + 1.0) * PI / 4.0
    z = (1.0 - sqr(r)) * torch.sign(sd)
    cos_phi = torch.cos(phi) * torch.sign(u)
    sin_phi = torch.sin(phi) * torch.sign(v)
    scale = r * safe_sqrt(2.0 - sqr(r))
    return torch.stack([cos_phi * scale, sin_phi * scale, z], dim=-1)


def equal_area_sphere_to_square(d):
    """Clarberg's equal-area map of unit directions to [0, 1]^2."""
    x, y, z = torch.abs(d[..., 0]), torch.abs(d[..., 1]), torch.abs(d[..., 2])
    r = safe_sqrt(1.0 - z)
    a = torch.maximum(x, y)
    b = torch.minimum(x, y)
    b = torch.where(a == 0, 0.0, safe_div(b, a))
    phi = torch.atan(b) * (2.0 / PI)
    phi = torch.where(x < y, 1.0 - phi, phi)
    v_ = phi * r
    u_ = r - v_
    # southern hemisphere: fold
    u_s = torch.where(d[..., 2] < 0, 1.0 - v_, u_)
    v_s = torch.where(d[..., 2] < 0, 1.0 - u_, v_)
    u_f = u_s * torch.sign(d[..., 0])
    v_f = v_s * torch.sign(d[..., 1])
    return torch.stack([0.5 * (u_f + 1.0), 0.5 * (v_f + 1.0)], dim=-1)
