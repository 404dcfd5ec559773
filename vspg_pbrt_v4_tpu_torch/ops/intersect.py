"""Ray-primitive helpers (counterpart of ``ops/intersect.py``:
``ray_aabb``, ``aabb_normal``, ``ray_sphere``, ``ray_triangle`` and
``offset_ray_origin``).
Misses are encoded as t = inf and every function broadcasts over leading
ray dims."""

from __future__ import annotations

import torch

from ..utils.math import nanmax, nanmin, quadratic, safe_div
from ..utils.vecmath import cross, dot, length_squared, normalize


def ray_aabb(o, d, t_max, b_min, b_max):
    """Slab test: (hit, t0, t1) of the overlap of ray [0, t_max] with the
    box. IEEE inf arithmetic handles zero direction components; the NaNs
    of 0*inf are skipped by the NaN-ignoring reductions."""
    inv_d = 1.0 / d
    t_lo = (b_min - o) * inv_d
    t_hi = (b_max - o) * inv_d
    t_near = nanmax(torch.minimum(t_lo, t_hi))
    t_far = nanmin(torch.maximum(t_lo, t_hi))
    # conservative epsilon like pbrt's 1+2*gamma(3)
    t_far = t_far * (1.0 + 2.0 * 6.0 * 5.96e-08)
    t0 = torch.clamp(t_near, min=0.0)
    t1 = torch.minimum(t_far, t_max)
    return t0 <= t1, t0, t1


def aabb_normal(p, b_min, b_max):
    """Outward normal of the box face nearest to surface point p."""
    c = 0.5 * (b_min + b_max)
    half = 0.5 * (b_max - b_min)
    rel = safe_div(p - c, half, fill=0.0)
    amax = torch.argmax(torch.abs(rel), dim=-1)
    sign = torch.sign(torch.gather(rel, -1, amax[..., None]))[..., 0]
    one_hot = torch.arange(3, device=p.device) == amax[..., None]
    return torch.where(one_hot, sign[..., None], torch.zeros_like(rel))


def ray_sphere(o, d, t_max, center, radius):
    """(hit, t, p, n) of the full sphere: the world-space quadratic, the
    nearer root beyond 1e-4 * radius, the point reprojected onto the
    surface (pbrt's p *= radius / Distance)."""
    oc = o - center
    a = length_squared(d)
    b = 2.0 * dot(oc, d)
    c = length_squared(oc) - radius * radius
    has, t0, t1 = quadratic(a, b, c)
    eps = 1e-4 * radius
    t = torch.where(t0 > eps, t0, t1)
    hit = has & (t > eps) & (t < t_max)
    p = o + t[..., None] * d
    pr = center + (p - center) * safe_div(
        radius, torch.sqrt(length_squared(p - center)), 1.0)[..., None]
    return hit, torch.where(hit, t, torch.inf), pr, normalize(pr - center)


def ray_triangle(o, d, t_max, p0, p1, p2):
    """Möller-Trumbore: (hit, t, b0, b1, n_geom), the barycentric
    parameterization of pbrt's TriangleIntersect (b0 weighs p0)."""
    e1 = p1 - p0
    e2 = p2 - p0
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    inv_det = safe_div(1.0, det, fill=0.0)
    tvec = o - p0
    b1 = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    b2 = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    hit = ((torch.abs(det) > 1e-9) & (b1 >= 0.0) & (b2 >= 0.0)
           & (b1 + b2 <= 1.0) & (t > 1e-5) & (t < t_max))
    ng = normalize(cross(e1, e2))
    return hit, torch.where(hit, t, torch.inf), 1.0 - b1 - b2, b1, ng


def offset_ray_origin(p, n, w):
    """Offset a spawn point along the normal, signed toward w (scale-aware
    epsilon; pbrt's error-bound OffsetRayOrigin, simplified)."""
    scale = torch.clamp(torch.amax(torch.abs(p), dim=-1), min=1.0)
    eps = 1e-4 * scale
    sign = torch.where(dot(n, w) >= 0.0, 1.0, -1.0)
    return p + (sign * eps)[..., None] * n
