"""Scene geometry (counterpart of ``models/shapes.py``): flat triangles and
axis-aligned boxes, the shapes of the medium-container and teaser scenes.

Triangles are intersected by brute force, as the JAX package does for
scenes of at most ``MAX_BRUTE_TRIS`` triangles; larger meshes need the BVH
(``ops/bvh.py``), which is not ported, so ``intersect`` raises for them.
Spheres and the other shapes of the JAX package are not ported yet.

Primitive ids are global, as in the JAX package: [0, T) triangles, then
[T, T + B) boxes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..ops.intersect import aabb_normal, ray_aabb, ray_triangle
from ..utils.device import OnDevice
from ..utils.math import nanmax, nanmin
from ..utils.vecmath import normalize

# the JAX package intersects up to this many triangles by brute force and
# builds a BVH above it
MAX_BRUTE_TRIS = 64


class HitRecord(NamedTuple):
    hit: torch.Tensor  # (R,) bool
    t: torch.Tensor  # (R,)
    p: torch.Tensor  # (R,3)
    n: torch.Tensor  # (R,3) geometric normal
    ns: torch.Tensor  # (R,3) shading normal
    uv: torch.Tensor  # (R,2)
    mat_id: torch.Tensor  # (R,) int32, -1 = interface-only
    light_id: torch.Tensor  # (R,) int32 area light id, -1 = none
    med_in: torch.Tensor  # (R,) int32 medium opposite the normal
    med_out: torch.Tensor  # (R,) int32 medium on the normal side
    prim_id: torch.Tensor  # (R,) int32 global primitive id


@dataclass(frozen=True)
class Geometry(OnDevice):
    box_min: torch.Tensor  # (B,3)
    box_max: torch.Tensor  # (B,3)
    box_mat: torch.Tensor  # (B,) int32
    box_light: torch.Tensor  # (B,) int32
    box_med_in: torch.Tensor  # (B,) int32
    box_med_out: torch.Tensor  # (B,) int32
    tri_p0: torch.Tensor  # (T,3)
    tri_p1: torch.Tensor
    tri_p2: torch.Tensor
    tri_n0: torch.Tensor  # (T,3) shading normals (geometric if absent)
    tri_n1: torch.Tensor
    tri_n2: torch.Tensor
    tri_uv0: torch.Tensor  # (T,2) per-corner texture coordinates
    tri_uv1: torch.Tensor
    tri_uv2: torch.Tensor
    tri_mat: torch.Tensor  # (T,) int32
    tri_light: torch.Tensor  # (T,) int32
    tri_med_in: torch.Tensor  # (T,) int32
    tri_med_out: torch.Tensor  # (T,) int32

    @staticmethod
    def build(boxes=(), triangles=(), *, device):
        """boxes: list of dicts {bmin, bmax, [mat], [light], [med_in],
        [med_out]}; triangles: list of dicts {p0, p1, p2, [n0, n1, n2],
        [uv0, uv1, uv2], [mat], [light], [med_in], [med_out]}. Ids default
        to -1, uvs to the barycentric map, shading normals to the
        geometric normal, as in the JAX package."""
        b, t = list(boxes), list(triangles)

        def stack(items, key, default, width):
            if not items:
                return np.zeros((0, width), np.float32)
            return np.stack([np.asarray(it.get(key, default), np.float32)
                             for it in items])

        def ids(items, key):
            return torch.as_tensor([int(it.get(key, -1)) for it in items],
                                   dtype=torch.int32, device=device)

        p0 = stack(t, "p0", (0, 0, 0), 3)
        p1 = stack(t, "p1", (0, 0, 0), 3)
        p2 = stack(t, "p2", (0, 0, 0), 3)
        ng = np.cross(p1 - p0, p2 - p0)
        ng = (ng / np.maximum(np.linalg.norm(ng, axis=-1, keepdims=True),
                              1e-20)).astype(np.float32)
        if any("n0" in it for it in t):
            ns = [np.stack([np.asarray(it.get(k, ng[i]), np.float32)
                            for i, it in enumerate(t)])
                  for k in ("n0", "n1", "n2")]
        else:
            ns = [ng, ng, ng]

        def f(a):
            return torch.as_tensor(a, device=device)

        return Geometry(
            f(stack(b, "bmin", (0, 0, 0), 3)), f(stack(b, "bmax", (0, 0, 0), 3)),
            ids(b, "mat"), ids(b, "light"), ids(b, "med_in"),
            ids(b, "med_out"), f(p0), f(p1), f(p2), *(f(n) for n in ns),
            f(stack(t, "uv0", (1, 0), 2)), f(stack(t, "uv1", (0, 1), 2)),
            f(stack(t, "uv2", (0, 0), 2)), ids(t, "mat"), ids(t, "light"),
            ids(t, "med_in"), ids(t, "med_out"))

    @property
    def n_box(self):
        return self.box_min.shape[0]

    @property
    def n_tri(self):
        return self.tri_p0.shape[0]

    def _check_brute_force(self):
        if self.n_tri > MAX_BRUTE_TRIS:
            raise NotImplementedError(
                f"{self.n_tri} triangles need the BVH, which is not ported "
                f"yet (brute force serves at most {MAX_BRUTE_TRIS})")

    def intersect(self, o, d, t_max=None, time=None):
        """Closest hit of every lane against every triangle, then every
        box (brute force, in the JAX package's order).

        As in the JAX package, `t_max` does not bound the search: callers
        compare ``hit.t`` with their own limit. `time` is unused (no
        animated geometry)."""
        self._check_brute_force()
        R = o.shape[:-1]
        dev = o.device
        inf = torch.full(R, torch.inf, device=dev)
        neg = torch.full(R, -1, dtype=torch.int32, device=dev)
        best = HitRecord(torch.zeros(R, dtype=torch.bool, device=dev), inf,
                         torch.zeros_like(o), torch.zeros_like(o),
                         torch.zeros_like(o), torch.zeros(R + (2,), device=dev),
                         neg, neg, neg, neg, neg)

        def upd(best, closer, t, p, n, ns, uv, mat, light, mi, mo, pid):
            c1, c3 = closer, closer[..., None]
            return HitRecord(
                best.hit | c1, torch.where(c1, t, best.t),
                torch.where(c3, p, best.p), torch.where(c3, n, best.n),
                torch.where(c3, ns, best.ns), torch.where(c3, uv, best.uv),
                torch.where(c1, mat, best.mat_id),
                torch.where(c1, light, best.light_id),
                torch.where(c1, mi, best.med_in),
                torch.where(c1, mo, best.med_out),
                torch.where(c1, pid, best.prim_id))

        def take(x, k):
            return torch.gather(x, -1, k[..., None])[..., 0]

        if self.n_tri:
            ht, tt, b0, b1, ng = ray_triangle(
                o[..., None, :], d[..., None, :], best.t[..., None],
                self.tri_p0, self.tri_p1, self.tri_p2)  # (R, T)
            tt = torch.where(ht, tt, torch.inf)
            k = torch.argmin(tt, dim=-1)
            t_k = take(tt, k)
            closer = torch.isfinite(t_k) & (t_k < best.t)
            b0k, b1k = take(b0, k), take(b1, k)
            b2k = 1.0 - b0k - b1k
            nsk = normalize(b0k[..., None] * self.tri_n0[k]
                            + b1k[..., None] * self.tri_n1[k]
                            + b2k[..., None] * self.tri_n2[k])
            uvk = (b0k[..., None] * self.tri_uv0[k]
                   + b1k[..., None] * self.tri_uv1[k]
                   + b2k[..., None] * self.tri_uv2[k])
            best = upd(best, closer, t_k, o + t_k[..., None] * d, ng[k], nsk,
                       uvk, self.tri_mat[k], self.tri_light[k],
                       self.tri_med_in[k], self.tri_med_out[k],
                       k.to(torch.int32))
        if self.n_box:
            eps = 1e-4
            inv_d = 1.0 / d[..., None, :]
            t_lo = (self.box_min - o[..., None, :]) * inv_d
            t_hi = (self.box_max - o[..., None, :]) * inv_d
            t_near = nanmax(torch.minimum(t_lo, t_hi))
            t_far = nanmin(torch.maximum(t_lo, t_hi))
            valid = t_near <= t_far
            t_c = torch.where(t_near > eps, t_near, t_far)
            t_c = torch.where(valid & (t_c > eps), t_c, torch.inf)
            k = torch.argmin(t_c, dim=-1)
            t_k = take(t_c, k)
            closer = torch.isfinite(t_k) & (t_k < best.t)
            p_k = o + t_k[..., None] * d
            n_k = aabb_normal(p_k, self.box_min[k], self.box_max[k])
            best = upd(best, closer, t_k, p_k, n_k, n_k,
                       torch.zeros(R + (2,), device=dev), self.box_mat[k],
                       self.box_light[k], self.box_med_in[k],
                       self.box_med_out[k], (self.n_tri + k).to(torch.int32))
        return best

    def intersect_p(self, o, d, t_max, time=None):
        """Any hit of an opaque primitive (``mat >= 0``) within t_max:
        occlusion of shadow rays; interface-only primitives never
        occlude."""
        self._check_brute_force()
        occluded = torch.zeros(o.shape[:-1], dtype=torch.bool,
                               device=o.device)
        if self.n_tri:
            ht = ray_triangle(o[..., None, :], d[..., None, :],
                              t_max[..., None], self.tri_p0, self.tri_p1,
                              self.tri_p2)[0]
            occluded = occluded | torch.any(ht & (self.tri_mat >= 0), dim=-1)
        if self.n_box:
            hb, t0, t1 = ray_aabb(o[..., None, :], d[..., None, :],
                                  t_max[..., None], self.box_min,
                                  self.box_max)
            crossing = hb & ((t0 > 1e-4) | (t1 < t_max[..., None] - 1e-4))
            occluded = occluded | torch.any(crossing & (self.box_mat >= 0),
                                            dim=-1)
        return occluded
