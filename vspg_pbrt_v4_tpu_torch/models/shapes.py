"""Scene geometry (counterpart of ``models/shapes.py``): flat triangles,
spheres and axis-aligned boxes, the shapes of the medium-container,
teaser, mesh and Cornell scenes.

Triangles are intersected by brute force, as the JAX package does for
scenes of at most ``MAX_BRUTE_TRIS`` triangles; above that
``Geometry.build`` builds a BVH over them (``ops/bvh.py``, the native
builder above 512 triangles when it loads, as in the JAX package), which
``intersect`` and ``intersect_p`` traverse. Spheres and boxes are always
tested by brute force. The kd-tree, the two-level BVH and the other
shapes of the JAX package are not ported yet.

Primitive ids are global, as in the JAX package: [0, T) triangles, then
[T, T + S) spheres, then [T + S, T + S + B) boxes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..ops.bvh import BVH, build_bvh, bvh_from_arrays, bvh_traverse
from ..ops.intersect import aabb_normal, ray_aabb, ray_sphere, ray_triangle
from ..utils.device import OnDevice
from ..utils.math import PI, nanmax, nanmin
from ..utils.vecmath import cross, normalize, spherical_phi, spherical_theta

# the JAX package intersects up to this many triangles by brute force and
# builds a BVH above it, natively above NATIVE_BVH_TRIS when it can
MAX_BRUTE_TRIS = 64
NATIVE_BVH_TRIS = 512


def build_tri_bvh(p0, p1, p2, *, device):
    """(BVH, builder name) over triangles (T, 3) numpy float32 corners,
    each box padded by 1e-5: the native builder above NATIVE_BVH_TRIS
    triangles when the library loads, else numpy (the JAX package's
    choice)."""
    from .. import native

    lo = np.minimum(np.minimum(p0, p1), p2) - 1e-5
    hi = np.maximum(np.maximum(p0, p1), p2) + 1e-5
    if p0.shape[0] > NATIVE_BVH_TRIS:
        arrays = native.build_bvh_native(lo, hi)
        if arrays is not None:
            return bvh_from_arrays(arrays, device=device), "native"
    return build_bvh(lo, hi, device=device), "numpy"


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


def _merge(best, closer, t, p, n, ns, uv, mat, light, mi, mo, pid):
    """`best` with the lanes of `closer` taking the given hit."""
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
    sph_c: torch.Tensor  # (S,3) centres
    sph_r: torch.Tensor  # (S,) radii
    sph_mat: torch.Tensor  # (S,) int32
    sph_light: torch.Tensor  # (S,) int32
    sph_med_in: torch.Tensor  # (S,) int32
    sph_med_out: torch.Tensor  # (S,) int32
    tri_bvh: BVH = None  # over the triangles; None = brute force

    @staticmethod
    def build(boxes=(), triangles=(), spheres=(), tri_meshes=(), *,
              device):
        """boxes: list of dicts {bmin, bmax, [mat], [light], [med_in],
        [med_out]}; triangles: list of dicts {p0, p1, p2, [n0, n1, n2],
        [uv0, uv1, uv2], [mat], [light], [med_in], [med_out]}; spheres:
        list of dicts {c, r, [mat], [light], [med_in], [med_out]};
        tri_meshes: whole meshes as array bundles {p0, p1, p2 (T,3)
        [, n0, n1, n2 (T,3)] [, uv0, uv1, uv2 (T,2)], mat, med_in,
        med_out}, placed after `triangles` (the JAX package's vectorised
        path for big meshes). Ids default to -1, uvs to the barycentric
        map, shading normals to the geometric normal, as in the JAX
        package; more than MAX_BRUTE_TRIS triangles get a BVH
        (``build_tri_bvh``)."""
        b, t, sp = list(boxes), list(triangles), list(spheres)

        def stack(items, key, default, width):
            if not items:
                return np.zeros((0, width), np.float32)
            return np.stack([np.asarray(it.get(key, default), np.float32)
                             for it in items])

        def ids_np(items, key):
            return np.asarray([int(it.get(key, -1)) for it in items],
                              np.int32)

        def ids(items, key):
            return torch.as_tensor(ids_np(items, key), device=device)

        def geometric(p0, p1, p2):
            ng = np.cross(p1 - p0, p2 - p0)
            return (ng / np.maximum(np.linalg.norm(ng, axis=-1,
                                                   keepdims=True),
                                    1e-20)).astype(np.float32)

        p0 = stack(t, "p0", (0, 0, 0), 3)
        p1 = stack(t, "p1", (0, 0, 0), 3)
        p2 = stack(t, "p2", (0, 0, 0), 3)
        ng = geometric(p0, p1, p2)
        if any("n0" in it for it in t):
            ns = [np.stack([np.asarray(it.get(k, ng[i]), np.float32)
                            for i, it in enumerate(t)])
                  for k in ("n0", "n1", "n2")]
        else:
            ns = [ng, ng, ng]
        uvs = [stack(t, "uv0", (1, 0), 2), stack(t, "uv1", (0, 1), 2),
               stack(t, "uv2", (0, 0), 2)]
        tid = [ids_np(t, k) for k in ("mat", "light", "med_in", "med_out")]
        for bund in tri_meshes:
            q = [np.asarray(bund[k], np.float32) for k in ("p0", "p1", "p2")]
            T = q[0].shape[0]
            bng = geometric(*q)
            p0, p1, p2 = (np.concatenate([a, c]) for a, c in
                          zip((p0, p1, p2), q))
            ns = [np.concatenate([a, np.asarray(bund.get(k, bng),
                                                np.float32)])
                  for a, k in zip(ns, ("n0", "n1", "n2"))]
            uvs = [np.concatenate([a, np.asarray(bund[k], np.float32)
                                   if k in bund else
                                   np.tile(np.float32(dflt), (T, 1))])
                   for a, k, dflt in zip(uvs, ("uv0", "uv1", "uv2"),
                                         ((1, 0), (0, 1), (0, 0)))]
            tid = [np.concatenate([a, np.broadcast_to(np.asarray(
                bund.get(k, -1), np.int32), (T,))])
                for a, k in zip(tid, ("mat", "light", "med_in", "med_out"))]

        def f(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=device)

        return Geometry(
            f(stack(b, "bmin", (0, 0, 0), 3)), f(stack(b, "bmax", (0, 0, 0), 3)),
            ids(b, "mat"), ids(b, "light"), ids(b, "med_in"),
            ids(b, "med_out"), f(p0), f(p1), f(p2), *(f(n) for n in ns),
            *(f(uv) for uv in uvs), *(f(i) for i in tid),
            f(stack(sp, "c", (0, 0, 0), 3)),
            torch.as_tensor([float(it["r"]) for it in sp],
                            dtype=torch.float32, device=device),
            ids(sp, "mat"), ids(sp, "light"), ids(sp, "med_in"),
            ids(sp, "med_out"),
            (build_tri_bvh(p0, p1, p2, device=device)[0]
             if p0.shape[0] > MAX_BRUTE_TRIS else None))

    @property
    def n_box(self):
        return self.box_min.shape[0]

    @property
    def n_sph(self):
        return self.sph_c.shape[0]

    @property
    def n_tri(self):
        return self.tri_p0.shape[0]

    def _check_brute_force(self):
        if self.n_tri > MAX_BRUTE_TRIS and self.tri_bvh is None:
            raise NotImplementedError(
                f"{self.n_tri} triangles without a BVH (brute force serves "
                f"at most {MAX_BRUTE_TRIS})")

    def intersect(self, o, d, t_max=None, time=None, counts=None):
        """Closest hit of every lane (o, d: (R, 3)) against the triangles,
        by brute force or through the BVH, then against every sphere and
        every box, in the JAX package's order.

        As in the JAX package, `t_max` does not bound the search: callers
        compare ``hit.t`` with their own limit. `time` is unused (no
        animated geometry). `counts` (a dict), when given, gathers the
        BVH traversal's node visits and triangle tests."""
        self._check_brute_force()
        R = o.shape[:-1]
        dev = o.device
        inf = torch.full(R, torch.inf, device=dev)
        neg = torch.full(R, -1, dtype=torch.int32, device=dev)
        best = HitRecord(torch.zeros(R, dtype=torch.bool, device=dev), inf,
                         torch.zeros_like(o), torch.zeros_like(o),
                         torch.zeros_like(o), torch.zeros(R + (2,), device=dev),
                         neg, neg, neg, neg, neg)

        def take(x, k):
            return torch.gather(x, -1, k[..., None])[..., 0]

        if self.n_tri and self.tri_bvh is not None:
            best = self._intersect_tris_bvh(o, d, best, counts)
        elif self.n_tri:
            ht, tt, b0, b1, ng = ray_triangle(
                o[..., None, :], d[..., None, :], best.t[..., None],
                self.tri_p0, self.tri_p1, self.tri_p2)  # (R, T)
            tt = torch.where(ht, tt, torch.inf)
            k = torch.argmin(tt, dim=-1)
            t_k = take(tt, k)
            closer = torch.isfinite(t_k) & (t_k < best.t)
            nsk, uvk = self._tri_attrs(k, take(b0, k), take(b1, k))
            best = _merge(best, closer, t_k, o + t_k[..., None] * d, ng[k],
                          nsk, uvk, self.tri_mat[k], self.tri_light[k],
                          self.tri_med_in[k], self.tri_med_out[k],
                          k.to(torch.int32))
        if self.n_sph:
            hs, ts, ps, ns_ = ray_sphere(o[..., None, :], d[..., None, :],
                                         best.t[..., None], self.sph_c,
                                         self.sph_r)  # (R, S)
            ts = torch.where(hs, ts, torch.inf)
            k = torch.argmin(ts, dim=-1)
            t_k = take(ts, k)
            closer = torch.isfinite(t_k) & (t_k < best.t)
            kk = k[..., None, None].expand(R + (1, 3))
            p_k = torch.gather(ps, -2, kk)[..., 0, :]
            n_k = torch.gather(ns_, -2, kk)[..., 0, :]
            # the spherical uv of shapes.h's Sphere parameterization
            uv_s = torch.stack([spherical_phi(n_k) / (2 * PI),
                                spherical_theta(n_k) / PI], -1)
            best = _merge(best, closer, t_k, p_k, n_k, n_k, uv_s,
                          self.sph_mat[k], self.sph_light[k],
                          self.sph_med_in[k], self.sph_med_out[k],
                          (self.n_tri + k).to(torch.int32))
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
            best = _merge(best, closer, t_k, p_k, n_k, n_k,
                          torch.zeros(R + (2,), device=dev), self.box_mat[k],
                          self.box_light[k], self.box_med_in[k],
                          self.box_med_out[k],
                          (self.n_tri + self.n_sph + k).to(torch.int32))
        return best

    def _tri_attrs(self, k, b0, b1):
        """Shading normal and uv of triangles k at barycentrics (b0, b1)."""
        b2 = 1.0 - b0 - b1
        ns = normalize(b0[..., None] * self.tri_n0[k]
                       + b1[..., None] * self.tri_n1[k]
                       + b2[..., None] * self.tri_n2[k])
        uv = (b0[..., None] * self.tri_uv0[k] + b1[..., None] * self.tri_uv1[k]
              + b2[..., None] * self.tri_uv2[k])
        return ns, uv

    def _intersect_tris_bvh(self, o, d, best, counts):
        """The closest triangle hit through the BVH
        (``_intersect_tris_bvh`` of the JAX package)."""
        R = o.shape[0]

        def leaf_fn(pid, m, t_best, payload):
            k_b, b0_b, b1_b = payload
            hit, t, b0, b1, _ = ray_triangle(
                o, d, t_best, self.tri_p0[pid], self.tri_p1[pid],
                self.tri_p2[pid])
            closer = m & hit
            return (torch.where(closer, t, t_best),
                    (torch.where(closer, pid.to(torch.int32), k_b),
                     torch.where(closer, b0, b0_b),
                     torch.where(closer, b1, b1_b)))

        payload0 = (torch.full((R,), -1, dtype=torch.int32, device=o.device),
                    torch.zeros(R, device=o.device),
                    torch.zeros(R, device=o.device))
        t_best, (k, b0k, b1k) = bvh_traverse(self.tri_bvh, o, d, best.t,
                                             leaf_fn, payload0,
                                             counts=counts)
        kc = torch.clamp(k, min=0).long()
        ngk = normalize(cross(self.tri_p1[kc] - self.tri_p0[kc],
                              self.tri_p2[kc] - self.tri_p0[kc]))
        nsk, uvk = self._tri_attrs(kc, b0k, b1k)
        return _merge(best, k >= 0, t_best, o + t_best[..., None] * d, ngk,
                      nsk, uvk, self.tri_mat[kc], self.tri_light[kc],
                      self.tri_med_in[kc], self.tri_med_out[kc],
                      kc.to(torch.int32))

    def intersect_p(self, o, d, t_max, time=None, counts=None):
        """Any hit of an opaque primitive (``mat >= 0``) within t_max:
        occlusion of shadow rays; interface-only primitives never
        occlude. `counts` as for ``intersect``."""
        self._check_brute_force()
        occluded = torch.zeros(o.shape[:-1], dtype=torch.bool,
                               device=o.device)
        if self.n_tri and self.tri_bvh is not None:
            def leaf_fn(pid, m, t_best, occ):
                hit = ray_triangle(o, d, t_best, self.tri_p0[pid],
                                   self.tri_p1[pid], self.tri_p2[pid])[0]
                occ_new = occ | (m & hit & (self.tri_mat[pid] >= 0))
                # a lane once occluded culls the rest of its walk
                return torch.where(occ_new, 0.0, t_best), occ_new

            occluded = bvh_traverse(self.tri_bvh, o, d, t_max, leaf_fn,
                                    occluded, counts=counts)[1]
        elif self.n_tri:
            ht = ray_triangle(o[..., None, :], d[..., None, :],
                              t_max[..., None], self.tri_p0, self.tri_p1,
                              self.tri_p2)[0]
            occluded = occluded | torch.any(ht & (self.tri_mat >= 0), dim=-1)
        if self.n_sph:
            hs = ray_sphere(o[..., None, :], d[..., None, :],
                            t_max[..., None], self.sph_c, self.sph_r)[0]
            occluded = occluded | torch.any(hs & (self.sph_mat >= 0), dim=-1)
        if self.n_box:
            hb, t0, t1 = ray_aabb(o[..., None, :], d[..., None, :],
                                  t_max[..., None], self.box_min,
                                  self.box_max)
            crossing = hb & ((t0 > 1e-4) | (t1 < t_max[..., None] - 1e-4))
            occluded = occluded | torch.any(crossing & (self.box_mat >= 0),
                                            dim=-1)
        return occluded
