"""Scene geometry (counterpart of ``models/shapes.py``): axis-aligned boxes
only, which is what the medium-container scenes of this package hold.

Triangles, spheres and the other shapes of the JAX package are not ported
yet. A Geometry converted from a JAX scene that has triangles keeps their
count, so the kernel dispatch can refuse it, and ``intersect`` raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..ops.intersect import aabb_normal
from ..utils.device import OnDevice
from ..utils.math import nanmax, nanmin


class HitRecord(NamedTuple):
    hit: torch.Tensor  # (R,) bool
    t: torch.Tensor  # (R,)
    p: torch.Tensor  # (R,3)
    n: torch.Tensor  # (R,3) geometric normal
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
    n_tri: int = 0  # triangles of the source scene (not ported)

    @staticmethod
    def build(boxes=(), *, device):
        """boxes: list of dicts {bmin, bmax, [mat], [light], [med_in],
        [med_out]} (ids default to -1, as in the JAX package)."""
        b = list(boxes)

        def stack(key):
            if not b:
                return torch.zeros((0, 3), dtype=torch.float32, device=device)
            return torch.as_tensor(
                np.stack([np.asarray(it[key], np.float32) for it in b]),
                device=device)

        def stack_i(key):
            return torch.as_tensor([int(it.get(key, -1)) for it in b],
                                   dtype=torch.int32, device=device)

        return Geometry(stack("bmin"), stack("bmax"), stack_i("mat"),
                        stack_i("light"), stack_i("med_in"),
                        stack_i("med_out"))

    @property
    def n_box(self):
        return self.box_min.shape[0]

    def intersect(self, o, d, t_max=None, time=None):
        """Closest hit of every lane against every box (brute force).

        As in the JAX package, `t_max` does not bound the search: callers
        compare ``hit.t`` with their own limit. `time` is unused (no
        animated geometry)."""
        if self.n_tri:
            raise NotImplementedError("triangle geometry is not ported yet")
        R = o.shape[:-1]
        dev = o.device
        inf = torch.full(R, torch.inf, device=dev)
        neg = torch.full(R, -1, dtype=torch.int32, device=dev)
        best = HitRecord(torch.zeros(R, dtype=torch.bool, device=dev), inf,
                         torch.zeros_like(o), torch.zeros_like(o),
                         neg, neg, neg, neg, neg)
        if self.n_box == 0:
            return best
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
        t_k = torch.gather(t_c, -1, k[..., None])[..., 0]
        closer = torch.isfinite(t_k) & (t_k < best.t)
        p_k = o + t_k[..., None] * d
        n_k = aabb_normal(p_k, self.box_min[k], self.box_max[k])
        c3 = closer[..., None]
        return HitRecord(
            best.hit | closer, torch.where(closer, t_k, best.t),
            torch.where(c3, p_k, best.p), torch.where(c3, n_k, best.n),
            torch.where(closer, self.box_mat[k], best.mat_id),
            torch.where(closer, self.box_light[k], best.light_id),
            torch.where(closer, self.box_med_in[k], best.med_in),
            torch.where(closer, self.box_med_out[k], best.med_out),
            torch.where(closer, k.to(torch.int32), best.prim_id))
