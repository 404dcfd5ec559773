"""Portal image infinite light (counterpart of ``models/portal_light.py``;
lights.h PortalImageInfiniteLight:700).

An environment light seen only through a planar rectangular portal:

- Directions are reparameterized in the portal's frame by
  (alpha, beta) = (atan(x/z), atan(y/z)) (lights.cpp ImageFromRender /
  RenderFromImage), so the directions through the portal from any point
  form an axis-aligned uv rectangle (ImageBounds).
- The environment is warped into this parameterization once, on the
  host, when the light is made; sampling restricted to the visible window
  reads a summed-area table (util/sampling.h
  WindowedPiecewiseConstant2D), inverted by a fixed number of bisection
  steps over every lane at once in place of a binary search.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.device import OnDevice
from ..utils.math import PI, safe_div
from ..utils.vecmath import dot, length, normalize

# bisection steps of sample_window's two inversions, as the JAX package's
_BISECT_STEPS = 20


@dataclass(frozen=True)
class PortalLight(OnDevice):
    img: torch.Tensor  # (S,S,3) radiance in portal uv
    sat: torch.Tensor  # (S+1,S+1) summed-area table of luminance
    p0: torch.Tensor  # (3,) portal corners (planar quad, CCW)
    p1: torch.Tensor
    p2: torch.Tensor
    p3: torch.Tensor
    x_axis: torch.Tensor  # (3,) the portal's frame
    y_axis: torch.Tensor
    z_axis: torch.Tensor  # faces the lit side

    @staticmethod
    def make(env_fn, corners, res=128, *, device):
        """corners: 4 CCW points of the planar portal; env_fn(dirs (N,3)
        numpy) -> (N,3) world radiance, evaluated on the portal-uv grid
        (the reference's image warp, lights.cpp:~750)."""
        c = [np.asarray(p, np.float64) for p in corners]
        x = c[1] - c[0]
        y = c[3] - c[0]
        xn = x / np.linalg.norm(x)
        yn = y / np.linalg.norm(y)
        zn = np.cross(xn, yn)
        zn = zn / np.linalg.norm(zn)
        # the uv grid -> directions -> radiance
        s = (np.arange(res) + 0.5) / res
        u, v = np.meshgrid(s, s, indexing="xy")
        tx = np.tan((u - 0.5) * np.pi)
        ty = np.tan((v - 0.5) * np.pi)
        d_local = np.stack([tx, ty, np.ones_like(tx)], -1)
        d_local /= np.linalg.norm(d_local, axis=-1, keepdims=True)
        d_world = (d_local[..., 0:1] * xn + d_local[..., 1:2] * yn
                   + d_local[..., 2:3] * zn)
        img = np.asarray(env_fn(d_world.reshape(-1, 3)),
                         np.float32).reshape(res, res, 3)
        lum = img.mean(-1).astype(np.float64)
        sat = np.zeros((res + 1, res + 1), np.float64)
        sat[1:, 1:] = lum.cumsum(0).cumsum(1)
        sat /= max(sat[-1, -1], 1e-20)

        def t(a):
            return torch.as_tensor(np.array(a, np.float32), device=device)

        return PortalLight(t(img), t(sat), t(c[0]), t(c[1]), t(c[2]),
                           t(c[3]), t(xn), t(yn), t(zn))

    # -- direction <-> uv ---------------------------------------------------
    def uv_of_dir(self, w):
        """World directions -> (uv (...,2), valid, |d(omega)/d(uv)|)
        (lights.cpp PortalImageInfiniteLight::ImageFromRender)."""
        wl = torch.stack([dot(w, self.x_axis), dot(w, self.y_axis),
                          dot(w, self.z_axis)], -1)
        z = wl[..., 2]
        valid = z > 1e-7
        zs = torch.where(valid, z, 1.0)
        ta = wl[..., 0] / zs
        tb = wl[..., 1] / zs
        u = torch.clamp(torch.atan(ta) / PI + 0.5, 0.0, 1.0)
        v = torch.clamp(torch.atan(tb) / PI + 0.5, 0.0, 1.0)
        # |J| = pi^2 (1 + tan^2 a)(1 + tan^2 b) cos^3 theta
        cos_t = zs / torch.clamp(length(wl), min=1e-12)
        jac = PI * PI * (1 + ta * ta) * (1 + tb * tb) * cos_t ** 3
        return torch.stack([u, v], -1), valid, torch.clamp(jac, min=1e-12)

    def dir_of_uv(self, uv):
        """(RenderFromImage)."""
        ta = torch.tan((uv[..., 0] - 0.5) * PI)
        tb = torch.tan((uv[..., 1] - 0.5) * PI)
        dl = torch.stack([ta, tb, torch.ones_like(ta)], -1)
        dl = dl / torch.clamp(length(dl), min=1e-12)[..., None]
        return (dl[..., 0:1] * self.x_axis + dl[..., 1:2] * self.y_axis
                + dl[..., 2:3] * self.z_axis)

    def image_bounds(self, p):
        """The uv window of the portal seen from p (ImageBounds): (lo, hi,
        valid)."""
        uv0, v0, _ = self.uv_of_dir(normalize(self.p0 - p))
        uv2, v2, _ = self.uv_of_dir(normalize(self.p2 - p))
        return torch.minimum(uv0, uv2), torch.maximum(uv0, uv2), v0 & v2

    # -- windowed sampling by the summed-area table ---------------------------
    def _sat_at(self, u, v):
        """Bilinear lookup of the table at continuous (u, v) in [0, 1]."""
        S = self.sat.shape[0] - 1
        x = torch.clamp(u * S, 0.0, S)
        y = torch.clamp(v * S, 0.0, S)
        x0 = torch.floor(x).to(torch.int64)
        y0 = torch.floor(y).to(torch.int64)
        x1 = torch.clamp(x0 + 1, max=S)
        y1 = torch.clamp(y0 + 1, max=S)
        fx = x - x0
        fy = y - y0
        return ((1 - fx) * (1 - fy) * self.sat[y0, x0]
                + fx * (1 - fy) * self.sat[y0, x1]
                + (1 - fx) * fy * self.sat[y1, x0]
                + fx * fy * self.sat[y1, x1])

    def _window_integral(self, lo_u, lo_v, hi_u, hi_v):
        return (self._sat_at(hi_u, hi_v) - self._sat_at(lo_u, hi_v)
                - self._sat_at(hi_u, lo_v) + self._sat_at(lo_u, lo_v))

    def sample_window(self, lo, hi, u2):
        """uv ~ image luminance restricted to [lo, hi]
        (WindowedPiecewiseConstant2D::Sample by bisection): (uv, pdf_uv)."""
        lo_u, lo_v = lo[..., 0], lo[..., 1]
        hi_u, hi_v = hi[..., 0], hi[..., 1]
        # the marginal in u: F(x) = I(lo_u..x, the whole v window)
        total = self._window_integral(lo_u, lo_v, hi_u, hi_v)
        a, b = lo_u, hi_u
        for _ in range(_BISECT_STEPS):
            m = 0.5 * (a + b)
            fm = safe_div(self._window_integral(lo_u, lo_v, m, hi_v), total,
                          0.0)
            go_hi = fm < u2[..., 0]
            a = torch.where(go_hi, m, a)
            b = torch.where(go_hi, b, m)
        u = 0.5 * (a + b)
        # the conditional in v at u (a strip one texel wide around u)
        eps = 1.0 / (self.sat.shape[0] - 1)
        su0 = torch.clamp(u - 0.5 * eps, lo_u, hi_u)
        su1 = torch.clamp(u + 0.5 * eps, lo_u, hi_u)
        strip = self._window_integral(su0, lo_v, su1, hi_v)
        a, b = lo_v, hi_v
        for _ in range(_BISECT_STEPS):
            m = 0.5 * (a + b)
            fm = safe_div(self._window_integral(su0, lo_v, su1, m), strip,
                          0.0)
            go_hi = fm < u2[..., 1]
            a = torch.where(go_hi, m, a)
            b = torch.where(go_hi, b, m)
        uv = torch.stack([u, 0.5 * (a + b)], -1)
        return uv, self.pdf_window(lo, hi, uv)

    def _texel(self, uv):
        S = self.img.shape[0]
        ix = torch.clamp((uv[..., 0] * S).to(torch.int64), 0, S - 1)
        iy = torch.clamp((uv[..., 1] * S).to(torch.int64), 0, S - 1)
        return self.img[iy, ix]

    def pdf_window(self, lo, hi, uv):
        """The windowed pdf of uv: the luminance at uv over the whole
        square's mean, over the window's share of the table."""
        f = torch.mean(self._texel(uv), -1)
        total = self._window_integral(lo[..., 0], lo[..., 1], hi[..., 0],
                                      hi[..., 1])
        whole = torch.clamp(torch.mean(self.img.mean(-1)), min=1e-20)
        f_norm = safe_div(f, whole, 0.0)
        return safe_div(f_norm, torch.clamp(total, min=1e-12), 0.0)

    # -- the light's interface -------------------------------------------------
    def le(self, w, o=None):
        """Escaped-ray radiance: nonzero only where the ray (o, w) passes
        through the portal (lights.cpp PortalImageInfiniteLight::Le tests
        Inside(uv, ImageBounds(ray.o)))."""
        uv, valid, _ = self.uv_of_dir(w)
        if o is not None:
            lo, hi, okb = self.image_bounds(o)
            valid = (valid & okb
                     & (uv[..., 0] >= lo[..., 0]) & (uv[..., 0] <= hi[..., 0])
                     & (uv[..., 1] >= lo[..., 1]) & (uv[..., 1] <= hi[..., 1]))
        return torch.where(valid[..., None], self._texel(uv), 0.0)

    def sample_li(self, p, u2):
        """An incident direction at p through the portal: (wi, L,
        pdf_solid, valid)."""
        lo, hi, ok = self.image_bounds(p)
        uv, pdf_uv = self.sample_window(lo, hi, u2)
        wi = self.dir_of_uv(uv)
        _, _, jac = self.uv_of_dir(wi)
        pdf_solid = safe_div(pdf_uv, jac, 0.0)  # p_w = p_uv / |J|
        ok = ok & (pdf_solid > 0)
        return (wi, torch.where(ok[..., None], self._texel(uv), 0.0),
                pdf_solid, ok)

    def pdf_li(self, p, wi):
        """The solid-angle pdf of ``sample_li`` at p for direction wi."""
        lo, hi, ok = self.image_bounds(p)
        uv, valid, jac = self.uv_of_dir(wi)
        inside = (valid & ok
                  & (uv[..., 0] >= lo[..., 0]) & (uv[..., 0] <= hi[..., 0])
                  & (uv[..., 1] >= lo[..., 1]) & (uv[..., 1] <= hi[..., 1]))
        pdf_uv = self.pdf_window(lo, hi, uv)
        return torch.where(inside, safe_div(pdf_uv, jac, 0.0), 0.0)
