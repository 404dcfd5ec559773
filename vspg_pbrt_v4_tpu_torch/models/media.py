"""Participating media (counterpart of ``models/media.py``).

- ``Media``: a block of homogeneous media, a tuple of ``GridMedium`` and a
  tuple of procedural media (medium ids: [0, n_homog) homogeneous |
  n_homog + i for grids[i] | base_procedural + j for procedurals[j]).
- ``GridMedium``: a dense density grid with a conservative max-pooled
  majorant supergrid, walked by a per-lane 3D DDA (``SegIter``,
  ``seg_init``/``seg_next``) in the collision loops.
- ``CloudMedium``: pbrt's procedural cumulus (fBm Perlin density with a
  domain warp), one constant-majorant segment clipped to its bounds.

RGB grids and the planet-scale ``EarthMedium`` of the JAX package are not
ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..utils.device import OnDevice
from ..utils.math import nanmax, nanmin
from ..utils.noise import perlin


class MediumProperties(NamedTuple):
    sigma_a: torch.Tensor  # (R,3)
    sigma_s: torch.Tensor  # (R,3)
    Le: torch.Tensor  # (R,3) emission
    g: torch.Tensor  # (R,) HG asymmetry


def _trilerp(grid, b_min, b_max, res, p):
    """Trilinear lookup of the (nx,ny,nz) `grid` at world p; clamp-to-edge
    inside, zero outside [b_min, b_max] (GridMedium::Density)."""
    nx, ny, nz = res
    resf = torch.tensor([nx, ny, nz], dtype=torch.float32, device=p.device)
    hi = torch.tensor([nx - 1, ny - 1, nz - 1], device=p.device)
    g = (p - b_min) / (b_max - b_min) * resf - 0.5
    g0 = torch.floor(g)
    w = g - g0
    i0 = torch.minimum(torch.clamp(g0.to(torch.int64), min=0), hi)
    i1 = torch.minimum(torch.clamp(i0 + 1, min=0), hi)

    def at(ix, iy, iz):
        return grid[ix, iy, iz]

    def lerp(a, b, t):
        return a * (1 - t) + b * t

    d00 = lerp(at(i0[..., 0], i0[..., 1], i0[..., 2]),
               at(i1[..., 0], i0[..., 1], i0[..., 2]), w[..., 0])
    d10 = lerp(at(i0[..., 0], i1[..., 1], i0[..., 2]),
               at(i1[..., 0], i1[..., 1], i0[..., 2]), w[..., 0])
    d01 = lerp(at(i0[..., 0], i0[..., 1], i1[..., 2]),
               at(i1[..., 0], i0[..., 1], i1[..., 2]), w[..., 0])
    d11 = lerp(at(i0[..., 0], i1[..., 1], i1[..., 2]),
               at(i1[..., 0], i1[..., 1], i1[..., 2]), w[..., 0])
    d0 = lerp(d00, d10, w[..., 1])
    d1 = lerp(d01, d11, w[..., 1])
    out = lerp(d0, d1, w[..., 2])
    inside = torch.all((p >= b_min) & (p <= b_max), dim=-1)
    return torch.where(inside, out, torch.zeros_like(out))


def max_pool_majorant(density, maj_res):
    """Conservative max-pooled majorant of a numpy (nx,ny,nz) density: each
    supervoxel's pool includes a one-voxel halo, so trilinear
    interpolation never exceeds its supervoxel's majorant."""
    d = np.asarray(density, np.float32)
    nx, ny, nz = d.shape
    mx, my, mz = maj_res
    maj = np.zeros((mx, my, mz), np.float32)
    xs = np.linspace(0, nx, mx + 1).astype(int)
    ys = np.linspace(0, ny, my + 1).astype(int)
    zs = np.linspace(0, nz, mz + 1).astype(int)
    for i in range(mx):
        x0, x1 = max(xs[i] - 1, 0), min(xs[i + 1] + 1, nx)
        for j in range(my):
            y0, y1 = max(ys[j] - 1, 0), min(ys[j + 1] + 1, ny)
            for k in range(mz):
                z0, z1 = max(zs[k] - 1, 0), min(zs[k + 1] + 1, nz)
                maj[i, j, k] = d[x0:x1, y0:y1, z0:z1].max()
    return maj


@dataclass(frozen=True)
class GridMedium(OnDevice):
    """Axis-aligned dense density grid; density scales sigma_a/sigma_s."""

    density: torch.Tensor  # (nx, ny, nz) nonneg
    sigma_a: torch.Tensor  # (3,) base absorption
    sigma_s: torch.Tensor  # (3,) base scattering
    Le: torch.Tensor  # (3,) emission
    g: torch.Tensor  # () HG asymmetry
    b_min: torch.Tensor  # (3,) world bounds
    b_max: torch.Tensor  # (3,)
    majorant: torch.Tensor  # (mx, my, mz) max density per supervoxel
    res: tuple  # (nx, ny, nz)
    maj_res: tuple  # (mx, my, mz)

    @staticmethod
    def make(density, sigma_a, sigma_s, b_min, b_max, g=0.0, Le=None,
             maj_res=16, majorant_scale=1.0, *, device):
        """density: numpy (nx,ny,nz). The majorant grid is built host-side
        (``max_pool_majorant``)."""
        d = np.asarray(density, np.float32)
        nx, ny, nz = d.shape
        if isinstance(maj_res, int):
            maj_res = (min(maj_res, nx), min(maj_res, ny), min(maj_res, nz))
        maj = max_pool_majorant(d, maj_res) * np.float32(majorant_scale)

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        return GridMedium(f32(d), f32(sigma_a), f32(sigma_s),
                          f32(np.zeros(3) if Le is None else Le), f32(g),
                          f32(b_min), f32(b_max), f32(maj), (nx, ny, nz),
                          tuple(int(v) for v in maj_res))

    def density_at(self, p):
        """Trilinear density at world p (GridMedium::Density)."""
        return _trilerp(self.density, self.b_min, self.b_max, self.res, p)


@dataclass(frozen=True)
class CloudMedium(OnDevice):
    """Procedural cumulus cloud (pbrt's CloudMedium): fBm Perlin density
    with a two-octave domain warp (wispiness) and altitude shaping,
    clamped to [0, 1], zero outside [b_min, b_max]; the majorant is the
    constant sigma_a + sigma_s."""

    sigma_a: torch.Tensor  # (3,)
    sigma_s: torch.Tensor  # (3,)
    g: torch.Tensor  # ()
    b_min: torch.Tensor  # (3,)
    b_max: torch.Tensor  # (3,)
    density: torch.Tensor  # () overall density scale
    wispiness: torch.Tensor  # ()
    frequency: torch.Tensor  # ()

    @staticmethod
    def make(sigma_a=(1, 1, 1), sigma_s=(1, 1, 1), g=0.0, p0=(0, 0, 0),
             p1=(1, 1, 1), density=1.0, wispiness=1.0, frequency=5.0, *,
             device):
        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        return CloudMedium(f32(sigma_a), f32(sigma_s), f32(g), f32(p0),
                           f32(p1), f32(density), f32(wispiness),
                           f32(frequency))

    def density_at(self, p):
        pp = self.frequency * p
        # wispiness: two octaves of vector noise from three decorrelated
        # Perlin channels perturb the lookup point
        dev = p.device
        shifts = [torch.tensor(v, device=dev) for v in
                  ((31.7, 0.0, 0.0), (0.0, 57.3, 0.0), (0.0, 0.0, 91.1))]
        vomega = 0.05 * self.wispiness
        vlam = 10.0
        for _ in range(2):
            dn = torch.stack([perlin(vlam * pp + sh) for sh in shifts], -1)
            pp = pp + vomega * dn
            vomega = vomega * 0.5
            vlam = vlam * 1.99
        # five octaves of fBm
        d = torch.zeros(p.shape[:-1], device=dev)
        omega, lam = 0.5, 1.0
        for _ in range(5):
            d = d + omega * perlin(lam * pp)
            omega *= 0.5
            lam *= 1.99
        # altitude shaping
        d = torch.clamp((1.0 - p[..., 1]) * 4.5 * self.density * d, 0.0, 1.0)
        d = d + 2.0 * torch.clamp(0.5 - p[..., 1], min=0.0)
        inside = torch.all((p >= self.b_min) & (p <= self.b_max), -1)
        return torch.where(inside, torch.clamp(d, 0.0, 1.0), 0.0)

    def majorant_rgb(self):
        return self.sigma_a + self.sigma_s  # density <= 1

    def sigma_at(self, p):
        d = self.density_at(p)[..., None]
        return d * self.sigma_a, d * self.sigma_s


@dataclass(frozen=True)
class Media(OnDevice):
    """All media of a scene: a homogeneous block, a tuple of grids and a
    tuple of procedural media."""

    h_sigma_a: torch.Tensor  # (Mh,3)
    h_sigma_s: torch.Tensor  # (Mh,3)
    h_Le: torch.Tensor  # (Mh,3)
    h_g: torch.Tensor  # (Mh,)
    grids: tuple = ()  # tuple[GridMedium]
    procedurals: tuple = ()  # tuple[CloudMedium]

    @staticmethod
    def make(homogeneous=None, grids=(), procedurals=(), *, device):
        """homogeneous: list of dicts {sigma_a, sigma_s, [Le], [g]}."""
        h = list(homogeneous or [])

        def f32(x, shape):
            a = np.asarray(x, np.float32).reshape(shape)
            return torch.as_tensor(a, device=device)

        n = len(h)
        return Media(
            f32([m["sigma_a"] for m in h], (n, 3)),
            f32([m["sigma_s"] for m in h], (n, 3)),
            f32([m.get("Le", (0, 0, 0)) for m in h], (n, 3)),
            f32([m.get("g", 0.0) for m in h], (n,)),
            tuple(gm.to(device) for gm in grids),
            tuple(pm.to(device) for pm in procedurals))

    @property
    def n_homog(self):
        return self.h_sigma_a.shape[0]

    @property
    def base_procedural(self):
        return self.n_homog + len(self.grids)

    def is_homogeneous(self, medium_id):
        return (medium_id >= 0) & (medium_id < self.n_homog)

    def sample_point(self, medium_id, p) -> MediumProperties:
        """Medium properties at p; medium_id < 0 -> vacuum."""
        shape3 = tuple(medium_id.shape) + (3,)
        dev = p.device
        if self.n_homog > 0:
            mid = torch.clamp(medium_id, 0, self.n_homog - 1).long()
            is_h = self.is_homogeneous(medium_id)[..., None]
            zero = torch.zeros(shape3, device=dev)
            sigma_a = torch.where(is_h, self.h_sigma_a[mid], zero)
            sigma_s = torch.where(is_h, self.h_sigma_s[mid], zero)
            Le = torch.where(is_h, self.h_Le[mid], zero)
            g = torch.where(is_h[..., 0], self.h_g[mid],
                            torch.zeros(medium_id.shape, device=dev))
        else:
            sigma_a = torch.zeros(shape3, device=dev)
            sigma_s = torch.zeros(shape3, device=dev)
            Le = torch.zeros(shape3, device=dev)
            g = torch.zeros(medium_id.shape, device=dev)
        for i, gm in enumerate(self.grids):
            sel = medium_id == self.n_homog + i
            dens = gm.density_at(p)
            s3 = sel[..., None]
            sigma_a = torch.where(s3, dens[..., None] * gm.sigma_a, sigma_a)
            sigma_s = torch.where(s3, dens[..., None] * gm.sigma_s, sigma_s)
            Le = torch.where(s3, gm.Le, Le)
            g = torch.where(sel, gm.g, g)
        for j, pm in enumerate(self.procedurals):
            sel = medium_id == self.base_procedural + j
            sa_p, ss_p = pm.sigma_at(p)
            sigma_a = torch.where(sel[..., None], sa_p, sigma_a)
            sigma_s = torch.where(sel[..., None], ss_p, sigma_s)
            g = torch.where(sel, pm.g, g)
        return MediumProperties(sigma_a, sigma_s, Le, g)


class HomogeneousMedia:
    """Constructor shim of the JAX package:
    ``HomogeneousMedia.make(sigma_a, sigma_s, Le, g, device=...)``."""

    @staticmethod
    def make(sigma_a, sigma_s, Le=None, g=None, *, device):
        sa = np.atleast_2d(np.asarray(sigma_a, np.float32))
        ss = np.atleast_2d(np.asarray(sigma_s, np.float32))
        m = sa.shape[0]
        le = (np.zeros((m, 3), np.float32) if Le is None
              else np.atleast_2d(np.asarray(Le, np.float32)))
        gg = (np.zeros((m,), np.float32) if g is None
              else np.atleast_1d(np.asarray(g, np.float32)))
        return Media.make([dict(sigma_a=sa[i], sigma_s=ss[i], Le=le[i],
                                g=float(gg[i])) for i in range(m)],
                          device=device)


# ---------------------------------------------------------------------------
# Per-lane majorant segment iterator (DDAMajorantIterator, vectorized)
# ---------------------------------------------------------------------------


class SegIter(NamedTuple):
    """Per-lane majorant-segment cursor for the collision loops."""

    t_seg_start: torch.Tensor  # (R,)
    t_seg_end: torch.Tensor  # (R,)
    sigma_maj: torch.Tensor  # (R,3) of the current segment
    voxel: torch.Tensor  # (R,3) int64 DDA voxel (grid lanes)
    t_next: torch.Tensor  # (R,3) next axis crossings
    t_delta: torch.Tensor  # (R,3)
    step: torch.Tensor  # (R,3) int64 +-1
    t_exit: torch.Tensor  # (R,) medium exit along the ray
    done: torch.Tensor  # (R,) iterator exhausted


def seg_init(media: Media, medium_id, o, d, t_max, active) -> SegIter:
    """Start the per-lane segment iterator over [0, t_max]: one segment for
    homogeneous lanes; grid lanes clip to the grid bounds and set up the
    DDA over the majorant supergrid; procedural lanes take one segment
    clipped to their bounds."""
    R = tuple(o.shape[:-1])
    dev = o.device
    zero = torch.zeros_like(t_max)
    is_h = media.is_homogeneous(medium_id)
    if media.n_homog > 0:
        mid = torch.clamp(medium_id, 0, media.n_homog - 1).long()
        sigma_maj = torch.where(is_h[..., None],
                                media.h_sigma_a[mid] + media.h_sigma_s[mid],
                                torch.zeros(R + (3,), device=dev))
    else:
        sigma_maj = torch.zeros(R + (3,), device=dev)
    n_known = media.base_procedural + len(media.procedurals)
    it = SegIter(
        t_seg_start=zero,
        t_seg_end=torch.where(is_h, t_max, zero),
        sigma_maj=sigma_maj,
        voxel=torch.zeros(R + (3,), dtype=torch.int64, device=dev),
        t_next=torch.full(R + (3,), torch.inf, device=dev),
        t_delta=torch.full(R + (3,), torch.inf, device=dev),
        step=torch.zeros(R + (3,), dtype=torch.int64, device=dev),
        t_exit=torch.where(is_h, t_max, zero),
        done=~active,
    )
    done = ~active | (medium_id < 0) | (medium_id >= n_known)
    for i, gm in enumerate(media.grids):
        sel = active & (medium_id == media.n_homog + i)
        mx, my, mz = gm.maj_res
        mres = torch.tensor([mx, my, mz], dtype=torch.float32, device=dev)
        mhi = torch.tensor([mx - 1, my - 1, mz - 1], device=dev)
        inv_d = 1.0 / d
        t_lo = (gm.b_min - o) * inv_d
        t_hi = (gm.b_max - o) * inv_d
        t0 = torch.clamp(nanmax(torch.minimum(t_lo, t_hi)), min=0.0)
        t1 = torch.minimum(nanmin(torch.maximum(t_lo, t_hi)), t_max)
        miss = t0 >= t1
        ext = gm.b_max - gm.b_min
        p0 = o + (t0 + 1e-6)[..., None] * d  # nudge inside
        gpos = (p0 - gm.b_min) / ext * mres
        vox = torch.minimum(torch.clamp(gpos.to(torch.int64), min=0), mhi)
        d_idx = d / ext * mres  # velocity in index space
        step = torch.where(d_idx >= 0, 1, -1)
        next_bound = vox + (step > 0).long()
        tiny = torch.abs(d_idx) < 1e-20
        safe_inv = 1.0 / torch.where(
            tiny, torch.where(d_idx >= 0, 1e-20, -1e-20), d_idx)
        t_next = t0[..., None] + (next_bound.float() - gpos) * safe_inv
        t_next = torch.where(tiny, torch.inf, t_next)
        t_delta = torch.abs(safe_inv)
        seg_end = torch.minimum(torch.amin(t_next, -1), t1)
        maj_dens = gm.majorant[vox[..., 0], vox[..., 1], vox[..., 2]]
        smaj = maj_dens[..., None] * (gm.sigma_a + gm.sigma_s)
        s3 = sel[..., None]
        it = it._replace(
            t_seg_start=torch.where(sel, t0, it.t_seg_start),
            t_seg_end=torch.where(sel, torch.where(miss, t0, seg_end),
                                  it.t_seg_end),
            sigma_maj=torch.where(s3, smaj, it.sigma_maj),
            voxel=torch.where(s3, vox, it.voxel),
            t_next=torch.where(s3, t_next, it.t_next),
            t_delta=torch.where(s3, t_delta, it.t_delta),
            step=torch.where(s3, step, it.step),
            t_exit=torch.where(sel, t1, it.t_exit),
        )
        done = done | (sel & miss)
    for j, pm in enumerate(media.procedurals):
        sel = active & (medium_id == media.base_procedural + j)
        inv_d = 1.0 / d
        t_lo = (pm.b_min - o) * inv_d
        t_hi = (pm.b_max - o) * inv_d
        t0 = torch.clamp(nanmax(torch.minimum(t_lo, t_hi)), min=0.0)
        t1 = torch.minimum(nanmin(torch.maximum(t_lo, t_hi)), t_max)
        miss = t0 >= t1
        smaj = torch.broadcast_to(pm.majorant_rgb(), it.sigma_maj.shape)
        it = it._replace(
            t_seg_start=torch.where(sel, t0, it.t_seg_start),
            t_seg_end=torch.where(sel, torch.where(miss, t0, t1),
                                  it.t_seg_end),
            sigma_maj=torch.where(sel[..., None], smaj, it.sigma_maj),
            t_exit=torch.where(sel, t1, it.t_exit))
        done = done | (sel & miss)
    return it._replace(done=done)


def seg_next(media: Media, medium_id, it: SegIter, want) -> SegIter:
    """Advance lanes in `want` (and not exhausted) to their next segment."""
    want = want & ~it.done
    # homogeneous and procedural lanes have one segment
    one_seg = media.is_homogeneous(medium_id) | (
        medium_id >= media.base_procedural)
    out = it._replace(done=it.done | (want & one_seg))
    for i, gm in enumerate(media.grids):
        sel = (medium_id == media.n_homog + i) & want
        mx, my, mz = gm.maj_res
        mhi = torch.tensor([mx - 1, my - 1, mz - 1], device=it.voxel.device)
        # step along the axis with the smallest t_next (first on ties)
        axis = torch.argmin(it.t_next, dim=-1)
        one_hot = torch.arange(3, device=axis.device) == axis[..., None]
        vox = it.voxel + torch.where(one_hot, it.step, 0)
        t_next = it.t_next + torch.where(one_hot, it.t_delta, 0.0)
        t_start = it.t_seg_end
        out_of_grid = (
            (vox[..., 0] < 0) | (vox[..., 0] >= mx)
            | (vox[..., 1] < 0) | (vox[..., 1] >= my)
            | (vox[..., 2] < 0) | (vox[..., 2] >= mz)
            | (t_start >= it.t_exit - 1e-7))
        vox_c = torch.minimum(torch.clamp(vox, min=0), mhi)
        seg_end = torch.minimum(torch.amin(t_next, -1), it.t_exit)
        maj_dens = gm.majorant[vox_c[..., 0], vox_c[..., 1], vox_c[..., 2]]
        smaj = maj_dens[..., None] * (gm.sigma_a + gm.sigma_s)
        s3 = sel[..., None]
        out = out._replace(
            t_seg_start=torch.where(sel, t_start, out.t_seg_start),
            t_seg_end=torch.where(sel, seg_end, out.t_seg_end),
            sigma_maj=torch.where(s3, smaj, out.sigma_maj),
            voxel=torch.where(s3, vox_c, out.voxel),
            t_next=torch.where(s3, t_next, out.t_next),
            done=torch.where(sel, out_of_grid, out.done),
        )
    return out
