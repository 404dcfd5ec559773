"""Participating media (counterpart of ``models/media.py``).

- ``Media``: a block of homogeneous media, a tuple of grids
  (``GridMedium`` or ``RGBGridMedium``) and a tuple of procedural media
  (``CloudMedium`` or ``EarthMedium``) (medium ids: [0, n_homog)
  homogeneous | n_homog + i for grids[i] | base_procedural + j for
  procedurals[j]).
- ``GridMedium``: a dense density grid with a conservative max-pooled
  majorant supergrid, walked by a per-lane 3D DDA (``SegIter``,
  ``seg_init``/``seg_next``) in the collision loops.
- ``RGBGridMedium``: per-voxel RGB sigma_a and sigma_s grids with an
  optional RGB emission grid, and a per-channel majorant supergrid walked
  by the same DDA.
- ``CloudMedium``: pbrt's procedural cumulus (fBm Perlin density with a
  domain warp), one constant-majorant segment clipped to its bounds.
- ``EarthMedium``: the fork's planet-scale medium, an exponential
  atmosphere around a sphere and a cloud shell whose radius comes from an
  equal-area heightmap; one constant-majorant segment like the cloud.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..utils.device import OnDevice
from ..utils.math import PI, nanmax, nanmin
from ..utils.noise import perlin
from ..utils.vecmath import (distance, equal_area_sphere_to_square, length,
                             normalize)


class MediumProperties(NamedTuple):
    sigma_a: torch.Tensor  # (R,3)
    sigma_s: torch.Tensor  # (R,3)
    Le: torch.Tensor  # (R,3) emission
    g: torch.Tensor  # (R,) HG asymmetry


def _trilerp(grid, b_min, b_max, res, p):
    """Trilinear lookup of the (nx,ny,nz) or (nx,ny,nz,C) `grid` at world
    p; clamp-to-edge inside, zero outside [b_min, b_max]
    (GridMedium::Density)."""
    nx, ny, nz = res
    resf = torch.tensor([nx, ny, nz], dtype=torch.float32, device=p.device)
    hi = torch.tensor([nx - 1, ny - 1, nz - 1], device=p.device)
    g = (p - b_min) / (b_max - b_min) * resf - 0.5
    g0 = torch.floor(g)
    w = g - g0
    i0 = torch.minimum(torch.clamp(g0.to(torch.int64), min=0), hi)
    i1 = torch.minimum(torch.clamp(i0 + 1, min=0), hi)

    has_c = grid.dim() == 4

    def at(ix, iy, iz):
        return grid[ix, iy, iz]

    def lerp(a, b, t):
        t = t[..., None] if has_c else t
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
    if has_c:
        inside = inside[..., None]
    return torch.where(inside, out, torch.zeros_like(out))


def max_pool_majorant(density, maj_res):
    """Conservative max-pooled majorant of a numpy (nx,ny,nz) density, or
    per channel of an (nx,ny,nz,C) one: each supervoxel's pool includes a
    one-voxel halo, so trilinear interpolation never exceeds its
    supervoxel's majorant."""
    d = np.asarray(density, np.float32)
    nx, ny, nz = d.shape[:3]
    mx, my, mz = maj_res
    maj = np.zeros((mx, my, mz) + d.shape[3:], np.float32)
    xs = np.linspace(0, nx, mx + 1).astype(int)
    ys = np.linspace(0, ny, my + 1).astype(int)
    zs = np.linspace(0, nz, mz + 1).astype(int)
    for i in range(mx):
        x0, x1 = max(xs[i] - 1, 0), min(xs[i + 1] + 1, nx)
        for j in range(my):
            y0, y1 = max(ys[j] - 1, 0), min(ys[j + 1] + 1, ny)
            for k in range(mz):
                z0, z1 = max(zs[k] - 1, 0), min(zs[k + 1] + 1, nz)
                maj[i, j, k] = d[x0:x1, y0:y1, z0:z1].max((0, 1, 2))
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
class RGBGridMedium(OnDevice):
    """Dense per-voxel RGB coefficient grids (media.h RGBGridMedium):
    sigma_a and sigma_s stored as full RGB a voxel (not density times a
    base colour), an optional RGB emission grid scaled by Le_scale. The
    majorant supergrid holds the per-channel maximum of sigma_t over each
    supervoxel and its one-voxel halo."""

    sigma_a_grid: torch.Tensor  # (nx,ny,nz,3)
    sigma_s_grid: torch.Tensor  # (nx,ny,nz,3)
    Le_grid: torch.Tensor  # (nx,ny,nz,3), or (1,1,1,3) zeros: no emission
    Le_scale: torch.Tensor  # ()
    g: torch.Tensor  # ()
    b_min: torch.Tensor  # (3,)
    b_max: torch.Tensor  # (3,)
    majorant: torch.Tensor  # (mx,my,mz,3) per-channel sigma_t maximum
    res: tuple  # (nx, ny, nz)
    maj_res: tuple  # (mx, my, mz)

    @staticmethod
    def make(sigma_a, sigma_s, b_min, b_max, Le=None, Le_scale=1.0, g=0.0,
             maj_res=16, majorant_scale=1.0, *, device):
        """sigma_a, sigma_s: numpy (nx,ny,nz,3). The majorant grid is built
        host-side (``max_pool_majorant`` of sigma_a + sigma_s)."""
        sa = np.asarray(sigma_a, np.float32)
        ss = np.asarray(sigma_s, np.float32)
        assert sa.ndim == 4 and sa.shape[-1] == 3, sa.shape
        nx, ny, nz = sa.shape[:3]
        if isinstance(maj_res, int):
            maj_res = (min(maj_res, nx), min(maj_res, ny), min(maj_res, nz))
        maj = max_pool_majorant(sa + ss, maj_res) * np.float32(majorant_scale)
        le = (np.zeros((1, 1, 1, 3), np.float32) if Le is None
              else np.asarray(Le, np.float32))

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        return RGBGridMedium(f32(sa), f32(ss), f32(le), f32(Le_scale), f32(g),
                             f32(b_min), f32(b_max), f32(maj), (nx, ny, nz),
                             tuple(int(v) for v in maj_res))

    def sigma_at(self, p):
        """(sigma_a, sigma_s) RGB at world p."""
        sa = _trilerp(self.sigma_a_grid, self.b_min, self.b_max, self.res, p)
        ss = _trilerp(self.sigma_s_grid, self.b_min, self.b_max, self.res, p)
        return sa, ss

    def le_at(self, p):
        """Emitted radiance at world p; zeros without an emission grid."""
        if self.Le_grid.shape[0] == 1:
            return torch.zeros(p.shape[:-1] + (3,), device=p.device)
        return self.Le_scale * _trilerp(self.Le_grid, self.b_min, self.b_max,
                                        self.res, p)


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
class EarthMedium(OnDevice):
    """The fork's planet-scale medium (media.h EarthMedium): an atmosphere
    of exponential falloff around a sphere plus a binary cloud shell whose
    outer radius comes from an equal-area heightmap, zero outside
    [b_min, b_max]; the majorant is a constant over the bounds."""

    sigma_a_atm: torch.Tensor  # (3,) pre-scaled by scale_atm
    sigma_s_atm: torch.Tensor  # (3,)
    sigma_a_cloud: torch.Tensor  # (3,) pre-scaled by scale_cloud
    sigma_s_cloud: torch.Tensor  # (3,)
    g: torch.Tensor  # ()
    b_min: torch.Tensor  # (3,)
    b_max: torch.Tensor  # (3,)
    center: torch.Tensor  # (3,)
    inner_r_atm: torch.Tensor  # ()
    inner_r_cloud: torch.Tensor  # ()
    outer_r_atm: torch.Tensor  # ()
    outer_r_cloud: torch.Tensor  # ()
    decay: torch.Tensor  # () the atmosphere's scale height
    majorant_scale: torch.Tensor  # ()
    density_offset: torch.Tensor  # ()
    rotation_y: torch.Tensor  # () radians: the heightmap's longitude shift
    heightmap: torch.Tensor  # (H,W) greyscale in [0, 1]

    @staticmethod
    def make(sigma_a_atm=(1, 1, 1), sigma_s_atm=(1, 1, 1),
             sigma_a_cloud=(0, 0, 0), sigma_s_cloud=(0, 0, 0), g=0.0,
             p0=(-2, -2, -2), p1=(2, 2, 2), center=(0, 0, 0),
             inner_r_atm=1.0, inner_r_cloud=1.0, outer_r_atm=1.0,
             outer_r_cloud=1.0, decay=1.0, majorant_scale=1.0,
             density_offset=0.0, rotation_y=0.0, heightmap=None,
             scale_atm=1.0, scale_cloud=1.0, *, device):
        """rotation_y in degrees; heightmap: numpy (H,W) or None (a
        constant shell at inner_r_cloud)."""
        def f32(x):
            return np.asarray(x, np.float32)

        def t(x):
            return torch.as_tensor(f32(x), device=device)

        hm = (np.zeros((1, 1), np.float32) if heightmap is None
              else f32(heightmap))
        sa, sc = np.float32(scale_atm), np.float32(scale_cloud)
        return EarthMedium(
            t(f32(sigma_a_atm) * sa), t(f32(sigma_s_atm) * sa),
            t(f32(sigma_a_cloud) * sc), t(f32(sigma_s_cloud) * sc), t(g),
            t(p0), t(p1), t(center), t(inner_r_atm), t(inner_r_cloud),
            t(outer_r_atm), t(outer_r_cloud), t(decay), t(majorant_scale),
            t(density_offset), t(np.radians(rotation_y)), t(hm))

    def _exp_density(self, p):
        """exp(-altitude / h) + densityOffset (media.h:861-866)."""
        dist = distance(p, self.center) - self.inner_r_atm
        dist = torch.minimum(torch.clamp(dist, min=0.0), self.outer_r_atm)
        decay = torch.clamp(self.decay, min=1e-9)
        return torch.exp(-dist / decay) + self.density_offset

    def _cloud_height(self, v):
        """The shell's outer radius along direction v (media.h GetHeight:
        the equal-area square, rolled in longitude, with (u, v) swapped
        before the lookup as the reference does)."""
        sq = equal_area_sphere_to_square(normalize(v))
        u0 = sq[..., 0] / PI
        u0 = u0 - torch.floor(u0)
        v1 = (sq[..., 1] + self.rotation_y) / (2.0 * PI)
        v1 = v1 - torch.floor(v1)
        H, W = self.heightmap.shape
        ix = torch.clamp((v1 * W).to(torch.int32), 0, W - 1).long()
        iy = torch.clamp((u0 * H).to(torch.int32), 0, H - 1).long()
        hval = self.heightmap[iy, ix]
        return (self.inner_r_cloud
                + (self.outer_r_cloud - self.inner_r_cloud) * hval)

    def sigma_at(self, p):
        ed = self._exp_density(p)[..., None]
        shifted = p - self.center
        in_cloud = (length(shifted) <= self._cloud_height(shifted))[..., None]
        inside = torch.all((p >= self.b_min) & (p <= self.b_max),
                           -1)[..., None]
        zero = torch.zeros((), device=p.device)
        sa = ed * self.sigma_a_atm + torch.where(in_cloud, self.sigma_a_cloud,
                                                 zero)
        ss = ed * self.sigma_s_atm + torch.where(in_cloud, self.sigma_s_cloud,
                                                 zero)
        return torch.where(inside, sa, zero), torch.where(inside, ss, zero)

    def majorant_rgb(self):
        """(media.h:852-855) the atmosphere times (1 + densityOffset) plus
        the cloud, times majorantScale."""
        return ((self.sigma_a_atm + self.sigma_s_atm)
                * (1.0 + self.density_offset)
                + self.sigma_a_cloud + self.sigma_s_cloud) * self.majorant_scale


@dataclass(frozen=True)
class Media(OnDevice):
    """All media of a scene: a homogeneous block, a tuple of grids and a
    tuple of procedural media."""

    h_sigma_a: torch.Tensor  # (Mh,3)
    h_sigma_s: torch.Tensor  # (Mh,3)
    h_Le: torch.Tensor  # (Mh,3)
    h_g: torch.Tensor  # (Mh,)
    grids: tuple = ()  # tuple[GridMedium | RGBGridMedium]
    procedurals: tuple = ()  # tuple[CloudMedium | EarthMedium]

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
        """Medium properties at p; medium_id < 0 -> vacuum. Le is the
        homogeneous media's, a grid's constant and an RGB grid's emission
        grid; procedural media emit nothing. The guided waves
        (``guided_volpath``, ``vspg``) read no Le, as in the JAX
        package."""
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
            s3 = sel[..., None]
            if isinstance(gm, RGBGridMedium):
                sa_g, ss_g = gm.sigma_at(p)
                sigma_a = torch.where(s3, sa_g, sigma_a)
                sigma_s = torch.where(s3, ss_g, sigma_s)
                Le = torch.where(s3, gm.le_at(p), Le)
                g = torch.where(sel, gm.g, g)
                continue
            dens = gm.density_at(p)
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


def _segment_majorant(gm, vox):
    """(R,3) sigma_maj of supervoxel `vox` of a grid: the RGB grid's
    per-channel majorant, or the density majorant times sigma_t."""
    maj = gm.majorant[vox[..., 0], vox[..., 1], vox[..., 2]]
    if isinstance(gm, RGBGridMedium):
        return maj
    return maj[..., None] * (gm.sigma_a + gm.sigma_s)


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
        smaj = _segment_majorant(gm, vox)
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
        smaj = _segment_majorant(gm, vox_c)
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
