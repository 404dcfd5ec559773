"""Counterpart of ``ops/pallas_surface.py``: B5, the vacuum surface path
tracer of the Cornell class, as a hand-written CUDA kernel
(``csrc/path_surface.cu``), its plain PyTorch version and the class
predicate that lets ``render_persistent`` use it.

The class: at most ``MAX_TRIS`` flat triangles with untextured diffuse
materials and no media, at most one point light, at most
``MAX_AREA_LIGHTS`` diffuse triangle area lights and a constant
environment under uniform light selection, a pinhole camera and a box
filter. A path: Moller-Trumbore closest hit over every triangle, emission
with area-light MIS, NEE (uniform light pick, uniform-area triangle
sampling, an any-hit shadow sweep), a cosine-sampled bounce and Russian
roulette.

The plain version keeps the Pallas kernel's random stream and formulas in
their order: the camera jitters on dimension 0, and every path iteration
draws two ``uniform4`` (NEE, then bounce and roulette) at dimensions that
restart at 1 with each sample. Its constants differ from the torch
wavefront's on purpose (``|det| > 1e-12`` and ``t > 1e-4`` in the
triangle test, a fixed ``1e-4`` spawn offset, area samples as ``p0 + b0
e1 + b1 e2``), so it meets the interpret-mode Pallas kernel per pixel and
the wavefront within Monte Carlo error only.

The kernel runs (pixel, sample) work items on persistent blocks and
writes each path's radiance to a scratch that
``vspg_kernels.reduce_samples`` adds per pixel in sample order
(``volpath_kernels.render_groups``). ``render_surface_plain`` is the plain
version per pixel (one lane a pixel, its samples in sequence), and
``render_surface_items_plain`` per sample (a lane a (pixel, sample)), which
is what the kernel writes. The wrapper ``render_surface`` renders with the plain version
only when its constant tensor lies on the CPU; on a CUDA tensor it
launches the kernel or raises. ``LAUNCHES`` counts the item launches, one
a chunk of samples (the reduce counts in ``vspg_kernels.LAUNCHES``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..utils import rng
from ..utils.math import INV_4PI, INV_PI
from .volpath_kernels import (_PLAIN_CHUNK, _camera_ray, _check, _count,
                              _keep)

LAUNCHES = {"surface": 0}

MAX_TRIS = 128
MAX_AREA_LIGHTS = 8
MAX_MATS = 8

# float32 constant table; csrc/path_surface.cu holds the same layout
S_RC = 0  # raster -> camera, 4x4 row-major
S_CW = 16  # camera -> world, 4x4 row-major
S_ALB = 32  # material albedos (MAX_MATS, 3)
S_AP0 = 56  # area lights: first corner (MAX_AREA_LIGHTS, 3)
S_AE1 = 80  # p1 - p0
S_AE2 = 104  # p2 - p0
S_AN = 128  # unit normal
S_AL = 152  # emitted radiance
S_AAREA = 176  # area (MAX_AREA_LIGHTS,)
S_ATWO = 184  # two-sided (1.0) or not (0.0)
S_LP = 192  # point light position (3)
S_LI = 195  # point light intensity (3)
S_ENV = 198  # constant environment radiance (3)
S_NX = 201
S_NY = 202
S_IMAGING = 203  # the film's imaging ratio
S_MAX_DEPTH = 204
S_RR_START = 205
S_N_LIGHTS = 206
S_N_TRI = 207
S_N_AREA = 208
S_N_MAT = 209
S_PMF = 210  # 1 / n_lights
S_PENV = 211  # pmf / (4 pi)
N_SCONST = 212

# triangle table (T, ST_COLS) float32, pallas_surface's layout
ST_P0 = 0  # first corner (3)
ST_E1 = 3  # p1 - p0 (3)
ST_E2 = 6  # p2 - p0 (3)
ST_NG = 9  # unit normal (3)
ST_MAT = 12  # material id
ST_LIGHT = 13  # area light id, -1 = none
ST_COLS = 16

_BIG = 3e37
TWO_PI = 2.0 * math.pi
# lanes x triangles a plain sweep holds at once
_TRI_PAIRS = 1 << 22


@dataclass(frozen=True)
class SurfaceConstants:
    """What B5 needs of a scene, as tensors on the scene's device."""

    nx: int
    ny: int
    imaging_ratio: float
    has_point: bool
    has_env: bool
    fconst: torch.Tensor  # (N_SCONST,) float32
    tris: torch.Tensor  # (T, ST_COLS) float32

    @property
    def n_tri(self):
        return int(self.tris.shape[0])


# ---------------------------------------------------------------------------
# Class predicate + constant extraction
# ---------------------------------------------------------------------------


def extract_constants(scene, camera, film, cfg):
    """SurfaceConstants if the scene, camera, film and config are of B5's
    class (``pallas_surface.extract_constants``' tests, in its order), else
    None. Only those tests return None; anything else that goes wrong
    raises."""
    if type(camera).__name__ != "PerspectiveCamera" or camera.lens_radius > 0:
        return None
    if cfg.spectral:
        return None
    g = scene.geometry
    n_tri = g.n_tri
    if g.n_box or g.n_sph or not (1 <= n_tri <= MAX_TRIS):
        return None
    if bool((g.tri_med_in >= 0).any()) or bool((g.tri_med_out >= 0).any()):
        return None
    # homogeneous media that no label names are inert, as in the JAX class
    if len(scene.media.grids):
        return None
    if not (torch.allclose(g.tri_n0, g.tri_n1)
            and torch.allclose(g.tri_n0, g.tri_n2)):
        return None  # flat shading normals only
    mat_ids = g.tri_mat.cpu().numpy()
    if (mat_ids < 0).any():
        return None  # interface triangles are not in the class
    mats = scene.materials
    n_mat = int(mats.n)
    if n_mat > MAX_MATS:
        return None
    mt = mats.mat_type.cpu().numpy()
    at = mats.albedo_tex.cpu().numpy()
    for mid in np.unique(mat_ids):
        if mt[mid] != 0 or at[mid] >= 0:
            return None  # diffuse and untextured only
    li = scene.lights
    if li.beyond_kernels:
        return None  # spot/gonio/projection/distant, image env, portal, BVH
    if li.n_point > 1 or li.n_area > MAX_AREA_LIGHTS:
        return None
    n_lights = li.n_lights
    if n_lights == 0:
        return None
    if not np.allclose(li.select_pmf_table.cpu().numpy(), 1.0 / n_lights,
                       atol=1e-6):
        return None  # uniform light selection only
    if film.filter.kind != "box" or abs(film.filter.radius - 0.5) > 1e-6:
        return None
    if not np.allclose(film.sensor_matrix.cpu().numpy(), np.eye(3)):
        return None
    if not math.isinf(film.max_component):
        return None

    def a(t):
        return t.detach().cpu().numpy().astype(np.float32)

    p0 = a(g.tri_p0)
    tab = np.zeros((n_tri, ST_COLS), np.float32)
    tab[:, ST_P0:ST_P0 + 3] = p0
    tab[:, ST_E1:ST_E1 + 3] = a(g.tri_p1) - p0
    tab[:, ST_E2:ST_E2 + 3] = a(g.tri_p2) - p0
    tab[:, ST_NG:ST_NG + 3] = a(g.tri_n0)
    tab[:, ST_MAT] = mat_ids.astype(np.float32)
    tab[:, ST_LIGHT] = a(g.tri_light)

    A = li.n_area
    has_point, has_env = li.n_point == 1, bool(li.has_env)
    f = np.zeros(N_SCONST, np.float32)
    f[S_RC:S_RC + 16] = a(camera.raster_to_camera.m).reshape(-1)
    f[S_CW:S_CW + 16] = a(camera.camera_to_world.m).reshape(-1)
    f[S_ALB:S_ALB + 3 * n_mat] = a(mats.albedo).reshape(-1)
    if A:
        ap0 = a(li.area_p0)
        e1 = a(li.area_p1) - ap0
        e2 = a(li.area_p2) - ap0
        cr = np.cross(e1, e2)
        nrm = np.linalg.norm(cr, axis=-1, keepdims=True)
        f[S_AP0:S_AP0 + 3 * A] = ap0.reshape(-1)
        f[S_AE1:S_AE1 + 3 * A] = e1.reshape(-1)
        f[S_AE2:S_AE2 + 3 * A] = e2.reshape(-1)
        f[S_AN:S_AN + 3 * A] = (cr / np.maximum(nrm, 1e-20)).reshape(-1)
        f[S_AL:S_AL + 3 * A] = a(li.area_L).reshape(-1)
        f[S_AAREA:S_AAREA + A] = 0.5 * nrm[:, 0]
        f[S_ATWO:S_ATWO + A] = li.area_twosided.cpu().numpy()
    if has_point:
        f[S_LP:S_LP + 3] = a(li.point_p[0])
        f[S_LI:S_LI + 3] = a(li.point_I[0])
    if has_env:
        f[S_ENV:S_ENV + 3] = a(li.env_L)
    f[S_NX], f[S_NY] = film.resolution
    f[S_IMAGING] = film.imaging_ratio
    f[S_MAX_DEPTH] = cfg.max_depth
    f[S_RR_START] = cfg.rr_start_depth
    f[S_N_LIGHTS] = n_lights
    f[S_N_TRI], f[S_N_AREA], f[S_N_MAT] = n_tri, A, n_mat
    # folded in double, as the Pallas kernel folds them at trace time
    pmf = 1.0 / n_lights
    f[S_PMF] = pmf
    f[S_PENV] = pmf * INV_4PI
    dev = film.device
    return SurfaceConstants(
        int(film.resolution[0]), int(film.resolution[1]),
        float(film.imaging_ratio), has_point, has_env,
        torch.as_tensor(f, device=dev), torch.as_tensor(tab, device=dev))


def npix_supported(c: SurfaceConstants):
    """The Pallas kernel's tiling test: whole 128-pixel rows."""
    return (c.nx * c.ny) % 128 == 0


def supports(scene, camera, film, cfg):
    """True where ``pallas_surface.supports`` is: the class, and a pixel
    count divisible by 128 (the CUDA kernel guards its tail threads and
    does not need it; the test keeps the dispatch the JAX package's)."""
    c = extract_constants(scene, camera, film, cfg)
    return c is not None and npix_supported(c)


# ---------------------------------------------------------------------------
# Plain versions: every live lane steps one path iteration in lockstep (the
# Pallas kernel's loop); per pixel one lane a pixel runs its samples in
# sequence, per sample every (pixel, sample) is a lane of its own
# ---------------------------------------------------------------------------


class _K:
    """A SurfaceConstants unpacked for the plain version: scalars become
    Python floats, each exactly the float32 the kernel reads."""

    def __init__(self, c: SurfaceConstants):
        fl = c.fconst.tolist()
        self.rc = fl[S_RC:S_RC + 16]
        self.cw = fl[S_CW:S_CW + 16]
        self.nx, self.ny = int(fl[S_NX]), int(fl[S_NY])
        self.max_depth = int(fl[S_MAX_DEPTH])
        self.rr_start = int(fl[S_RR_START])
        self.n_lights = int(fl[S_N_LIGHTS])
        self.n_area, self.n_mat = int(fl[S_N_AREA]), int(fl[S_N_MAT])
        self.has_point, self.has_env = c.has_point, c.has_env
        self.pmf, self.penv = fl[S_PMF], fl[S_PENV]
        self.lp, self.lI = fl[S_LP:S_LP + 3], fl[S_LI:S_LI + 3]
        self.env = fl[S_ENV:S_ENV + 3]
        f = c.fconst
        A = max(self.n_area, 1)
        # per-light rows, gathered per lane by the sampled light's index
        self.alb = f[S_ALB:S_ALB + 3 * MAX_MATS].reshape(MAX_MATS, 3)
        self.ap0 = f[S_AP0:S_AP0 + 3 * A].reshape(A, 3)
        self.ae1 = f[S_AE1:S_AE1 + 3 * A].reshape(A, 3)
        self.ae2 = f[S_AE2:S_AE2 + 3 * A].reshape(A, 3)
        self.an = f[S_AN:S_AN + 3 * A].reshape(A, 3)
        self.aL = f[S_AL:S_AL + 3 * A].reshape(A, 3)
        self.aarea = f[S_AAREA:S_AAREA + A]
        self.atwo = f[S_ATWO:S_ATWO + A] != 0
        self.tris = c.tris
        self.dev = f.device


def _start(K, seed, pix, samp):
    """Camera rays of samples `samp` of pixels `pix`: dimension 0 jitters
    the pixel as ``px + 0.5 + (u0 - 0.5)``."""
    u0, u1, _, _ = rng.uniform4(seed, pix, samp, 0)
    px = (pix % K.nx).to(torch.float32) + 0.5 + (u0 - 0.5)
    py = (pix // K.nx).to(torch.float32) + 0.5 + (u1 - 0.5)
    d = _camera_ray(K, px, py)
    o = torch.tensor([K.cw[3], K.cw[7], K.cw[11]], dtype=torch.float32,
                     device=K.dev).expand_as(d).clone()
    return o, d


def _mt(K, o, d):
    """Moller-Trumbore of every ray against every triangle: (ok, tt),
    each (n, T); `ok` holds every test but ``tt < t_best``."""
    T = K.tris
    col = [T[:, j][None, :] for j in range(12)]
    p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = col[:9]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    big = torch.abs(det) > 1e-12
    inv_det = torch.where(big, 1.0 / torch.where(big, det, 1.0), 0.0)
    tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
    b1 = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    b2 = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    ok = big & (b1 >= 0.0) & (b2 >= 0.0) & (b1 + b2 <= 1.0) & (tt > 1e-4)
    return ok, tt


def _chunks(n, n_tri):
    step = max(1, _TRI_PAIRS // max(n_tri, 1))
    return [slice(s, min(n, s + step)) for s in range(0, n, step)]


def _closest(K, o, d):
    """(t, k) of the closest hit, the first of equal distances in table
    order (the kernel's sweep with ``tt < t_best``); t = _BIG, k = -1 on a
    miss."""
    t = torch.empty_like(o[:, 0])
    k = torch.empty(o.shape[0], dtype=torch.int64, device=o.device)
    for s in _chunks(o.shape[0], K.tris.shape[0]):
        ok, tt = _mt(K, o[s], d[s])
        tm, km = torch.min(torch.where(ok & (tt < _BIG), tt, _BIG), dim=1)
        t[s], k[s] = tm, torch.where(tm < _BIG, km, -1)
    return t, k


def _occluded(K, o, d, t_max, counts):
    """Any-hit sweep in (1e-4, t_max); counts the tests a sweep that stops
    at its first occluder makes."""
    occ = torch.zeros_like(o[:, 0], dtype=torch.bool)
    n_tri = K.tris.shape[0]
    for s in _chunks(o.shape[0], n_tri):
        ok, tt = _mt(K, o[s], d[s])
        hit = ok & (tt < t_max[s, None])
        occ[s] = hit.any(1)
        if counts is not None:
            first = torch.argmax(hit.to(torch.int32), dim=1) + 1
            _count(counts, "shadow_tests",
                   torch.where(occ[s], first, n_tri).sum())
    return occ


def _coord_system(v):
    """Duff et al.'s branchless frame about unit v (the Pallas kernel's)."""
    vx, vy, vz = v[:, 0], v[:, 1], v[:, 2]
    sign = torch.where(vz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + vz)
    b = vx * vy * a
    t1 = (1.0 + sign * vx * vx * a, sign * b, -sign * vx)
    t2 = (b, sign + vy * vy * a, -vy)
    return t1, t2


def _shade(K, seed, pix, samp, dim, o, d, t_h, ng, mat, beta, L, depth,
           counts):
    """NEE, the cosine bounce and Russian roulette at the hits of lanes
    that shade. Returns (o, d, beta, rl, L, alive) of those lanes."""
    m = pix.shape[0]
    dev = K.dev
    h = torch.stack([o[:, j] + t_h * d[:, j] for j in range(3)], -1)
    cos_d = ng[:, 0] * d[:, 0] + ng[:, 1] * d[:, 1] + ng[:, 2] * d[:, 2]
    ns = ng * torch.where(cos_d < 0, 1.0, -1.0)[:, None]
    alb = K.alb[mat]
    ua, ub, uc, _ = rng.uniform4(seed, pix, samp, dim)
    u4a, u4b, u_rr, _ = rng.uniform4(seed, pix, samp, dim + 1)

    # ---- NEE: uniform light pick over point | area... | env ---------------
    lsel = torch.clamp((ua * K.n_lights).to(torch.int64), max=K.n_lights - 1)
    wi = torch.zeros((m, 3), device=dev)
    Lc = torch.zeros((m, 3), device=dev)
    t_sh = torch.zeros(m, device=dev)
    p_dir = torch.zeros(m, device=dev)
    delta = torch.zeros(m, dtype=torch.bool, device=dev)
    idx = 0
    if K.has_point:
        selp = lsel == 0
        tl = torch.stack([K.lp[j] - h[:, j] for j in range(3)], -1)
        d2 = torch.clamp(tl[:, 0] * tl[:, 0] + tl[:, 1] * tl[:, 1]
                         + tl[:, 2] * tl[:, 2], min=1e-12)
        dist = torch.sqrt(d2)
        inv = 1.0 / dist
        wi = torch.where(selp[:, None], tl * inv[:, None], wi)
        t_sh = torch.where(selp, dist, t_sh)
        p_dir = torch.where(selp, 1.0, p_dir)
        delta = selp
        inv_d2 = 1.0 / d2
        Lc = torch.where(selp[:, None],
                         torch.stack([K.lI[j] * inv_d2 for j in range(3)], -1),
                         Lc)
        idx = 1
    if K.n_area:
        # SampleUniformTriangle (sqrt-free variant) on p0 + b0 e1 + b1 e2
        flip = ub < uc
        sb0 = torch.where(flip, ub * 0.5, ub - uc * 0.5)
        sb1 = torch.where(flip, uc - sb0, uc * 0.5)
        sela = (lsel >= idx) & (lsel < idx + K.n_area)
        ai = torch.clamp(lsel - idx, 0, K.n_area - 1)
        p0, e1, e2 = K.ap0[ai], K.ae1[ai], K.ae2[ai]
        pl = p0 + sb0[:, None] * e1 + sb1[:, None] * e2
        tl = pl - h
        d2 = torch.clamp(tl[:, 0] * tl[:, 0] + tl[:, 1] * tl[:, 1]
                         + tl[:, 2] * tl[:, 2], min=1e-12)
        dist = torch.sqrt(d2)
        inv = 1.0 / dist
        w = tl * inv[:, None]
        an = K.an[ai]
        cos_l = -(w[:, 0] * an[:, 0] + w[:, 1] * an[:, 1] + w[:, 2] * an[:, 2])
        front = torch.where(K.atwo[ai], torch.abs(cos_l) > 1e-7,
                            cos_l > 1e-7)
        pdf_a = d2 / torch.clamp(torch.abs(cos_l) * K.aarea[ai], min=1e-30)
        wi = torch.where(sela[:, None], w, wi)
        t_sh = torch.where(sela, dist * (1.0 - 1e-3), t_sh)
        lit = sela & front
        p_dir = torch.where(lit, pdf_a, p_dir)
        Lc = torch.where(lit[:, None], K.aL[ai], Lc)
        idx += K.n_area
    if K.has_env:
        sele = lsel == idx
        ez = 1.0 - 2.0 * ub
        er = torch.sqrt(torch.clamp(1.0 - ez * ez, min=0.0))
        ephi = TWO_PI * uc
        we = torch.stack([er * torch.cos(ephi), er * torch.sin(ephi), ez], -1)
        wi = torch.where(sele[:, None], we, wi)
        t_sh = torch.where(sele, _BIG, t_sh)
        p_dir = torch.where(sele, INV_4PI, p_dir)
        Lc = torch.where(sele[:, None],
                         torch.tensor(K.env, device=dev).expand(m, 3), Lc)

    cos_wi = wi[:, 0] * ns[:, 0] + wi[:, 1] * ns[:, 1] + wi[:, 2] * ns[:, 2]
    # diffuse BRDF: f = albedo / pi, pdf = cos / pi
    f_w = INV_PI * torch.clamp(cos_wi, min=0.0)
    spdf = f_w
    nee_ok = (p_dir > 0) & (f_w > 0) & (Lc > 0).any(-1)
    so = h + 1e-4 * ns
    occ = torch.zeros_like(nee_ok)
    if bool(nee_ok.any()):
        occ[nee_ok] = _occluded(K, so[nee_ok], wi[nee_ok], t_sh[nee_ok],
                                counts)
    nee_ok = nee_ok & ~occ
    p_l = K.pmf * p_dir
    den = torch.where(delta, p_l, torch.clamp(p_l + spdf, min=1e-30))
    w_nee = f_w / torch.clamp(den, min=1e-30)
    L = torch.where(nee_ok[:, None], L + beta * alb * Lc * w_nee[:, None], L)

    # ---- cosine-sampled bounce --------------------------------------------
    r_s = torch.sqrt(u4a)
    phi = TWO_PI * u4b
    lx = r_s * torch.cos(phi)
    ly = r_s * torch.sin(phi)
    lz = torch.sqrt(torch.clamp(1.0 - u4a, min=0.0))
    t1, t2 = _coord_system(ns)
    d_new = torch.stack([lx * t1[j] + ly * t2[j] + lz * ns[:, j]
                         for j in range(3)], -1)
    bpdf = INV_PI * torch.clamp(lz, min=1e-12)
    beta = beta * alb  # f cos / pdf = albedo under cosine sampling
    alive = ~(torch.amax(beta, -1) <= 0)
    rl = 1.0 / bpdf
    o_new = so

    # ---- Russian roulette (integrators.cpp:1301-1312) ---------------------
    rr_max = torch.amax(beta, -1)
    do_rr = (rr_max < 1.0) & (depth >= K.rr_start)
    q = torch.clamp(1.0 - rr_max, min=0.0)
    kill = do_rr & (u_rr < q)
    alive = alive & ~kill
    inv_keep = 1.0 / torch.clamp(1.0 - q, min=1e-6)
    beta = torch.where((do_rr & ~kill)[:, None], beta * inv_keep[:, None],
                       beta)
    return o_new, d_new, beta, rl, L, alive


def _fresh(K, seed, pix, samp, counts):
    """The lane state of fresh paths, samples `samp` of pixels `pix`."""
    o, d = _start(K, seed, pix, samp)
    _count(counts, "samples", pix.shape[0])
    n = pix.shape[0]
    return dict(pix=pix, samp=samp, dim=torch.ones_like(samp), o=o, d=d,
                beta=torch.ones((n, 3), device=K.dev),
                rl=torch.ones(n, device=K.dev),
                L=torch.zeros((n, 3), device=K.dev),
                depth=torch.zeros_like(samp))


def _iterate(K, seed, S, counts):
    """One path iteration of every lane of S (updated in place): the
    closest hit, escape or emission with MIS, shading, and the radiance
    scrub. Returns the lanes' alive mask."""
    pix, samp, d, depth = S["pix"], S["samp"], S["d"], S["depth"]
    beta, rl, L = S["beta"], S["rl"], S["L"]
    n = pix.shape[0]
    _count(counts, "iters", n)
    _count(counts, "tri_tests", n * K.tris.shape[0])
    t_h, k = _closest(K, S["o"], d)
    hit = k >= 0
    row = K.tris[torch.clamp(k, min=0)]
    ng = torch.where(hit[:, None], row[:, ST_NG:ST_NG + 3], 0.0)
    mat = torch.where(hit, row[:, ST_MAT].to(torch.int64), -1)
    li = torch.where(hit, row[:, ST_LIGHT].to(torch.int64), -1)
    first = depth == 0

    # ---- escaped: the environment with MIS ------------------------------
    escaped = ~hit
    if K.has_env:
        env = torch.tensor(K.env, device=K.dev)
        L = torch.where((escaped & first)[:, None], L + beta * env, L)
        den = torch.clamp(1.0 + rl * K.penv, min=1e-30)
        L = torch.where((escaped & ~first)[:, None],
                        L + beta * env / den[:, None], L)
    alive = ~escaped

    # ---- emissive hit (one-sided unless two-sided) ----------------------
    if K.n_area:
        cos_o = -(ng[:, 0] * d[:, 0] + ng[:, 1] * d[:, 1]
                  + ng[:, 2] * d[:, 2])
        known = (li >= 0) & (li < K.n_area)
        ai = torch.clamp(li, 0, K.n_area - 1)
        front = (cos_o > 0) | K.atwo[ai]
        Le = torch.where((known & front)[:, None], K.aL[ai], 0.0)
        area_l = torch.where(known, K.aarea[ai], 1.0)
        emissive = alive & (li >= 0)
        L = torch.where((emissive & first)[:, None], L + beta * Le, L)
        # pdf_li_area: pmf * dist^2 / (|cos_l| * area)
        p_l_area = (K.pmf * t_h * t_h
                    / torch.clamp(torch.abs(cos_o) * area_l, min=1e-30))
        den_s = torch.clamp(1.0 + rl * p_l_area, min=1e-30)
        L = torch.where((emissive & ~first)[:, None],
                        L + beta * Le / den_s[:, None], L)

    # ---- shading --------------------------------------------------------
    shade = alive & (mat >= 0)
    alive = alive & ~(hit & (mat < 0))
    too_deep = shade & (depth >= K.max_depth)
    alive = alive & ~too_deep
    shade = shade & ~too_deep
    S["depth"] = depth = torch.where(shade, depth + 1, depth)
    if bool(shade.any()):
        _count(counts, "shades", int(shade.sum()))
        s = shade
        o_s, d_s, beta_s, rl_s, L_s, alive_s = _shade(
            K, seed, pix[s], samp[s], S["dim"][s], S["o"][s], d[s], t_h[s],
            ng[s], mat[s], beta[s], L[s], depth[s], counts)
        S["o"][s], d[s], beta[s], rl[s], L[s] = o_s, d_s, beta_s, rl_s, L_s
        alive[s] = alive_s
    S["dim"] = S["dim"] + 2
    S.update(beta=beta, rl=rl,
             L=torch.where(torch.isfinite(L).all(-1)[:, None], L, 0.0))
    return alive


def render_surface_plain(c: SurfaceConstants, spp, seed, counts=None):
    """B5's plain version per pixel: one lane a pixel runs its samples in
    sequence, summed in sample order; (ny, nx, 3). `counts` (a dict), when
    given, gathers the work the bound needs: lane-iterations ("iters"),
    closest-hit triangle tests ("tri_tests"), shading iterations
    ("shades"), shadow-sweep triangle tests ("shadow_tests", stopping at
    the first occluder) and camera samples ("samples")."""
    K = _K(c)
    spp = int(spp)
    if spp < 1:
        raise ValueError("spp must be at least 1")
    seed = int(seed) & 0xFFFFFFFF
    npix = K.nx * K.ny
    acc = torch.zeros((npix, 3), dtype=torch.float32, device=K.dev)
    pix = torch.arange(npix, device=K.dev)
    S = _fresh(K, seed, pix, torch.zeros_like(pix), counts)
    it = 0
    max_iters = spp * (K.max_depth + 2)
    while S["pix"].numel() and it < max_iters:
        alive = _iterate(K, seed, S, counts)

        # ---- commit + regenerate ----------------------------------------
        died = ~alive
        acc.index_add_(0, S["pix"][died], S["L"][died])
        samp = torch.where(died, S["samp"] + 1, S["samp"])
        fresh = died & (samp < spp)
        S["samp"] = samp
        if bool(fresh.any()):
            F = _fresh(K, seed, S["pix"][fresh], samp[fresh], counts)
            for key in ("o", "d", "dim", "beta", "rl", "L", "depth"):
                S[key][fresh] = F[key]
        S = _keep(S, alive | fresh)
        it += 1
    return (acc * (c.imaging_ratio / spp)).reshape(K.ny, K.nx, 3)


def render_surface_items_plain(c: SurfaceConstants, spp, seed, pixels=None):
    """B5's plain version per sample: the raw radiance (spp, npix, 3) of
    every (sample, pixel), each a lane of its own from a fresh path that
    runs at most max_depth + 2 iterations (the kernel's cap, which no path
    reaches); with `pixels` (flat indices) the (spp, len(pixels), 3) of
    those pixels: what the kernel writes."""
    K = _K(c)
    spp = int(spp)
    if spp < 1:
        raise ValueError("spp must be at least 1")
    seed = int(seed) & 0xFFFFFFFF
    pixels = (torch.arange(K.nx * K.ny, device=K.dev) if pixels is None
              else torch.as_tensor(pixels, dtype=torch.int64, device=K.dev))
    n = pixels.numel()
    total = n * spp
    acc = torch.zeros((total, 3), dtype=torch.float32, device=K.dev)
    for start in range(0, total, _PLAIN_CHUNK):
        lane = torch.arange(start, min(total, start + _PLAIN_CHUNK),
                            device=K.dev)
        S = _fresh(K, seed, pixels[lane % n], lane // n, None)
        S["lane"] = lane
        for _ in range(K.max_depth + 2):
            if S["pix"].numel() == 0:
                break
            alive = _iterate(K, seed, S, None)
            acc[S["lane"][~alive]] = S["L"][~alive]
            S = _keep(S, alive)
        acc[S["lane"]] = S["L"]
    return acc.reshape(spp, n, 3)


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------


def _surface_args(c: SurfaceConstants):
    dev = c.fconst.device
    if dev.type != "cuda":
        raise ValueError(f"path_surface: no kernel for device {dev}")
    n_tri = c.n_tri
    if not 1 <= n_tri <= MAX_TRIS:
        raise ValueError(f"{n_tri} triangles: the kernel takes 1-{MAX_TRIS}")
    _check(c.fconst, torch.float32, (N_SCONST,), dev, "fconst")
    _check(c.tris, torch.float32, (n_tri, ST_COLS), dev, "tris")
    return dev


def surface_info(c: SurfaceConstants):
    """B5's persistent grid for the constants' instantiation on their card
    (``volpath_kernels.item_grid``)."""
    from .volpath_kernels import cached_item_grid

    return cached_item_grid("path_surface_info",
                            (int(c.has_point), int(c.has_env)),
                            _surface_args(c))


def _surface_launch(c, seed, samp0, n_samp, blocks, out, counter):
    """One launch of B5's item kernel on checked arguments."""
    from . import _build

    dev = c.fconst.device
    with torch.cuda.device(dev):
        err = _build.load().path_surface_launch(
            c.fconst.data_ptr(), c.tris.data_ptr(), out.data_ptr(),
            counter.data_ptr(), c.nx * c.ny, samp0, n_samp,
            int(seed) & 0xFFFFFFFF, int(c.has_point), int(c.has_env), blocks,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"path_surface kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["surface"] += 1
    return out


def surface_items(c: SurfaceConstants, seed, samp0, n_samp, blocks=None,
                  out=None):
    """B5's item kernel alone: the radiance (n_samp, npix, 3) of samples
    samp0, ..., samp0 + n_samp - 1 of every pixel, one (pixel, sample)
    item at a time on `blocks` persistent blocks (None: the SMs times the
    resident blocks an SM), written to `out` (allocated when None)."""
    from .volpath_kernels import item_blocks, item_out

    dev = _surface_args(c)
    samp0, n_samp = int(samp0), int(n_samp)
    blocks = item_blocks(samp0, n_samp, 1, blocks, surface_info(c))
    out = item_out(out, n_samp, c.nx * c.ny, dev)
    counter = torch.zeros(1, dtype=torch.int64, device=dev)
    return _surface_launch(c, seed, samp0, n_samp, blocks, out, counter)


def render_surface(c: SurfaceConstants, spp, seed, blocks=None):
    """B5: render the Cornell class, (ny, nx, 3). On a card the item kernel
    writes each (pixel, sample)'s radiance (``surface_items``; `blocks` as
    there) and ``volpath_kernels.render_groups`` reduces them in sample
    order; for constants on the CPU the per-pixel plain version."""
    from .volpath_kernels import item_blocks, render_groups

    dev = c.fconst.device
    if dev.type == "cpu":
        return render_surface_plain(c, spp, seed)
    spp = int(spp)
    if spp < 1:
        raise ValueError("spp must be at least 1")
    blocks = item_blocks(0, spp, 1, blocks, surface_info(c))
    return render_groups(
        lambda s0, n, out, counter: _surface_launch(c, seed, s0, n, blocks,
                                                    out, counter),
        c.nx, c.ny, spp, 1, c.imaging_ratio / spp, dev)


# ---------------------------------------------------------------------------
# Scenes of the class, built without JAX
# ---------------------------------------------------------------------------

# the bench line's view of the Cornell box (bench.py bench_config6)
CORNELL_EYE, CORNELL_AT, CORNELL_FOV = (0, 1, 3.2), (0, 1, 0), 45.0
# what the lit Cornell box adds to the bench one: a two-sided emitter
# triangle in the box (a third area light), a point light and an env
LIT_TRI = dict(p0=(-0.6, 0.3, -0.2), p1=(-0.2, 0.3, -0.6),
               p2=(-0.4, 0.9, -0.4))
LIT_TRI_L = (3.0, 2.0, 1.0)
LIT_POINT = ((0.3, 1.5, 0.2), (2.0, 2.0, 2.0))
LIT_ENV = (0.2, 0.3, 0.4)
# the floor furnace: a diffuse plane under a unit env, seen from above
FLOOR_EYE, FLOOR_AT = (0, 2.0, 0.01), (0, 0, 0)
FLOOR_TRIS = (dict(p0=(-10, 0, -10), p1=(10, 0, -10), p2=(10, 0, 10), mat=0),
              dict(p0=(-10, 0, -10), p1=(10, 0, 10), p2=(-10, 0, 10), mat=0))


def cornell_view(nx, ny, eye=CORNELL_EYE, at=CORNELL_AT, *, device):
    """(camera, film) of the bench line's view at nx x ny pixels."""
    from ..models.cameras import PerspectiveCamera
    from ..models.film import RGBFilm
    from ..utils import transform as tr

    cam = PerspectiveCamera.make(tr.look_at(eye, at, (0, 1, 0),
                                            device=device),
                                 CORNELL_FOV, (nx, ny), device=device)
    return cam, RGBFilm.make((nx, ny), device=device)


def make_cornell_lit_scene(*, device):
    """The Cornell box with every light type of the class: its two
    one-sided ceiling emitters, a two-sided emitter triangle (LIT_TRI), a
    point light and a constant environment."""
    from ..models.integrators.volpath import Scene, make_cornell_box_scene
    from ..models.lights import Lights
    from ..models.media import Media
    from ..models.shapes import Geometry

    base = make_cornell_box_scene(device=device)
    g, li = base.geometry, base.lights

    def row(t, i):
        return tuple(t[i].tolist())

    tris = [dict(p0=row(g.tri_p0, i), p1=row(g.tri_p1, i),
                 p2=row(g.tri_p2, i), mat=int(g.tri_mat[i]),
                 light=int(g.tri_light[i])) for i in range(g.n_tri)]
    tris.append(dict(LIT_TRI, mat=0, light=li.n_area))
    area = [dict(p0=row(li.area_p0, i), p1=row(li.area_p1, i),
                 p2=row(li.area_p2, i), L=row(li.area_L, i))
            for i in range(li.n_area)]
    area.append(dict(LIT_TRI, L=LIT_TRI_L, twosided=True))
    lights = Lights.make(point_p=[LIT_POINT[0]], point_I=[LIT_POINT[1]],
                         env_L=LIT_ENV, world_radius=100.0, area_tris=area,
                         device=device)
    return Scene(Geometry.build(triangles=tris, device=device),
                 base.materials, Media.make(device=device), lights)


def make_floor_scene(albedo=(0.7, 0.5, 0.3), env=1.0, *, device):
    """A diffuse plane under a constant environment: every pixel of the
    view from FLOOR_EYE reads albedo * env."""
    from ..models.integrators.volpath import Scene
    from ..models.lights import Lights
    from ..models.materials import Materials
    from ..models.media import Media
    from ..models.shapes import Geometry

    return Scene(Geometry.build(triangles=FLOOR_TRIS, device=device),
                 Materials.build([dict(type=0, albedo=albedo)],
                                 device=device),
                 Media.make(device=device),
                 Lights.make(env_L=[env] * 3, world_radius=100.0,
                             device=device))
