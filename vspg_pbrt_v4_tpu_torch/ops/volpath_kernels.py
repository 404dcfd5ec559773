"""Counterpart of ``ops/pallas_volpath.py``: the hand-written CUDA kernels of
the delta-tracking volpath path, their plain PyTorch versions, and the
support predicate that decides when ``render_persistent`` may use them.

Two scene classes, each with one kernel (sources under ``csrc/``):

- ``"homog"``: one box of homogeneous fog. ``csrc/volpath_homog.cu``
  replaces ``pallas_volpath._make_kernel``. It keeps that kernel's random
  stream exactly (camera on dimension 0, then three ``uniform4``
  dimensions per path event), so ``render_homog_plain`` agrees per pixel
  with the Pallas kernel run in interpret mode.
- ``"grid"``: one box holding one density grid. ``csrc/volpath_grid.cuh``
  replaces ``pallas_volpath._make_grid_kernel`` in three geometry modes:
  without triangles (B2a in ROADMAP.md); with at most ``MAX_TRIS_GRID``
  flat triangles of the teaser materials inside the cloud (B2b, a sweep of
  the triangle table in shared memory); and the mesh class, at most
  ``MAX_TRIS_MESH`` triangles (B2c, ``csrc/volpath_grid_mesh.cu``: each
  thread walks the scene's BVH, its node table and the triangle table in
  global memory). Its random stream is its own (``render_grid_plain``
  documents it), so it agrees with the JAX package within Monte Carlo
  error.

B1's threads each render all samples of one pixel. B2a-c run every (pixel,
sample) as a work item of its own on persistent blocks, one flat step loop
a lane, and write each item's radiance to a scratch that
``vspg_kernels.reduce_samples`` sums per pixel in sample order
(``render_grid``; ``render_grid_items_plain`` is the plain version of the
items). A sample runs at most ``cfg.max_events`` path events. A wrapper
renders with the plain version only when its constant tensor lies on the
CPU; on a CUDA tensor it launches its kernel or raises. ``LAUNCHES``
counts the kernel launches: one a render for B1, one a chunk of samples
for B2a-c (whose reduce counts in ``vspg_kernels.LAUNCHES``).
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..models.media import GridMedium, Media, seg_init, seg_next
from ..utils import rng
from ..utils.math import INV_4PI

LAUNCHES = {"homog": 0, "grid": 0, "grid_tris": 0, "grid_mesh": 0}

# float32 constant table; csrc/common.cuh holds the same layout
F_RC, F_CW = 0, 16  # raster->camera, camera->world (4x4 row-major)
F_SA, F_SS, F_ST = 32, 35, 38  # sigma_a, sigma_s, their f32 sum
F_BMIN, F_BMAX = 41, 44  # medium box
F_LP, F_LI, F_ENV = 47, 50, 53  # point position / intensity, env radiance
F_PMF, F_PENV = 56, 57  # light-selection pmf, pmf / (4 pi)
F_HG_C1, F_HG_C2, F_HG_C3 = 58, 59, 60  # 1+g^2, 2g, (1-g^2)/(4 pi)
F_HG_1MG2, F_HG_1PG, F_TWO_PI = 61, 62, 63  # 1-g^2, 1+g, 2 pi
N_FCONST = 64
# int32 constant table
(I_NX, I_NY, I_HAS_POINT, I_HAS_ENV, I_MAX_DEPTH, I_MAX_EVENTS, I_MAX_COLL,
 I_RR_START, I_HG_ISO, I_GX, I_GY, I_GZ, I_MX, I_MY, I_MZ) = range(15)
N_ICONST = 15

# triangle table (T, TRI_COLS) float32, pallas_volpath.pack_tri_table's
# layout; csrc/common.cuh holds the same
TRI_COLS = 24
(T_P0, T_E1, T_E2, T_NG, T_MAT, T_MED_IN, T_MED_OUT, T_UV0, T_UV1,
 T_UV2) = (0, 3, 6, 9, 12, 13, 14, 16, 18, 20)
MAX_TRIS_GRID = 64
# the mesh class (pallas_volpath.MAX_TRIS_MESH): triangle and node tables
# in global memory, walked through the BVH
MAX_TRIS_MESH = 16384
# BVH node table (N, NODE_COLS) float32, csrc/bvh.cuh holds the same
# layout: bmin, bmax, then the second child (interior) or the first row of
# the leaf's triangles, and the triangle count (0 = interior)
NODE_COLS = 8
N_BMIN, N_BMAX, N_INDEX, N_COUNT = 0, 3, 6, 7
# material table (M, MAT_COLS) float32: kind, albedo, eta, roughness, then
# the albedo texture (kind -1 none / 1 checker, its two colours, uv scale)
MAT_COLS = 16
(M_KIND, M_ALB, M_ETA, M_ROUGH, M_TEX, M_C0, M_C1, M_UVS) = (0, 1, 4, 5, 6,
                                                           7, 10, 13)
MAX_MATS = 16

# majorant grids live in one block's shared memory
MAX_MAJ_VOX = 4096
_BIG = 3e37
# lanes (pixel, sample pairs) a plain render holds at once, and the lane x
# triangle pairs its brute-force closest-hit sweep holds at once
_PLAIN_CHUNK = 1 << 21
_TRI_PAIRS = 1 << 22


@dataclass(frozen=True)
class KernelConstants:
    """What a kernel needs of a scene, as tensors on the scene's device."""

    kind: str  # "homog" | "grid"
    nx: int
    ny: int
    imaging_ratio: float
    fconst: torch.Tensor  # (N_FCONST,) float32
    iconst: torch.Tensor  # (N_ICONST,) int32
    density: torch.Tensor = None  # (gx, gy, gz) float32, grid class
    majorant: torch.Tensor = None  # (mx, my, mz) float32, grid class
    tris: torch.Tensor = None  # (T, TRI_COLS) float32, teaser/mesh class
    mats: torch.Tensor = None  # (M, MAT_COLS) float32, teaser/mesh class
    nodes: torch.Tensor = None  # (N, NODE_COLS) float32, mesh class

    @property
    def n_tri(self):
        return 0 if self.tris is None else int(self.tris.shape[0])


# ---------------------------------------------------------------------------
# Support predicate + constant extraction
# ---------------------------------------------------------------------------


def extract_constants(scene, camera, film, cfg):
    """KernelConstants if the scene, camera, film and config are of a
    kernel's class, else None. Only the explicit tests below return None;
    anything else that goes wrong raises."""
    if type(camera).__name__ != "PerspectiveCamera" or camera.lens_radius > 0:
        return None
    if cfg.spectral or cfg.sss:
        return None
    g = scene.geometry
    if g.n_box != 1:
        return None
    if g.n_tri and not _tris_supported(scene):
        return None
    if int(g.box_mat[0]) >= 0:
        return None
    if int(g.box_med_in[0]) != 0 or int(g.box_med_out[0]) != -1:
        return None
    m = scene.media
    bmin = g.box_min[0].cpu().numpy()
    bmax = g.box_max[0].cpu().numpy()
    grid = None
    if len(m.grids) == 0:
        if m.n_homog != 1 or float(m.h_Le.max()) > 0:
            return None
        kind = "homog"
        sa = m.h_sigma_a[0].cpu().numpy()
        ss = m.h_sigma_s[0].cpu().numpy()
        g_hg = float(m.h_g[0])
    elif len(m.grids) == 1 and m.n_homog == 0:
        grid = m.grids[0]
        if g.n_tri and not all(
                bool(((v >= grid.b_min) & (v <= grid.b_max)).all())
                for v in (g.tri_p0, g.tri_p1, g.tri_p2)):
            return None  # the kernel's shadow rays start their walk inside
        if float(grid.Le.max()) > 0:
            return None
        if not (np.allclose(grid.b_min.cpu().numpy(), bmin)
                and np.allclose(grid.b_max.cpu().numpy(), bmax)):
            return None
        # the DDA's uniform cells must match GridMedium.make's partition,
        # or a majorant could fail to bound the density it covers
        if any(grid.res[k] % grid.maj_res[k] for k in range(3)):
            return None
        if int(np.prod(grid.maj_res)) > MAX_MAJ_VOX:
            return None
        if int(np.prod(grid.res)) >= 2 ** 31:
            return None
        kind = "grid"
        sa = grid.sigma_a.cpu().numpy()
        ss = grid.sigma_s.cpu().numpy()
        g_hg = float(grid.g)
    else:
        return None
    if g.n_tri and kind != "grid":
        return None  # fused surfaces only in the grid kernel
    li = scene.lights
    if li.n_point > 1 or li.n_area:
        return None  # B1 and B2 shade no emission (pallas_volpath's gate)
    has_point, has_env = li.n_point == 1, bool(li.has_env)
    if not (has_point or has_env):
        return None
    if film.filter.kind != "box" or abs(film.filter.radius - 0.5) > 1e-6:
        return None
    if not np.allclose(film.sensor_matrix.cpu().numpy(), np.eye(3)):
        return None
    if not math.isinf(film.max_component):
        return None

    sa = np.asarray(sa, np.float32)
    ss = np.asarray(ss, np.float32)
    gc = float(np.clip(g_hg, -0.99, 0.99))
    pmf = 1.0 / (int(has_point) + int(has_env))
    f = np.zeros(N_FCONST, np.float32)
    f[F_RC:F_RC + 16] = camera.raster_to_camera.m.cpu().numpy().reshape(-1)
    f[F_CW:F_CW + 16] = camera.camera_to_world.m.cpu().numpy().reshape(-1)
    f[F_SA:F_SA + 3] = sa
    f[F_SS:F_SS + 3] = ss
    f[F_ST:F_ST + 3] = sa + ss
    f[F_BMIN:F_BMIN + 3] = bmin
    f[F_BMAX:F_BMAX + 3] = bmax
    if has_point:
        f[F_LP:F_LP + 3] = li.point_p[0].cpu().numpy()
        f[F_LI:F_LI + 3] = li.point_I[0].cpu().numpy()
    if has_env:
        f[F_ENV:F_ENV + 3] = li.env_L.cpu().numpy()
    f[F_PMF] = pmf
    f[F_PENV] = pmf * INV_4PI
    # HG constants folded in double, as the Pallas kernel folds them at
    # trace time
    f[F_HG_C1] = 1.0 + gc * gc
    f[F_HG_C2] = 2.0 * gc
    f[F_HG_C3] = INV_4PI * (1.0 - gc * gc)
    f[F_HG_1MG2] = 1.0 - gc * gc
    f[F_HG_1PG] = 1.0 + gc
    f[F_TWO_PI] = 2.0 * np.pi
    i = np.zeros(N_ICONST, np.int32)
    i[I_NX], i[I_NY] = film.resolution
    i[I_HAS_POINT], i[I_HAS_ENV] = int(has_point), int(has_env)
    i[I_MAX_DEPTH] = cfg.max_depth
    i[I_MAX_EVENTS] = cfg.max_events
    i[I_MAX_COLL] = cfg.max_collisions
    i[I_RR_START] = cfg.rr_start_depth
    i[I_HG_ISO] = int(abs(gc) < 1e-3)
    if grid is not None:
        i[I_GX:I_GX + 3] = grid.res
        i[I_MX:I_MX + 3] = grid.maj_res
    dev = film.device
    tris = mats = nodes = None
    if g.n_tri:
        tris = pack_tri_table(g)
        mats = torch.as_tensor(pack_mat_table(scene.materials,
                                              scene.textures), device=dev)
        if g.n_tri > MAX_TRIS_GRID:
            # a leaf's triangles as contiguous rows of the table
            tris = tris[g.tri_bvh.prim_ids.cpu().numpy()]
            nodes = torch.as_tensor(pack_node_table(g.tri_bvh), device=dev)
        tris = torch.as_tensor(tris, device=dev)
    return KernelConstants(
        kind, int(film.resolution[0]), int(film.resolution[1]),
        float(film.imaging_ratio), torch.as_tensor(f, device=dev),
        torch.as_tensor(i, device=dev),
        None if grid is None else grid.density.to(dev).contiguous(),
        None if grid is None else grid.majorant.to(dev).contiguous(),
        tris, mats, nodes)


def _tris_supported(scene):
    """The teaser and mesh classes (``pallas_volpath.extract_constants``'
    triangle gate): at most MAX_TRIS_MESH flat triangles, no emitters,
    interface ids among {-1, 0}, every triangle opaque, materials diffuse /
    conductor / smooth dielectric / CookTorrance, albedo textures only
    checkers and only in the teaser class (at most MAX_TRIS_GRID); above
    that the geometry must carry its BVH."""
    from ..models.materials import PORTED_KINDS
    from ..models.textures import CHECKER

    g = scene.geometry
    if g.n_tri > MAX_TRIS_MESH or bool((g.tri_light >= 0).any()):
        return False
    mesh = g.n_tri > MAX_TRIS_GRID
    if mesh and g.tri_bvh is None:
        return False
    if not (torch.allclose(g.tri_n0, g.tri_n1)
            and torch.allclose(g.tri_n0, g.tri_n2)):
        return False
    for ids in (g.tri_med_in, g.tri_med_out):
        if not bool(((ids == -1) | (ids == 0)).all()):
            return False
    if bool((g.tri_mat < 0).any()):
        return False
    mats = scene.materials
    if mats.n > MAX_MATS:
        return False
    for mid in torch.unique(g.tri_mat).tolist():
        kind = int(mats.mat_type[mid])
        if kind not in PORTED_KINDS:
            return False
        if kind == 2 and float(mats.roughness[mid]) >= 1e-3:
            return False
        tex = int(mats.albedo_tex[mid])
        if tex >= 0 and (mesh or scene.textures is None
                         or int(scene.textures.kind[tex]) != CHECKER):
            return False
    return True


def pack_tri_table(geometry):
    """(T, TRI_COLS) float32 numpy table: p0, e1 = p1 - p0, e2 = p2 - p0,
    the normal n0, mat, med_in, med_out, then the corner uvs."""
    g = geometry

    def a(t):
        return t.detach().cpu().numpy().astype(np.float32)

    p0 = a(g.tri_p0)
    tab = np.zeros((p0.shape[0], TRI_COLS), np.float32)
    tab[:, T_P0:T_P0 + 3] = p0
    tab[:, T_E1:T_E1 + 3] = a(g.tri_p1) - p0
    tab[:, T_E2:T_E2 + 3] = a(g.tri_p2) - p0
    tab[:, T_NG:T_NG + 3] = a(g.tri_n0)
    tab[:, T_MAT] = a(g.tri_mat)
    tab[:, T_MED_IN] = a(g.tri_med_in)
    tab[:, T_MED_OUT] = a(g.tri_med_out)
    tab[:, T_UV0:T_UV0 + 2] = a(g.tri_uv0)
    tab[:, T_UV1:T_UV1 + 2] = a(g.tri_uv1)
    tab[:, T_UV2:T_UV2 + 2] = a(g.tri_uv2)
    return tab


def pack_node_table(bvh):
    """(N, NODE_COLS) float32 numpy table of a BVH's nodes; a leaf's index
    is the row, in the table ordered by ``bvh.prim_ids``, of its first
    triangle."""
    count = bvh.count.cpu().numpy()
    tab = np.zeros((count.shape[0], NODE_COLS), np.float32)
    tab[:, N_BMIN:N_BMIN + 3] = bvh.bmin.cpu().numpy()
    tab[:, N_BMAX:N_BMAX + 3] = bvh.bmax.cpu().numpy()
    tab[:, N_INDEX] = np.where(count > 0, bvh.start.cpu().numpy(),
                               bvh.right.cpu().numpy())
    tab[:, N_COUNT] = count
    return tab


def pack_mat_table(materials, textures):
    """(M, MAT_COLS) float32 numpy table of the materials, each with its
    albedo texture resolved (kind -1 when it has none)."""
    m = materials

    def a(t):
        return t.detach().cpu().numpy().astype(np.float32)

    tab = np.zeros((m.n, MAT_COLS), np.float32)
    tab[:, M_KIND] = a(m.mat_type)
    tab[:, M_ALB:M_ALB + 3] = a(m.albedo)
    tab[:, M_ETA] = a(m.eta)
    tab[:, M_ROUGH] = a(m.roughness)
    tab[:, M_TEX] = -1.0
    tab[:, M_UVS:M_UVS + 2] = 1.0
    for i, t in enumerate(m.albedo_tex.tolist()):
        if t >= 0 and textures is not None:
            tab[i, M_TEX] = float(textures.kind[t])
            tab[i, M_C0:M_C0 + 3] = a(textures.c0[t])
            tab[i, M_C1:M_C1 + 3] = a(textures.c1[t])
            tab[i, M_UVS:M_UVS + 2] = a(textures.uvscale[t])
    return tab


# ---------------------------------------------------------------------------
# Plain versions: shared per-lane math (the Pallas kernels' formulas, in
# their operation order, so that interpret-mode runs compare closely)
# ---------------------------------------------------------------------------


class _Consts:
    """A KernelConstants unpacked for the plain versions: per-channel
    constants stay (3,) float32 tensors, scalars become Python floats (each
    exactly the float32 the kernel reads)."""

    def __init__(self, c: KernelConstants):
        f = c.fconst
        fl = f.tolist()
        il = c.iconst.tolist()
        self.rc = fl[F_RC:F_RC + 16]
        self.cw = fl[F_CW:F_CW + 16]
        self.sa, self.ss, self.st = f[F_SA:F_SA + 3], f[F_SS:F_SS + 3], \
            f[F_ST:F_ST + 3]
        self.nst = -self.st
        self.bmin, self.bmax = fl[F_BMIN:F_BMIN + 3], fl[F_BMAX:F_BMAX + 3]
        self.lp, self.lI, self.envL = f[F_LP:F_LP + 3], f[F_LI:F_LI + 3], \
            f[F_ENV:F_ENV + 3]
        self.pmf, self.penv = fl[F_PMF], fl[F_PENV]
        self.c1, self.c2 = fl[F_HG_C1], fl[F_HG_C2]
        self.opg, self.two_pi = fl[F_HG_1PG], fl[F_TWO_PI]
        # dividends and divisors as 0-dim tensors on the device: PyTorch
        # divides by (or into) a Python number through its reciprocal,
        # rounding twice where the kernels round once
        self.c2_t, self.c3_t, self.omg2_t = (f[F_HG_C2], f[F_HG_C3],
                                             f[F_HG_1MG2])
        self.nx, self.ny = il[I_NX], il[I_NY]
        self.has_point, self.has_env = bool(il[I_HAS_POINT]), \
            bool(il[I_HAS_ENV])
        self.max_depth, self.max_events = il[I_MAX_DEPTH], il[I_MAX_EVENTS]
        self.max_coll, self.rr_start = il[I_MAX_COLL], il[I_RR_START]
        self.iso = bool(il[I_HG_ISO])
        self.res = tuple(il[I_GX:I_GX + 3])
        self.mres = tuple(il[I_MX:I_MX + 3])
        self.dev = f.device


def _dot(a, b):
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def _avg3(v):
    return (v[:, 0] + v[:, 1] + v[:, 2]) * (1.0 / 3.0)


def _normalize(v):
    return v * torch.rsqrt(torch.clamp(_dot(v, v), min=1e-30))[:, None]


def _box_hit(o, d, bmin, bmax):
    """Slab test of the Pallas kernels: (hit, t_hit, entering); entering =
    the near face is ahead (origin outside the box)."""
    t_n = torch.full_like(o[:, 0], -_BIG)
    t_f = torch.full_like(o[:, 0], _BIG)
    for k in range(3):
        dc = d[:, k]
        inv = 1.0 / torch.where(torch.abs(dc) < 1e-12,
                                torch.where(dc >= 0, 1e-12, -1e-12), dc)
        t0 = (bmin[k] - o[:, k]) * inv
        t1 = (bmax[k] - o[:, k]) * inv
        t_n = torch.maximum(t_n, torch.minimum(t0, t1))
        t_f = torch.minimum(t_f, torch.maximum(t0, t1))
    ok = (t_n <= t_f) & (t_f > 1e-4)
    entering = t_n > 1e-4
    t_hit = torch.where(entering, t_n, t_f)
    return ok, torch.where(ok, t_hit, _BIG), entering


def _camera_ray(K, px, py):
    """Continuous raster coordinates -> normalized world direction."""
    rc, cw = K.rc, K.cw
    xc = rc[0] * px + rc[1] * py + rc[3]
    yc = rc[4] * px + rc[5] * py + rc[7]
    zc = rc[8] * px + rc[9] * py + rc[11]
    wc = rc[12] * px + rc[13] * py + rc[15]
    inv_w = torch.where(torch.abs(wc - 1.0) < 1e-9, 1.0, 1.0 / wc)
    dc = _normalize(torch.stack([xc * inv_w, yc * inv_w, zc * inv_w], -1))
    dx = cw[0] * dc[:, 0] + cw[1] * dc[:, 1] + cw[2] * dc[:, 2]
    dy = cw[4] * dc[:, 0] + cw[5] * dc[:, 1] + cw[6] * dc[:, 2]
    dz = cw[8] * dc[:, 0] + cw[9] * dc[:, 1] + cw[10] * dc[:, 2]
    return _normalize(torch.stack([dx, dy, dz], -1))


def _hg_value(K, cos_theta):
    denom = torch.clamp(K.c1 + K.c2 * cos_theta, min=1e-12)
    return K.c3_t / (denom * torch.sqrt(denom))


def _sample_hg(K, wo, u0, u1):
    """HG direction around -wo (pbrt convention) and its pdf."""
    if K.iso:
        cos_t = 1.0 - 2.0 * u0
    else:
        sq = K.omg2_t / (K.opg - K.c2 * u0)
        cos_t = -(K.c1 - sq * sq) / K.c2_t
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = K.two_pi * u1
    lx = sin_t * torch.cos(phi)
    ly = sin_t * torch.sin(phi)
    vx, vy, vz = wo[:, 0], wo[:, 1], wo[:, 2]
    sign = torch.where(vz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + vz)
    b = vx * vy * a
    t1 = (1.0 + sign * vx * vx * a, sign * b, -sign * vx)
    t2 = (b, sign + vy * vy * a, -vy)
    wi = torch.stack([lx * t1[k] + ly * t2[k] + cos_t * wo[:, k]
                      for k in range(3)], -1)
    return wi, _hg_value(K, cos_t)


def _start_lanes(K, seed, pix, samp):
    """Camera rays + fresh state for lanes (pixel, sample): dimension 0
    jitters the pixel (u0, u1) and picks the hero channel (u2)."""
    u0, u1, u2, _ = rng.uniform4(seed, pix, samp, 0)
    px = (pix % K.nx).to(torch.float32) + 0.5 + (u0 - 0.5)
    py = (pix // K.nx).to(torch.float32) + 0.5 + (u1 - 0.5)
    d = _camera_ray(K, px, py)
    cam_o = torch.tensor([K.cw[3], K.cw[7], K.cw[11]], dtype=torch.float32,
                         device=K.dev)
    ones = torch.ones_like(d)
    return dict(
        pix=pix, samp=samp, dim=torch.ones_like(pix), o=cam_o.expand_as(d),
        d=d, beta=ones, ru=ones, rl=ones, L=torch.zeros_like(d),
        depth=torch.zeros_like(pix),
        hero=torch.clamp(torch.floor(u2 * 3.0).to(torch.int64), max=2),
        med=torch.full_like(pix, -1), spec=torch.zeros_like(pix, dtype=bool),
        eta=torch.ones_like(d[:, 0]))


def _keep(S, mask):
    """The lanes of `mask` of every tensor of S, and of every tensor of a
    NamedTuple in S."""
    return {k: type(v)(*(x[mask] for x in v)) if isinstance(v, tuple)
            else v[mask] for k, v in S.items()}


def _count(counts, key, n):
    """Add n to counts[key] when counting (counts is a dict or None)."""
    if counts is not None:
        counts[key] = counts.get(key, 0) + int(n)


def _render_plain(c, spp, seed, event, counts=None, pixels=None,
                  items=False):
    """Shared driver of the plain versions: lanes are (pixel, sample)
    pairs, chunked; `event` advances every live lane by one path event and
    returns its alive mask; dead lanes commit their radiance and leave.
    `counts` (a dict), when given, gathers the lane-events run. `pixels`
    (flat indices), when given, renders only those; the rest stay 0. With
    `items` each lane's radiance is stored at its (sample, pixel) slot
    instead: the raw (spp, len(pixels), 3) radiances, unscaled."""
    K = _Consts(c)
    seed = int(seed) & 0xFFFFFFFF
    npix = K.nx * K.ny
    if pixels is None:
        pixels = torch.arange(npix, device=K.dev)
    n = pixels.numel()
    total = n * int(spp)
    acc = torch.zeros((total if items else npix, 3), dtype=torch.float32,
                      device=K.dev)

    def commit(S, m):
        if items:
            acc.index_put_((S["lane"][m],), S["L"][m])
        else:
            acc.index_add_(0, S["pix"][m], S["L"][m])

    for start in range(0, total, _PLAIN_CHUNK):
        gid = torch.arange(start, min(total, start + _PLAIN_CHUNK),
                           device=K.dev)
        S = _start_lanes(K, seed, pixels[gid % n], gid // n)
        S["lane"] = gid
        for _ in range(K.max_events):
            if S["pix"].numel() == 0:
                break
            _count(counts, "events", S["pix"].numel())
            alive = event(K, seed, S)
            # NaN/Inf scrub (RayIntegrator, integrators.cpp:308)
            S["L"] = torch.where(torch.isfinite(S["L"]).all(-1)[:, None],
                                 S["L"], 0.0)
            commit(S, ~alive)
            S = _keep(S, alive)
        # lanes still alive after max_events commit what they gathered
        commit(S, torch.ones_like(S["pix"], dtype=torch.bool))
    if items:
        return acc.reshape(int(spp), n, 3)
    return (acc * (c.imaging_ratio / int(spp))).reshape(K.ny, K.nx, 3)


def _where3(m, new, old):
    return torch.where(m[:, None], new, old)


# ---------------------------------------------------------------------------
# B1: homogeneous fog box
# ---------------------------------------------------------------------------


def _homog_event(K, seed, S):
    """One event of ``pallas_volpath._make_kernel`` for every lane of S
    (updated in place). Dimensions: collision/absorb/light-select/env-z,
    then env-phi/phase-u0, then phase-u1."""
    o, d, hero = S["o"], S["d"], S["hero"]
    beta, ru, rl, L = S["beta"], S["ru"], S["rl"], S["L"]
    st_h, sa_h, ss_h = K.st[hero], K.sa[hero], K.ss[hero]
    hit, t_wall, entering = _box_hit(o, d, K.bmin, K.bmax)
    in_med = S["med"] == 0
    seg = torch.where(hit, t_wall, _BIG)

    ua, ub, uc, ud = rng.uniform4(seed, S["pix"], S["samp"], S["dim"])
    t_coll = -torch.log1p(-ua) / torch.clamp(st_h, min=1e-30)
    t_coll = torch.where(st_h > 0, t_coll, _BIG)
    coll = in_med & (t_coll < seg)

    # ran-to-end spectral rescale exp(-seg (sigma - sigma_h))
    ran = in_med & ~coll
    segc = torch.clamp(seg, max=_BIG)
    Te = torch.exp(K.nst * segc[:, None])
    Te_h = torch.clamp(torch.exp(-st_h * segc), min=1e-30)
    se = Te / Te_h[:, None]
    beta = _where3(ran, beta * se, beta)
    ru = _where3(ran, ru * se, ru)
    rl = _where3(ran, rl * se, rl)

    # collision: absorb vs scatter (no null collisions)
    p_absorb = sa_h / torch.clamp(st_h, min=1e-30)
    is_absorb = coll & (ub < p_absorb)
    is_scatter = coll & ~is_absorb
    depth_exceeded = is_scatter & (S["depth"] >= K.max_depth)
    scat = is_scatter & ~depth_exceeded
    S["depth"] = torch.where(scat, S["depth"] + 1, S["depth"])
    Tm = torch.exp(K.nst * t_coll[:, None])
    Tm_h = torch.clamp(torch.exp(-st_h * t_coll), min=1e-30)
    pdf_s = torch.clamp(Tm_h * ss_h, min=1e-30)
    sc = Tm * K.ss / pdf_s[:, None]
    beta = _where3(scat, beta * sc, beta)
    ru = _where3(scat, ru * sc, ru)
    alive = ~(is_absorb | depth_exceeded)

    sp = o + t_coll[:, None] * d
    wo = -d
    un0, un1, _, _ = rng.uniform4(seed, S["pix"], S["samp"], S["dim"] + 1)
    if K.has_point:
        pl = sp - K.lp
        dist2 = torch.clamp(_dot(pl, pl), min=1e-12)
        dist = torch.sqrt(dist2)
        wi = -pl * (1.0 / dist)[:, None]
        f_hg = _hg_value(K, _dot(wo, wi))
        _, t_exit, _ = _box_hit(sp, wi, K.bmin, K.bmax)
        Tr = torch.exp(K.nst * torch.minimum(dist, t_exit)[:, None])
        denom = torch.clamp(_avg3(ru * K.pmf), min=1e-30)
        okp = scat & (f_hg > 0)
        if K.has_env:
            okp = okp & (uc < K.pmf)
        w = f_hg / (dist2 * denom)
        L = _where3(okp, L + beta * Tr * K.lI * w[:, None], L)
    if K.has_env:
        ez = 1.0 - 2.0 * ud
        er = torch.sqrt(torch.clamp(1.0 - ez * ez, min=0.0))
        ephi = K.two_pi * un0
        wi = torch.stack([er * torch.cos(ephi), er * torch.sin(ephi), ez], -1)
        f_hg = _hg_value(K, _dot(wo, wi))
        _, t_exit, _ = _box_hit(sp, wi, K.bmin, K.bmax)
        Tr = torch.exp(K.nst * torch.clamp(t_exit, max=_BIG)[:, None])
        denom = torch.clamp(_avg3(ru * K.penv + ru * f_hg[:, None]),
                            min=1e-30)
        oke = scat & (f_hg > 0)
        if K.has_point:
            oke = oke & (uc >= K.pmf)
        w = f_hg / denom
        L = _where3(oke, L + beta * Tr * K.envL * w[:, None], L)

    u_ph = rng.uniform4(seed, S["pix"], S["samp"], S["dim"] + 2)[0]
    S["dim"] = S["dim"] + 3
    pw, ppdf = _sample_hg(K, wo, un1, u_ph)
    alive = alive & ~(scat & (ppdf <= 0))
    rl = _where3(scat, ru * (1.0 / torch.clamp(ppdf, min=1e-30))[:, None], rl)
    o = _where3(scat, sp, o)
    d2 = _where3(scat, pw, d)

    # non-scattered lanes: escape (env MIS) / interface skip
    flew = alive & ~scat & ~coll
    escaped = flew & ~hit
    if K.has_env:
        first = S["depth"] == 0
        ru_avg = torch.clamp(_avg3(ru), min=1e-30)
        L = _where3(escaped & first, L + beta * K.envL / ru_avg[:, None], L)
        den = torch.clamp(_avg3(ru + rl * K.penv), min=1e-30)
        L = _where3(escaped & ~first, L + beta * K.envL / den[:, None], L)
    alive = alive & ~escaped
    iface = alive & flew & hit
    S["med"] = torch.where(iface, torch.where(entering, 0, -1), S["med"])
    o = _where3(iface, o + (t_wall + 1e-4)[:, None] * d, o)
    S.update(o=o, d=d2, beta=beta, ru=ru, rl=rl, L=L)
    return alive


def render_homog_plain(c: KernelConstants, spp, seed, counts=None):
    """Plain PyTorch version of ``csrc/volpath_homog.cu``: (ny, nx, 3).
    `counts` gathers the lane-events run (key "events")."""
    return _render_plain(c, spp, seed, _homog_event, counts)


# ---------------------------------------------------------------------------
# B2a / B2b: one density grid in the box, with or without triangles
#
# Random stream (the kernel's own): dimension 0 is the camera, as in B1.
# Then each flight iteration of delta tracking (a tentative collision or a
# majorant-cell crossing) draws one dimension [step, event]; a real scatter
# draws one for NEE [light select, env u, env v], one per iteration of the
# shadow ray's ratio tracking [step, roulette], and one for the phase
# function [u0, u1, Russian roulette]. A surface hit (teaser class) draws
# one for NEE [light select, env u, env v], the shadow walk's, and one for
# the BSDF [lobe, u0, u1, Russian roulette]. A shadow ray that an opaque
# triangle blocks draws nothing.
# ---------------------------------------------------------------------------


def _put(t, idx, v):
    return t.index_put((idx,), v)


def _sel3(v, hero):
    return torch.gather(v, 1, hero[:, None])[:, 0]


def _max3(v):
    return torch.amax(v, dim=-1)


def _grid_media(K, c):
    """The grid of a grid-class KernelConstants as a one-grid ``Media``
    (medium id 0), walked by ``media.seg_init``/``seg_next``."""
    z3 = torch.zeros(3, device=K.dev)
    f = c.fconst
    gm = GridMedium(c.density, K.sa, K.ss, z3, torch.zeros((), device=K.dev),
                    f[F_BMIN:F_BMIN + 3], f[F_BMAX:F_BMAX + 3], c.majorant,
                    K.res, K.mres)
    empty = torch.zeros((0, 3), device=K.dev)
    return Media(empty, empty, empty, torch.zeros(0, device=K.dev), (gm,))


def _seg_start(media, o, d, t_max):
    """Majorant DDA over [0, t_max] of (o, d): the per-lane cursor and the
    lanes whose ray misses the grid."""
    mid = torch.zeros(t_max.shape, dtype=torch.int64, device=t_max.device)
    it = seg_init(media, mid, o, d, t_max, torch.ones_like(mid, dtype=bool))
    return it, it.done


def _seg_advance(media, it, past):
    """Move the lanes in `past` to their next majorant cell; the cursor and
    the lanes that left the grid."""
    mid = torch.zeros_like(it.step[:, 0])
    it = seg_next(media, mid, it, past)
    return it, it.done


def _flight(K, media, seed, F, counts=None):
    """Delta tracking of the lanes of F along (o, d) over [0, seg]
    (``volpath.sample_medium_interaction`` per lane). Updates F's dim,
    beta, ru, rl, depth; adds scattered, terminated and t_scatter."""
    n = F["pix"].numel()
    dev = K.dev
    it, miss = _seg_start(media, F["o"], F["d"], F["seg"])
    W = dict(it=it, t_min=it.t_seg_start, i=torch.arange(n, device=dev),
             T_maj=torch.ones_like(F["o"]),
             **{k: F[k] for k in ("pix", "samp", "dim", "o", "d", "hero",
                                  "beta", "ru", "rl", "depth")})
    F["scattered"] = torch.zeros(n, dtype=torch.bool, device=dev)
    F["terminated"] = torch.zeros(n, dtype=torch.bool, device=dev)
    F["t_scatter"] = torch.zeros(n, device=dev)
    W = _keep(W, ~miss)  # missed the grid: ran to the end with T_maj = 1

    def finish(W, fin, ran):
        """Write finished lanes back; lanes that ran to the end of their
        flight get the hero-relative rescale T_maj / T_maj[hero]."""
        T_h = torch.clamp(_sel3(W["T_maj"], W["hero"]), min=1e-30)
        scale = torch.where(ran[:, None], W["T_maj"] / T_h[:, None], 1.0)
        i = W["i"][fin]
        for k in ("beta", "ru", "rl"):
            F[k] = _put(F[k], i, (W[k] * scale)[fin])
        for k in ("dim", "depth"):
            F[k] = _put(F[k], i, W[k][fin])

    for _ in range(K.max_coll):
        if W["i"].numel() == 0:
            break
        _count(counts, "flight_steps", W["i"].numel())
        hero = W["hero"]
        ua, ub, _, _ = rng.uniform4(seed, W["pix"], W["samp"], W["dim"])
        W["dim"] = W["dim"] + 1
        it = W["it"]
        sigma_maj = it.sigma_maj
        maj_h = _sel3(sigma_maj, hero)
        t = torch.where(maj_h > 0, W["t_min"] + (-torch.log1p(-ua))
                        / torch.clamp(maj_h, min=1e-30), torch.inf)
        past = t >= it.t_seg_end
        dt = torch.clamp(it.t_seg_end - W["t_min"], 0.0, 3e37)
        T_maj = _where3(past, W["T_maj"] * torch.exp(-dt[:, None] * sigma_maj),
                        W["T_maj"])
        W["it"], exhausted = _seg_advance(media, it, past)

        coll = ~past
        t_min = torch.where(past, W["it"].t_seg_start, W["t_min"])
        T_maj = _where3(coll, T_maj * torch.exp(-(t - t_min)[:, None]
                                                * sigma_maj), T_maj)
        dens = media.grids[0].density_at(W["o"] + t[:, None] * W["d"])
        sa_c = dens[:, None] * K.sa
        ss_c = dens[:, None] * K.ss
        T_maj_h = _sel3(T_maj, hero)
        sa_h, ss_h = _sel3(sa_c, hero), _sel3(ss_c, hero)
        p_absorb = sa_h / torch.clamp(maj_h, min=1e-30)
        p_scatter = ss_h / torch.clamp(maj_h, min=1e-30)
        is_absorb = coll & (ub < p_absorb)
        is_scatter = coll & ~is_absorb & (ub < p_absorb + p_scatter)
        is_null = coll & ~is_absorb & ~is_scatter
        depth_exceeded = is_scatter & (W["depth"] >= K.max_depth)
        do_scatter = is_scatter & ~depth_exceeded
        W["depth"] = torch.where(do_scatter, W["depth"] + 1, W["depth"])
        scale_s = T_maj * ss_c / torch.clamp(T_maj_h * ss_h,
                                             min=1e-30)[:, None]
        beta = _where3(do_scatter, W["beta"] * scale_s, W["beta"])
        ru = _where3(do_scatter, W["ru"] * scale_s, W["ru"])
        rl = W["rl"]
        sigma_n = torch.clamp(sigma_maj - sa_c - ss_c, min=0.0)
        pdf_n = T_maj_h * _sel3(sigma_n, hero)
        inv_pdf_n = (1.0 / torch.clamp(pdf_n, min=1e-30))[:, None]
        beta = _where3(is_null, beta * T_maj * sigma_n * inv_pdf_n, beta)
        beta = _where3(is_null & (pdf_n == 0), torch.zeros_like(beta), beta)
        ru = _where3(is_null, ru * T_maj * sigma_n * inv_pdf_n, ru)
        rl = _where3(is_null, rl * T_maj * sigma_maj * inv_pdf_n, rl)
        died = is_null & ((_max3(beta) == 0) | (_max3(ru) == 0))
        W["T_maj"] = _where3(is_null & ~died, torch.ones_like(T_maj), T_maj)
        W["t_min"] = torch.where(is_null, t, t_min)
        W.update(beta=beta, ru=ru, rl=rl)

        term = is_absorb | depth_exceeded | died
        fin = term | do_scatter | exhausted
        finish(W, fin, exhausted)
        i = W["i"]
        F["scattered"] = _put(F["scattered"], i[do_scatter],
                              torch.ones_like(i[do_scatter], dtype=torch.bool))
        F["terminated"] = _put(F["terminated"], i[term],
                               torch.ones_like(i[term], dtype=torch.bool))
        F["t_scatter"] = _put(F["t_scatter"], i[do_scatter], t[do_scatter])
        W = _keep(W, ~fin)
    # lanes stopped by max_collisions count as having reached the end
    finish(W, torch.ones_like(W["i"], dtype=torch.bool),
           torch.ones_like(W["i"], dtype=torch.bool))


def _ratio_track(K, media, seed, P, counts=None):
    """Ratio-tracking transmittance of shadow rays (o, wi) over [0, seg]
    (``volpath.transmittance_ratio_tracking`` per lane, with its
    low-transmittance roulette). Updates P's dim; adds T_ray, tr_l, tr_u."""
    n = P["pix"].numel()
    dev = K.dev
    it, miss = _seg_start(media, P["o"], P["wi"], P["seg"])
    ones = torch.ones_like(P["o"])
    W = dict(it=it, t_min=it.t_seg_start, i=torch.arange(n, device=dev),
             T_maj=ones, T_ray=ones, tr_l=ones, tr_u=ones,
             **{k: P[k] for k in ("pix", "samp", "dim", "o", "wi", "hero")})
    P.update(T_ray=ones, tr_l=ones, tr_u=ones)
    W = _keep(W, ~miss)

    def finish(W, fin):
        T_h = torch.clamp(_sel3(W["T_maj"], W["hero"]), min=1e-30)
        scale = W["T_maj"] / T_h[:, None]
        i = W["i"][fin]
        for k in ("T_ray", "tr_l", "tr_u"):
            P[k] = _put(P[k], i, (W[k] * scale)[fin])
        P["dim"] = _put(P["dim"], i, W["dim"][fin])

    for _ in range(K.max_coll):
        if W["i"].numel() == 0:
            break
        _count(counts, "shadow_steps", W["i"].numel())
        hero = W["hero"]
        ua, u_rr, _, _ = rng.uniform4(seed, W["pix"], W["samp"], W["dim"])
        W["dim"] = W["dim"] + 1
        it = W["it"]
        sigma_maj = it.sigma_maj
        maj_h = _sel3(sigma_maj, hero)
        t = torch.where(maj_h > 0, W["t_min"] + (-torch.log1p(-ua))
                        / torch.clamp(maj_h, min=1e-30), torch.inf)
        past = t >= it.t_seg_end
        dt = torch.clamp(it.t_seg_end - W["t_min"], 0.0, 3e37)
        T_maj = _where3(past, W["T_maj"] * torch.exp(-dt[:, None] * sigma_maj),
                        W["T_maj"])
        W["it"], exhausted = _seg_advance(media, it, past)

        coll = ~past
        t_min = torch.where(past, W["it"].t_seg_start, W["t_min"])
        T_maj = _where3(coll, T_maj * torch.exp(-(t - t_min)[:, None]
                                                * sigma_maj), T_maj)
        dens = media.grids[0].density_at(W["o"] + t[:, None] * W["wi"])
        sigma_n = torch.clamp(sigma_maj - dens[:, None] * K.sa
                              - dens[:, None] * K.ss, min=0.0)
        pdf = torch.clamp(_sel3(T_maj, hero) * maj_h, min=1e-30)[:, None]
        T_ray = _where3(coll, W["T_ray"] * T_maj * sigma_n / pdf, W["T_ray"])
        tr_l = _where3(coll, W["tr_l"] * T_maj * sigma_maj / pdf, W["tr_l"])
        tr_u = _where3(coll, W["tr_u"] * T_maj * sigma_n / pdf, W["tr_u"])
        Tr = T_ray / torch.clamp(_avg3(tr_l + tr_u), min=1e-30)[:, None]
        low = coll & (_max3(Tr) < 0.05)
        killed = low & (u_rr < 0.75)
        T_ray = _where3(killed, torch.zeros_like(T_ray), T_ray)
        T_ray = _where3(low & ~killed, T_ray / 0.25, T_ray)
        dead = coll & (_max3(T_ray) == 0)
        W["T_maj"] = _where3(coll & ~dead, torch.ones_like(T_maj), T_maj)
        W["t_min"] = torch.where(coll, t, t_min)
        W.update(T_ray=T_ray, tr_l=tr_l, tr_u=tr_u)
        fin = exhausted | dead
        finish(W, fin)
        W = _keep(W, ~fin)
    finish(W, torch.ones_like(W["i"], dtype=torch.bool))


def _tri_hit(tab, o, d, t_max):
    """Closest triangle of table `tab` along (o, d) nearer than t_max: the
    kernels' Moller-Trumbore sweep (``pallas_vspg`` closest_hit), by brute
    force over every row, in chunks of lanes. Returns (hit, t (_BIG on a
    miss), index, b1, b2) per lane."""
    step = max(1, _TRI_PAIRS // max(tab.shape[0], 1))
    if o.shape[0] <= step:
        return _tri_hit_chunk(tab, o, d, t_max)
    parts = [_tri_hit_chunk(tab, o[i:i + step], d[i:i + step],
                            t_max[i:i + step])
             for i in range(0, o.shape[0], step)]
    return tuple(torch.cat(x) for x in zip(*parts))


def _tri_hit_chunk(tab, o, d, t_max):
    def col(j):
        return tab[:, j][None, :]

    ox, oy, oz = (o[:, k:k + 1] for k in range(3))
    dx, dy, dz = (d[:, k:k + 1] for k in range(3))
    e1x, e1y, e1z = col(T_E1), col(T_E1 + 1), col(T_E1 + 2)
    e2x, e2y, e2z = col(T_E2), col(T_E2 + 1), col(T_E2 + 2)
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    big = torch.abs(det) > 1e-12
    inv_det = torch.where(big, 1.0 / det, 0.0)
    tvx, tvy, tvz = ox - col(T_P0), oy - col(T_P0 + 1), oz - col(T_P0 + 2)
    b1 = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    b2 = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    ok = (big & (b1 >= 0.0) & (b2 >= 0.0) & (b1 + b2 <= 1.0) & (tt > 1e-4)
          & (tt < t_max[:, None]))
    tt = torch.where(ok, tt, torch.inf)
    k = torch.argmin(tt, dim=1)
    t = torch.gather(tt, 1, k[:, None])[:, 0]
    hit = torch.isfinite(t)

    def at(x):
        return torch.gather(x, 1, k[:, None])[:, 0]

    return hit, torch.where(hit, t, _BIG), k, at(b1), at(b2)


def _light_pick(K, p, u_sel, ua, ub):
    """NEE light choice at p: (use_point, wi, dist, dist2)."""
    use_point = torch.full_like(u_sel, K.has_point, dtype=torch.bool)
    if K.has_point and K.has_env:
        use_point = u_sel < K.pmf
    pl = p - K.lp
    dist2 = torch.clamp(_dot(pl, pl), min=1e-12)
    dist = torch.sqrt(dist2)
    ez = 1.0 - 2.0 * ua
    er = torch.sqrt(torch.clamp(1.0 - ez * ez, min=0.0))
    phi = K.two_pi * ub
    wi = torch.where(use_point[:, None], -pl * (1.0 / dist)[:, None],
                     torch.stack([er * torch.cos(phi), er * torch.sin(phi),
                                  ez], -1))
    return use_point, wi, dist, dist2


def _nee(K, media, seed, P, p, wi, use_point, dist, dist2, f_hat, spdf, ok,
         tris, in_med, counts):
    """The NEE contribution of lanes P from p toward wi: f_hat (N,3) is
    the BSDF or phase value times the cosine, spdf the scattering pdf for
    MIS against env hits. Opaque triangles block; lanes in the medium
    ratio-track their shadow ray to the box exit. Updates P's dim."""
    _, t_exit, _ = _box_hit(p, wi, K.bmin, K.bmax)
    seg = torch.where(use_point, dist, _BIG)
    if tris is not None:
        n_ok = ok.sum()
        _count(counts, "shadow_queries", n_ok)
        _count(counts, "tri_tests", n_ok * tris.shape[0])
        blocked = _tri_hit(tris, p, wi, seg)[0]
        ok_t = ok & ~blocked
    else:
        ok_t = ok
    P.update(o=p, wi=wi, seg=torch.minimum(seg, t_exit))
    T_ray = torch.where(ok_t[:, None], 1.0, torch.zeros_like(p))
    tr_l = tr_u = torch.ones_like(p)
    j = torch.nonzero(ok_t & in_med)[:, 0]
    if j.numel():
        Q = {k: v[j] for k, v in P.items()}
        _ratio_track(K, media, seed, Q, counts)
        P["dim"] = _put(P["dim"], j, Q["dim"])
        T_ray = _put(T_ray, j, Q["T_ray"])
        tr_l = _put(tr_l, j, Q["tr_l"])
        tr_u = _put(tr_u, j, Q["tr_u"])
    ru = P["ru"]
    Le = torch.where(use_point[:, None], K.lI / dist2[:, None], K.envL)
    p_l = torch.where(use_point, K.pmf, K.penv)
    r_l = tr_l * ru * p_l[:, None]
    r_u = tr_u * ru * spdf[:, None]
    denom = torch.where(use_point, _avg3(r_l), _avg3(r_l + r_u))
    contrib = (P["beta"] * f_hat * T_ray * Le
               / torch.clamp(denom, min=1e-30)[:, None])
    return torch.where((ok & (denom > 0))[:, None], contrib, 0.0)


def _russian_roulette(K, beta, ru, eta, depth, ok, u_rr):
    """Throughput roulette after NEE and sampling (integrators.cpp:
    1301-1312): (beta, killed)."""
    rr_max = _max3(beta * eta[:, None]
                   / torch.clamp(_avg3(ru), min=1e-30)[:, None])
    do_rr = ok & (depth >= K.rr_start) & (rr_max < 1.0)
    q = torch.clamp(1.0 - rr_max, min=0.0)
    rr_kill = do_rr & (u_rr < q)
    beta = _where3(do_rr & ~rr_kill,
                   beta / torch.clamp(1.0 - q, min=1e-6)[:, None], beta)
    return beta, rr_kill


def _surface_lanes(mats, tris, k, b1, b2):
    """The BSDFLanes of hits on triangles k at barycentrics (b1, b2), the
    checker albedo evaluated at the interpolated uv."""
    from ..models.materials import BSDFLanes

    tri = tris[k]
    m = mats[tri[:, T_MAT].long()]
    b0 = 1.0 - b1 - b2
    uv = (b0[:, None] * tri[:, T_UV0:T_UV0 + 2]
          + b1[:, None] * tri[:, T_UV1:T_UV1 + 2]
          + b2[:, None] * tri[:, T_UV2:T_UV2 + 2])
    su = uv * m[:, M_UVS:M_UVS + 2]
    odd = (torch.floor(su[:, 0]) + torch.floor(su[:, 1])).to(
        torch.int32) % 2 != 0
    alb = m[:, M_ALB:M_ALB + 3]
    checker = m[:, M_TEX] == 1.0
    alb = torch.where(checker[:, None],
                      torch.where(odd[:, None], m[:, M_C1:M_C1 + 3],
                                  m[:, M_C0:M_C0 + 3]), alb)
    return BSDFLanes(m[:, M_KIND].to(torch.int32), alb, m[:, M_ETA],
                     m[:, M_ROUGH])


def _surface_event(K, media, seed, S, idx, hit_t, k, b1, b2, tris, mats,
                   counts):
    """NEE and BSDF sampling at the surface hits of lanes idx (the surface
    half of ``volpath.volpath_bounce``, with its reflection-keeps-medium
    rule). Returns their alive mask."""
    from ..models.materials import bsdf_f, bsdf_pdf, bsdf_sample
    from ..utils.vecmath import coordinate_system

    _count(counts, "surface_events", idx.numel())
    P = {key: S[key][idx] for key in ("pix", "samp", "dim", "hero", "beta",
                                      "ru", "rl", "L", "depth", "med",
                                      "spec", "eta", "o", "d")}
    d = P["d"]
    ok_depth = P["depth"] < K.max_depth
    P["depth"] = torch.where(ok_depth, P["depth"] + 1, P["depth"])
    p = P["o"] + hit_t[:, None] * d
    ng = tris[k][:, T_NG:T_NG + 3]
    lanes = _surface_lanes(mats, tris, k, b1, b2)
    t1, t2 = coordinate_system(ng)

    def to_local(w):
        return torch.stack([_dot(w, t1), _dot(w, t2), _dot(w, ng)], -1)

    wo_l = to_local(-d)
    # NEE from the offset origin (non-specular lanes)
    u_sel, ua, ub, _ = rng.uniform4(seed, P["pix"], P["samp"], P["dim"])
    P["dim"] = P["dim"] + 1
    scl = torch.clamp(torch.amax(torch.abs(p), -1), min=1.0)
    sgn_o = torch.where(_dot(ng, -d) >= 0.0, 1.0, -1.0)
    p_off = p + (sgn_o * 1e-4 * scl)[:, None] * ng
    use_point, wi, dist, dist2 = _light_pick(K, p_off, u_sel, ua, ub)
    wi_l = to_local(wi)
    f_hat = bsdf_f(lanes, wo_l, wi_l) * torch.abs(_dot(wi, ng))[:, None]
    spdf = bsdf_pdf(lanes, wo_l, wi_l)
    ok = ok_depth & ~lanes.is_specular & (_max3(f_hat) > 0)
    P["o"] = p_off
    L = P["L"] + _nee(K, media, seed, P, p_off, wi, use_point, dist, dist2,
                      f_hat, spdf, ok, tris, P["med"] == 0, counts)
    # BSDF sampling
    u_lobe, v0, v1, u_rr = rng.uniform4(seed, P["pix"], P["samp"], P["dim"])
    P["dim"] = P["dim"] + 1
    bs = bsdf_sample(lanes, wo_l, u_lobe, torch.stack([v0, v1], -1))
    bs_ok = ok_depth & bs.valid & (bs.pdf > 0)
    w = _normalize_safe(bs.wi[:, 0:1] * t1 + bs.wi[:, 1:2] * t2
                        + bs.wi[:, 2:3] * ng)
    scale_b = (bs.f * torch.abs(_dot(w, ng))[:, None]
               / torch.clamp(bs.pdf, min=1e-30)[:, None])
    beta = _where3(bs_ok, P["beta"] * scale_b, P["beta"])
    rl = _where3(bs_ok, P["ru"] / torch.clamp(bs.pdf, min=1e-30)[:, None],
                 P["rl"])
    spec = torch.where(bs_ok, bs.is_specular, P["spec"])
    eta = torch.where(bs_ok & bs.is_transmission, P["eta"] * bs.eta * bs.eta,
                      P["eta"])
    # a reflected ray keeps its medium; a crossing adopts the far side's
    wi_front = _dot(w, ng) > 0
    crossed = bs_ok & (wi_front != (_dot(d, ng) < 0))
    tri = tris[k]
    far = torch.where(wi_front, tri[:, T_MED_OUT], tri[:, T_MED_IN]).long()
    med = torch.where(crossed, far, P["med"])
    sgn_w = torch.where(_dot(ng, w) >= 0.0, 1.0, -1.0)
    o_new = p + (sgn_w * 1e-4 * scl)[:, None] * ng
    alive = bs_ok & (_max3(beta) != 0)
    beta, rr_kill = _russian_roulette(K, beta, P["ru"], eta, P["depth"],
                                      alive, u_rr)
    for key, v in (("o", o_new), ("d", w), ("beta", beta), ("rl", rl),
                   ("L", L), ("dim", P["dim"]), ("depth", P["depth"]),
                   ("spec", spec), ("eta", eta), ("med", med)):
        S[key] = _put(S[key], idx, v)
    return alive & ~rr_kill


def _normalize_safe(v):
    """v / |v|, zero for a zero vector (vecmath.normalize)."""
    n = torch.sqrt(_dot(v, v))
    return v * torch.where(n != 0, 1.0 / torch.where(n != 0, n, 1.0),
                           0.0)[:, None]


def _grid_event(K, media, seed, S, tris=None, mats=None, counts=None):
    """One path event of ``csrc/volpath_grid.cuh`` for every lane of S (the
    TRIS instantiation when `tris` holds the triangle table)."""
    dev = K.dev
    n = S["pix"].numel()
    o, d = S["o"], S["d"]
    # stuck-lane guard: a lane whose origin left the box is in vacuum
    gm = media.grids[0]
    outside = ((o < gm.b_min) | (o > gm.b_max)).any(-1)
    S["med"] = torch.where((S["med"] == 0) & outside, -1, S["med"])
    hit, t_wall, entering = _box_hit(o, d, K.bmin, K.bmax)
    wall = torch.where(hit, t_wall, _BIG)
    if tris is not None:
        _count(counts, "tri_queries", n)
        _count(counts, "tri_tests", n * tris.shape[0])
        s_hit, t_surf, s_k, s_b1, s_b2 = _tri_hit(tris, o, d, wall)
    else:
        s_hit = torch.zeros(n, dtype=torch.bool, device=dev)
        t_surf = wall

    scattered = torch.zeros(n, dtype=torch.bool, device=dev)
    terminated = torch.zeros(n, dtype=torch.bool, device=dev)
    t_sc = torch.zeros(n, device=dev)
    idx = torch.nonzero(S["med"] == 0)[:, 0]
    if idx.numel():
        F = {k: S[k][idx] for k in ("pix", "samp", "dim", "o", "d", "hero",
                                     "beta", "ru", "rl", "depth")}
        F["seg"] = torch.minimum(wall, t_surf)[idx]
        _flight(K, media, seed, F, counts)
        for k in ("dim", "beta", "ru", "rl", "depth"):
            S[k] = _put(S[k], idx, F[k])
        scattered = _put(scattered, idx, F["scattered"])
        terminated = _put(terminated, idx, F["terminated"])
        t_sc = _put(t_sc, idx, F["t_scatter"])
    alive = ~terminated

    idx = torch.nonzero(scattered)[:, 0]
    if idx.numel():
        P = {k: S[k][idx] for k in ("pix", "samp", "dim", "hero", "beta",
                                     "ru")}
        p = o[idx] + t_sc[idx][:, None] * d[idx]
        wo = -d[idx]
        u_sel, ua, ub, _ = rng.uniform4(seed, P["pix"], P["samp"], P["dim"])
        P["dim"] = P["dim"] + 1
        use_point, wi, dist, dist2 = _light_pick(K, p, u_sel, ua, ub)
        f = _hg_value(K, _dot(wo, wi))
        L = S["L"][idx] + _nee(K, media, seed, P, p, wi, use_point, dist,
                               dist2, f[:, None], f, f > 0, tris,
                               torch.ones_like(f, dtype=torch.bool), counts)
        v0, v1, v_rr, _ = rng.uniform4(seed, P["pix"], P["samp"], P["dim"])
        P["dim"] = P["dim"] + 1
        wi_p, ppdf = _sample_hg(K, wo, v0, v1)
        ok_phase = ppdf > 0
        ru = P["ru"]
        rl = ru / torch.clamp(ppdf, min=1e-30)[:, None]
        beta, rr_kill = _russian_roulette(K, P["beta"], ru, S["eta"][idx],
                                          S["depth"][idx], ok_phase, v_rr)
        alive = _put(alive, idx, ok_phase & ~rr_kill)
        for k, v in (("o", p), ("d", wi_p), ("rl", rl), ("beta", beta),
                     ("L", L), ("dim", P["dim"])):
            S[k] = _put(S[k], idx, v)
        S["spec"] = _put(S["spec"], idx, torch.zeros_like(idx,
                                                          dtype=torch.bool))

    # lanes that flew through: a surface, escape with env MIS, or the wall
    flew = alive & ~scattered
    at_surf = flew & s_hit
    escaped = flew & ~hit & ~s_hit
    if K.has_env:
        beta, ru, rl, L = S["beta"], S["ru"], S["rl"], S["L"]
        first = (S["depth"] == 0) | S["spec"]
        L = _where3(escaped & first, L + beta * K.envL
                    / torch.clamp(_avg3(ru), min=1e-30)[:, None], L)
        den = torch.clamp(_avg3(ru + rl * K.penv), min=1e-30)
        S["L"] = _where3(escaped & ~first, L + beta * K.envL / den[:, None], L)
    alive = alive & ~escaped
    iface = flew & hit & ~s_hit
    S["med"] = torch.where(iface, torch.where(entering, 0, -1), S["med"])
    S["o"] = _where3(iface, S["o"] + (t_wall + 1e-4)[:, None] * S["d"],
                     S["o"])
    idx = torch.nonzero(at_surf)[:, 0]
    if idx.numel():
        alive = _put(alive, idx, _surface_event(
            K, media, seed, S, idx, t_surf[idx], s_k[idx], s_b1[idx],
            s_b2[idx], tris, mats, counts))
    return alive


def render_grid_plain(c: KernelConstants, spp, seed, counts=None,
                      pixels=None):
    """Plain PyTorch version of ``csrc/volpath_grid.cuh``: (ny, nx, 3).
    With triangles its closest hit is a brute-force sweep of the table
    whatever their number, independent of the mesh class's BVH, which the
    kernel's traversal is held to. `counts` gathers the lane-events, flight
    steps and shadow-walk steps run, and with triangles the surface events,
    the closest-hit and shadow queries and their ray-triangle tests (keys
    "events", "flight_steps", "shadow_steps", "surface_events",
    "tri_queries", "shadow_queries", "tri_tests"). `pixels` (flat
    indices), when given, renders only those pixels; the rest stay 0."""
    K = _Consts(c)
    media = _grid_media(K, c)
    return _render_plain(
        c, spp, seed,
        lambda K, seed, S: _grid_event(K, media, seed, S, c.tris, c.mats,
                                       counts), counts, pixels)


def render_grid_items_plain(c: KernelConstants, spp, seed, pixels=None):
    """Plain PyTorch version of the item kernel of ``csrc/volpath_grid.cuh``:
    the raw radiance (spp, npix, 3) of every (sample, pixel) item, each a
    lane of its own from a fresh path (``render_grid_plain``'s lanes, each
    stored at its slot). With `pixels` (flat indices) the (spp,
    len(pixels), 3) items of those pixels. ``vspg_kernels.
    reduce_samples_plain(items, None, 0, out_scale)`` sums them per pixel
    in the kernel's order."""
    K = _Consts(c)
    media = _grid_media(K, c)
    if pixels is not None:
        pixels = torch.as_tensor(pixels, dtype=torch.int64, device=K.dev)
    return _render_plain(
        c, spp, seed,
        lambda K, seed, S: _grid_event(K, media, seed, S, c.tris, c.mats),
        pixels=pixels, items=True)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check(t, dtype, shape, device, name):
    if (t.device != device or t.dtype != dtype or not t.is_contiguous()
            or tuple(t.shape) != tuple(shape)):
        raise ValueError(f"{name}: want a contiguous {dtype} tensor of shape "
                         f"{tuple(shape)} on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def render_homog(c: KernelConstants, spp, seed):
    """B1: render the homogeneous-fog class; the CUDA kernel on a card (on
    the current stream of the constants' card), the plain version for
    constants on the CPU."""
    from . import _build

    if c.kind != "homog":
        raise ValueError(f"render_homog got a {c.kind!r} scene")
    dev = c.fconst.device
    if dev.type == "cpu":
        return render_homog_plain(c, spp, seed)
    if dev.type != "cuda":
        raise ValueError(f"homog: no kernel for device {dev}")
    _check(c.fconst, torch.float32, (N_FCONST,), dev, "fconst")
    _check(c.iconst, torch.int32, (N_ICONST,), dev, "iconst")
    if int(spp) < 1:
        raise ValueError("spp must be at least 1")
    lib = _build.load()
    with torch.cuda.device(dev):
        out = torch.empty((c.ny, c.nx, 3), dtype=torch.float32, device=dev)
        err = lib.volpath_homog_launch(
            c.fconst.data_ptr(), c.iconst.data_ptr(), out.data_ptr(),
            c.nx * c.ny, int(spp), int(seed) & 0xFFFFFFFF,
            c.imaging_ratio / int(spp),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"volpath_homog kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["homog"] += 1
    return out


def _grid_args(c: KernelConstants):
    """Check a grid-class launch's tables on their card; returns the entry
    point's stem, the table pointers and (nmaj, n_tri, n_node, n_mat)."""
    dev = c.fconst.device
    if dev.type != "cuda":
        raise ValueError(f"render_grid: no kernel for device {dev}")
    _check(c.fconst, torch.float32, (N_FCONST,), dev, "fconst")
    _check(c.iconst, torch.int32, (N_ICONST,), dev, "iconst")
    res = tuple(int(v) for v in c.iconst[I_GX:I_GX + 3].tolist())
    mres = tuple(int(v) for v in c.iconst[I_MX:I_MX + 3].tolist())
    _check(c.density, torch.float32, res, dev, "density")
    _check(c.majorant, torch.float32, mres, dev, "majorant")
    nmaj = mres[0] * mres[1] * mres[2]
    if nmaj > MAX_MAJ_VOX:
        raise ValueError(f"majorant grid of {nmaj} cells exceeds "
                         f"{MAX_MAJ_VOX}")
    ptrs = [c.fconst.data_ptr(), c.iconst.data_ptr(), c.density.data_ptr(),
            c.majorant.data_ptr(), 0, 0, 0]
    if c.tris is None:
        return "grid", ptrs, (nmaj, 0, 0, 0)
    n_tri, n_mat = c.n_tri, int(c.mats.shape[0])
    cap = MAX_TRIS_GRID if c.nodes is None else MAX_TRIS_MESH
    if not (1 <= n_tri <= cap and 1 <= n_mat <= MAX_MATS):
        raise ValueError(f"{n_tri} triangles / {n_mat} materials: the kernel "
                         f"takes 1-{cap} and 1-{MAX_MATS}")
    _check(c.tris, torch.float32, (n_tri, TRI_COLS), dev, "tris")
    _check(c.mats, torch.float32, (n_mat, MAT_COLS), dev, "mats")
    ptrs[4], ptrs[6] = c.tris.data_ptr(), c.mats.data_ptr()
    if c.nodes is None:
        return "grid_tris", ptrs, (nmaj, n_tri, 0, n_mat)
    n_node = int(c.nodes.shape[0])
    _check(c.nodes, torch.float32, (n_node, NODE_COLS), dev, "nodes")
    # the kernel reads both tables as float4s
    if c.tris.data_ptr() % 16 or c.nodes.data_ptr() % 16:
        raise ValueError("tris and nodes must be 16-byte aligned")
    ptrs[5] = c.nodes.data_ptr()
    return "grid_mesh", ptrs, (nmaj, n_tri, n_node, n_mat)


def grid_info(c: KernelConstants, lib=None):
    """The item kernel's persistent grid for the constants' scene class on
    their card: blocks (the SMs times the resident blocks an SM), per_sm,
    sms, and the build's registers and local-memory bytes a thread (`lib`
    as for ``grid_items``)."""
    from . import _build

    name, _, (nmaj, n_tri, _, n_mat) = _grid_args(c)
    lib = _build.load() if lib is None else lib
    info = (ctypes.c_int * 4)()
    with torch.cuda.device(c.fconst.device):
        err = getattr(lib, f"volpath_{name}_info")(nmaj, n_tri, n_mat, info)
    if err != 0:
        raise RuntimeError(f"volpath_{name}_info failed: CUDA error {err}")
    per_sm, sms, regs, local = info
    return dict(blocks=per_sm * sms, per_sm=per_sm, sms=sms, regs=regs,
                local_bytes=local)


def grid_chunk_samples(npix, spp):
    """Samples per chunk of a grid render: as many as
    ``vspg_kernels.SCRATCH_BYTES`` of per-item radiance hold, at least
    one."""
    from . import vspg_kernels as sk

    return max(1, min(int(spp), sk.SCRATCH_BYTES // (12 * int(npix))))


def grid_items(c: KernelConstants, seed, samp0, n_samp, blocks=None,
               lib=None, out=None):
    """B2a-c's item kernel alone: the raw radiances (n_samp, npix, 3) of
    samples samp0, ..., samp0 + n_samp - 1 of every pixel, one (pixel,
    sample) item at a time on `blocks` persistent blocks (None: the SMs
    times the resident blocks an SM), written to `out` (allocated when
    None). `lib`: the package's library (None) or another build of the
    grid sources bound with their entry points (chip_smoke.py times
    some)."""
    from . import _build

    name, ptrs, (nmaj, n_tri, n_node, n_mat) = _grid_args(c)
    n_samp = int(n_samp)
    if n_samp < 1 or int(samp0) < 0:
        raise ValueError(f"samples {samp0}..{samp0 + n_samp - 1}")
    if blocks is not None and int(blocks) < 1:
        raise ValueError(f"blocks must be at least 1, got {blocks}")
    npix = c.nx * c.ny
    dev = c.fconst.device
    lib = _build.load() if lib is None else lib
    with torch.cuda.device(dev):
        if out is None:
            out = torch.empty((n_samp, npix, 3), dtype=torch.float32,
                              device=dev)
        _check(out, torch.float32, (n_samp, npix, 3), dev, "out")
        counter = torch.zeros(1, dtype=torch.int64, device=dev)
        err = getattr(lib, f"volpath_{name}_launch")(
            *ptrs, out.data_ptr(), counter.data_ptr(), npix, int(samp0),
            n_samp, int(seed) & 0xFFFFFFFF, nmaj, n_tri, n_node, n_mat,
            0 if blocks is None else int(blocks),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"volpath_{name} kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES[name] += 1
    return out


def render_grid(c: KernelConstants, spp, seed, blocks=None, lib=None):
    """B2a / B2b / B2c: render the grid-cloud class, with its triangles
    (swept, or through the BVH in the mesh class) when it has any, (ny, nx,
    3). On a card, per chunk of samples (``grid_chunk_samples``) the item
    kernel writes each (pixel, sample)'s radiance to the scratch
    (``grid_items``; `blocks` and `lib` as there) and
    ``vspg_kernels.reduce_samples`` adds it to the image in sample order;
    for constants on the CPU the plain version."""
    from . import vspg_kernels as sk

    if c.kind != "grid":
        raise ValueError(f"render_grid got a {c.kind!r} scene")
    if c.fconst.device.type == "cpu":
        return render_grid_plain(c, spp, seed)
    spp = int(spp)
    if spp < 1:
        raise ValueError("spp must be at least 1")
    npix = c.nx * c.ny
    dev = c.fconst.device
    chunk = grid_chunk_samples(npix, spp)
    n_chunks = -(-spp // chunk)
    with torch.cuda.device(dev):
        lbuf = torch.empty((chunk, npix, 3), dtype=torch.float32, device=dev)
        out = torch.empty((c.ny, c.nx, 3), dtype=torch.float32, device=dev)
        for k in range(n_chunks):
            n = min(chunk, spp - k * chunk)
            grid_items(c, seed, k * chunk, n, blocks, lib, lbuf[:n])
            sk.reduce_samples(lbuf[:n], None, 0, c.imaging_ratio / spp, out,
                              None, k == 0, k == n_chunks - 1)
    return out


def render(c: KernelConstants, spp, seed):
    """Render with the kernel of the constants' scene class."""
    return (render_homog if c.kind == "homog" else render_grid)(c, spp, seed)


# ---------------------------------------------------------------------------
# Bench scenes, built without JAX
# ---------------------------------------------------------------------------


def make_fog_box_scene(*, device):
    """The bench fog (``bench.py`` bench_config1): HG fog box, point light
    inside the box plus a constant environment."""
    from ..models.integrators.volpath import make_fog_box_scene as _fog

    return _fog([0.05, 0.05, 0.05], [0.5, 0.6, 0.7], g=0.3,
                env_L=[0.1, 0.12, 0.15],
                point=((0.0, 0.8, 0.0), (5.0, 5.0, 5.0)), device=device)


def cloud64_density(n=64):
    """The bench cloud's lumpy density (``bench.py`` _cloud_scene), numpy
    (n, n, n) float32."""
    x = np.linspace(-1, 1, n, dtype=np.float32)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    r = np.sqrt(X * X + Y * Y + Z * Z)
    dens = np.clip(1.0 - r, 0.0, None)
    dens *= (0.75 + 0.25 * np.sin(7.1 * X) * np.sin(5.3 * Y + 1.1)
             * np.sin(6.7 * Z + 2.3))
    return (np.clip(dens, 0.0, None) * 4.0).astype(np.float32)


def make_cloud64_scene(*, device):
    """The bench cloud (``bench.py`` _cloud_scene): 64^3 density, 8^3
    majorants, sigma_a 0.1, sigma_s 2.0, g 0.3, external point + env."""
    from ..models.integrators.volpath import Scene
    from ..models.lights import Lights
    from ..models.materials import Materials
    from ..models.media import GridMedium, Media
    from ..models.shapes import Geometry

    gm = GridMedium.make(cloud64_density(), [0.1] * 3, [2.0] * 3,
                         (-1, -1, -1), (1, 1, 1), g=0.3, maj_res=8,
                         device=device)
    lights = Lights.make(point_p=[(0.0, 1.8, 0.0)], point_I=[(8.0,) * 3],
                         env_L=[0.1, 0.12, 0.15], world_radius=100.0,
                         device=device)
    geom = Geometry.build(boxes=[dict(bmin=(-1, -1, -1), bmax=(1, 1, 1),
                                      mat=-1, light=-1, med_in=0,
                                      med_out=-1)], device=device)
    return Scene(geom, Materials.build([], device=device),
                 Media.make(grids=(gm,), device=device), lights)


def bench_camera(res, *, device):
    """The bench camera: from (0, 0, -4) at the origin, 30 degree fov."""
    from ..models.cameras import PerspectiveCamera
    from ..utils import transform as tr

    return PerspectiveCamera.make(
        tr.look_at((0, 0, -4), (0, 0, 0), (0, 1, 0), device=device), 30.0,
        (res, res), device=device)


# the machines' parts: (centre, half size, material): a glass body, a metal
# part, a diffuse part and a small glass part; each a cube of 12 triangles
# over corners i = (x, y, z bits)
MACHINE_PARTS = (((0.05, -0.25, 0.0), 0.33, 1), ((-0.42, 0.18, 0.15), 0.17, 2),
                 ((0.42, 0.3, -0.2), 0.15, 0), ((0.0, 0.45, 0.3), 0.12, 1))
CUBE_FACES = ((0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5), (0, 4, 5), (0, 5, 1),
              (2, 3, 7), (2, 7, 6), (0, 2, 6), (0, 6, 4), (1, 5, 7), (1, 7, 3))


def machine_tris():
    """The bench's transparent-machines proxy (``bench.py`` _machine_tris):
    a glass body, a metal part, a diffuse part and a small glass part, 12
    triangles each, with vacuum inside (med_in -1) and the cloud outside
    (med_out 0)."""
    tris = []
    for (cx, cy, cz), h, mat in MACHINE_PARTS:
        v = [(cx + (h if i & 1 else -h), cy + (h if i & 2 else -h),
              cz + (h if i & 4 else -h)) for i in range(8)]
        tris += [dict(p0=v[a], p1=v[b], p2=v[c], mat=mat, light=-1,
                      med_in=-1, med_out=0) for (a, b, c) in CUBE_FACES]
    return tris


# the teaser materials (``bench.py`` bench_config5m/5v) and the variants
# chip_smoke.py holds the kernels to: Trowbridge-Reitz rough conductor and
# CookTorrance in place of the diffuse part and the metal, and a checker
# albedo on the diffuse part
MACHINE_MATERIALS = {
    "smooth": [dict(type=0, albedo=(0.65, 0.3, 0.2)),
               dict(type=2, eta=1.5, roughness=0.0),
               dict(type=1, albedo=(0.9, 0.75, 0.5), roughness=0.0)],
    "rough": [dict(type=11, albedo=(0.65, 0.3, 0.2), eta=1.5, roughness=0.3),
              dict(type=2, eta=1.5, roughness=0.0),
              dict(type=1, albedo=(0.9, 0.75, 0.5), roughness=0.25)],
    "checker": [dict(type=0, albedo=(0.65, 0.3, 0.2), albedo_tex=0),
                dict(type=2, eta=1.5, roughness=0.0),
                dict(type=1, albedo=(0.9, 0.75, 0.5), roughness=0.0)],
}
MACHINE_CHECKER = dict(kind=1, c0=(0.65, 0.3, 0.2), c1=(0.9, 0.9, 0.85),
                       uvscale=(4.0, 4.0))


def machine_mesh_tris(n_sub=3):
    """The bench's machines as a real mesh (``bench.py``
    _machine_mesh_tris): each part of ``machine_tris`` a cube
    loop-subdivided n_sub times, written to a PLY file and read back (4
    parts x 12 x 4^n_sub = 3072 triangles at n_sub 3)."""
    import tempfile
    from pathlib import Path

    from ..tools.plytool import read_ply, write_ply
    from ..utils.loopsubdiv import subdivide

    faces = np.array(CUBE_FACES, np.int32)
    tris = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, ((cx, cy, cz), h, mat) in enumerate(MACHINE_PARTS):
            verts = np.array([[cx + (h if j & 1 else -h),
                               cy + (h if j & 2 else -h),
                               cz + (h if j & 4 else -h)] for j in range(8)],
                             np.float32)
            v, f, _ = subdivide(verts, faces, n_sub, compute_limit=False)
            path = Path(tmp) / f"part{i}.ply"
            write_ply(path, v, f)
            mesh = read_ply(path)
            P = np.asarray(mesh["P"], np.float32)
            for (a, b, c) in np.asarray(mesh["indices"],
                                        np.int64).reshape(-1, 3):
                tris.append(dict(p0=P[a], p1=P[b], p2=P[c], mat=mat,
                                 light=-1, med_in=-1, med_out=0))
    return tris


def make_machines_scene(mesh=False, materials="smooth", *, device):
    """The teaser scene: the 48-triangle machines proxy (mesh=False) or
    the 3072-triangle PLY machines (mesh=True, ``machine_mesh_tris``)
    inside the bench's pyroclastic cloud
    (``vspg_kernels.make_pyro64_scene``), with the materials of
    ``bench.py`` (or a variant of MACHINE_MATERIALS)."""
    from ..models.integrators.volpath import Scene
    from ..models.materials import Materials
    from ..models.shapes import Geometry
    from ..models.textures import Textures
    from .vspg_kernels import make_pyro64_scene

    base = make_pyro64_scene(device=device)
    geom = Geometry.build(
        boxes=[dict(bmin=(-1, -1, -1), bmax=(1, 1, 1), mat=-1, light=-1,
                    med_in=0, med_out=-1)],
        triangles=machine_mesh_tris() if mesh else machine_tris(),
        device=device)
    tex = (Textures.build([MACHINE_CHECKER], device=device)
           if materials == "checker" else None)
    return Scene(geom, Materials.build(MACHINE_MATERIALS[materials],
                                       device=device),
                 base.media, base.lights, tex)
