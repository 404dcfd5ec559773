"""Counterpart of ``ops/pallas_vspg.py``: the VSPG kernel of the guided
render path, its host-side tables, its plain PyTorch versions and the
support predicate that decides when ``render_vspg`` may use it.

One kernel, ``csrc/vspg.cu``, replaces ``pallas_vspg._make_vspg_kernel``
for the grid-cloud class, with each of the three distance routes:
resampling (B3a/B4a in ROADMAP.md), NDS and NDS+ (B3b/B4b), with at most
64 triangles of the teaser materials in the cloud (B3c/B4c: the field
table then holds the surface half's rows after the volume half's, and
diffuse hits draw from the guided BSDF), and on a uniform or an adaptive
guiding field (B3d/B4d: a field query resolves the coarse cell to its
leaf through an int32 indirection table, then reads the leaf's column and
re-aims the lobes from the leaf's centre). It has two variants: the render
variant renders spp frozen-field samples per pixel; the record variant
renders one training sample per pixel and writes the ``REC_ROWS`` x
``rec_depth`` record rows of each lane. Under NDS a guided walk first runs
the exact majorant optical-depth prepass (mode 1), then either the ODS
walk (mode 2: candidates drawn in optical-depth space on the delta step's
algebra) or, where the target VSP is below 1 - e^-t_v, the delta walk
(mode 3). NDS+ reads a per-pixel TrBuffer as ISGB rows 3-5.

Each lane (one pixel) runs the per-lane state machine of the Pallas
kernel: one event per iteration (transport, reservoir-resampling walk,
delta walk, point/env shadow walk), the same eight ``uniform4`` draws per
iteration in the same order (nine with triangles, ten with a glossy
material), and the same iteration cap. So the plain
versions here, and through them the kernel, agree per pixel with the
Pallas kernel run in interpret mode wherever bf16 rounds nothing. What the
Pallas kernel does only for the TPU is not carried over: bf16 packing of
density, majorant and field table, one-hot MXU gathers, chunk sweeps, the
stochastic one-corner trilerp, the tiled lane map and spp chunking. The
density is float32 with the exact eight-corner trilerp; the field table is
float32 and unpacked.

On the card the render variant runs each (pixel, sample) as a work item
of its own on persistent blocks and writes the items' radiances and
iteration counts to a scratch, which a second kernel (``vspg_reduce``)
sums per pixel in sample order while the pixel's running count stays
within its iteration cap: the per-pixel loop's order and cap, so the image
is the same float for float; ``render_items_plain`` is the plain version
of the items, ``reduce_samples_plain`` of the sum. The record variant runs
its pixels as work items on persistent blocks too, each lane writing its
pixel's image entry and record rows, so its output is the per-pixel
kernel's whatever lane runs a pixel. Both variants count the items that
reach the iteration cap. The render variant also renders a block of the
image's rows (``block_constants``) at a pixel base, each pixel keeping the
random stream and camera ray of its place in the image, so that the
blocks of ``parallel/mesh.render_vspg_pallas_sharded`` stitch into the
whole render float for float. A walk that starts within 1e-4 of the box's
exit ends there (``volpath_kernels._box_exit``), as the XLA path's clip to
the grid's bounds ends it (ROADMAP.md section C 4); the Pallas kernel
steps on beyond the box.

A wrapper runs the plain version only when its tensors lie on the CPU; on
a CUDA tensor it launches its kernel or raises. ``LAUNCHES`` counts the
kernel launches; while ``LAUNCH_EVENTS`` is a list, each kernel call (a
render call: its memsets, item kernel and reduce) appends (name, start,
end) CUDA events around itself, so that a caller can take the kernels'
share of a whole render (chip_smoke.py does); while ``AT_CAP`` and
``RECORD_AT_CAP`` are lists, each render call and each record launch
appends its count of items at the cap.
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..models.guiding.isgb import isgb_contribution, isgb_primary_vsp
from ..models.guiding.recording import SegmentRecord
from ..utils import rng
from ..utils.math import INV_4PI, INV_PI, PI
from .volpath_kernels import (F_BMAX, F_BMIN, F_SA, F_SS, I_GX,
                              I_MAX_EVENTS, I_MX, I_NY,
                              M_ALB, M_ETA, M_KIND, M_ROUGH, MAT_COLS,
                              T_MAT, T_MED_IN, T_MED_OUT, T_NG, TRI_COLS,
                              _BIG, _box_exit, _box_hit, _camera_ray,
                              _check, _Consts, _count, _dot,
                              _hg_value, _keep, _normalize, _sample_hg,
                              _tri_hit, extract_constants)

# the TRIS instantiations (scenes with triangles) and the launches on an
# adaptive field count apart
LAUNCHES = {f"vspg_{v}{t}{a}": 0 for a in ("", "_adaptive")
            for t in ("", "_tris") for v in ("render", "record")}
# the render variant's ordered per-sample sum, one launch a chunk
LAUNCHES["vspg_reduce"] = 0
LAUNCH_EVENTS = None
# while a list, each render call appends its count of items stopped at the
# iteration cap (a (1,) int32 tensor on the card)
AT_CAP = None
# while a list, each record launch appends its count of pixels stopped at
# the iteration cap (a (1,) int32 tensor on the card)
RECORD_AT_CAP = None
# bytes of the render variant's per-item scratch, radiance (samples, npix,
# 3) float32 and iterations (samples, npix) int32: 64 MiB holds 64 samples
# at 256^2; larger renders run their samples in chunks
SCRATCH_BYTES = 64 << 20

MIN_KAPPA = 1e-2
MAX_KAPPA = 2e3
# lobes per cell in the kernel's table: each cell's top K_PACK lobes by
# weight, renormalized; sampling and every pdf use the same truncated
# mixture, so the estimator stays unbiased
K_PACK = 4
_LUM = (0.2126, 0.7152, 0.0722)
# training-record rows (pallas_vspg.REC_ROWS layout): per slot 0-2 pos,
# 3-5 wi, 6 scatter weight, 7 pdf, 8-10 NEE direct, 11-13 MIS-weighted
# emission, 18 vertex-is-volume, 22-23 scatter weight G/B; slot 0 only:
# 14 first-event-is-volume, 15-17 first-event normal, 19-21 albedo
REC_ROWS = 24

# float32 guiding constant table; csrc/vspg.cuh holds the same layout
(G_FB0, G_FEXT, G_EXT, G_KM, G_CELL, G_ALB) = (0, 3, 6, 9, 12, 15)
(G_FRES_HI, G_PG, G_1MPG, G_PG_SAFE, G_PG_NEE, G_1MPG_NEE, G_RIS_C0,
 G_MIS, G_1MMIS, G_SCALE_CAP, G_KAPPA_H, G_LOG_C_H, G_HG_SIGN,
 G_LOG_2PI, G_KAPPA_COS, G_LOG_C_COS) = range(18, 34)
N_GCONST = 34
# int32 guiding constant table
(GI_FRES, GI_K, GI_NCELL, GI_RIS, GI_GUIDE_RR, GI_MIN_RR_DEPTH,
 GI_GUIDE_PRIMARY, GI_GUIDE_SECONDARY, GI_VOL_GUIDING, GI_APPLY_HG,
 GI_SIGMA_GRAY, GI_METHOD, GI_SURF_GUIDE, GI_ANY_ROUGH, GI_NEXTRA,
 GI_NLEAF) = range(16)
N_GICONST = 16
# vMF approximation of the clamped-cosine lobe (vmf.COSINE_KAPPA), the
# product the surface half takes at diffuse hits
KAPPA_COS = 2.18853
TINY_G = 1e-18
# GI_METHOD values: the distance route of guided walks
METHODS = ("resampling", "nds", "nds+")


# ---------------------------------------------------------------------------
# Host side: guiding constants, tables, support predicate
# ---------------------------------------------------------------------------


def guiding_constants(field, gopt, vopt):
    """The guiding configuration the kernel is built for, as a dict (the
    keys of ``pallas_vspg.guiding_constants`` but its TPU fetch switch)."""
    b0 = field.b_min.cpu().numpy()
    b1 = field.b_max.cpu().numpy()
    return dict(
        fres=int(field.res),
        K=min(int(field.n_lobes), K_PACK),
        fb_min=tuple(float(x) for x in b0),
        fb_max=tuple(float(x) for x in b1),
        pg=float(gopt.guiding_prob),
        mode=str(gopt.mode),
        vsp_mis_ratio=float(vopt.vsp_mis_ratio),
        sampling_method=str(vopt.sampling_method),
        guide_rr=bool(vopt.guide_rr),
        min_rr_depth=int(vopt.min_rr_depth),
        guide_primary=bool(vopt.guide_vsp and vopt.guide_primary_vsp),
        guide_secondary=bool(vopt.guide_vsp and vopt.guide_secondary_vsp),
        volume_guiding=bool(gopt.volume_guiding),
        surface_guiding=bool(gopt.surface_guiding),
        scale_vsp_cap=float(vopt.scale_vsp_cap),
        trained=int(field.iteration) > 0,
        max_collisions=256,
        n_extra=int(field.n_extra))


@dataclass(frozen=True)
class GuidingConstants:
    """The guiding tables of one kernel launch, as tensors on its card."""

    fconst: torch.Tensor  # (N_GCONST,) float32
    iconst: torch.Tensor  # (N_GICONST,) int32
    ris: bool
    method: int  # index into METHODS
    n_tri: int = 0  # triangles of the scene: the field table holds both halves
    # an adaptive field's coarse-cell indirection (pack_cell_table), (3, C)
    # int32; None on a uniform field
    cells: torch.Tensor = None

    @property
    def isgb_rows(self):
        """Rows of the ISGB table: 6 under NDS+ (the TrBuffer), else 3."""
        return 6 if METHODS[self.method] == "nds+" else 3


def pack_guiding_constants(c, gc, device, cells=None):
    """GuidingConstants of guiding dict `gc` for the scene constants `c`
    (a grid-class ``KernelConstants``); `cells` is the adaptive field's
    ``pack_cell_table``, which gc["n_extra"] > 0 needs. Constants the Pallas
    kernel folds at trace time in double are folded here in double too."""
    if gc["mode"] not in ("mis", "ris"):
        raise ValueError(f"unknown guiding mode {gc['mode']!r}")
    if gc["sampling_method"] not in METHODS:
        raise ValueError(f"unknown sampling method {gc['sampling_method']!r}")
    method = METHODS.index(gc["sampling_method"])
    f_np = c.fconst.cpu().numpy()
    i_np = c.iconst.cpu().numpy()
    sa = f_np[F_SA:F_SA + 3]
    ss = f_np[F_SS:F_SS + 3]
    st = sa + ss
    bmin = [float(x) for x in f_np[F_BMIN:F_BMIN + 3]]
    bmax = [float(x) for x in f_np[F_BMAX:F_BMAX + 3]]
    ext = [bmax[k] - bmin[k] for k in range(3)]
    mres = [int(v) for v in i_np[I_MX:I_MX + 3]]
    g_hg = float(np.clip(_grid_g(c), -0.99, 0.99))
    rho = abs(g_hg)
    kappa_h = float(np.clip(rho * (3 - rho * rho) / max(1 - rho * rho, 1e-6),
                            0.0, MAX_KAPPA))
    kh = max(kappa_h, MIN_KAPPA)
    pg = float(gc["pg"])
    ris = gc["mode"] == "ris"
    pg_nee = 0.5 if ris else pg
    mis = float(gc["vsp_mis_ratio"])
    fb0, fb1 = gc["fb_min"], gc["fb_max"]
    f = np.zeros(N_GCONST, np.float64)
    f[G_FB0:G_FB0 + 3] = fb0
    f[G_FEXT:G_FEXT + 3] = [fb1[k] - fb0[k] for k in range(3)]
    f[G_EXT:G_EXT + 3] = ext
    f[G_KM:G_KM + 3] = [mres[k] / ext[k] for k in range(3)]
    f[G_CELL:G_CELL + 3] = [ext[k] / mres[k] for k in range(3)]
    f[G_ALB:G_ALB + 3] = [float(ss[k] / max(st[k], 1e-12)) for k in range(3)]
    f[G_FRES_HI] = gc["fres"] - 1e-4
    f[G_PG], f[G_1MPG], f[G_PG_SAFE] = pg, 1.0 - pg, max(pg, 1e-6)
    f[G_PG_NEE], f[G_1MPG_NEE] = pg_nee, 1.0 - pg_nee
    f[G_RIS_C0] = (1 - pg) * INV_4PI
    f[G_MIS], f[G_1MMIS] = mis, 1.0 - mis
    f[G_SCALE_CAP] = gc["scale_vsp_cap"]
    f[G_KAPPA_H] = kappa_h
    f[G_LOG_C_H] = (np.log(kh) - np.log(2.0 * np.pi)
                    - np.log1p(-np.exp(-2.0 * kh)))
    f[G_HG_SIGN] = 1.0 if g_hg >= 0 else -1.0
    f[G_LOG_2PI] = np.float32(np.log(2.0 * np.pi))
    f[G_KAPPA_COS] = KAPPA_COS
    f[G_LOG_C_COS] = (np.log(KAPPA_COS) - np.log(2.0 * np.pi)
                      - np.log1p(-np.exp(-2.0 * KAPPA_COS)))
    i = np.zeros(N_GICONST, np.int32)
    i[GI_FRES] = gc["fres"]
    i[GI_K] = gc["K"]
    i[GI_NCELL] = gc["fres"] ** 3
    i[GI_RIS] = int(ris)
    i[GI_GUIDE_RR] = int(gc["guide_rr"])
    i[GI_MIN_RR_DEPTH] = gc["min_rr_depth"]
    i[GI_GUIDE_PRIMARY] = int(gc["guide_primary"])
    i[GI_GUIDE_SECONDARY] = int(gc["guide_secondary"] and gc["trained"])
    i[GI_VOL_GUIDING] = int(gc["volume_guiding"] and gc["trained"])
    i[GI_APPLY_HG] = int(abs(g_hg) > 1e-3)
    i[GI_SIGMA_GRAY] = int(float(st[0]) == float(st[1]) == float(st[2]))
    i[GI_METHOD] = method
    n_extra = int(gc["n_extra"])
    i[GI_NEXTRA] = n_extra
    i[GI_NLEAF] = gc["fres"] ** 3 + n_extra
    if n_extra and (cells is None
                    or tuple(cells.shape) != (3, gc["fres"] ** 3)):
        raise ValueError("an adaptive field needs its (3, fres^3) cell table")
    n_tri = c.n_tri
    i[GI_SURF_GUIDE] = int(n_tri > 0 and gc["surface_guiding"]
                           and gc["trained"])
    if n_tri:
        from .volpath_kernels import M_KIND, M_ROUGH

        m = c.mats.cpu().numpy()
        i[GI_ANY_ROUGH] = int(bool(np.any(
            ((m[:, M_KIND] == 1) & (m[:, M_ROUGH] >= 1e-3))
            | (m[:, M_KIND] == 11))))
    return GuidingConstants(
        torch.as_tensor(f.astype(np.float32), device=device),
        torch.as_tensor(i, device=device), ris, method, n_tri,
        torch.as_tensor(np.asarray(cells, np.int32), device=device)
        if n_extra else None)


def _grid_g(c):
    """The HG g of a grid-class KernelConstants, recovered from its folded
    2g constant (exact: 2g is a power-of-two scaling)."""
    from .volpath_kernels import F_HG_C2

    return float(c.fconst[F_HG_C2]) / 2.0


def pack_field_table(field, criterion="variance", with_surface=False):
    """The volume half of `field` as a float32 (P, L) numpy table over its
    L = res^3 + n_extra leaves, P = 8K + 8 with K = min(n_lobes, K_PACK):
    per lobe [w, mux, muy, muz, kappa, mean_dist, vsp_lobe_vol,
    vsp_lobe_surf], then [valid, vsp, flux_r, flux_g, flux_b, cx, cy, cz],
    vsp with the criterion applied and c the leaf centre
    (``pallas_vspg.pack_field_table(k_top=K_PACK)`` before its bf16 rounding
    and without its indirection rows: see ``pack_cell_table``). Leaves not
    yet allocated are packed as ``GuidingField.make`` left them (fresh
    lobes, valid 0, a zero centre). with_surface (scenes with triangles)
    appends the surface half's rows in the same layout: P = 2 (8K + 8)."""
    rows = _pack_half_rows(field, field.volume, criterion)
    if with_surface:
        rows += _pack_half_rows(field, field.surface, criterion)
    return np.stack(rows, 0).astype(np.float32)


def _pack_half_rows(field, vol, criterion):
    def a(t):
        return t.detach().cpu().numpy().astype(np.float32)

    K = field.n_lobes
    w, mu, kap = a(vol.weights), a(vol.mu), a(vol.kappa)
    sw, sd = a(vol.stats_w), a(vol.stats_dist)
    dist = sd / np.maximum(sw, 1e-12)
    vlv, vls = a(vol.vsp_lobe_vol), a(vol.vsp_lobe_surf)
    C = w.shape[0]
    if K_PACK < K:
        # each cell's top K_PACK lobes by weight, renormalized to the
        # mixture's mass; numpy's argsort, as the JAX package, so that ties
        # (a fresh field's equal weights) pick the same lobes
        order = np.argsort(-w, axis=1)[:, :K_PACK]
        li = np.arange(C)[:, None]
        tot = w.sum(1, keepdims=True)
        w = w[li, order]
        w = w * tot / np.maximum(w.sum(1, keepdims=True), 1e-20)
        mu, kap, sw = mu[li, order], kap[li, order], sw[li, order]
        dist, vlv, vls = dist[li, order], vlv[li, order], vls[li, order]
        K = K_PACK
    valid = (sw.sum(-1) > 8.0).astype(np.float32)
    vsp_n = a(vol.vsp_n)
    n = np.maximum(vsp_n, 1.0)
    c_vol = a(vol.vsp_c_vol) / n
    c_surf = a(vol.vsp_c_surf) / n
    if criterion == "variance":
        v_vol = np.maximum(a(vol.vsp_c2_vol) / n - c_vol ** 2, 0.0)
        v_surf = np.maximum(a(vol.vsp_c2_surf) / n - c_surf ** 2, 0.0)
        num = c_vol * c_vol + v_vol
        den = num + c_surf * c_surf + v_surf
    else:
        num = c_vol
        den = c_vol + c_surf
    vsp = np.where(den > 0, num / np.maximum(den, 1e-20), -1.0)
    vsp = np.where(vsp_n > 8.0, vsp, -1.0)
    flux = a(vol.flux) / np.maximum(a(vol.flux_w), 1e-12)[:, None]
    centers = a(field.leaf_center)
    rows = []
    for k in range(K):
        rows += [w[:, k], mu[:, k, 0], mu[:, k, 1], mu[:, k, 2], kap[:, k],
                 dist[:, k], vlv[:, k], vls[:, k]]
    rows += [valid, vsp.astype(np.float32), flux[:, 0], flux[:, 1],
             flux[:, 2], centers[:, 0], centers[:, 1], centers[:, 2]]
    return rows


def pack_cell_table(field):
    """The coarse-cell indirection of an adaptive field as a (3, C) int32
    numpy table: [leaf_of, child_base, refined]; None for a uniform field.
    It replaces the five bf16 indirection rows of
    ``pallas_vspg.pack_field_table``."""
    if field.n_extra == 0:
        return None
    return np.stack([field.leaf_of.cpu().numpy(),
                     field.child_base.cpu().numpy(),
                     field.refined.cpu().numpy()], 0).astype(np.int32)


def pack_isgb_table(isgb, npix, tr_buffer=None):
    """(3, npix) float32: [primary VSP (-1 while not ready), pixel-estimate
    luminance, pixel-estimate channel mean]. With `tr_buffer` (the NDS+
    per-pixel primary transmittance, (npix, 3)), rows 3-5 append it clipped
    to [0, 1]: (6, npix)."""
    pid = torch.arange(npix, device=isgb.vsp_est.device)
    vsp = isgb_primary_vsp(isgb, pid)
    pe = isgb_contribution(isgb, pid)
    lum = pe[:, 0] * _LUM[0] + pe[:, 1] * _LUM[1] + pe[:, 2] * _LUM[2]
    rows = [vsp, lum, torch.mean(pe, -1)]
    if tr_buffer is not None:
        tr = torch.clamp(tr_buffer.to(device=vsp.device, dtype=torch.float32),
                         0.0, 1.0)
        rows += [tr[:, 0], tr[:, 1], tr[:, 2]]
    return torch.stack(rows, 0).contiguous()


def supports(scene, camera, film, cfg, gopt, vopt, field):
    """True when the VSPG kernel serves this render: the grid-cloud class
    of ``volpath_kernels.extract_constants`` (one box holding one density
    grid, with at most 64 triangles of untextured diffuse, conductor,
    smooth dielectric or CookTorrance materials: ``pallas_vspg.supports``'
    gate, which refuses the mesh class), a uniform or an adaptive field and
    any of the three distance routes. It shades no emission, so it refuses
    area lights, and it sees no sphere, no RGB grid (refused in
    ``extract_constants``) and no procedural medium. It samples point and
    constant environment lights by a uniform table only: no spot,
    goniometric, projection or distant light, image environment, portal or
    BVH light sampler."""
    if (scene.lights.n_area or scene.lights.beyond_kernels
            or scene.geometry.n_sph or len(scene.media.procedurals)):
        return False
    c = extract_constants(scene, camera, film, cfg)
    if c is None or c.kind != "grid":
        return False
    if c.n_tri:
        from .volpath_kernels import (KERNEL_KINDS, M_KIND, M_ROUGH, M_TEX,
                                      MAX_TRIS_GRID)

        if c.n_tri > MAX_TRIS_GRID:
            return False  # the mesh class trains and renders in torch waves

        m = c.mats.cpu().numpy()
        if not (np.isin(m[:, M_KIND], KERNEL_KINDS).all()
                and not ((m[:, M_KIND] == 2) & (m[:, M_ROUGH] >= 1e-3)).any()
                and (m[:, M_TEX] < 0).all()):
            return False
    return str(vopt.sampling_method) in METHODS


# ---------------------------------------------------------------------------
# Plain versions: the per-lane machine vectorised over a compacted set of
# live lanes (one lane per pixel, its samples in sequence, as the kernel)
# ---------------------------------------------------------------------------


class _G:
    """GuidingConstants unpacked for the plain versions."""

    def __init__(self, g: GuidingConstants, dev):
        f = g.fconst.to(dev)
        fl = f.tolist()
        il = g.iconst.tolist()
        self.fb0, self.fext = f[G_FB0:G_FB0 + 3], f[G_FEXT:G_FEXT + 3]
        self.ext, self.km = f[G_EXT:G_EXT + 3], f[G_KM:G_KM + 3]
        self.cell, self.alb = f[G_CELL:G_CELL + 3], f[G_ALB:G_ALB + 3]
        (self.fres_hi, self.pg, self.one_m_pg, self.pg_safe, self.pg_nee,
         self.one_m_pg_nee, self.ris_c0, self.mis, self.one_m_mis,
         self.cap, self.kappa_h, self.log_c_h, self.hg_sign,
         self.log_2pi) = fl[G_FRES_HI:G_LOG_2PI + 1]
        (self.fres, self.K, self.ncell, ris, guide_rr, self.min_rr_depth,
         gp, gs, vg, ahg, gray, method, sgd, rough, n_extra, self.nleaf) = il
        # the adaptive field's indirection, and its allocated leaves: the
        # refined cells' children follow the res^3 grid cells
        self.cells = None if g.cells is None else g.cells.to(dev).long()
        self.n_alloc = self.ncell + (0 if g.cells is None
                                     else 8 * int(self.cells[2].sum()))
        self.kappa_cos, self.log_c_cos = fl[G_KAPPA_COS], fl[G_LOG_C_COS]
        self.surf_guide, self.any_rough = bool(sgd), bool(rough)
        self.ris, self.guide_rr = bool(ris), bool(guide_rr)
        self.guide_primary, self.guide_secondary = bool(gp), bool(gs)
        self.vol_guiding, self.apply_hg, self.gray = bool(vg), bool(ahg), \
            bool(gray)
        self.nds = METHODS[method] in ("nds", "nds+")
        self.nds_plus = METHODS[method] == "nds+"
        # true dividends and divisors (see _Consts)
        self.pg_safe_t, self.mis_t = f[G_PG_SAFE], f[G_MIS]


def _W(m, new, old):
    """torch.where with an (N,) mask over (N,) or (N,3) values."""
    if any(isinstance(v, torch.Tensor) and v.dim() == 2 for v in (new, old)):
        m = m[:, None]
    return torch.where(m, new, old)


def _avg3(v):
    return (v[:, 0] + v[:, 1] + v[:, 2]) * (1.0 / 3.0)


def _max3(v):
    return torch.maximum(torch.maximum(v[:, 0], v[:, 1]), v[:, 2])


def _sel(v, hero):
    """Hero-channel entry of (N,3) v, or of a (3,) constant."""
    if v.dim() == 1:
        return v[hero]
    return torch.gather(v, 1, hero[:, None])[:, 0]


def _vmf_pdf_e(K, cw, kappa):
    k = torch.clamp(kappa, min=MIN_KAPPA)
    cnorm = k / (K.two_pi * (1.0 - torch.exp(-2.0 * k)))
    val = cnorm * torch.exp(k * (cw - 1.0))
    return torch.where(kappa < MIN_KAPPA, INV_4PI, val)


def _log_c(G, kappa):
    k = torch.clamp(kappa, min=MIN_KAPPA)
    return torch.log(k) - G.log_2pi - torch.log1p(-torch.exp(-2.0 * k))


def _lobe_cos(lob, k, w):
    mu = lob["mu"][k]
    return w[:, 0] * mu[:, 0] + w[:, 1] * mu[:, 1] + w[:, 2] * mu[:, 2]


def _mixture_pdf(K, lob, w):
    p = torch.zeros_like(w[:, 0])
    for k in range(len(lob["w"])):
        p = p + lob["w"][k] * _vmf_pdf_e(K, _lobe_cos(lob, k, w),
                                         lob["kappa"][k])
    return p


def _product_vmf(lob, mb, kb, log_c_b, G):
    """Every lobe times one vMF about mb with static kappa kb."""
    tot_old = torch.zeros_like(mb[:, 0])
    tot_new = torch.zeros_like(mb[:, 0])
    out = {"w": [], "mu": [], "kappa": []}
    for k in range(len(lob["w"])):
        kap, mu, w = lob["kappa"][k], lob["mu"][k], lob["w"][k]
        kmu = kap[:, None] * mu + kb * mb
        k_new = torch.sqrt(torch.clamp(
            kmu[:, 0] * kmu[:, 0] + kmu[:, 1] * kmu[:, 1]
            + kmu[:, 2] * kmu[:, 2], min=1e-12))
        inv = 1.0 / torch.clamp(k_new, min=1e-8)
        log_s = (_log_c(G, kap) + log_c_b - _log_c(G, k_new)
                 + (k_new - kap - kb))
        w_new = w * torch.exp(torch.clamp(log_s, -60.0, 60.0))
        tot_old = tot_old + w
        tot_new = tot_new + w_new
        out["w"].append(w_new)
        out["mu"].append(kmu * inv[:, None])
        out["kappa"].append(torch.clamp(k_new, 0.0, MAX_KAPPA))
    scale = tot_old / torch.clamp(tot_new, min=1e-20)
    out["w"] = [w * scale for w in out["w"]]
    return out


def _product_hg(K, G, lob, d):
    """Every lobe times the HG lobe's vMF about d (static kappa)."""
    if not G.apply_hg:
        return lob
    return _product_vmf(lob, d * G.hg_sign, G.kappa_h, G.log_c_h, G)


def _coord_system(v):
    sign = torch.where(v[:, 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + v[:, 2])
    b = v[:, 0] * v[:, 1] * a
    t1 = torch.stack([1.0 + sign * v[:, 0] * v[:, 0] * a, sign * b,
                      -sign * v[:, 0]], -1)
    t2 = torch.stack([b, sign + v[:, 1] * v[:, 1] * a, -v[:, 1]], -1)
    return t1, t2


def _mixture_sample(K, lob, u_sel, u0, u1):
    """CDF lobe select + vMF sample: (w, pdf)."""
    nk = len(lob["w"])
    tot = torch.zeros_like(u0)
    for k in range(nk):
        tot = tot + lob["w"][k]
    inv_tot = 1.0 / torch.clamp(tot, min=1e-12)
    cdf = torch.zeros_like(u0)
    k_idx = torch.zeros_like(u0, dtype=torch.int64)
    for k in range(nk):
        cdf = cdf + lob["w"][k] * inv_tot
        k_idx = k_idx + (u_sel >= cdf).to(torch.int64)
    k_idx = torch.clamp(k_idx, 0, nk - 1)
    mu = torch.stack(lob["mu"], 1)  # (N,K,3)
    mu = torch.gather(mu, 1, k_idx[:, None, None].expand(-1, 1, 3))[:, 0]
    kap = torch.gather(torch.stack(lob["kappa"], 1), 1, k_idx[:, None])[:, 0]
    sk = torch.clamp(kap, min=MIN_KAPPA)
    ct = 1.0 + torch.log1p(-(1.0 - torch.exp(-2.0 * sk)) * (1.0 - u0)) / sk
    ct = torch.where(kap < MIN_KAPPA, 1.0 - 2.0 * u0, ct)
    ct = torch.clamp(ct, -1.0, 1.0)
    st_ = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    phi = K.two_pi * u1
    t1, t2 = _coord_system(mu)
    cphi, sphi = torch.cos(phi), torch.sin(phi)
    w = ((st_ * cphi)[:, None] * t1 + (st_ * sphi)[:, None] * t2
         + ct[:, None] * mu)
    w = _normalize(w)
    return w, _mixture_pdf(K, lob, w)


def _vsp_directional(K, lob, vsp_cell, d):
    z = torch.zeros_like(vsp_cell)
    resp_sum, num, den, mass = z, z, z, z
    for k in range(len(lob["w"])):
        r = lob["w"][k] * _vmf_pdf_e(K, _lobe_cos(lob, k, d),
                                     lob["kappa"][k])
        vlv, vls = lob["vlv"][k], lob["vls"][k]
        resp_sum = resp_sum + r
        num = num + r * vlv
        den = den + r * (vlv + vls)
        mass = mass + vlv + vls
    inv = 1.0 / torch.clamp(resp_sum, min=1e-20)
    num = num * inv
    den = den * inv
    vdir = torch.where(den > 1e-12, num / torch.clamp(den, min=1e-20), -1.0)
    return torch.where((mass > 8.0) & (vdir >= 0.0), vdir, vsp_cell)


def _leaf(G, p):
    """The field leaf at p: the coarse cell, and on an adaptive field the
    child of the octant of the clamped grid coordinate in a refined cell,
    the cell's own leaf in any other."""
    gf = torch.clamp((p - G.fb0) / G.fext * G.fres, 0.0, G.fres_hi)
    ix = gf.to(torch.int64)
    cid = (ix[:, 0] * G.fres + ix[:, 1]) * G.fres + ix[:, 2]
    if G.cells is None:
        return cid
    hi = (gf - ix.to(torch.float32) >= 0.5).to(torch.int64)
    octant = hi[:, 0] * 4 + hi[:, 1] * 2 + hi[:, 2]
    ind = G.cells[:, cid]
    leaf = torch.where(ind[2] != 0, ind[1] + octant, ind[0])
    if not bool((leaf < G.n_alloc).all()):
        raise RuntimeError("a field query reached an unallocated leaf")
    return leaf


def _field_query(G, ftab, p):
    """The lobes (parallax re-aimed, mu renormalized), valid, vsp and flux
    of the field leaf at p: of the volume half, then, when the table holds
    both halves, of the surface half."""
    cid = _leaf(G, p)
    v = ftab[:, cid]  # (P, N)
    K = G.K
    half = 8 * K + 8

    def parse(v):
        valid = v[8 * K] > 0.5
        cc = torch.stack([v[8 * K + 5], v[8 * K + 6], v[8 * K + 7]], -1)
        lob = {"w": [], "mu": [], "kappa": [], "vlv": [], "vls": []}
        for k in range(K):
            r = v[8 * k:8 * k + 8]
            mu = _normalize(torch.stack([r[1], r[2], r[3]], -1))
            dist = r[5]
            tgt = cc + mu * dist[:, None] - p
            use = (dist > 1e-6) & valid
            lob["w"].append(r[0])
            lob["mu"].append(_W(use, _normalize(tgt), mu))
            lob["kappa"].append(r[4])
            lob["vlv"].append(r[6])
            lob["vls"].append(r[7])
        flux = torch.stack([v[8 * K + 2], v[8 * K + 3], v[8 * K + 4]], -1)
        return lob, valid, v[8 * K + 1], flux

    out = parse(v[:half])
    if v.shape[0] == 2 * half:
        out = out + parse(v[half:])
    return out


def _density8(K, G, dens, p):
    """Exact trilinear density with the eight corners summed in the Pallas
    kernel's order, zero outside the box."""
    gres = torch.tensor(K.res, dtype=torch.float32, device=K.dev)
    f = (p - K.bmin_t) / G.ext * gres - 0.5
    f0 = torch.floor(f)
    wgt = f - f0
    hi = torch.tensor([r - 1 for r in K.res], device=K.dev)
    i0 = torch.minimum(torch.clamp(f0.to(torch.int64), min=0), hi)
    i1 = torch.minimum(i0 + 1, hi)
    gy, gz = K.res[1], K.res[2]
    d = None
    for cx, wx in ((i0[:, 0], 1.0 - wgt[:, 0]), (i1[:, 0], wgt[:, 0])):
        for cy, wy in ((i0[:, 1], 1.0 - wgt[:, 1]), (i1[:, 1], wgt[:, 1])):
            for cz, wz in ((i0[:, 2], 1.0 - wgt[:, 2]),
                           (i1[:, 2], wgt[:, 2])):
                term = dens[(cx * gy + cy) * gz + cz] * (wx * wy * wz)
                d = term if d is None else d + term
    inside = ((p >= K.bmin_t) & (p <= K.bmax_t)).all(-1)
    return torch.where(inside, d, 0.0)


def _maj_at(K, maj, ix):
    hi = torch.tensor([m - 1 for m in K.mres], device=K.dev)
    i = torch.minimum(torch.clamp(ix, min=0), hi)
    return maj[(i[:, 0] * K.mres[1] + i[:, 1]) * K.mres[2] + i[:, 2]]


class _Rec:
    """The (REC_ROWS, D, npix) record buffer of a plain record wave."""

    def __init__(self, D, npix, dev):
        self.buf = torch.zeros((REC_ROWS, D, npix), device=dev)
        self.D = D

    def put(self, rows, slot, mask, val, pix, add=False):
        m = mask & (slot >= 0) & (slot < self.D)
        if not bool(m.any()):
            return
        s, p = slot[m], pix[m]
        v = val[m]
        for j, row in enumerate(rows):
            vj = v if v.dim() == 1 else v[:, j]
            if add:
                vj = self.buf[row, s, p] + vj
            self.buf[row, s, p] = vj


def _start(K, seed, pix, samp):
    """Camera rays of (pixel, sample): dimension 0 jitters the pixel and
    picks the hero channel."""
    u0, u1, u2, _ = rng.uniform4(seed, pix, samp, 0)
    px = (pix % K.nx).to(torch.float32) + 0.5 + (u0 - 0.5)
    py = (pix // K.nx).to(torch.float32) + 0.5 + (u1 - 0.5)
    d = _camera_ray(K, px, py)
    o = torch.tensor([K.cw[3], K.cw[7], K.cw[11]], dtype=torch.float32,
                     device=K.dev).expand_as(d).clone()
    hero = torch.clamp(torch.floor(u2 * 3.0).to(torch.int64), max=2)
    return o, d, hero


def _init_lanes(K, seed, itab, pix, samp, n_samp, pix_base=0):
    """The lanes' state: lane i renders pixel pix[i] of the block that
    starts at image pixel `pix_base` from sample samp[i] (int64, one entry
    a lane each) to sample samp[i] + n_samp - 1. The image pixel ("gpix")
    keys the random stream and the camera ray; the block's ("pix") indexes
    the ISGB table and the record."""
    n = samp.numel()
    dev = K.dev
    gpix = pix + int(pix_base)
    o, d, hero = _start(K, seed, gpix, samp)

    def z():
        return torch.zeros(n, device=dev)

    def o1():
        return torch.ones(n, device=dev)

    def z3():
        return torch.zeros((n, 3), device=dev)

    def o3():
        return torch.ones((n, 3), device=dev)

    zi = torch.zeros(n, dtype=torch.int64, device=dev)
    return dict(
        lane=torch.arange(n, device=dev), pix=pix, gpix=gpix, samp=samp,
        end=samp + int(n_samp), dim=zi + 1,
        alive=torch.ones(n, dtype=torch.bool, device=dev), o=o, d=d,
        b=o3(), ru=o3(), rl=o3(), L=z3(), depth=zi.clone(), hero=hero,
        med=zi - 1, acc=z3(), mode=zi.clone(), t_walk=z(), wf=o3(),
        wu=o3(), wl=o3(), wT=o3(), wr=o3(), w_sum=z(), c_t=z(), c_wi=z(),
        c_ste=z(), cn=o3(), cd=o3(),
        has_c=torch.zeros(n, dtype=torch.bool, device=dev), maj_sc=o1(),
        tau_acc=z(), vsp_c=z(), sh=z3(), sh_t=z(), sh_end=z(), sh_pdf=z(),
        sh_d2=o1(), sT=o3(), sl=o3(), su=o3(), sh_f=z(), rr_srv=o1(),
        sh_fl=z(), rslot=zi.clone(), ivsp=itab[0][pix], ipel=itab[1][pix],
        ipem=itab[2][pix],
        itr=itab[3:6].T[pix] if itab.shape[0] == 6 else o3(),
        # the surface machine (scenes with triangles): the pending closest
        # hit (distance, normal, material, interface ids), the sweep and
        # occlusion requests, the delta-bounce flag, the albedo tint of a
        # surface NEE's record and the per-channel glossy NEE folds
        t_surf=z() + _BIG, hng=z3(), hmat=zi - 1, hmi=zi - 1, hmo=zi - 1,
        needs_i=torch.ones(n, dtype=torch.bool, device=dev),
        sh_occ=torch.zeros(n, dtype=torch.bool, device=dev),
        spec_last=torch.zeros(n, dtype=torch.bool, device=dev), ra=o3(),
        sh_f1=z(), sh_f2=z())


# ---------------------------------------------------------------------------
# The surface machine of the plain versions (scenes with triangles): the
# Pallas kernel's teaser blocks, in its operation order
# ---------------------------------------------------------------------------


def _tr_d_z(alpha, mz2):
    """Trowbridge-Reitz D of a half vector with squared cosine mz2."""
    c2 = torch.clamp(mz2, min=1e-8)
    t2 = (1.0 - c2) / c2
    a2 = alpha * alpha
    e = 1.0 + t2 / a2
    return 1.0 / (PI * a2 * c2 * c2 * e * e)


def _tr_lam(alpha, wz):
    c2 = torch.clamp(wz * wz, 1e-8, 1.0)
    t2 = (1.0 - c2) / c2
    return 0.5 * (torch.sqrt(1.0 + alpha * alpha * t2) - 1.0)


def _frd(ci, eta):
    """Dielectric Fresnel reflectance at cosine ci of the outer side."""
    ci = torch.clamp(ci, 0.0, 1.0)
    s2 = (1.0 - ci * ci) / torch.clamp(eta * eta, min=1e-12)
    ct = torch.sqrt(torch.clamp(1.0 - s2, min=0.0))
    rp = (eta * ci - ct) / torch.clamp(eta * ci + ct, min=1e-12)
    rq = (ci - eta * ct) / torch.clamp(ci + eta * ct, min=1e-12)
    return torch.where(s2 >= 1.0, 1.0, 0.5 * (rp * rp + rq * rq))


def _pow5(x):
    return x * x * x * x * x


def _to_loc(SF, v):
    return torch.stack([_dot(v, SF["g1"]), _dot(v, SF["g2"]),
                        _dot(v, SF["ns"])], -1)


def _glossy_f(SF, wo_l, wi_l):
    """Per-channel glossy f (rough conductor: Schlick-tinted microfacet;
    CookTorrance: Fresnel-weighted microfacet over a Lambertian base) at
    local directions wo_l, wi_l, and its microfacet terms."""
    h = _normalize(wo_l + wi_l)
    h = h * torch.where(h[:, 2] < 0, -1.0, 1.0)[:, None]
    alpha = SF["alpha"]
    Dm = _tr_d_z(alpha, h[:, 2] * h[:, 2])
    G2 = 1.0 / (1.0 + SF["lam_o"] + _tr_lam(alpha, wi_l[:, 2]))
    zi = torch.clamp(torch.abs(wi_l[:, 2]), min=1e-6)
    c_owm = torch.abs(_dot(wo_l, h))
    omc5 = _pow5(torch.clamp(1.0 - c_owm, 0.0, 1.0))
    spec = Dm * G2 / (4.0 * SF["zo_s"] * zi)
    F_ct = _frd(c_owm, SF["eta"])
    alb = SF["alb"]
    f = torch.where(SF["shade_ct"][:, None],
                    spec[:, None] * F_ct[:, None]
                    + alb * INV_PI * (1.0 - F_ct)[:, None],
                    spec[:, None] * (alb + (1.0 - alb) * omc5[:, None]))
    pdf_spec = SF["G1o"] * Dm / (4.0 * SF["zo_s"])
    return f, pdf_spec


def _surface_frame(K, G, sfq, hit_s, hng, hmat, d, mats):
    """Classify the surface lanes by material, face the normal against the
    ray, and build the glossy frame and the guided surface distribution."""
    slob, svalid, _, sflux = sfq
    front = _dot(hng, d) < 0
    ns = _W(front, hng, -hng)
    has = hmat >= 0
    m = mats[torch.clamp(hmat, min=0)]
    kind = torch.where(has, m[:, M_KIND].long(), -1)
    rough = torch.where(has, torch.clamp(m[:, M_ROUGH], min=1e-4), 0.0)
    smooth = rough < 1e-3
    SF = dict(ns=ns, front=front, alpha=rough, slob=slob, svalid=svalid,
              sflux=sflux, alb=_W(has, m[:, M_ALB:M_ALB + 3], 0.0),
              eta=torch.where(has, torch.clamp(m[:, M_ETA], min=1e-3), 1.0),
              shade_df=hit_s & (kind == 0),
              shade_co=hit_s & (kind == 1) & smooth,
              shade_dl=hit_s & (kind == 2),
              glossy=torch.zeros_like(hit_s))
    if G.any_rough:
        SF["shade_cr"] = hit_s & (kind == 1) & ~smooth
        SF["shade_ct"] = hit_s & (kind == 11)
        SF["glossy"] = SF["shade_cr"] | SF["shade_ct"]
        SF["g1"], SF["g2"] = _coord_system(ns)
        wo_l = _to_loc(SF, -d)
        SF["wo_l"] = wo_l
        SF["lam_o"] = _tr_lam(rough, wo_l[:, 2])
        SF["G1o"] = 1.0 / (1.0 + SF["lam_o"])
        SF["zo_s"] = torch.clamp(torch.abs(wo_l[:, 2]), min=1e-6)
    SF["use_gs"] = SF["shade_df"] & svalid if G.surf_guide else \
        torch.zeros_like(hit_s)
    if G.surf_guide:
        SF["sprod"] = _product_vmf(slob, ns, G.kappa_cos, G.log_c_cos, G)
    return SF


def _surface_nee(K, G, SF, wi):
    """The surface half of the shared NEE sample toward wi: the cosine,
    the pdf of the MIS competitor and the glossy f."""
    ns = SF["ns"]
    cosn = _dot(wi, ns)
    SF["cosn"] = cosn
    SF["nee_srf"] = SF["shade_df"] & (cosn > 0)
    bpdf = torch.clamp(cosn, min=0.0) * INV_PI
    spdf = bpdf
    if G.surf_guide:
        spdf = torch.where(SF["use_gs"], G.one_m_pg * bpdf + G.pg
                           * _mixture_pdf(K, SF["sprod"], wi), bpdf)
    SF["f_srf_nee"] = cosn * INV_PI
    SF["nee_glo"] = SF["glossy"] & (cosn > 0)
    if G.any_rough:
        wi_l = _to_loc(SF, wi)
        fne, pdf_spec = _glossy_f(SF, SF["wo_l"], wi_l)
        pr_ct = _frd(torch.abs(SF["wo_l"][:, 2]), SF["eta"])
        pdf_glo = torch.where(
            SF["shade_ct"], pr_ct * pdf_spec + (1.0 - pr_ct)
            * torch.clamp(cosn, min=0.0) * INV_PI, pdf_spec)
        spdf = torch.where(SF["nee_glo"], pdf_glo, spdf)
        SF["fne"] = fne
    SF["spdf_srf"] = spdf


def _surface_bounce(K, G, SF, d, u_s, u_dir, U):
    """The continuation of every surface lane: the cosine (or guided)
    diffuse draw, the unguided glossy VNDF draw, the mirror and the
    Fresnel pick of the dielectric. Returns the lanes, their new
    direction, throughput factor and MIS pdf, and what the records take."""
    u_s0, u_s1, u_s2 = u_s
    u_c, u_g0, u_g1, u_pk, u_sel = u_dir
    ns = SF["ns"]
    t1, t2 = _coord_system(ns)
    r_cs = torch.sqrt(u_s0)
    phi = K.two_pi * u_s1
    lx, ly = r_cs * torch.cos(phi), r_cs * torch.sin(phi)
    lz = torch.sqrt(torch.clamp(1.0 - u_s0, min=0.0))
    wdf = lx[:, None] * t1 + ly[:, None] * t2 + lz[:, None] * ns
    pdf_df = torch.clamp(lz, min=1e-6) * INV_PI
    ws, pdf_sv, mis_pdf_s, valid_sv = wdf, pdf_df, pdf_df, pdf_df > 0
    use_gs = SF["use_gs"]
    if G.surf_guide:
        sprod, svalid = SF["sprod"], SF["svalid"]
        if not G.ris:
            take = use_gs & (u_c < G.pg)
            u_lob = torch.clamp(u_c / G.pg_safe_t, 0.0, 0.999999)
            gw, gpdf = _mixture_sample(K, sprod, u_lob, u_g0, u_g1)
            ws = _W(take, gw, wdf)
            base = torch.where(take, torch.clamp(_dot(gw, ns), min=0.0)
                               * INV_PI, pdf_df)
            guide = torch.where(take, gpdf, _mixture_pdf(K, sprod, wdf))
            pdf_sv = torch.where(use_gs, G.one_m_pg * base + G.pg * guide,
                                 pdf_df)
            mis_pdf_s = pdf_sv
            valid_sv = (((take & (base > 0)) | (~take & (pdf_df > 0)))
                        & (pdf_sv > 0))
        else:
            gw, gpdf = _mixture_sample(K, sprod, u_g0, u_pk, u_sel)
            bpdf_g = torch.clamp(_dot(gw, ns), min=0.0) * INV_PI
            gpdf_b = _mixture_pdf(K, sprod, wdf)
            irp_b = torch.where(svalid, _mixture_pdf(K, SF["slob"], wdf),
                                INV_4PI)
            irp_g = torch.where(svalid, _mixture_pdf(K, SF["slob"], gw),
                                INV_4PI)
            mis0 = 0.5 * (pdf_df + gpdf_b)
            mis1 = 0.5 * (bpdf_g + gpdf)
            w0 = torch.where(pdf_df > 0, pdf_df * (G.ris_c0 + G.pg * irp_b)
                             / torch.clamp(mis0, min=1e-20), 0.0)
            w1 = torch.where(bpdf_g > 0, bpdf_g * (G.ris_c0 + G.pg * irp_g)
                             / torch.clamp(mis1, min=1e-20), 0.0)
            sum_w = w0 + w1
            pick1 = u_c * torch.clamp(sum_w, min=1e-20) > w0
            mis_sel = torch.where(pick1, mis1, mis0)
            pdf_ris = (torch.where(pick1, w1, w0) * mis_sel * 2.0
                       / torch.clamp(sum_w, min=1e-20))
            ws = _W(use_gs, _W(pick1, gw, wdf), wdf)
            pdf_sv = torch.where(use_gs, pdf_ris, pdf_df)
            mis_pdf_s = torch.where(use_gs, mis_sel, pdf_df)
            valid_sv = ((use_gs & (sum_w > 0) & (pdf_ris > 0))
                        | (~use_gs & (pdf_df > 0)))
    cos_out = torch.clamp(_dot(ws, ns), min=0.0)
    s_df = cos_out * INV_PI / torch.clamp(pdf_sv, min=1e-30)
    # an invalid guided draw (below the hemisphere) keeps the lane alive
    # with a vanishing weight, so that the pending surface NEE still folds
    # the exact product (the Pallas kernel's TINY_G continuation)
    s_df = torch.where(SF["shade_df"] & ~valid_sv, TINY_G, s_df)
    out = dict(ws=ws, pdf_sv=pdf_sv, s_df=s_df)
    glossy = SF["glossy"]
    if G.any_rough:
        u_r0, u_r1, u_r2, _ = U()
        wo_l, alpha = SF["wo_l"], SF["alpha"]
        wh = _normalize(torch.stack([alpha * wo_l[:, 0], alpha * wo_l[:, 1],
                                     wo_l[:, 2]], -1))
        wh = wh * torch.where(wh[:, 2] < 0, -1.0, 1.0)[:, None]
        whx, why, whz = wh[:, 0], wh[:, 1], wh[:, 2]
        tlen = torch.sqrt(torch.clamp(whx * whx + why * why, min=1e-18))
        big_z = whz > 0.999999
        t1hx = torch.where(big_z, 1.0, -why / tlen)
        t1hy = torch.where(big_z, 0.0, whx / tlen)
        t2hx, t2hy = -whz * t1hy, whz * t1hx
        t2hz = whx * t1hy - why * t1hx
        r_d = torch.sqrt(u_r0)
        ph_d = K.two_pi * u_r1
        px_d, py_d = r_d * torch.cos(ph_d), r_d * torch.sin(ph_d)
        h_d = torch.sqrt(torch.clamp(1.0 - px_d * px_d, min=0.0))
        mixz = (1.0 + whz) * 0.5
        py_d = mixz * py_d + (1.0 - mixz) * h_d
        pz_d = torch.sqrt(torch.clamp(1.0 - px_d * px_d - py_d * py_d,
                                      min=0.0))
        nhx = px_d * t1hx + py_d * t2hx + pz_d * whx
        nhy = px_d * t1hy + py_d * t2hy + pz_d * why
        nhz = px_d * 0.0 + py_d * t2hz + pz_d * whz
        wm = _normalize(torch.stack([alpha * nhx, alpha * nhy,
                                     torch.clamp(nhz, min=1e-6)], -1))
        owm = _dot(wo_l, wm)
        ri = 2.0 * owm[:, None] * wm - wo_l
        pr_s = _frd(torch.abs(wo_l[:, 2]), SF["eta"])
        take_spec = SF["shade_cr"] | (SF["shade_ct"] & (u_r2 < pr_s))
        wi_gl = _W(take_spec, ri, torch.stack([lx, ly, lz], -1))
        ziL = wi_gl[:, 2]
        fg, pdf_spec = _glossy_f(SF, wo_l, wi_gl)
        zi_c = torch.clamp(torch.abs(ziL), min=1e-6)
        pdf_gs = torch.where(SF["shade_ct"], pr_s * pdf_spec
                             + (1.0 - pr_s) * zi_c * INV_PI, pdf_spec)
        valid_g = (ziL > 1e-6) & (pdf_gs > 1e-12)
        pdf_gs = torch.clamp(pdf_gs, min=1e-12)
        inv_pgs = 1.0 / pdf_gs
        wg = _W(valid_g, fg * ziL[:, None] * inv_pgs[:, None], TINY_G)
        wi_w = (wi_gl[:, 0:1] * SF["g1"] + wi_gl[:, 1:2] * SF["g2"]
                + wi_gl[:, 2:3] * ns)
        out.update(wg=wg, wi_w=wi_w, pdf_gs=pdf_gs, inv_pgs=inv_pgs)
    shade_df, shade_co, shade_dl = (SF["shade_df"], SF["shade_co"],
                                    SF["shade_dl"])
    hit_s = shade_df | shade_co | shade_dl | glossy
    # conductor: mirror about ns with the Schlick tint; dielectric: the
    # Fresnel pick of reflection or refraction
    dnd = _dot(d, ns)
    wr = d - (2.0 * dnd)[:, None] * ns
    cos_o = torch.clamp(-dnd, 0.0, 1.0)
    eta_rel = torch.where(SF["front"], SF["eta"], 1.0 / SF["eta"])
    sin2_t = (torch.clamp(1.0 - cos_o * cos_o, min=0.0)
              / torch.clamp(eta_rel * eta_rel, min=1e-12))
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    r_par = ((eta_rel * cos_o - cos_t)
             / torch.clamp(eta_rel * cos_o + cos_t, min=1e-12))
    r_per = ((cos_o - eta_rel * cos_t)
             / torch.clamp(cos_o + eta_rel * cos_t, min=1e-12))
    F_dl = torch.where(sin2_t >= 1.0, 1.0,
                       0.5 * (r_par * r_par + r_per * r_per))
    refl_dl = u_s2 < F_dl
    inv_er = 1.0 / torch.clamp(eta_rel, min=1e-12)
    wt = _normalize(d * inv_er[:, None]
                    + (cos_o * inv_er - cos_t)[:, None] * ns)
    go_refl = shade_co | (shade_dl & refl_dl)
    n_d = _W(shade_df, ws, _W(go_refl, wr, wt))
    omc5 = _pow5(1.0 - cos_o)
    alb = SF["alb"]
    fs = alb + (1.0 - alb) * omc5[:, None]
    trans = inv_er * inv_er
    w_b = _W(shade_df, alb * s_df[:, None],
             _W(shade_co, fs, torch.where(refl_dl, 1.0, trans)[:, None]
                .expand_as(fs)))
    inv_mis = 1.0 / torch.clamp(mis_pdf_s, min=1e-30)
    if G.any_rough:
        n_d = _W(glossy, out["wi_w"], n_d)
        w_b = _W(glossy, out["wg"], w_b)
        inv_mis = torch.where(glossy, out["inv_pgs"], inv_mis)
    out.update(hit_s=hit_s, n_d=n_d, w_b=w_b, inv_mis=inv_mis,
               nondelta=shade_df | glossy,
               went_t=shade_dl & ~refl_dl)
    return out


def _body(K, G, T, S, seed, rec, counts):
    """One iteration of ``pallas_vspg._make_vspg_kernel``'s loop body for
    every lane of S, updating S in place; a lane's samples end before its
    sample number S["end"]. The eight draws per iteration:
    deferred RR, walk step, walk event, reservoir conclusion, majorant
    probe, NEE, direction (two); with triangles a ninth for the surface
    bounce and, when a material is glossy, a tenth for its lobe. `counts`
    gathers the lane-iterations, walk/shadow steps, scatters, walk-start
    field queries, surface events and ray-triangle tests run."""
    dev = K.dev
    dens, maj, ftab, tris, mats = T
    TR = tris is not None
    st, ss, envL, lI = K.st, K.ss, K.envL, K.lI

    def U():
        u = rng.uniform4(seed, S["gpix"], S["samp"], S["dim"])
        S["dim"] = S["dim"] + 1
        return u

    alive, mode = S["alive"], S["mode"]
    o, d, b, ru, rl, L = S["o"], S["d"], S["b"], S["ru"], S["rl"], S["L"]
    hero, depth, med = S["hero"], S["depth"], S["med"]
    rr_srv, maj_sc, vsp_c = S["rr_srv"], S["maj_sc"], S["vsp_c"]
    t_walk, w_sum, tau_acc = S["t_walk"], S["w_sum"], S["tau_acc"]
    wf, wu, wl, wT, wr = S["wf"], S["wu"], S["wl"], S["wT"], S["wr"]
    c_t, c_wi, c_ste, cn, cd = S["c_t"], S["c_wi"], S["c_ste"], S["cn"], \
        S["cd"]
    sh, sh_t, sh_end, sh_pdf, sh_d2 = S["sh"], S["sh_t"], S["sh_end"], \
        S["sh_pdf"], S["sh_d2"]
    sT, sl, su, sh_f, sh_fl = S["sT"], S["sl"], S["su"], S["sh_f"], \
        S["sh_fl"]
    rslot, pix = S["rslot"], S["pix"]

    # mode 2 is the reservoir walk of the resampling route and the ODS walk
    # under NDS, whose state aliases the reservoir's (the Pallas kernel's
    # carries): c_t the candidate's remaining optical depth (-1: draw one,
    # _BIG: passing to the wall), wT[0] / wT[1] the running t_v / t_n,
    # tau_acc / c_ste their totals, cn the per-channel truncation
    # renormalisations tp, c_wi the defensive plain-exponential flag, w_sum
    # the NDS+ bias exponent; mode 1 is the NDS majorant-OD prepass
    walk_res = alive & (mode == 2) & (not G.nds)
    walk_nds = alive & (mode == 2) & G.nds
    walk_pre = alive & (mode == 1)
    walk_del = alive & (mode == 3)
    st_h = st[hero]

    # deferred Russian roulette (survival stored at the last scatter)
    u_rr0 = U()[0]
    do_rr = alive & (mode == 0) & (rr_srv < 1.0)
    rr_kill = do_rr & (u_rr0 >= rr_srv)
    alive = alive & ~rr_kill
    inv_srv = 1.0 / torch.clamp(rr_srv, min=1e-3)
    b = _W(do_rr & ~rr_kill, b * inv_srv[:, None], b)
    rr_srv = torch.where(alive & (mode == 0), 1.0, rr_srv)

    stall = torch.zeros_like(alive)
    if TR:
        # one triangle sweep per iteration serves each lane's pending
        # query: the closest hit of its path ray after a direction change,
        # or the occlusion of its shadow ray at walk start. A lane stalls
        # the iteration it is swept, and so does a lane whose shadow walk
        # was just blocked: its path ray was not swept yet
        t_surf, hng, hmat = S["t_surf"], S["hng"], S["hmat"]
        hmi, hmo, needs_i = S["hmi"], S["hmo"], S["needs_i"]
        sh_occ = S["sh_occ"]
        do_is = alive & (mode == 0) & needs_i
        do_oc = alive & (mode >= 4) & sh_occ
        query = do_is | do_oc
        j = torch.nonzero(query)[:, 0]
        if j.numel():
            _count(counts, "tri_tests", j.numel() * tris.shape[0])
            qd = _W(do_oc, sh, d)[j]
            hit_j, t_j, k_j, _, _ = _tri_hit(tris, o[j], qd, torch.full_like(
                qd[:, 0], _BIG))
            row = tris[k_j]
            neg = torch.full_like(k_j, -1)
            t_h = torch.full_like(t_surf, _BIG).index_put((j,), t_j)
            nh = torch.zeros_like(hng).index_put(
                (j,), _W(hit_j, row[:, T_NG:T_NG + 3], 0.0))
            m_h, mi_h, mo_h = (neg.new_full(t_surf.shape, -1).index_put(
                (j,), torch.where(hit_j, row[:, col].long(), neg))
                for col in (T_MAT, T_MED_IN, T_MED_OUT))
        else:
            t_h = torch.full_like(t_surf, _BIG)
            nh = torch.zeros_like(hng)
            m_h = mi_h = mo_h = torch.full_like(hmat, -1)
        t_surf = torch.where(do_is, t_h, t_surf)
        hng = _W(do_is, nh, hng)
        hmat = torch.where(do_is, m_h, hmat)
        hmi = torch.where(do_is, mi_h, hmi)
        hmo = torch.where(do_is, mo_h, hmo)
        needs_i = needs_i & ~do_is
        # point lights occlude up to the light, the environment to infinity
        occ_t = torch.where(mode == 4, torch.sqrt(S["sh_d2"]), _BIG)
        blocked = do_oc & (t_h < occ_t - 1e-4)
        mode = torch.where(blocked, 0, mode)
        sh_occ = sh_occ & ~do_oc
        stall = do_is | (alive & (mode == 0) & needs_i)

    # stuck-lane guard, then transport lanes enter the box or escape
    oob = ((o < K.bmin_t) | (o > K.bmax_t)).any(-1)
    med = torch.where((med == 0) & oob & (mode == 0) & ~stall, -1, med)
    hit, t_wall, entering = _box_hit(o, d, K.bmin, K.bmax)
    outside = alive & (mode == 0) & (med != 0) & ~stall
    if TR:
        no_surf = t_surf >= _BIG * 0.5
        escaped = outside & ~hit & no_surf
    else:
        escaped = outside & ~hit
    if K.has_env:
        first = depth == 0
        if TR:
            # a delta bounce has no light-sampling competitor
            first = first | S["spec_last"]
        ru_avg = torch.clamp(_avg3(ru), min=1e-30)
        L = _W(escaped & first, L + b * envL / ru_avg[:, None], L)
        den = torch.clamp(_avg3(ru + rl * K.penv), min=1e-30)
        L = _W(escaped & ~first, L + b * envL / den[:, None], L)
        if rec is not None:
            w_mis = torch.where(first, 1.0, ru_avg / den)
            rec.put((11, 12, 13), rslot - 1, escaped,
                    envL * w_mis[:, None], pix)
    alive = alive & ~escaped
    if TR:
        # a surface before the box wall: a flight outside the medium
        # reaches a triangle (inside the glass too); otherwise a wall
        # crossing sets the medium by the side entered
        wall_o = torch.where(hit, t_wall, _BIG)
        at_surf_nm = outside & ~escaped & ~no_surf & (t_surf < wall_o)
        iface = outside & ~escaped & ~at_surf_nm & hit
        med = torch.where(iface, torch.where(entering, 0, -1), med)
        o = _W(iface, o + (t_wall + 1e-4)[:, None] * d, o)
        t_surf = torch.where(iface, t_surf - (t_wall + 1e-4), t_surf)
        enter = iface & entering
    else:
        enter = alive & outside & hit & entering
        med = torch.where(enter, 0, med)
        o = _W(enter, o + (t_wall + 1e-4)[:, None] * d, o)
        stuck = alive & outside & hit & ~entering
        alive = alive & ~stuck
    in_med = alive & (mode == 0) & (med == 0) & ~enter & ~stall
    # a walk in the medium ends at the exit, also one nearer than
    # _box_hit's 1e-4 (ROADMAP.md section C 4)
    wall = torch.where(hit, t_wall, torch.where(
        med == 0, _box_exit(o, d, K.bmin, K.bmax), _BIG))
    _count(counts, "exit_walks", (in_med & ~hit).sum())
    # walks are bounded by the nearer of the wall and the next surface
    plim = torch.minimum(wall, t_surf) if TR else wall
    has_c = S["has_c"]

    # ---- one shared majorant + density event of every walking lane ------
    is_sh = alive & (mode >= 4)
    ep = _W(is_sh, o + sh_t[:, None] * sh, o + t_walk[:, None] * d)
    wd = _W(is_sh, sh, d)
    t_lim = torch.where(is_sh, sh_end - sh_t, plim - t_walk)
    ua, ub, uc, _ = U()
    if G.nds:
        # ODS candidate draw: lanes without a pending candidate draw an
        # optical depth on the truncated exponential over [0, t_n) (the
        # defensive lanes: the plain exponential); tp gathers the
        # truncation renormalisations of every channel
        need_d = walk_nds & (c_t < 0)
        tn_pos = torch.clamp(wT[:, 1], min=0.0)
        step_tr = -torch.expm1(-tn_pos)
        dist_g = -torch.log1p(-ua * torch.clamp(step_tr, 0.0, 1.0 - 1e-7))
        dist = torch.where(c_wi > 0.5, -torch.log1p(-ua), dist_g)
        inv_sth = 1.0 / torch.clamp(st_h, min=1e-30)
        cn = _W(need_d, cn * torch.clamp(-torch.expm1(
            (-tn_pos)[:, None] * st * inv_sth[:, None]), min=1e-30), cn)
        pass_n = need_d & (wT[:, 0] - dist < 1e-5)
        tailf = torch.clamp(-torch.expm1(-torch.clamp(c_ste - tau_acc,
                                                      min=0.0)), min=1e-30)
        cn = _W(pass_n, cn / tailf[:, None], cn)
        c_t = torch.where(need_d, torch.where(pass_n, _BIG, dist), c_t)
    stepper = walk_res | walk_del | is_sh | walk_nds | walk_pre
    if counts is not None:
        _count(counts, "iters", alive.numel())
        _count(counts, "steps", (stepper & ~walk_pre).sum())
        _count(counts, "pre_steps", walk_pre.sum())
        if G.nds:
            _count(counts, "draws", need_d.sum())
    rate = torch.where(walk_res, maj_sc, 1.0)
    tau0 = -torch.log1p(-ua)
    if G.nds:
        # ODS lanes fly to their candidate; the prepass never collides
        tau0 = torch.where(walk_nds, torch.clamp(c_t, min=0.0), tau0)
        tau0 = torch.where(walk_pre, _BIG, tau0)
    u0 = (ep - K.bmin_t) * G.km
    den_w = torch.where(torch.abs(wd) < 1e-12,
                        torch.where(wd >= 0, 1e-12, -1e-12), wd)
    inv_du = G.cell / den_w
    eps = torch.where(wd >= 0, 3e-4, -3e-4)
    m_raw = _maj_at(K, maj, u0.to(torch.int64))
    cf = torch.floor(u0 + eps)
    bnd = torch.where(wd >= 0, cf + 1.0, cf)
    tx = (bnd - u0) * inv_du
    t_exit = torch.minimum(torch.minimum(tx[:, 0], tx[:, 1]), tx[:, 2])
    t_exit = torch.clamp(t_exit, min=1e-5)
    end_c = torch.minimum(t_exit, t_lim)
    r_i = m_raw * rate * st_h
    dtau = r_i * torch.clamp(end_c, min=0.0)
    hit_c = stepper & (tau0 < dtau)
    at_lim = stepper & ~hit_c & (t_lim <= t_exit + 1e-6)
    t_next = torch.where(hit_c, tau0 / torch.clamp(r_i, min=1e-30), end_c)
    S_raw = torch.where(stepper, m_raw * t_next, 0.0)
    t_cum = torch.where(stepper, torch.where(hit_c | at_lim, t_next,
                                             t_exit + 1e-6), 0.0)
    m_last = torch.where(hit_c, m_raw, 0.0)
    coll = stepper & hit_c
    m_d = torch.where(walk_res, m_last * maj_sc, m_last)
    maj_h = m_d * st_h
    step = t_cum
    S_eff = S_raw * rate
    od_raw = st_h * S_raw
    Tm_h = torch.clamp(torch.exp(-st_h * S_eff), min=1e-30)
    if G.gray:
        Tm = Tm_h[:, None].expand(-1, 3)
        sc_tail = None
    else:
        Tm = torch.exp(-st * S_eff[:, None])
        sc_tail = Tm / Tm_h[:, None]
    un0 = U()[0]
    dloc = _density8(K, G, dens, ep + step[:, None] * wd)
    st_loc_h = dloc * st_h
    sn = torch.clamp((m_d - dloc)[:, None] * st, min=0.0)
    sn_h = torch.clamp(m_d - dloc, min=0.0) * st_h

    # ---- modes 4/5: one ratio-tracking step of the shadow walk ----------
    s_coll = is_sh & coll
    if sc_tail is not None:
        s_tail = is_sh & ~coll
        sT = _W(s_tail, sT * sc_tail, sT)
        sl = _W(s_tail, sl * sc_tail, sl)
        su = _W(s_tail, su * sc_tail, su)
    inv_spdf = (1.0 / torch.clamp(Tm_h * maj_h, min=1e-30))[:, None]
    sT = _W(s_coll, sT * Tm * sn * inv_spdf, sT)
    sl = _W(s_coll, sl * Tm * m_d[:, None] * st * inv_spdf, sl)
    su = _W(s_coll, su * Tm * sn * inv_spdf, su)
    trm = _max3(sT) / torch.clamp(_avg3(sl + su), min=1e-30)
    low = s_coll & (trm < 0.05)
    killed = low & (un0 < 0.75)
    sT = _W(killed, torch.zeros_like(sT), _W(low, sT / 0.25, sT))
    sh_t_new = sh_t + step + 1e-6
    sh_t = torch.where(is_sh, sh_t_new, sh_t)
    s_dead = is_sh & ((_max3(sT) == 0) | (sh_t_new >= sh_end))
    # the fold value per channel: a glossy surface's f is tinted
    f3 = (torch.stack([sh_f, S["sh_f1"], S["sh_f2"]], -1)
          if TR and G.any_rough else sh_f[:, None])
    ra = S["ra"]  # a surface NEE record's albedo tint (1 elsewhere)
    if K.has_point:
        okp = s_dead & (mode == 4)
        denom = torch.clamp(_avg3(sl * ru * K.pmf), min=1e-30)
        w = f3 / (sh_d2 * denom)[:, None]
        L = _W(okp, L + b * sT * lI * w, L)
        if rec is not None:
            den_lp = torch.clamp(_avg3(sl * K.pmf), min=1e-30)
            wl_ = sh_fl / (sh_d2 * den_lp)
            rec.put((8, 9, 10), rslot - 1, okp,
                    sT * lI * wl_[:, None] * ra, pix)
    if K.has_env:
        oke = s_dead & (mode == 5)
        p_l = K.penv
        denom = torch.clamp(_avg3(sl * ru * p_l + su * ru * sh_pdf[:, None]),
                            min=1e-30)
        w = f3 / denom[:, None]
        L = _W(oke, L + b * sT * envL * w, L)
        if rec is not None:
            den_le = torch.clamp(_avg3(sl * p_l + su * sh_pdf[:, None]),
                                 min=1e-30)
            wl_ = sh_fl / den_le
            rec.put((8, 9, 10), rslot - 1, oke,
                    sT * envL * wl_[:, None] * ra, pix, add=True)
    mode = torch.where(s_dead, 0, mode)

    # ---- mode 3: one delta-tracking step (ODS lanes ride the same algebra
    # on their optical-depth candidates) -----------------------------------
    wd_m = walk_del | walk_nds
    d_coll = wd_m & coll
    if sc_tail is not None:
        d_tail = wd_m & ~coll
        wf = _W(d_tail, wf * sc_tail, wf)
        wu = _W(d_tail, wu * sc_tail, wu)
        wl = _W(d_tail, wl * sc_tail, wl)
    p_real = st_loc_h / torch.clamp(maj_h, min=1e-30)
    p_cls = p_real
    if G.nds_plus:
        # NDS+ raises a primary ray's real-collision probability to
        # p^(1/(1+Tr)), Tr the pixel's TrBuffer entry
        prim_l = walk_nds & (depth == 0)
        p_cls = torch.where(prim_l, torch.clamp(p_real, 1e-30, 1.0)
                            ** torch.clamp(w_sum, 1e-3, 1.0), p_real)
    d_real = d_coll & (ub < p_cls)
    d_null = d_coll & ~d_real
    pdf_r = torch.clamp(Tm_h * st_loc_h, min=1e-30)[:, None]
    dl = dloc[:, None]
    wf = _W(d_real, wf * Tm * dl * ss / pdf_r, wf)
    wu = _W(d_real, wu * Tm * dl * st / pdf_r, wu)
    pdf_dn = Tm_h * sn_h
    inv_dn = (1.0 / torch.clamp(pdf_dn, min=1e-30))[:, None]
    wf = _W(d_null, wf * Tm * sn * inv_dn, wf)
    wu = _W(d_null, wu * Tm * sn * inv_dn, wu)
    wl = _W(d_null, wl * Tm * m_d[:, None] * st * inv_dn, wl)
    d_died = d_null & ((pdf_dn <= 0) | (_max3(wf) == 0))
    del_t_new = t_walk + step + 1e-6
    d_passed = wd_m & ~coll & (del_t_new >= plim)
    t_walk = torch.where(wd_m, del_t_new, t_walk)
    if G.nds:
        # ODS bookkeeping: the flight consumed od_raw of the running
        # interval; a null collision draws anew next iteration
        wT = _W(walk_nds, torch.stack([wT[:, 0] - od_raw, wT[:, 1] - od_raw,
                                       wT[:, 2]], -1), wT)
        c_t = torch.where(walk_nds & coll, -1.0,
                          torch.where(walk_nds, c_t - od_raw, c_t))
        # one-sample MIS factor against plain delta tracking, on r_u at a
        # real collision and on r_u and r_l at the pass exit
        ruf = G.mis_t / torch.clamp(cn, min=1e-30) + G.one_m_mis
        nreal = d_real & walk_nds
        npass = d_passed & walk_nds
        wu = _W(nreal | npass, wu * ruf, wu)
        wl = _W(npass, wl * ruf, wl)
        if G.nds_plus:
            # exact r_u compensation of the biased classification
            comp_r = m_d * p_cls / torch.clamp(dloc, min=1e-30)
            comp_n = m_d * (1.0 - p_cls) / torch.clamp(m_d - dloc, min=1e-30)
            wu = _W(nreal & prim_l, wu * comp_r[:, None],
                    _W(d_null & prim_l, wu * comp_n[:, None], wu))

        # ---- mode 1: the exact majorant-OD prepass to the chord end; then
        # the ODS walk, or the delta walk where vsp < 1 - e^-t_v -----------
        tau_acc = torch.where(walk_pre, tau_acc + od_raw, tau_acc)
        pre_t_new = t_walk + step + 1e-6
        pre_done = walk_pre & (pre_t_new >= plim)
        t_walk = torch.where(walk_pre, torch.where(pre_done, 0.0, pre_t_new),
                             t_walk)
        one_m_e = -torch.expm1(-tau_acc)
        fb = pre_done & ((vsp_c < one_m_e) | (tau_acc <= 1e-7))
        go = pre_done & ~fb
        mode = torch.where(pre_done, torch.where(fb, 3, 2), mode)
        t_n0 = -torch.log1p(-torch.clamp(
            one_m_e / torch.clamp(vsp_c, min=1e-4), max=1.0 - 1e-7))
        wT = _W(go, torch.stack([tau_acc, t_n0, wT[:, 2]], -1), wT)
        c_ste = torch.where(go, t_n0, c_ste)
        c_t = torch.where(go, -1.0, c_t)
        cn = _W(go, torch.ones_like(cn), cn)
        # the defensive-MIS technique pick
        c_wi = torch.where(go, (uc > G.mis).to(torch.float32), c_wi)
        inv_gamma = 1.0
        if G.nds_plus:
            inv_gamma = torch.where(depth == 0, 1.0 / (1.0 + torch.clamp(
                _sel(S["itr"], hero), 0.0, 1.0)), 1.0)
        w_sum = torch.where(go, inv_gamma, w_sum)

    # ---- mode 2: one reservoir-resampling step ---------------------------
    tau_acc = torch.where(walk_res, tau_acc + od_raw, tau_acc)
    r_coll = walk_res & coll
    wTn = _W(walk_res, wT * Tm, wT)
    tr_h = _sel(wr, hero)
    wi_r = torch.where(r_coll, st_loc_h / torch.clamp(maj_h, min=1e-30)
                       * tr_h, 0.0)
    w_sum_new = w_sum + wi_r
    take = r_coll & (wi_r > 0) & (ub < wi_r / torch.clamp(w_sum_new,
                                                          min=1e-30))
    T_h = torch.clamp(_sel(wTn, hero), min=1e-30)
    pdf_rr = torch.clamp(T_h * st_loc_h, min=1e-30)[:, None]
    t_c_r = t_walk + step
    c_t = torch.where(take, t_c_r, c_t)
    c_wi = torch.where(take, wi_r, c_wi)
    c_ste = torch.where(take, wi_r, c_ste)
    cn = _W(take, wf * wTn * dl * ss / pdf_rr, cn)
    cd = _W(take, wu * wTn * dl * st / pdf_rr, cd)
    has_c = has_c | take
    w_sum = torch.where(r_coll, w_sum_new, w_sum)
    pdf_rn = torch.clamp(T_h * sn_h, min=1e-30)[:, None]
    wf = _W(r_coll, wf * wTn * sn / pdf_rn, wf)
    wu = _W(r_coll, wu * wTn * sn / pdf_rn, wu)
    wl = _W(r_coll, wl * wTn * m_d[:, None] * st / pdf_rn, wl)
    nsc = torch.clamp(m_d - dloc, min=0.0) * (
        1.0 / torch.clamp(m_d, min=1e-30))
    wr = _W(r_coll, wr * nsc[:, None], wr)
    wT = _W(r_coll, torch.ones_like(wTn), wTn)
    res_t_new = torch.where(r_coll, t_c_r, t_walk + step + 1e-6)
    t_walk = torch.where(walk_res, res_t_new, t_walk)
    res_done = walk_res & (res_t_new >= plim)

    # ---- reservoir conclusion: tail fold + candidate selection -----------
    u_rc = U()[0]
    T_hf = torch.clamp(_sel(wT, hero), min=1e-30)[:, None]
    tr_hf = _sel(wr, hero)
    vratio = torch.clamp(vsp_c / torch.clamp(
        1.0 - torch.exp(-maj_sc * tau_acc), min=1e-6), max=1.0)
    vol_ratio = vratio * G.mis + (1.0 - tr_hf) * G.one_m_mis
    adj = res_done & (tr_hf < 1) & (tr_hf > 0) & (w_sum > 0)
    surf_wi = torch.where(adj, (1.0 - vol_ratio) / torch.clamp(
        vol_ratio, min=1e-6) * w_sum, tr_hf)
    w_total = w_sum + surf_wi
    r_dead0 = res_done & (w_total <= 0)
    pick_surf = res_done & ~r_dead0 & (u_rc < surf_wi / torch.clamp(
        w_total, min=1e-30))
    pick_vol = res_done & ~r_dead0 & ~pick_surf & has_c
    r_dead = r_dead0 | (res_done & ~pick_surf & ~has_c)
    sel_wi = torch.where(pick_surf, surf_wi, c_wi)
    sel_ste = torch.where(pick_surf, tr_hf, c_ste)
    sn_ = _W(pick_surf, wf * wT / T_hf, cn)
    sd_ = _W(pick_surf, wu * wT / T_hf, cd)
    factor = w_total * sel_ste / torch.clamp(sel_wi, min=1e-30)
    r_ok = res_done & ~r_dead
    one3 = torch.ones_like(b)
    rfb = _W(r_ok, sn_ * factor[:, None], one3)
    rfu = _W(r_ok, sd_, one3)
    rfl = _W(pick_surf, wl * wT / T_hf, one3)
    finite = (torch.isfinite(rfb).all(-1) & torch.isfinite(rfu).all(-1)
              & torch.isfinite(rfl).all(-1))
    r_bad = r_ok & ~finite
    r_dead = r_dead | r_bad
    r_scat = pick_vol & ~r_bad

    # ---- walk conclusions -------------------------------------------------
    del_conc = d_real | d_died | d_passed
    b = _W(del_conc, b * wf, _W(res_done, b * rfb, b))
    ru = _W(del_conc, ru * wu, _W(res_done, ru * rfu, ru))
    rl = _W(del_conc, rl * wl, _W(res_done, rl * rfl, rl))
    scat_w = d_real | r_scat
    term_w = d_died | r_dead
    passed = d_passed | pick_surf
    # under NDS c_t holds the ODS candidate: only a real collision scatters
    t_sc = torch.where(d_real, t_walk, 0.0 if G.nds else c_t)
    alive = alive & ~term_w
    alive = alive & ~(scat_w & (depth >= K.max_depth))
    scat = scat_w & (depth < K.max_depth) & alive
    depth = torch.where(scat, depth + 1, depth)
    # a walk that passes ends at the box wall (the lane leaves the medium)
    # or, with triangles, at the next surface (the medium unchanged)
    if TR:
        at_surf_m = passed & (t_surf < wall - 1e-6)
        leave = passed & ~at_surf_m
    else:
        leave = passed
    med = torch.where(leave, -1, med)
    mode = torch.where(passed | term_w | scat_w, 0, mode)
    o = _W(leave, o + (wall + 1e-4)[:, None] * d, o)
    if TR:
        t_surf = torch.where(leave, t_surf - (wall + 1e-4), t_surf)

    # ---- field query: walk starts (secondary VSP) and scatter vertices ---
    s = o + t_sc[:, None] * d
    if counts is not None:
        _count(counts, "scatters", scat.sum())
        if G.guide_secondary:
            _count(counts, "queries", (in_med & (depth != 0)).sum())
        if G.cells is not None:
            _count(counts, "child_scatters",
                   (scat & (_leaf(G, s) >= G.ncell)).sum())
    q = _W(scat, s, o)
    if TR:
        # surface interactions (the depth cap holds for surfaces too)
        hit_s0 = (at_surf_m | at_surf_nm) & (hmat >= 0)
        alive = alive & ~(hit_s0 & (depth >= K.max_depth))
        hit_s = hit_s0 & alive
        depth = torch.where(hit_s, depth + 1, depth)
        hpos = o + t_surf[:, None] * d
        q = _W(hit_s, hpos, q)
        _count(counts, "surface_events", hit_s.sum())
    fq = _field_query(G, ftab, q)
    lob, valid_q, vsp_cell_q, flux_q = fq[:4]
    primary = depth == 0
    vsp = torch.full_like(vsp_c, -1.0)
    if G.guide_primary:
        vsp = torch.where(primary, S["ivsp"], vsp)
    if G.guide_secondary:
        vsp = torch.where(~primary, _vsp_directional(K, lob, vsp_cell_q, d),
                          vsp)
    guide = in_med & (vsp >= 0.0)
    vsp_c = torch.where(in_med, torch.clamp(vsp, 0.001, 0.999), vsp_c)
    # NDS: a guided walk starts with the majorant-OD prepass (mode 1)
    mode = torch.where(in_med, torch.where(guide, 1 if G.nds else 2, 3),
                       mode)
    t_walk = torch.where(in_med, 0.0, t_walk)
    w_sum = torch.where(in_med, 0.0, w_sum)
    tau_acc = torch.where(in_med, 0.0, tau_acc)
    # majorant scale of the guided walk from a one-point estimate of the
    # segment's majorant optical depth
    u_m0 = U()[0]
    pm = o + (u_m0 * plim)[:, None] * d
    m_pt = _maj_at(K, maj, ((pm - K.bmin_t) / G.ext * K.mres_t).to(
        torch.int64))
    tau_e = m_pt * st_h * plim
    min_total = -torch.log(torch.clamp(
        1.0 - torch.clamp(vsp_c, max=G.cap), min=1e-6))
    if G.nds:  # optical-depth space: no majorant scaling
        maj_sc = torch.where(in_med, 1.0, maj_sc)
    else:
        maj_sc = torch.where(guide, torch.clamp(
            min_total / torch.clamp(tau_e, min=1e-6), 1.0, 16.0),
            torch.where(in_med, 1.0, maj_sc))
    wf = _W(in_med, one3, wf)
    wu = _W(in_med, one3, wu)
    wl = _W(in_med, one3, wl)
    wT = _W(guide, one3, wT)
    wr = _W(guide, one3, wr)
    c_t = torch.where(guide, 0.0, c_t)
    c_wi = torch.where(guide, 0.0, c_wi)
    c_ste = torch.where(guide, 0.0, c_ste)
    cn = _W(guide, one3, cn)
    cd = _W(guide, one3, cd)
    has_c = has_c & ~guide

    # ---- scatter vertices: guided RR, NEE light pick, direction ----------
    use_guide = scat & valid_q & G.vol_guiding
    prod = _product_hg(K, G, lob, d)
    wo = -d
    if TR:
        SF = _surface_frame(K, G, fq[4:], hit_s, hng, hmat, d, mats)
    if G.guide_rr:
        bf = b * flux_q
        num_rr = bf[:, 0] * _LUM[0] + bf[:, 1] * _LUM[1] + bf[:, 2] * _LUM[2]
        survival = torch.where(
            valid_q & (S["ipem"] > 0),
            torch.clamp(num_rr / torch.clamp(S["ipel"], min=1e-6), 0.1, 1.0),
            1.0)
    else:
        survival = torch.clamp(_max3(b) / torch.clamp(_avg3(ru), min=1e-30),
                               0.0, 1.0)
    rr_srv = torch.where(scat & (depth > G.min_rr_depth), survival, rr_srv)

    up0, up1, up2, _ = U()
    if K.has_point:
        sel_pt = (up0 < K.pmf) if K.has_env else torch.ones_like(scat)
    else:
        sel_pt = torch.zeros_like(scat)
    # volume scatters and non-delta surfaces share one light sample (the
    # Pallas kernel takes glossy surfaces' from the volume vertex's
    # position, a fault the port does not copy: ROADMAP.md §C)
    sp = _W(SF["shade_df"] | SF["glossy"], hpos, s) if TR else s
    pl = sp - K.lp
    dist2 = torch.clamp(_dot(pl, pl), min=1e-12)
    dist = torch.sqrt(dist2)
    ez = 1.0 - 2.0 * up1
    er = torch.sqrt(torch.clamp(1.0 - ez * ez, min=0.0))
    ephi = K.two_pi * up2
    wi = _W(sel_pt, -pl * (1.0 / dist)[:, None],
            torch.stack([er * torch.cos(ephi), er * torch.sin(ephi), ez], -1))
    f_hg = _hg_value(K, _dot(wo, wi))
    spdf_l = torch.where(use_guide, G.one_m_pg_nee * f_hg
                         + G.pg_nee * _mixture_pdf(K, prod, wi), f_hg)
    # a shadow walk from a scatter vertex or a hit inside the box ends at
    # the exit; from a hit outside it, at the face _box_hit reports
    t_exit_s = _box_exit(sp, wi, K.bmin, K.bmax)
    if TR:
        away = (SF["shade_df"] | SF["glossy"]) & (
            (sp < K.bmin_t) | (sp > K.bmax_t)).any(-1)
        t_exit_s = torch.where(away, _box_hit(sp, wi, K.bmin, K.bmax)[1],
                               t_exit_s)
    t_med = torch.where(sel_pt, torch.minimum(dist, t_exit_s), t_exit_s)
    nee_act = scat & (f_hg > 0)
    if TR:
        _surface_nee(K, G, SF, wi)

    u_p0, u_p1, u_sel, u_pk = U()
    u_c, u_g0, u_g1, _ = U()
    hw, hpdf = _sample_hg(K, wo, u_p0, u_p1)
    if not G.ris:
        take_g = use_guide & (u_c < G.pg)
        u_lobe = torch.clamp(u_c / G.pg_safe_t, 0.0, 0.999999)
        gw, gpdf = _mixture_sample(K, prod, u_lobe, u_g0, u_g1)
        wv = _W(take_g, gw, hw)
        base_pdf = torch.where(take_g, _hg_value(K, _dot(wo, gw)), hpdf)
        guide_pdf = torch.where(take_g, gpdf, _mixture_pdf(K, prod, hw))
        pdf_v = torch.where(use_guide, G.one_m_pg * base_pdf
                            + G.pg * guide_pdf, hpdf)
        mis_pdf = pdf_v
        valid_v = (((take_g & (base_pdf > 0)) | (~take_g & (hpdf > 0)))
                   & (pdf_v > 0))
    else:
        gw, gpdf = _mixture_sample(K, prod, u_g0, u_pk, u_sel)
        bpdf_g = _hg_value(K, _dot(wo, gw))
        gpdf_b = _mixture_pdf(K, prod, hw)
        irp_b = torch.where(valid_q, _mixture_pdf(K, lob, hw), INV_4PI)
        irp_g = torch.where(valid_q, _mixture_pdf(K, lob, gw), INV_4PI)
        mis0 = 0.5 * (hpdf + gpdf_b)
        mis1 = 0.5 * (bpdf_g + gpdf)
        target0 = hpdf * (G.ris_c0 + G.pg * irp_b)
        target1 = bpdf_g * (G.ris_c0 + G.pg * irp_g)
        w0 = torch.where(hpdf > 0, target0 / torch.clamp(mis0, min=1e-20),
                         0.0)
        w1 = torch.where(bpdf_g > 0, target1 / torch.clamp(mis1, min=1e-20),
                         0.0)
        sum_w = w0 + w1
        pick1 = u_c * torch.clamp(sum_w, min=1e-20) > w0
        mis_sel = torch.where(pick1, mis1, mis0)
        w_sel = torch.where(pick1, w1, w0)
        pdf_ris = w_sel * mis_sel * 2.0 / torch.clamp(sum_w, min=1e-20)
        ris_valid = use_guide & (sum_w > 0) & (pdf_ris > 0)
        wv = _W(use_guide, _W(pick1, gw, hw), hw)
        pdf_v = torch.where(use_guide, pdf_ris, hpdf)
        mis_pdf = torch.where(use_guide, mis_sel, hpdf)
        valid_v = (use_guide & ris_valid) | (~use_guide & (hpdf > 0))
    f_v = _hg_value(K, _dot(wo, wv))
    alive = alive & ~(scat & ~valid_v)
    scale_v = f_v / torch.clamp(pdf_v, min=1e-30)
    b = _W(scat, b * scale_v[:, None], b)
    rl = _W(scat, ru * (1.0 / torch.clamp(mis_pdf, min=1e-30))[:, None], rl)
    o = _W(scat, s, o)
    d = _W(scat, wv, d)

    if TR:
        # ---- surface bounces ---------------------------------------------
        u_s0, u_s1, u_s2, _ = U()
        spec_lane = SF["shade_co"] | SF["shade_dl"]
        SB = _surface_bounce(K, G, SF, d, (u_s0, u_s1, u_s2),
                             (u_c, u_g0, u_g1, u_pk, u_sel), U)
        hit_s = SB["hit_s"]
        b = _W(hit_s, b * SB["w_b"], b)
        rl = _W(hit_s, _W(SB["nondelta"], ru * SB["inv_mis"][:, None], ru),
                rl)
        # dielectric transmission switches to the far side's medium
        med = torch.where(SB["went_t"], torch.where(SF["front"], hmi, hmo),
                          med)
        ns = SF["ns"]
        out_sgn = torch.where(_dot(SB["n_d"], ns) >= 0, 1.0, -1.0)
        o = _W(hit_s, hpos + (out_sgn * 1e-4)[:, None] * ns, o)
        d = _W(hit_s, SB["n_d"], d)
        spec_last = torch.where(hit_s, ~SB["nondelta"],
                                S["spec_last"] & ~scat)
        t_surf = torch.where(hit_s | scat, _BIG, t_surf)
        needs_i = needs_i | hit_s | scat
        # guided RR at surfaces: the surface half's flux and the
        # continued beta; delta lanes survive at 0.95
        if G.guide_rr:
            bf = b * SF["sflux"]
            num_rs = (bf[:, 0] * _LUM[0] + bf[:, 1] * _LUM[1]
                      + bf[:, 2] * _LUM[2])
            surv_s = torch.where(
                SF["svalid"] & (S["ipem"] > 0),
                torch.clamp(num_rs / torch.clamp(S["ipel"], min=1e-6), 0.1,
                            1.0), 1.0)
            surv_s = torch.where(spec_lane, 0.95, surv_s)
        else:
            surv_s = torch.clamp(_max3(b) / torch.clamp(_avg3(ru),
                                                        min=1e-30), 0.0, 1.0)
        rr_srv = torch.where(hit_s & (depth > G.min_rr_depth), surv_s,
                             rr_srv)

    if rec is not None:
        # a new vertex slot per recorded vertex: volume scatters and, with
        # triangles, non-delta surface bounces (delta bounces are not
        # recorded); vertices past the record depth are dropped
        ones = torch.ones_like(scale_v)
        rec_v, rp, rw, rpdf = scat, s, wv, pdf_v
        rsw = torch.stack([scale_v, scale_v, scale_v], -1)
        is_vol = ones
        if TR:
            rec_nd = SB["nondelta"]
            rec_v = scat | rec_nd
            rp = _W(rec_nd, hpos, s)
            rw = _W(SF["shade_df"], SB["ws"], wv)
            rsw = _W(SF["shade_df"], SF["alb"] * SB["s_df"][:, None], rsw)
            rpdf = torch.where(SF["shade_df"], SB["pdf_sv"], pdf_v)
            if G.any_rough:
                glossy = SF["glossy"]
                rw = _W(glossy, SB["wi_w"], rw)
                rsw = _W(glossy, SB["wg"], rsw)
                rpdf = torch.where(glossy, SB["pdf_gs"], rpdf)
            is_vol = scat.to(torch.float32)
        rec.put((0, 1, 2), rslot, rec_v, rp, pix)
        rec.put((3, 4, 5), rslot, rec_v, rw, pix)
        rec.put((6, 22, 23, 7, 18), rslot, rec_v, torch.cat(
            [rsw, rpdf[:, None], is_vol[:, None]], -1), pix)
        f1 = scat & (depth == 1)
        zs = torch.zeros_like(rslot)
        rec.put((14, 15, 16, 17, 19, 20, 21), zs, f1, torch.cat(
            [ones[:, None], wo, ones[:, None] * G.alb], -1), pix)
        if TR:
            fs1 = hit_s & (depth == 1)
            rec.put((15, 16, 17, 19, 20, 21), zs, fs1,
                    torch.cat([SF["ns"], SF["alb"]], -1), pix)
        rslot = torch.where(rec_v, rslot + 1, rslot)

    # ---- arm the shadow walk of the pending NEE ---------------------------
    nee_go = nee_act & alive
    nee_all = nee_go
    if TR:
        nee_gs = SF["nee_srf"] & alive & SF["shade_df"]
        nee_gl = SF["nee_glo"] & alive
        nee_all = nee_go | nee_gs | nee_gl
    _count(counts, "exit_shadows", (nee_all & (t_exit_s <= 1e-4)).sum())
    mode = torch.where(nee_all, torch.where(sel_pt, 4, 5), mode)
    sh = _W(nee_all, wi, sh)
    sh_t = torch.where(nee_all, 0.0, sh_t)
    sh_end = torch.where(nee_all, t_med, sh_end)
    sh_pdf = torch.where(nee_go, spdf_l, sh_pdf)
    sh_d2 = torch.where(nee_all, dist2, sh_d2)
    sh_f = torch.where(nee_go, f_hg / torch.clamp(scale_v, min=1e-30), sh_f)
    sh_fl = torch.where(nee_go, f_hg, sh_fl)
    sh_f1, sh_f2, ra = S["sh_f1"], S["sh_f2"], S["ra"]
    if TR:
        # the surface NEE folds with the continued beta: at a diffuse
        # surface f = cos/pi and beta carries alb * s_df, so the fold is
        # (cos/pi) / s_df; a glossy fold is per channel
        sh_pdf = torch.where(nee_gs | nee_gl, SF["spdf_srf"], sh_pdf)
        sh_f = torch.where(nee_gs, SF["f_srf_nee"]
                           / torch.clamp(SB["s_df"], min=1e-30), sh_f)
        sh_fl = torch.where(nee_gs, SF["f_srf_nee"], sh_fl)
        sh_occ = sh_occ | nee_all
        if G.any_rough:
            sh_f1 = torch.where(nee_go | nee_gs, sh_f, sh_f1)
            sh_f2 = torch.where(nee_go | nee_gs, sh_f, sh_f2)
            fold = (SF["fne"] * SF["cosn"][:, None]
                    / torch.clamp(SB["wg"], min=1e-30))
            sh_f = torch.where(nee_gl, fold[:, 0], sh_f)
            sh_f1 = torch.where(nee_gl, fold[:, 1], sh_f1)
            sh_f2 = torch.where(nee_gl, fold[:, 2], sh_f2)
            sh_fl = torch.where(nee_gl, SF["cosn"], sh_fl)
        if rec is not None:
            # surface NEE records carry the material's albedo tint
            ra = _W(nee_all, _W(nee_gs, SF["alb"], one3), ra)
            if G.any_rough:
                ra = _W(nee_gl, SF["fne"], ra)
    # every armed walk starts from unit transmittance (the Pallas kernel
    # resets it for volume NEE only, so that a surface NEE there folds the
    # previous walk's: a fault the port does not copy, ROADMAP.md §C)
    sT = _W(nee_all, one3, sT)
    sl = _W(nee_all, one3, sl)
    su = _W(nee_all, one3, su)

    # ---- commit finished samples, start the next ones ---------------------
    samp = S["samp"]
    end = S["end"]
    died = ~alive & (samp < end)
    L = _W(~torch.isfinite(L).all(-1), torch.zeros_like(L), L)
    acc = _W(died, S["acc"] + L, S["acc"])
    has_budget = died & (samp + 1 < end)
    samp = torch.where(died, samp + 1, samp)
    dim = S["dim"]
    j = torch.nonzero(has_budget)[:, 0]
    if j.numel():
        o_n, d_n, hero_n = _start(K, seed, S["gpix"][j], samp[j])
        o, d = o.index_put((j,), o_n), d.index_put((j,), d_n)
        hero = hero.index_put((j,), hero_n)
        dim = dim.index_put((j,), torch.ones_like(j))
        one_j = torch.ones((j.numel(), 3), device=dev)
        b, ru, rl = (t.index_put((j,), one_j) for t in (b, ru, rl))
        L = L.index_put((j,), torch.zeros((j.numel(), 3), device=dev))
        zero_j = torch.zeros_like(j)
        depth = depth.index_put((j,), zero_j)
        med = med.index_put((j,), zero_j - 1)
        mode = mode.index_put((j,), zero_j)
        rr_srv = rr_srv.index_put((j,), torch.ones(j.numel(), device=dev))
        rslot = rslot.index_put((j,), zero_j)
        if TR:
            t_surf = t_surf.index_put((j,), torch.full(
                (j.numel(),), _BIG, device=dev))
            true_j = torch.ones_like(j, dtype=torch.bool)
            needs_i = needs_i.index_put((j,), true_j)
            sh_occ = sh_occ.index_put((j,), ~true_j)
            spec_last = spec_last.index_put((j,), ~true_j)
    alive = alive | has_budget
    S.update(alive=alive, mode=mode, o=o, d=d, b=b, ru=ru, rl=rl, L=L,
             hero=hero, depth=depth, med=med, rr_srv=rr_srv, maj_sc=maj_sc,
             vsp_c=vsp_c, t_walk=t_walk, w_sum=w_sum, tau_acc=tau_acc, wf=wf,
             wu=wu, wl=wl, wT=wT, wr=wr, c_t=c_t, c_wi=c_wi, c_ste=c_ste,
             cn=cn, cd=cd, has_c=has_c, sh=sh, sh_t=sh_t, sh_end=sh_end,
             sh_pdf=sh_pdf, sh_d2=sh_d2, sT=sT, sl=sl, su=su, sh_f=sh_f,
             sh_fl=sh_fl, rslot=rslot, samp=samp, acc=acc, dim=dim, ra=ra,
             sh_f1=sh_f1, sh_f2=sh_f2)
    if TR:
        S.update(t_surf=t_surf, hng=hng, hmat=hmat, hmi=hmi, hmo=hmo,
                 needs_i=needs_i, sh_occ=sh_occ, spec_last=spec_last)


def _plain(c, gconst, ftab, itab, spp, seed, rec_depth=None, counts=None,
           first_sample=0, items=False, pixels=None, pix_base=0):
    """The lockstep loop of the plain versions: one lane a pixel running
    samples first_sample, ..., first_sample + spp - 1 in turn, returning the
    image (and the record of a record wave), or with `pixels` (int64 pixel
    indices) the (len(pixels), 3) values of those pixels alone; with
    `items`, one lane a (pixel, sample) item in the render kernel's
    sample-major order, returning the items' raw radiances (spp, npix, 3)
    and iterations (spp, npix), cap + 1 for an item stopped at the cap.
    Either way the iteration cap is spp * max_events * 12, the whole
    pixel's. `c` may be a block of rows of the image that starts at image
    pixel `pix_base` (``block_constants``); its pixels and `itab` are the
    block's."""
    K = _Consts(c)
    K.bmin_t = torch.tensor(K.bmin, dtype=torch.float32, device=K.dev)
    K.bmax_t = torch.tensor(K.bmax, dtype=torch.float32, device=K.dev)
    K.mres_t = torch.tensor(K.mres, dtype=torch.float32, device=K.dev)
    G = _G(gconst, K.dev)
    seed = int(seed) & 0xFFFFFFFF
    spp = int(spp)
    npix = K.nx * K.ny
    if tuple(itab.shape) != (gconst.isgb_rows, npix):
        raise ValueError(f"ISGB table of shape {tuple(itab.shape)}, want "
                         f"{(gconst.isgb_rows, npix)}")
    T = (c.density.reshape(-1), c.majorant.reshape(-1), ftab, c.tris,
         c.mats)
    rec = None if rec_depth is None else _Rec(int(rec_depth), npix, K.dev)
    if items:
        lane = torch.arange(spp * npix, device=K.dev)
        S = _init_lanes(K, seed, itab, lane % npix, lane // npix, 1,
                        pix_base)
    else:
        pix = (torch.arange(npix, device=K.dev) if pixels is None
               else torch.as_tensor(pixels, dtype=torch.int64, device=K.dev))
        samp = torch.full_like(pix, int(first_sample))
        S = _init_lanes(K, seed, itab, pix, samp, spp, pix_base)
    n = S["lane"].numel()
    out = torch.zeros((n, 3), device=K.dev)
    max_iters = spp * K.max_events * 12
    n_iter = torch.full((n,), max_iters + 1, dtype=torch.int32,
                        device=K.dev)
    for it in range(max_iters):
        if S["lane"].numel() == 0:
            break
        _count(counts, "lockstep_iters", 1)
        _body(K, G, T, S, seed, rec, counts)
        done = ~S["alive"]
        if bool(done.any()):
            out.index_put_((S["lane"][done],), S["acc"][done])
            n_iter[S["lane"][done]] = it + 1
            S = _keep(S, ~done)
    # lanes still alive here stopped at the iteration cap
    _count(counts, "capped", S["lane"].numel())
    out.index_put_((S["lane"],), S["acc"])
    if items:
        return out.reshape(spp, npix, 3), n_iter.reshape(spp, npix)
    out = out * (c.imaging_ratio / spp)
    if pixels is not None:
        return out
    img = out.reshape(K.ny, K.nx, 3)
    return img if rec is None else (img, rec.buf)


def render_vspg_plain(c, gconst, ftab, itab, spp, seed, counts=None,
                      first_sample=0, pixels=None, pix_base=0):
    """Plain PyTorch version of the render variant of ``csrc/vspg.cu``:
    the (ny, nx, 3) image of `spp` frozen-field samples per pixel, one lane
    a pixel running samples `first_sample`, ..., `first_sample + spp - 1`
    in turn within one iteration cap of spp * max_events * 12; with
    `pixels` (pixel indices) the (len(pixels), 3) values of a crop. `counts` (a
    dict) gathers the work run: lane-iterations ("iters"), walk and shadow
    steps ("steps"), NDS prepass steps ("pre_steps") and ODS candidate
    draws ("draws"), scatters, walk-start field queries, the lanes stopped
    at the cap ("capped"), the walks and shadow walks that start within
    1e-4 of the box's exit ("exit_walks", "exit_shadows"), the lockstep
    iterations run, the longest lane's ("lockstep_iters"); on an adaptive
    field also the scatters whose leaf is a refined cell's child
    ("child_scatters"). With `c` a block of rows (``block_constants``)
    and `itab` the block's ISGB columns, the block's image: its pixels'
    random streams and camera rays are those of image pixels pix_base
    on."""
    return _plain(c, gconst, ftab, itab, spp, seed, None, counts,
                  first_sample, pixels=pixels, pix_base=pix_base)


def render_items_plain(c, gconst, ftab, itab, spp, seed, counts=None):
    """Plain PyTorch version of the render variant's item kernel: the raw
    radiance (spp, npix, 3) and the iterations (spp, npix) of every (pixel,
    sample) item, each a lane of its own from a fresh state with the whole
    pixel's iteration cap spp * max_events * 12 (an item at the cap gives
    zero radiance and cap + 1 iterations). Sample s of pixel p is
    ``render_vspg_plain(spp=1, first_sample=s)``'s, and
    ``reduce_samples_plain`` of the items is ``render_vspg_plain``'s
    image. `counts` as for ``render_vspg_plain``, with "capped" counting
    items."""
    return _plain(c, gconst, ftab, itab, spp, seed, None, counts,
                  items=True)


def reduce_samples_plain(L, n_iter, max_iters, out_scale, acc=None):
    """Plain PyTorch version of ``csrc/vspg.cu``'s sample reduce: per pixel
    and channel, ``acc = acc + L[s]`` in sample order from zero while the
    pixel's running total of item iterations (`n_iter`, (samples, npix))
    stays within `max_iters`, then ``acc * out_scale``; L is (samples,
    npix, 3). This is the per-pixel loop's sum: it runs a pixel's samples
    in turn within one cap of max_iters iterations and loses the sample the
    cap cuts and every later one. With `n_iter` None (the grid kernel's
    items) every sample counts, and the sum may start from `acc`, the
    unscaled sum of earlier chunks of samples. A Python loop, because
    ``torch.sum`` may reorder the adds."""
    if acc is not None and n_iter is not None:
        raise ValueError("a carried sum needs the carried iteration counts")
    acc = torch.zeros_like(L[0]) if acc is None else acc.clone()
    used = torch.zeros(L.shape[1], dtype=torch.int64, device=L.device)
    for s in range(L.shape[0]):
        if n_iter is None:
            acc = acc + L[s]
            continue
        used = used + n_iter[s].to(torch.int64)
        acc = torch.where((used <= int(max_iters))[:, None], acc + L[s], acc)
    return acc * out_scale


def train_wave_plain(c, gconst, ftab, itab, seed, rec_depth, counts=None):
    """Plain PyTorch version of the record variant of ``csrc/vspg.cu``: one
    sample per pixel; returns (image, record (REC_ROWS, rec_depth, npix)).
    `counts` as for ``render_vspg_plain``, with "capped" counting the
    pixels stopped at the iteration cap (the kernel's at-cap count)."""
    return _plain(c, gconst, ftab, itab, 1, seed, rec_depth, counts)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_inputs(c, g, ftab, itab, name):
    """Check the inputs of a launch of either variant; returns (npix,
    majorant cells, triangles, materials, adaptive)."""
    dev = c.fconst.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    if c.kind != "grid":
        raise ValueError(f"{name} got a {c.kind!r} scene")
    _check(c.fconst, torch.float32, (c.fconst.numel(),), dev, "fconst")
    _check(g.fconst, torch.float32, (N_GCONST,), dev, "gconst")
    _check(g.iconst, torch.int32, (N_GICONST,), dev, "giconst")
    res = tuple(int(v) for v in c.iconst[I_GX:I_GX + 3].tolist())
    mres = tuple(int(v) for v in c.iconst[I_MX:I_MX + 3].tolist())
    _check(c.density, torch.float32, res, dev, "density")
    _check(c.majorant, torch.float32, mres, dev, "majorant")
    gi = g.iconst.tolist()
    P = (8 * gi[GI_K] + 8) * (2 if c.n_tri else 1)
    _check(ftab, torch.float32, (P, gi[GI_NLEAF]), dev, "ftab")
    adaptive = gi[GI_NEXTRA] > 0
    if adaptive:
        _check(g.cells, torch.int32, (3, gi[GI_NCELL]), dev, "cells")
    n_tri = c.n_tri
    n_mat = 0 if c.mats is None else int(c.mats.shape[0])
    if n_tri:
        from .volpath_kernels import MAX_MATS, MAX_TRIS_GRID

        if not (n_tri <= MAX_TRIS_GRID and 1 <= n_mat <= MAX_MATS):
            raise ValueError(f"{n_tri} triangles / {n_mat} materials: the "
                             f"kernel takes 1-{MAX_TRIS_GRID} and "
                             f"1-{MAX_MATS}")
        _check(c.tris, torch.float32, (n_tri, TRI_COLS), dev, "tris")
        _check(c.mats, torch.float32, (n_mat, MAT_COLS), dev, "mats")
    npix = c.nx * c.ny
    _check(itab, torch.float32, (g.isgb_rows, npix), dev, "itab")
    nmaj = mres[0] * mres[1] * mres[2]
    from .volpath_kernels import MAX_MAJ_VOX

    if nmaj > MAX_MAJ_VOX:
        raise ValueError(f"majorant grid of {nmaj} cells exceeds "
                         f"{MAX_MAJ_VOX}")
    if gi[GI_K] > K_PACK:
        raise ValueError(f"at most {K_PACK} lobes per cell, got {gi[GI_K]}")
    return npix, nmaj, n_tri, n_mat, adaptive


def _table_ptrs(c, g, ftab, itab, adaptive):
    """The pointers of the tables both variants read, in the launchers'
    order."""
    return (c.fconst.data_ptr(), c.iconst.data_ptr(), g.fconst.data_ptr(),
            g.iconst.data_ptr(), c.density.data_ptr(), c.majorant.data_ptr(),
            ftab.data_ptr(), itab.data_ptr(),
            g.cells.data_ptr() if adaptive else 0,
            c.tris.data_ptr() if c.n_tri else 0,
            c.mats.data_ptr() if c.n_tri else 0)


def _start_events(stream):
    if LAUNCH_EVENTS is None:
        return None
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    events[0].record(stream)
    return events


def _end_events(events, name, stream):
    if events is not None:
        events[1].record(stream)
        LAUNCH_EVENTS.append((name, *events))


def _record_launch(c, g, ftab, itab, seed, rec_depth, blocks=None):
    """Launch the record variant on the current stream of the constants'
    card: the pixels as work items on `blocks` persistent blocks (None: the
    SMs times the resident blocks an SM), taken from a zeroed counter.
    Returns (image, record, pixels at the cap (a (1,) int32 tensor))."""
    from . import _build

    if blocks is not None and int(blocks) < 1:
        raise ValueError(f"blocks must be at least 1, got {blocks}")
    npix, nmaj, n_tri, n_mat, adaptive = _check_inputs(c, g, ftab, itab,
                                                       "vspg_record")
    lib = _build.load()
    dev = c.fconst.device
    name = ("vspg_record" + ("_tris" if n_tri else "")
            + ("_adaptive" if adaptive else ""))
    D = int(rec_depth)
    with torch.cuda.device(dev):
        out = torch.empty((c.ny, c.nx, 3), dtype=torch.float32, device=dev)
        rec = torch.zeros((REC_ROWS, D, npix), dtype=torch.float32,
                          device=dev)
        counter = torch.zeros(1, dtype=torch.int64, device=dev)
        at_cap = torch.zeros(1, dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev)
        events = _start_events(stream)
        err = lib.vspg_record_launch(
            *_table_ptrs(c, g, ftab, itab, adaptive), out.data_ptr(),
            rec.data_ptr(), counter.data_ptr(), at_cap.data_ptr(), npix,
            int(seed) & 0xFFFFFFFF, c.imaging_ratio, nmaj, D, int(g.ris),
            int(g.method), n_tri, n_mat, 0 if blocks is None else int(blocks),
            stream.cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                               f"{err}")
        _end_events(events, name, stream)
    LAUNCHES[name] += 1
    if RECORD_AT_CAP is not None:
        RECORD_AT_CAP.append(at_cap)
    return out, rec, at_cap


def scratch_samples(npix, spp):
    """Samples per chunk of a render: as many as SCRATCH_BYTES of per-item
    radiance and iterations hold, at least one."""
    return max(1, min(int(spp), SCRATCH_BYTES // (16 * int(npix))))


def render_grid(c, g, lib=None, variant="render"):
    """The render (or with `variant` "record" the record) instantiation's
    persistent grid on the constants' card: blocks (the SMs times the
    resident blocks an SM), per_sm, sms, and the build's registers and
    local-memory bytes a thread (``lib`` as for ``render_vspg_items``)."""
    from . import _build

    lib = _build.load() if lib is None else lib
    n_tri = c.n_tri
    n_mat = 0 if c.mats is None else int(c.mats.shape[0])
    info = (ctypes.c_int * 4)()
    entry = f"vspg_{variant}_info"
    with torch.cuda.device(c.fconst.device):
        err = getattr(lib, entry)(int(g.ris), int(g.method), n_tri,
                                  c.majorant.numel(), n_mat, info)
    if err != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {err}")
    per_sm, sms, regs, local = info
    return dict(blocks=per_sm * sms, per_sm=per_sm, sms=sms, regs=regs,
                local_bytes=local)


def reduce_samples(L, n_iter, max_iters, out_scale, out=None, used=None,
                   first=True, last=True, lib=None):
    """B3's ordered per-sample sum: `L` (samples, npix, 3) summed per pixel
    and channel in sample order onto zero (`first`) or onto the running
    sum in `out`, while the pixel's running total of item iterations
    (`n_iter` (samples, npix) int32, carried in `used` (npix, 3) int32)
    stays within `max_iters`, then times `out_scale` (`last`); returns
    `out` ((npix, 3), allocated when None). With `n_iter` None (B2a-c's
    items) every sample counts and `used` and `max_iters` are not read.
    The CUDA kernel for a CUDA tensor, the plain version (`first` and
    `last` only) for a CPU one."""
    if L.device.type == "cpu":
        if not (first and last):
            raise ValueError("the plain version sums one whole chunk")
        return reduce_samples_plain(L, n_iter, max_iters, out_scale)
    from . import _build

    S, npix = int(L.shape[0]), int(L.shape[1])
    dev = L.device
    _check(L, torch.float32, (S, npix, 3), dev, "L")
    if n_iter is not None:
        _check(n_iter, torch.int32, (S, npix), dev, "n_iter")
        if not 1 <= int(max_iters) < 2 ** 31 - 1:
            raise ValueError(f"max_iters {max_iters} out of the int32 range")
    lib = _build.load() if lib is None else lib
    with torch.cuda.device(dev):
        if out is None:
            out = torch.empty((npix, 3), dtype=torch.float32, device=dev)
        _check(out.view(npix, 3), torch.float32, (npix, 3), dev, "out")
        if n_iter is not None:
            if used is None:
                used = torch.empty((npix, 3), dtype=torch.int32, device=dev)
            _check(used.view(npix, 3), torch.int32, (npix, 3), dev, "used")
        err = lib.vspg_reduce_launch(
            L.data_ptr(), 0 if n_iter is None else n_iter.data_ptr(),
            out.data_ptr(), 0 if n_iter is None else used.data_ptr(),
            npix, S, int(max_iters), float(out_scale), int(bool(first)),
            int(bool(last)), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"vspg_reduce kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["vspg_reduce"] += 1
    return out


def render_vspg_items(c, gconst, ftab, itab, spp, seed, blocks=None,
                      lib=None, pix_base=0):
    """B3a-d: `spp` frozen-field VSPG samples per pixel; returns (image
    (ny, nx, 3), items at cap (a (1,) int32 tensor)). On a card: zero the
    item counters and the cap count, then per chunk of samples
    (``scratch_samples``) the item kernel on `blocks` persistent blocks
    (None: the SMs times the resident blocks an SM), writing each (pixel,
    sample)'s radiance and iterations to the scratch, and the ordered
    reduce; every item's iteration cap is the whole pixel's, and the
    reduce drops the samples that the per-pixel loop's cap would have cut.
    For CPU tensors the plain
    version, whose count is of pixels stopped at the cap. `lib`: the
    package's library (None) or another build of vspg.cu (chip_smoke.py
    times one). `c` may be a block of the image's rows that starts at image
    pixel `pix_base` (``block_constants``), with `itab` the block's ISGB
    columns; the block's image is then the same float for float as those
    rows of the whole image's render."""
    if int(pix_base) < 0:
        raise ValueError(f"pix_base must be at least 0, got {pix_base}")
    if c.fconst.device.type == "cpu":
        counts = {}
        img = render_vspg_plain(c, gconst, ftab, itab, spp, seed, counts,
                                pix_base=pix_base)
        return img, torch.tensor([counts["capped"]], dtype=torch.int32)
    from . import _build

    spp = int(spp)
    if spp < 1:
        raise ValueError("spp must be at least 1")
    if blocks is not None and int(blocks) < 1:
        raise ValueError(f"blocks must be at least 1, got {blocks}")
    npix, nmaj, n_tri, n_mat, adaptive = _check_inputs(
        c, gconst, ftab, itab, "vspg_render")
    lib = _build.load() if lib is None else lib
    dev = c.fconst.device
    name = ("vspg_render" + ("_tris" if n_tri else "")
            + ("_adaptive" if adaptive else ""))
    max_iters = spp * int(c.iconst[I_MAX_EVENTS]) * 12
    if max_iters + 1 >= 2 ** 31:
        raise ValueError(f"an iteration cap of {max_iters} exceeds int32")
    chunk = scratch_samples(npix, spp)
    n_chunks = -(-spp // chunk)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        events = _start_events(stream)
        counters = torch.zeros(n_chunks, dtype=torch.int64, device=dev)
        at_cap = torch.zeros(1, dtype=torch.int32, device=dev)
        lbuf = torch.empty((chunk, npix, 3), dtype=torch.float32, device=dev)
        nbuf = torch.empty((chunk, npix), dtype=torch.int32, device=dev)
        out = torch.empty((c.ny, c.nx, 3), dtype=torch.float32, device=dev)
        used = torch.empty((npix, 3), dtype=torch.int32, device=dev)
        tables = _table_ptrs(c, gconst, ftab, itab, adaptive)
        for k in range(n_chunks):
            s0 = k * chunk
            n = min(chunk, spp - s0)
            err = lib.vspg_render_launch(
                *tables, lbuf.data_ptr(), nbuf.data_ptr(),
                counters[k:].data_ptr(),
                at_cap.data_ptr(), npix, int(pix_base), spp, s0, n,
                int(seed) & 0xFFFFFFFF, nmaj, int(gconst.ris),
                int(gconst.method), n_tri, n_mat,
                0 if blocks is None else int(blocks), stream.cuda_stream)
            if err != 0:
                raise RuntimeError(f"{name} kernel launch failed: CUDA "
                                   f"error {err}")
            LAUNCHES[name] += 1
            reduce_samples(lbuf[:n], nbuf[:n], max_iters,
                           c.imaging_ratio / spp, out, used, k == 0,
                           k == n_chunks - 1, lib)
        _end_events(events, name, stream)
    if AT_CAP is not None:
        AT_CAP.append(at_cap)
    return out, at_cap


def render_vspg_kernel(c, gconst, ftab, itab, spp, seed, pix_base=0):
    """B3a-d: `spp` frozen-field VSPG samples per pixel, (ny, nx, 3): the
    image of ``render_vspg_items`` (the CUDA kernels on a card, the plain
    version for tensors on the CPU)."""
    return render_vspg_items(c, gconst, ftab, itab, spp, seed,
                             pix_base=pix_base)[0]


def block_constants(c, rows, n_blocks):
    """The constants of row block `rows` of `n_blocks` equal blocks of the
    image of `c`: the block's height as ny, nx unchanged (the raster decode
    of an image pixel), and the block's first image pixel. Returns (block
    constants, pix_base)."""
    if c.ny % n_blocks:
        raise ValueError(f"{c.ny} rows do not split into {n_blocks} blocks")
    ny_b = c.ny // n_blocks
    ic = c.iconst.clone()
    ic[I_NY] = ny_b
    return (dataclasses.replace(c, ny=ny_b, iconst=ic),
            int(rows) * ny_b * c.nx)


def train_wave_items(c, gconst, ftab, itab, seed, rec_depth, blocks=None):
    """B4a-d: one training sample per pixel; (image, record (REC_ROWS,
    rec_depth, npix), pixels at the cap (a (1,) int32 tensor)). On a card
    the pixels run as work items on `blocks` persistent blocks (None: the
    SMs times the resident blocks an SM); for CPU tensors the plain
    version."""
    if int(rec_depth) < 1:
        raise ValueError("rec_depth must be at least 1")
    if c.fconst.device.type == "cpu":
        counts = {}
        img, rec = train_wave_plain(c, gconst, ftab, itab, seed, rec_depth,
                                    counts)
        return img, rec, torch.tensor([counts["capped"]], dtype=torch.int32)
    return _record_launch(c, gconst, ftab, itab, seed, rec_depth, blocks)


def train_wave_kernel(c, gconst, ftab, itab, seed, rec_depth):
    """B4a-d: one training sample per pixel; (image, record (REC_ROWS,
    rec_depth, npix)): ``train_wave_items``'s (the CUDA kernel on a card,
    the plain version for tensors on the CPU)."""
    return train_wave_items(c, gconst, ftab, itab, seed, rec_depth)[:2]


# ---------------------------------------------------------------------------
# Drivers: one training wave, one frozen render
# ---------------------------------------------------------------------------


def kernel_inputs(scene, camera, film, cfg, gopt, vopt, field, isgb,
                  tr_buffer=None):
    """(constants, guiding constants, field table, ISGB table) of a render
    through the VSPG kernel, on the film's device. Under NDS+ the ISGB
    table carries `tr_buffer` ((npix, 3); all ones when None) as rows
    3-5."""
    if not supports(scene, camera, film, cfg, gopt, vopt, field):
        raise NotImplementedError(
            "scene outside the VSPG kernel's class (ROADMAP.md §B: the XLA "
            "wave serves the others)")
    c = extract_constants(scene, camera, film, cfg)
    dev = c.fconst.device
    gc = guiding_constants(field, gopt, vopt)
    g = pack_guiding_constants(c, gc, dev, pack_cell_table(field))
    ftab = torch.as_tensor(pack_field_table(field, vopt.vsp_criterion,
                                            with_surface=c.n_tri > 0),
                           device=dev)
    npix = c.nx * c.ny
    if g.isgb_rows == 6 and tr_buffer is None:
        tr_buffer = torch.ones((npix, 3), device=dev)
    return c, g, ftab, pack_isgb_table(
        isgb, npix, tr_buffer if g.isgb_rows == 6 else None)


def records_to_segments(rec):
    """The record rows (REC_ROWS, D, npix) of a training wave as a
    SegmentRecord of npix lanes and D slots, plus the ISGB first-event
    data (first_albedo, first_normal, first_vol). Edge distances come from
    consecutive vertex positions; unset ones fall to propagate()'s 1e6."""
    def rows(a, b):
        return rec[a:b].permute(2, 1, 0)  # (npix, D, b - a)

    pos, wi = rows(0, 3), rows(3, 6)
    sw = torch.stack([rec[6], rec[22], rec[23]], -1).transpose(0, 1)
    pdf = rec[7].T
    valid = pdf > 0
    is_vol = (rec[18].T > 0.5) & valid
    nxt = torch.cat([valid[:, 1:], torch.zeros_like(valid[:, :1])], 1)
    dpos = torch.cat([pos[:, 1:] - pos[:, :-1], torch.zeros_like(pos[:, :1])],
                     1)
    dist = torch.where(nxt, torch.sqrt(torch.clamp(
        torch.sum(dpos * dpos, -1), min=0.0)), 0.0)
    seg = SegmentRecord(pos=pos, wi=wi, scatter_w=sw, direct=rows(8, 11),
                        emission=rows(11, 14), pdf=pdf, distance=dist,
                        is_volume=is_vol, valid=valid,
                        count=torch.sum(valid, 1).to(torch.int32))
    return (seg, rec[19:22, 0].T, rec[15:18, 0].T, rec[14, 0] > 0.5)


def train_wave(scene, camera, film, cfg, gopt, vopt, field, isgb, seed):
    """One 1-spp training wave through the record variant; returns (image,
    SegmentRecord, first_albedo, first_normal, first_vol, L_raw), as
    ``pallas_vspg.train_wave_pallas`` (under NDS+ the kernel reads a
    TrBuffer of ones, as there)."""
    c, g, ftab, itab = kernel_inputs(scene, camera, film, cfg, gopt, vopt,
                                     field, isgb)
    img, rec = train_wave_kernel(c, g, ftab, itab, seed,
                                 int(gopt.record_depth))
    seg, f_alb, f_nrm, f_vol = records_to_segments(rec)
    # the film image back to raw per-lane radiance for the ISGB stream
    L_raw = img.reshape(-1, 3) / c.imaging_ratio
    return img, seg, f_alb, f_nrm, f_vol, L_raw


def render_frozen(scene, camera, film, spp, cfg, gopt, vopt, field, isgb,
                  seed, tr_buffer=None):
    """`spp` frozen-field samples per pixel through the render variant,
    all in one launch; the (ny, nx, 3) mean image. `tr_buffer` is the NDS+
    TrBuffer ((npix, 3); ones when None)."""
    c, g, ftab, itab = kernel_inputs(scene, camera, film, cfg, gopt, vopt,
                                     field, isgb, tr_buffer)
    return render_vspg_kernel(c, g, ftab, itab, spp, seed)


# ---------------------------------------------------------------------------
# The bench's pyroclastic cloud, built without JAX
# ---------------------------------------------------------------------------


def pyro64_density(n=64):
    """The 64^3 pyroclastic density of ``bench.py`` _pyro_cloud_scene
    (fbm-displaced sphere), numpy float32. The bench's NanoVDB round trip
    is lossless and skipped."""
    rng_np = np.random.default_rng(7)
    fbm = np.zeros((n, n, n), np.float32)
    for gsz, amp in ((4, 1.0), (8, 0.5), (16, 0.25), (32, 0.125)):
        gr = rng_np.standard_normal((gsz,) * 3).astype(np.float32)
        idx = np.linspace(0, gsz - 1, n)
        i0 = np.floor(idx).astype(int)
        w = (idx - i0).astype(np.float32)
        i1 = np.minimum(i0 + 1, gsz - 1)
        gx = gr[i0] * (1 - w)[:, None, None] + gr[i1] * w[:, None, None]
        gxy = (gx[:, i0] * (1 - w)[None, :, None]
               + gx[:, i1] * w[None, :, None])
        fbm += amp * (gxy[:, :, i0] * (1 - w)[None, None, :]
                      + gxy[:, :, i1] * w[None, None, :])
    x = np.linspace(-1, 1, n, dtype=np.float32)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    r = np.sqrt(X * X + Y * Y + Z * Z)
    dens = np.clip((0.72 - r) * 3.0 + 0.9 * fbm, 0.0, 1.2) * 8.0
    return dens.astype(np.float32)


def make_pyro64_scene(*, device="cuda"):
    """The bench's backlit pyroclastic cloud: 64^3 density, 8^3 majorants,
    sigma_a 0.004, sigma_s 0.8, g 0.85, a point light behind the cloud at
    (0, 0.4, 2.6) with intensity 60 and a dim environment."""
    from ..models.integrators.volpath import Scene
    from ..models.lights import Lights
    from ..models.materials import Materials
    from ..models.media import GridMedium, Media
    from ..models.shapes import Geometry

    gm = GridMedium.make(pyro64_density(), [0.004] * 3, [0.8] * 3,
                         (-1, -1, -1), (1, 1, 1), g=0.85, maj_res=8,
                         device=device)
    lights = Lights.make(point_p=[(0.0, 0.4, 2.6)], point_I=[(60.0,) * 3],
                         env_L=[0.03, 0.035, 0.04], world_radius=100.0,
                         device=device)
    geom = Geometry.build(boxes=[dict(bmin=(-1, -1, -1), bmax=(1, 1, 1),
                                      mat=-1, light=-1, med_in=0,
                                      med_out=-1)], device=device)
    return Scene(geom, Materials.build([], device=device),
                 Media.make(grids=(gm,), device=device), lights)
