"""Counterpart of ``ops/pallas_vspg.py``: the VSPG kernel of the guided
render path, its host-side tables, its plain PyTorch versions and the
support predicate that decides when ``render_vspg`` may use it.

One kernel, ``csrc/vspg.cu``, replaces ``pallas_vspg._make_vspg_kernel``
for the grid-cloud class without triangles, on a uniform guiding field,
with each of the three distance routes: resampling (B3a/B4a in
ROADMAP.md), NDS and NDS+ (B3b/B4b). It has two variants: the render
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
iteration in the same order, and the same iteration cap. So the plain
versions here, and through them the kernel, agree per pixel with the
Pallas kernel run in interpret mode wherever bf16 rounds nothing. What the
Pallas kernel does only for the TPU is not carried over: bf16 packing of
density, majorant and field table, one-hot MXU gathers, chunk sweeps, the
stochastic one-corner trilerp, the tiled lane map and spp chunking. The
density is float32 with the exact eight-corner trilerp; the field table is
float32 and unpacked.

A wrapper runs the plain version only when its tensors lie on the CPU; on
a CUDA tensor it launches its kernel or raises. ``LAUNCHES`` counts the
kernel launches; while ``LAUNCH_EVENTS`` is a list, each launch appends
(name, start, end) CUDA events around itself, so that a caller can take
the kernels' share of a whole render (chip_smoke.py does).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models.guiding.isgb import isgb_contribution, isgb_primary_vsp
from ..models.guiding.recording import SegmentRecord
from ..utils import rng
from ..utils.math import INV_4PI
from .volpath_kernels import (F_BMAX, F_BMIN, F_SA, F_SS, I_GX, I_MX, _BIG,
                              _box_hit, _camera_ray,
                              _check, _Consts, _count, _dot, _hg_value, _keep,
                              _normalize, _sample_hg, extract_constants)

LAUNCHES = {"vspg_render": 0, "vspg_record": 0}
LAUNCH_EVENTS = None

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
 G_LOG_2PI) = range(18, 32)
N_GCONST = 32
# int32 guiding constant table
(GI_FRES, GI_K, GI_NCELL, GI_RIS, GI_GUIDE_RR, GI_MIN_RR_DEPTH,
 GI_GUIDE_PRIMARY, GI_GUIDE_SECONDARY, GI_VOL_GUIDING, GI_APPLY_HG,
 GI_SIGMA_GRAY, GI_METHOD) = range(12)
N_GICONST = 12
# GI_METHOD values: the distance route of guided walks
METHODS = ("resampling", "nds", "nds+")


# ---------------------------------------------------------------------------
# Host side: guiding constants, tables, support predicate
# ---------------------------------------------------------------------------


def guiding_constants(field, gopt, vopt):
    """The guiding configuration the kernel is built for, as a dict (the
    keys of ``pallas_vspg.guiding_constants`` but its TPU fetch switch and
    the surface half's ``surface_guiding``: no triangles here)."""
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

    @property
    def isgb_rows(self):
        """Rows of the ISGB table: 6 under NDS+ (the TrBuffer), else 3."""
        return 6 if METHODS[self.method] == "nds+" else 3


def pack_guiding_constants(c, gc, device):
    """GuidingConstants of guiding dict `gc` for the scene constants `c`
    (a grid-class ``KernelConstants``). Constants the Pallas kernel folds
    at trace time in double are folded here in double too."""
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
    return GuidingConstants(
        torch.as_tensor(f.astype(np.float32), device=device),
        torch.as_tensor(i, device=device), ris, method)


def _grid_g(c):
    """The HG g of a grid-class KernelConstants, recovered from its folded
    2g constant (exact: 2g is a power-of-two scaling)."""
    from .volpath_kernels import F_HG_C2

    return float(c.fconst[F_HG_C2]) / 2.0


def pack_field_table(field, criterion="variance"):
    """The volume half of `field` as a float32 (P, C) numpy table over its
    C = res^3 cells, P = 8K + 8 with K = min(n_lobes, K_PACK): per lobe [w,
    mux, muy, muz, kappa, mean_dist, vsp_lobe_vol, vsp_lobe_surf], then
    [valid, vsp, flux_r, flux_g, flux_b, cx, cy, cz], vsp with the criterion
    applied (``pallas_vspg.pack_field_table(k_top=K_PACK)`` before its bf16
    rounding)."""
    return np.stack(_pack_half_rows(field, field.volume, criterion),
                    0).astype(np.float32)


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
    res = int(field.res)
    ii = np.arange(C)
    gi = np.stack([ii // (res * res), (ii // res) % res, ii % res],
                  -1).astype(np.float32)
    b0, b1 = a(field.b_min), a(field.b_max)
    centers = b0 + (gi + 0.5) / res * (b1 - b0)
    rows = []
    for k in range(K):
        rows += [w[:, k], mu[:, k, 0], mu[:, k, 1], mu[:, k, 2], kap[:, k],
                 dist[:, k], vlv[:, k], vls[:, k]]
    rows += [valid, vsp.astype(np.float32), flux[:, 0], flux[:, 1],
             flux[:, 2], centers[:, 0], centers[:, 1], centers[:, 2]]
    return rows


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
    grid, no triangles), a uniform field and any of the three distance
    routes."""
    c = extract_constants(scene, camera, film, cfg)
    if c is None or c.kind != "grid":
        return False
    if field is not None and int(getattr(field, "n_extra", 0)) != 0:
        return False
    if int(getattr(gopt, "adaptive_extra", 0)) != 0:
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
         gp, gs, vg, ahg, gray, method) = il
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


def _product_hg(K, G, lob, d):
    """Every lobe times the HG lobe's vMF about d (static kappa)."""
    if not G.apply_hg:
        return lob
    mb = d * G.hg_sign
    kb = G.kappa_h
    tot_old = torch.zeros_like(d[:, 0])
    tot_new = torch.zeros_like(d[:, 0])
    out = {"w": [], "mu": [], "kappa": []}
    for k in range(len(lob["w"])):
        kap, mu, w = lob["kappa"][k], lob["mu"][k], lob["w"][k]
        kmu = kap[:, None] * mu + kb * mb
        k_new = torch.sqrt(torch.clamp(
            kmu[:, 0] * kmu[:, 0] + kmu[:, 1] * kmu[:, 1]
            + kmu[:, 2] * kmu[:, 2], min=1e-12))
        inv = 1.0 / torch.clamp(k_new, min=1e-8)
        log_s = (_log_c(G, kap) + G.log_c_h - _log_c(G, k_new)
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


def _field_query(G, ftab, p):
    """The lobes (parallax re-aimed, mu renormalized), valid, vsp and flux
    of the field cell at p."""
    gf = torch.clamp((p - G.fb0) / G.fext * G.fres, 0.0, G.fres_hi)
    ix = gf.to(torch.int64)
    cid = (ix[:, 0] * G.fres + ix[:, 1]) * G.fres + ix[:, 2]
    v = ftab[:, cid]  # (P, N)
    K = G.K
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


def _init_lanes(K, seed, itab):
    npix = K.nx * K.ny
    dev = K.dev
    pix = torch.arange(npix, device=dev)
    o, d, hero = _start(K, seed, pix, torch.zeros_like(pix))

    def z():
        return torch.zeros(npix, device=dev)

    def o1():
        return torch.ones(npix, device=dev)

    def z3():
        return torch.zeros((npix, 3), device=dev)

    def o3():
        return torch.ones((npix, 3), device=dev)

    zi = torch.zeros(npix, dtype=torch.int64, device=dev)
    return dict(
        pix=pix, samp=zi.clone(), dim=zi + 1,
        alive=torch.ones(npix, dtype=torch.bool, device=dev), o=o, d=d,
        b=o3(), ru=o3(), rl=o3(), L=z3(), depth=zi.clone(), hero=hero,
        med=zi - 1, acc=z3(), mode=zi.clone(), t_walk=z(), wf=o3(),
        wu=o3(), wl=o3(), wT=o3(), wr=o3(), w_sum=z(), c_t=z(), c_wi=z(),
        c_ste=z(), cn=o3(), cd=o3(),
        has_c=torch.zeros(npix, dtype=torch.bool, device=dev), maj_sc=o1(),
        tau_acc=z(), vsp_c=z(), sh=z3(), sh_t=z(), sh_end=z(), sh_pdf=z(),
        sh_d2=o1(), sT=o3(), sl=o3(), su=o3(), sh_f=z(), rr_srv=o1(),
        sh_fl=z(), rslot=zi.clone(), ivsp=itab[0].clone(),
        ipel=itab[1].clone(), ipem=itab[2].clone(),
        itr=itab[3:6].T.clone() if itab.shape[0] == 6 else o3())


def _body(K, G, T, S, seed, spp, rec, counts):
    """One iteration of ``pallas_vspg._make_vspg_kernel``'s loop body for
    every lane of S (resampling route, no triangles), updating S in place.
    The eight draws per iteration: deferred RR, walk step, walk event,
    reservoir conclusion, majorant probe, NEE, direction (two). `counts`
    gathers the lane-iterations, walk/shadow steps, scatters and
    walk-start field queries run."""
    dev = K.dev
    dens, maj, ftab = T
    st, ss, envL, lI = K.st, K.ss, K.envL, K.lI

    def U():
        u = rng.uniform4(seed, S["pix"], S["samp"], S["dim"])
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

    # stuck-lane guard, then transport lanes enter the box or escape
    oob = ((o < K.bmin_t) | (o > K.bmax_t)).any(-1)
    med = torch.where((med == 0) & oob & (mode == 0), -1, med)
    hit, t_wall, entering = _box_hit(o, d, K.bmin, K.bmax)
    outside = alive & (mode == 0) & (med != 0)
    escaped = outside & ~hit
    if K.has_env:
        first = depth == 0
        ru_avg = torch.clamp(_avg3(ru), min=1e-30)
        L = _W(escaped & first, L + b * envL / ru_avg[:, None], L)
        den = torch.clamp(_avg3(ru + rl * K.penv), min=1e-30)
        L = _W(escaped & ~first, L + b * envL / den[:, None], L)
        if rec is not None:
            w_mis = torch.where(first, 1.0, ru_avg / den)
            rec.put((11, 12, 13), rslot - 1, escaped,
                    envL * w_mis[:, None], pix)
    alive = alive & ~escaped
    enter = alive & outside & hit & entering
    med = torch.where(enter, 0, med)
    o = _W(enter, o + (t_wall + 1e-4)[:, None] * d, o)
    stuck = alive & outside & hit & ~entering
    alive = alive & ~stuck
    in_med = alive & (mode == 0) & (med == 0) & ~enter
    wall = torch.where(hit, t_wall, _BIG)
    plim = wall
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
    if K.has_point:
        okp = s_dead & (mode == 4)
        denom = torch.clamp(_avg3(sl * ru * K.pmf), min=1e-30)
        w = sh_f / (sh_d2 * denom)
        L = _W(okp, L + b * sT * lI * w[:, None], L)
        if rec is not None:
            den_lp = torch.clamp(_avg3(sl * K.pmf), min=1e-30)
            wl_ = sh_fl / (sh_d2 * den_lp)
            rec.put((8, 9, 10), rslot - 1, okp, sT * lI * wl_[:, None], pix)
    if K.has_env:
        oke = s_dead & (mode == 5)
        p_l = K.penv
        denom = torch.clamp(_avg3(sl * ru * p_l + su * ru * sh_pdf[:, None]),
                            min=1e-30)
        w = sh_f / denom
        L = _W(oke, L + b * sT * envL * w[:, None], L)
        if rec is not None:
            den_le = torch.clamp(_avg3(sl * p_l + su * sh_pdf[:, None]),
                                 min=1e-30)
            wl_ = sh_fl / den_le
            rec.put((8, 9, 10), rslot - 1, oke, sT * envL * wl_[:, None],
                    pix, add=True)
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
    med = torch.where(passed, -1, med)
    mode = torch.where(passed | term_w | scat_w, 0, mode)
    o = _W(passed, o + (wall + 1e-4)[:, None] * d, o)

    # ---- field query: walk starts (secondary VSP) and scatter vertices ---
    s = o + t_sc[:, None] * d
    if counts is not None:
        _count(counts, "scatters", scat.sum())
        if G.guide_secondary:
            _count(counts, "queries", (in_med & (depth != 0)).sum())
    q = _W(scat, s, o)
    lob, valid_q, vsp_cell_q, flux_q = _field_query(G, ftab, q)
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
    pl = s - K.lp
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
    _, t_exit_s, _ = _box_hit(s, wi, K.bmin, K.bmax)
    t_med = torch.where(sel_pt, torch.minimum(dist, t_exit_s), t_exit_s)
    nee_act = scat & (f_hg > 0)

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

    if rec is not None:
        ones = torch.ones_like(scale_v)
        rec.put((0, 1, 2), rslot, scat, s, pix)
        rec.put((3, 4, 5), rslot, scat, wv, pix)
        rec.put((6, 22, 23, 7, 18), rslot, scat,
                torch.stack([scale_v, scale_v, scale_v, pdf_v, ones], -1),
                pix)
        f1 = scat & (depth == 1)
        zs = torch.zeros_like(rslot)
        rec.put((14, 15, 16, 17, 19, 20, 21), zs, f1, torch.cat(
            [ones[:, None], wo, ones[:, None] * G.alb], -1), pix)
        rslot = torch.where(scat, rslot + 1, rslot)

    # ---- arm the shadow walk of the pending NEE ---------------------------
    nee_go = nee_act & alive
    mode = torch.where(nee_go, torch.where(sel_pt, 4, 5), mode)
    sh = _W(nee_go, wi, sh)
    sh_t = torch.where(nee_go, 0.0, sh_t)
    sh_end = torch.where(nee_go, t_med, sh_end)
    sh_pdf = torch.where(nee_go, spdf_l, sh_pdf)
    sh_d2 = torch.where(nee_go, dist2, sh_d2)
    sh_f = torch.where(nee_go, f_hg / torch.clamp(scale_v, min=1e-30), sh_f)
    sh_fl = torch.where(nee_go, f_hg, sh_fl)
    sT = _W(nee_go, one3, sT)
    sl = _W(nee_go, one3, sl)
    su = _W(nee_go, one3, su)

    # ---- commit finished samples, start the next ones ---------------------
    samp = S["samp"]
    died = ~alive & (samp < spp)
    L = _W(~torch.isfinite(L).all(-1), torch.zeros_like(L), L)
    acc = _W(died, S["acc"] + L, S["acc"])
    has_budget = died & (samp + 1 < spp)
    samp = torch.where(died, samp + 1, samp)
    dim = S["dim"]
    j = torch.nonzero(has_budget)[:, 0]
    if j.numel():
        o_n, d_n, hero_n = _start(K, seed, pix[j], samp[j])
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
    alive = alive | has_budget
    S.update(alive=alive, mode=mode, o=o, d=d, b=b, ru=ru, rl=rl, L=L,
             hero=hero, depth=depth, med=med, rr_srv=rr_srv, maj_sc=maj_sc,
             vsp_c=vsp_c, t_walk=t_walk, w_sum=w_sum, tau_acc=tau_acc, wf=wf,
             wu=wu, wl=wl, wT=wT, wr=wr, c_t=c_t, c_wi=c_wi, c_ste=c_ste,
             cn=cn, cd=cd, has_c=has_c, sh=sh, sh_t=sh_t, sh_end=sh_end,
             sh_pdf=sh_pdf, sh_d2=sh_d2, sT=sT, sl=sl, su=su, sh_f=sh_f,
             sh_fl=sh_fl, rslot=rslot, samp=samp, acc=acc, dim=dim)


def _plain(c, gconst, ftab, itab, spp, seed, rec_depth=None, counts=None):
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
    T = (c.density.reshape(-1), c.majorant.reshape(-1), ftab)
    rec = None if rec_depth is None else _Rec(int(rec_depth), npix, K.dev)
    S = _init_lanes(K, seed, itab)
    out = torch.zeros((npix, 3), device=K.dev)
    max_iters = spp * K.max_events * 12
    for _ in range(max_iters):
        if S["pix"].numel() == 0:
            break
        _body(K, G, T, S, seed, spp, rec, counts)
        done = ~S["alive"]
        if bool(done.any()):
            out.index_put_((S["pix"][done],), S["acc"][done])
            S = _keep(S, ~done)
    out.index_put_((S["pix"],), S["acc"])
    img = (out * (c.imaging_ratio / spp)).reshape(K.ny, K.nx, 3)
    return img if rec is None else (img, rec.buf)


def render_vspg_plain(c, gconst, ftab, itab, spp, seed, counts=None):
    """Plain PyTorch version of the render variant of ``csrc/vspg.cu``:
    the (ny, nx, 3) image of `spp` frozen-field samples per pixel.
    `counts` (a dict) gathers the work run: lane-iterations ("iters"),
    walk and shadow steps ("steps"), NDS prepass steps ("pre_steps") and
    ODS candidate draws ("draws"), scatters, walk-start field queries."""
    return _plain(c, gconst, ftab, itab, spp, seed, None, counts)


def train_wave_plain(c, gconst, ftab, itab, seed, rec_depth, counts=None):
    """Plain PyTorch version of the record variant of ``csrc/vspg.cu``: one
    sample per pixel; returns (image, record (REC_ROWS, rec_depth, npix)).
    `counts` as for ``render_vspg_plain``."""
    return _plain(c, gconst, ftab, itab, 1, seed, rec_depth, counts)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _launch(c, g, ftab, itab, spp, seed, rec_depth, lib=None):
    """Launch the render (rec_depth None) or record variant on the current
    stream of the constants' card, from `lib` (default: the package's
    library; chip_smoke.py passes a build with other flags to time it)."""
    from . import _build

    dev = c.fconst.device
    name = "vspg_render" if rec_depth is None else "vspg_record"
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    if c.kind != "grid":
        raise ValueError(f"{name} got a {c.kind!r} scene")
    if int(spp) < 1:
        raise ValueError("spp must be at least 1")
    _check(c.fconst, torch.float32, (c.fconst.numel(),), dev, "fconst")
    _check(g.fconst, torch.float32, (N_GCONST,), dev, "gconst")
    _check(g.iconst, torch.int32, (N_GICONST,), dev, "giconst")
    res = tuple(int(v) for v in c.iconst[I_GX:I_GX + 3].tolist())
    mres = tuple(int(v) for v in c.iconst[I_MX:I_MX + 3].tolist())
    _check(c.density, torch.float32, res, dev, "density")
    _check(c.majorant, torch.float32, mres, dev, "majorant")
    gi = g.iconst.tolist()
    P = 8 * gi[GI_K] + 8
    _check(ftab, torch.float32, (P, gi[GI_NCELL]), dev, "ftab")
    npix = c.nx * c.ny
    _check(itab, torch.float32, (g.isgb_rows, npix), dev, "itab")
    nmaj = mres[0] * mres[1] * mres[2]
    from .volpath_kernels import MAX_MAJ_VOX

    if nmaj > MAX_MAJ_VOX:
        raise ValueError(f"majorant grid of {nmaj} cells exceeds "
                         f"{MAX_MAJ_VOX}")
    if gi[GI_K] > K_PACK:
        raise ValueError(f"at most {K_PACK} lobes per cell, got {gi[GI_K]}")
    lib = _build.load() if lib is None else lib
    with torch.cuda.device(dev):
        out = torch.empty((c.ny, c.nx, 3), dtype=torch.float32, device=dev)
        D = 0 if rec_depth is None else int(rec_depth)
        rec = (torch.zeros((REC_ROWS, D, npix), dtype=torch.float32,
                           device=dev) if D else None)
        stream = torch.cuda.current_stream(dev)
        events = None
        if LAUNCH_EVENTS is not None:
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            events[0].record(stream)
        fn = getattr(lib, f"{name}_launch")
        err = fn(c.fconst.data_ptr(), c.iconst.data_ptr(),
                 g.fconst.data_ptr(), g.iconst.data_ptr(),
                 c.density.data_ptr(), c.majorant.data_ptr(),
                 ftab.data_ptr(), itab.data_ptr(), out.data_ptr(),
                 0 if rec is None else rec.data_ptr(), npix, int(spp),
                 int(seed) & 0xFFFFFFFF, c.imaging_ratio / int(spp), nmaj, D,
                 int(g.ris), int(g.method), stream.cuda_stream)
        if events is not None:
            events[1].record(stream)
            LAUNCH_EVENTS.append((name, *events))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    return out if rec is None else (out, rec)


def render_vspg_kernel(c, gconst, ftab, itab, spp, seed):
    """B3a/B3b: `spp` frozen-field VSPG samples per pixel, (ny, nx, 3);
    the CUDA kernel on a card, the plain version for tensors on the CPU."""
    if c.fconst.device.type == "cpu":
        return render_vspg_plain(c, gconst, ftab, itab, spp, seed)
    return _launch(c, gconst, ftab, itab, spp, seed, None)


def train_wave_kernel(c, gconst, ftab, itab, seed, rec_depth):
    """B4a/B4b: one training sample per pixel; (image, record (REC_ROWS,
    rec_depth, npix)). The CUDA kernel on a card, the plain version for
    tensors on the CPU."""
    if c.fconst.device.type == "cpu":
        return train_wave_plain(c, gconst, ftab, itab, seed, rec_depth)
    if int(rec_depth) < 1:
        raise ValueError("rec_depth must be at least 1")
    return _launch(c, gconst, ftab, itab, 1, seed, int(rec_depth))


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
    g = pack_guiding_constants(c, gc, dev)
    ftab = torch.as_tensor(pack_field_table(field, vopt.vsp_criterion),
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
