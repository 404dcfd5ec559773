"""Spatial-directional guiding field (counterpart of
``models/guiding/field.py``): a uniform res^3 voxel grid over the scene
bounds whose cells hold a surface and a volume half, each a K-lobe vMF
mixture trained by incremental weighted EM, parallax distances, VSP
statistics (contribution and variance criteria) and a flux cache.

Only the uniform grid is ported. The adaptive two-level field
(``n_extra > 0``, ``refine_field``) and ``save_field``/``load_field``
are queued in ROADMAP.md §A item 6.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple

import numpy as np
import torch

from ...utils.device import OnDevice
from ...utils.math import INV_4PI
from ...utils.vecmath import normalize
from . import vmf


@dataclass(frozen=True)
class FieldHalf(OnDevice):
    """One half (surface or volume) of the guiding field, over C cells."""

    weights: torch.Tensor  # (C,K)
    mu: torch.Tensor  # (C,K,3)
    kappa: torch.Tensor  # (C,K)
    stats_w: torch.Tensor  # (C,K) EM sufficient statistics
    stats_s: torch.Tensor  # (C,K,3)
    stats_dist: torch.Tensor  # (C,K) weighted distance sums (parallax)
    vsp_c_vol: torch.Tensor  # (C,) volume-scatter contribution sums
    vsp_c_surf: torch.Tensor  # (C,) surface contribution sums
    vsp_c2_vol: torch.Tensor  # (C,) second moments
    vsp_c2_surf: torch.Tensor  # (C,)
    vsp_n: torch.Tensor  # (C,) sample counts
    flux: torch.Tensor  # (C,3) RGB fluence accumulator
    flux_w: torch.Tensor  # (C,)
    vsp_lobe_vol: torch.Tensor  # (C,K) directional VSP moments
    vsp_lobe_surf: torch.Tensor  # (C,K)


@dataclass(frozen=True)
class GuidingField(OnDevice):
    b_min: torch.Tensor  # (3,)
    b_max: torch.Tensor  # (3,)
    surface: FieldHalf
    volume: FieldHalf
    iteration: int  # training iterations done
    res: int  # cells per axis
    n_lobes: int
    n_extra: int = 0  # adaptive leaves: always 0 here

    @staticmethod
    def make(b_min, b_max, res=16, n_lobes=8, n_extra=0, *, device="cuda"):
        """A fresh field: every cell holds K fibonacci-spiral lobes of equal
        weight and kappa 1."""
        if n_extra:
            raise NotImplementedError(
                "the adaptive guiding field (n_extra > 0) is not ported yet "
                "(ROADMAP.md §B: the adaptive field)")
        C = res ** 3
        K = n_lobes
        i = np.arange(K)
        golden = (1 + 5 ** 0.5) / 2
        z = 1 - 2 * (i + 0.5) / K
        r = np.sqrt(np.maximum(0, 1 - z * z))
        phi = 2 * np.pi * i / golden
        dirs = np.stack([r * np.cos(phi), r * np.sin(phi), z],
                        -1).astype(np.float32)

        def f(shape, v=0.0):
            return torch.full(shape, v, dtype=torch.float32, device=device)

        def half():
            return FieldHalf(
                f((C, K), 1.0 / K),
                torch.as_tensor(np.tile(dirs[None], (C, 1, 1)),
                                device=device),
                f((C, K), 1.0), f((C, K)), f((C, K, 3)), f((C, K)), f((C,)),
                f((C,)), f((C,)), f((C,)), f((C,)), f((C, 3)), f((C,)),
                f((C, K)), f((C, K)))

        def vec(v):
            return torch.as_tensor(np.asarray(v, np.float32), device=device)

        return GuidingField(vec(b_min), vec(b_max), half(), half(), 0,
                            int(res), int(n_lobes))

    def cell_id(self, p):
        """(..., 3) world position -> flat cell index (...)."""
        g = (p - self.b_min) / (self.b_max - self.b_min)
        i = torch.clamp(g * self.res, 0.0, self.res - 1e-4).to(torch.int64)
        return (i[..., 0] * self.res + i[..., 1]) * self.res + i[..., 2]

    @property
    def trained(self):
        """Usable once at least one training iteration ran."""
        return self.iteration > 0


class CellDistribution(NamedTuple):
    """Per-lane directional distribution gathered from the field."""

    weights: torch.Tensor  # (R,K)
    mu: torch.Tensor  # (R,K,3)
    kappa: torch.Tensor  # (R,K)
    valid: torch.Tensor  # (R,) the cell holds enough data
    cell: torch.Tensor  # (R,) cell id
    vsp: torch.Tensor  # (R,) cell volume-scatter-probability estimate
    flux: torch.Tensor  # (R,3) cell mean radiance
    vsp_lobe_vol: torch.Tensor = None  # (R,K)
    vsp_lobe_surf: torch.Tensor = None  # (R,K)


def _cell_center(field: GuidingField, cid):
    res = field.res
    idx = torch.stack([cid // (res * res), (cid // res) % res, cid % res],
                      -1).to(torch.float32) + 0.5
    return field.b_min + idx / res * (field.b_max - field.b_min)


def _gather_half(field: GuidingField, half: FieldHalf, p, vsp_variance=True):
    cid = field.cell_id(p)
    w = half.weights[cid]
    mu = half.mu[cid]
    kap = half.kappa[cid]
    valid = torch.sum(half.stats_w[cid], -1) > 8.0
    # parallax re-aim: point each lobe from the cell centre's mean target to
    # the query position
    dist = half.stats_dist[cid] / torch.clamp(half.stats_w[cid], min=1e-12)
    has_dist = dist > 1e-6
    target = _cell_center(field, cid)[..., None, :] + mu * dist[..., None]
    mu_re = normalize(target - p[..., None, :])
    mu = torch.where((has_dist & valid[..., None])[..., None], mu_re, mu)

    n = torch.clamp(half.vsp_n[cid], min=1.0)
    c_vol = half.vsp_c_vol[cid] / n
    c_surf = half.vsp_c_surf[cid] / n
    if vsp_variance:
        v_vol = torch.clamp(half.vsp_c2_vol[cid] / n - c_vol ** 2, min=0.0)
        v_surf = torch.clamp(half.vsp_c2_surf[cid] / n - c_surf ** 2,
                             min=0.0)
        num = c_vol * c_vol + v_vol
        den = num + c_surf * c_surf + v_surf
    else:
        num = c_vol
        den = c_vol + c_surf
    vsp = torch.where(den > 0, num / torch.clamp(den, min=1e-20), -1.0)
    vsp = torch.where(half.vsp_n[cid] > 8.0, vsp, -1.0)
    flux = half.flux[cid] / torch.clamp(half.flux_w[cid], min=1e-12)[..., None]
    return CellDistribution(w, mu, kap, valid, cid, vsp, flux,
                            half.vsp_lobe_vol[cid], half.vsp_lobe_surf[cid])


def surface_distribution(field: GuidingField, p, ns, apply_cosine=True):
    """The surface half at p, with the clamped-cosine product about ns for
    opaque surfaces (guiding.h:83-109)."""
    d = _gather_half(field, field.surface, p)
    if not apply_cosine:
        return d
    w, mu, kap = vmf.product_with_vmf(
        d.weights, d.mu, d.kappa, ns,
        torch.full(ns.shape[:-1], vmf.COSINE_KAPPA, device=ns.device))
    return d._replace(weights=w, mu=mu, kappa=kap)


def volume_distribution(field: GuidingField, p, wo, g, apply_hg=True):
    """The volume half at p with the single-lobe HG product applied where
    the medium is anisotropic."""
    d = _gather_half(field, field.volume, p)
    if not apply_hg:
        return d
    mu_h, kap_h = vmf.hg_lobe(wo, g)
    w, mu, kap = vmf.product_with_vmf(d.weights, d.mu, d.kappa, mu_h, kap_h)
    aniso = (torch.abs(g) > 1e-3)[..., None]
    return d._replace(weights=torch.where(aniso, w, d.weights),
                      mu=torch.where(aniso[..., None], mu, d.mu),
                      kappa=torch.where(aniso, kap, d.kappa))


def dist_sample(d: CellDistribution, u_sel, u2):
    """Sample wi from a gathered distribution: (wi, pdf)."""
    return vmf.mixture_sample(d.weights, d.mu, d.kappa, u_sel, u2)


def dist_pdf(d: CellDistribution, wi):
    return vmf.mixture_pdf(wi, d.weights, d.mu, d.kappa)


def incoming_radiance_pdf(field: GuidingField, half_name, p, wi):
    """The pdf at wi of the field's distribution at p without the product
    (the RIS target's radiance term); 1/(4 pi) where the cell holds too
    little data."""
    half = field.surface if half_name == "surface" else field.volume
    d = _gather_half(field, half, p)
    pdf = vmf.mixture_pdf(wi, d.weights, d.mu, d.kappa)
    return torch.where(d.valid, pdf, INV_4PI)


def dist_vsp_directional(d: CellDistribution, wi):
    """Directional volume scatter probability: the per-lobe contribution
    moments blended by the mixture posterior at wi, or the cell estimate
    where the lobes carry too little mass."""
    resp = d.weights * vmf.vmf_pdf(wi[..., None, :], d.mu, d.kappa)
    resp = resp / torch.clamp(torch.sum(resp, -1, keepdim=True), min=1e-20)
    num = torch.sum(resp * d.vsp_lobe_vol, -1)
    den = num + torch.sum(resp * d.vsp_lobe_surf, -1)
    mass = torch.sum(d.vsp_lobe_vol + d.vsp_lobe_surf, -1)
    vdir = torch.where(den > 1e-12, num / torch.clamp(den, min=1e-20), -1.0)
    return torch.where((mass > 8.0) & (vdir >= 0.0), vdir, d.vsp)


class TrainBatch(NamedTuple):
    """Flattened training samples."""

    pos: torch.Tensor  # (N,3)
    wi: torch.Tensor  # (N,3)
    weight: torch.Tensor  # (N,) luminance of Li / pdf
    radiance: torch.Tensor  # (N,3) RGB incoming radiance estimate
    distance: torch.Tensor  # (N,) distance to the radiance source
    is_volume: torch.Tensor  # (N,) bool
    c_vol: torch.Tensor  # (N,) volume-scattered contribution
    c_surf: torch.Tensor  # (N,) surface contribution
    valid: torch.Tensor  # (N,) bool


def _update_half(field, half: FieldHalf, batch: TrainBatch, sel, decay):
    cid = field.cell_id(batch.pos)
    ok = sel & batch.valid
    w = torch.where(ok, batch.weight, 0.0)
    stats_w, stats_s, weights, mu, kappa = vmf.em_update(
        half.stats_w, half.stats_s, half.weights, half.mu, half.kappa, cid,
        half.weights.shape[0], batch.wi, w, decay=decay)
    # distance statistics: responsibilities under the updated mixture
    resp = weights[cid] * vmf.vmf_pdf(batch.wi[..., None, :], mu[cid],
                                      kappa[cid])
    resp = resp / torch.clamp(torch.sum(resp, -1, keepdim=True), min=1e-20)
    d_ok = torch.isfinite(batch.distance) & (batch.distance > 0)
    wd = torch.where(ok & d_ok, batch.weight, 0.0)

    def acc(old, add):
        return old * decay + torch.zeros_like(old).index_add_(0, cid, add)

    wv = torch.where(ok, 1.0, 0.0)
    return FieldHalf(
        weights, mu, kappa, stats_w, stats_s,
        acc(half.stats_dist,
            resp * (wd * torch.clamp(batch.distance, max=1e6))[..., None]),
        acc(half.vsp_c_vol, wv * batch.c_vol),
        acc(half.vsp_c_surf, wv * batch.c_surf),
        acc(half.vsp_c2_vol, wv * batch.c_vol ** 2),
        acc(half.vsp_c2_surf, wv * batch.c_surf ** 2),
        acc(half.vsp_n, wv),
        acc(half.flux, torch.where(ok[..., None], batch.radiance, 0.0)),
        acc(half.flux_w, wv),
        acc(half.vsp_lobe_vol, resp * (wv * batch.c_vol)[..., None]),
        acc(half.vsp_lobe_surf, resp * (wv * batch.c_surf)[..., None]))


def field_update(field: GuidingField, batch: TrainBatch, decay=0.75):
    """One per-wave training iteration (Field::Update)."""
    return replace(
        field,
        surface=_update_half(field, field.surface, batch, ~batch.is_volume,
                             decay),
        volume=_update_half(field, field.volume, batch, batch.is_volume,
                            decay),
        iteration=field.iteration + 1)
