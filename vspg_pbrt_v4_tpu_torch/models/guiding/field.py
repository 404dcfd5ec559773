"""Spatial-directional guiding field (counterpart of
``models/guiding/field.py``): a res^3 voxel grid over the scene bounds
whose leaves hold a surface and a volume half, each a K-lobe vMF mixture
trained by incremental weighted EM, parallax distances, VSP statistics
(contribution and variance criteria) and a flux cache.

With ``n_extra > 0`` the field is adaptive and two-level (the JAX
package's analog of OpenPGL's sample-adaptive kd-tree): between waves,
``refine_field`` splits dense coarse cells into 2^3 child leaves, and a
coarse cell resolves to its leaf through the indirection arrays
``leaf_of``, ``refined`` and ``child_base``. ``save_field`` and
``load_field`` store and load a field in the JAX package's npz layout, so
that a guiding cache written by either package loads in the other.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple

import numpy as np
import torch

from ...utils.device import OnDevice
from ...utils.math import INV_4PI, index_sum
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
    # the adaptive two-level addressing: L = res^3 + n_extra leaves; a
    # refined coarse cell c maps octant o to leaf child_base[c] + o, any
    # other to leaf_of[c]. n_extra 0 is the plain uniform grid.
    n_extra: int = 0
    leaf_of: torch.Tensor = None  # (C,) int64 coarse cell -> leaf
    refined: torch.Tensor = None  # (C,) bool
    child_base: torch.Tensor = None  # (C,) int64 first of the 8 children
    n_leaves: int = 0  # allocated leaves
    leaf_center: torch.Tensor = None  # (L,3) leaf centres (parallax re-aim)

    @staticmethod
    def make(b_min, b_max, res=16, n_lobes=8, n_extra=0, *, device="cuda"):
        """A fresh field of res^3 + n_extra leaves: every leaf holds K
        fibonacci-spiral lobes of equal weight and kappa 1; the first res^3
        are the grid cells, the rest wait for ``refine_field``."""
        C = res ** 3
        L = C + int(n_extra)
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
                f((L, K), 1.0 / K),
                torch.as_tensor(np.tile(dirs[None], (L, 1, 1)),
                                device=device),
                f((L, K), 1.0), f((L, K)), f((L, K, 3)), f((L, K)), f((L,)),
                f((L,)), f((L,)), f((L,)), f((L,)), f((L, 3)), f((L,)),
                f((L, K)), f((L, K)))

        bmin = np.asarray(b_min, np.float32)
        bmax = np.asarray(b_max, np.float32)
        ii = np.arange(C)
        idx = np.stack([ii // (res * res), (ii // res) % res, ii % res],
                       -1).astype(np.float32) + 0.5
        leaf_center = np.zeros((L, 3), np.float32)
        leaf_center[:C] = bmin + idx / res * (bmax - bmin)

        def t(a):
            return torch.as_tensor(a, device=device)

        return GuidingField(
            t(bmin), t(bmax), half(), half(), 0, int(res), int(n_lobes),
            n_extra=int(n_extra), leaf_of=t(np.arange(C)),
            refined=t(np.zeros(C, bool)), child_base=t(np.zeros(C, np.int64)),
            n_leaves=C, leaf_center=t(leaf_center))

    def cell_id(self, p):
        """(..., 3) world position -> flat leaf index (...): the coarse
        cell, then, on an adaptive field, its leaf, from the octant of the
        clamped grid coordinate."""
        g = (p - self.b_min) / (self.b_max - self.b_min)
        gi = torch.clamp(g * self.res, 0.0, self.res - 1e-4)
        i = gi.to(torch.int64)
        c = (i[..., 0] * self.res + i[..., 1]) * self.res + i[..., 2]
        if self.n_extra == 0:
            return c
        frac = gi - i.to(torch.float32)
        half = (frac >= 0.5).to(torch.int64)
        octant = half[..., 0] * 4 + half[..., 1] * 2 + half[..., 2]
        return torch.where(self.refined[c], self.child_base[c] + octant,
                           self.leaf_of[c])

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
    if field.n_extra > 0:
        return field.leaf_center[cid]
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
        return old * decay + index_sum(torch.zeros_like(old), cid, add)

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


def refine_field(field: GuidingField, threshold=256.0, max_splits=16):
    """Between-wave spatial refinement: the coarse cells whose EM sample
    mass (both halves) exceeds `threshold`, heaviest first, at most
    `max_splits` and as many as the free leaves hold, split into 2^3
    children that inherit the parent's lobes with 1/8 of its statistics.
    The cells are picked on the host as the JAX package picks them (numpy
    float32 sums, numpy's argsort, whose tie order a torch sort would not
    keep); the row copies run on the field's device. A uniform field
    (n_extra 0) is returned as it is."""
    if field.n_extra == 0:
        return field
    C = field.res ** 3
    L = C + field.n_extra
    n_leaves = int(field.n_leaves)
    cap = (L - n_leaves) // 8
    if cap <= 0:
        return field
    refined = field.refined.cpu().numpy().copy()
    leaf_of = field.leaf_of.cpu().numpy()
    mass = (field.surface.stats_w.cpu().numpy().sum(-1)
            + field.volume.stats_w.cpu().numpy().sum(-1))
    cell_mass = np.where(refined, 0.0, mass[leaf_of])
    order = np.argsort(-cell_mass)
    picks = [int(c) for c in order if cell_mass[c] > threshold]
    picks = picks[:min(int(max_splits), cap)]
    if not picks:
        return field
    dev = field.b_min.device
    bmin = field.b_min.cpu().numpy()
    bmax = field.b_max.cpu().numpy()
    cell = (bmax - bmin) / field.res
    res = field.res
    child_base = field.child_base.cpu().numpy().copy()
    centers = np.zeros((8 * len(picks), 3), np.float32)
    for j, c in enumerate(picks):
        lo = bmin + np.asarray([c // (res * res), (c // res) % res,
                                c % res]) * cell
        for o in range(8):
            off = np.asarray([(o >> 2) & 1, (o >> 1) & 1, o & 1], np.float32)
            centers[8 * j + o] = lo + (off * 0.5 + 0.25) * cell
        refined[c] = True
        child_base[c] = n_leaves + 8 * j
    dst = torch.arange(n_leaves, n_leaves + 8 * len(picks), device=dev)
    src = torch.as_tensor(np.repeat(leaf_of[picks], 8), device=dev)

    def split(h):
        rows = {}
        for name in FieldHalf.__dataclass_fields__:
            a = getattr(h, name).clone()
            row = a[src]
            # children inherit the distribution and split the statistics
            a[dst] = row if name in ("weights", "mu", "kappa") else row / 8.0
            rows[name] = a
        return FieldHalf(**rows)

    leaf_center = field.leaf_center.clone()
    leaf_center[dst] = torch.as_tensor(centers, device=dev)
    return replace(
        field, surface=split(field.surface), volume=split(field.volume),
        refined=torch.as_tensor(refined, device=dev),
        child_base=torch.as_tensor(child_base, device=dev),
        n_leaves=n_leaves + 8 * len(picks), leaf_center=leaf_center)


# the JAX package's npz layout of a field: its leaves in the order of
# jax.tree.flatten(GuidingField) (the dataclass's array fields in order,
# each half's fields in order), then the static res, n_lobes and n_extra
_HALF_FIELDS = ("weights", "mu", "kappa", "stats_w", "stats_s",
                "stats_dist", "vsp_c_vol", "vsp_c_surf", "vsp_c2_vol",
                "vsp_c2_surf", "vsp_n", "flux", "flux_w", "vsp_lobe_vol",
                "vsp_lobe_surf")


def save_field(field: GuidingField, path):
    """Store the field (storeGuidingCache analog) as an npz."""
    def half(h):
        return [getattr(h, k).cpu().numpy() for k in _HALF_FIELDS]

    arrays = ([field.b_min.cpu().numpy(), field.b_max.cpu().numpy()]
              + half(field.surface) + half(field.volume)
              + [np.int32(field.iteration),
                 field.leaf_of.cpu().numpy().astype(np.int32),
                 field.refined.cpu().numpy(),
                 field.child_base.cpu().numpy().astype(np.int32),
                 np.int32(field.n_leaves), field.leaf_center.cpu().numpy()])
    np.savez(path, *arrays, res=field.res, n_lobes=field.n_lobes,
             n_extra=field.n_extra)


def load_field(path, device="cuda") -> GuidingField:
    """A field stored by either package's ``save_field``, on `device`."""
    data = np.load(path)
    n_meta = 3 if "n_extra" in data.files else 2
    a = [data[f"arr_{i}"] for i in range(len(data.files) - n_meta)]
    n_h = len(_HALF_FIELDS)
    if len(a) != 2 + 2 * n_h + 6:
        raise ValueError(f"{path}: {len(a)} arrays, not a guiding field")

    def t(x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    def half(xs):
        return FieldHalf(*(t(x, torch.float32) for x in xs))

    it, leaf_of, refined, child_base, n_leaves, leaf_center = a[2 + 2 * n_h:]
    return GuidingField(
        t(a[0], torch.float32), t(a[1], torch.float32),
        half(a[2:2 + n_h]), half(a[2 + n_h:2 + 2 * n_h]), int(it),
        int(data["res"]), int(data["n_lobes"]),
        n_extra=int(data["n_extra"]) if "n_extra" in data.files else 0,
        leaf_of=t(leaf_of, torch.int64), refined=t(refined, torch.bool),
        child_base=t(child_base, torch.int64), n_leaves=int(n_leaves),
        leaf_center=t(leaf_center, torch.float32))
