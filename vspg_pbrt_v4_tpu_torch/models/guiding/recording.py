"""Path-segment records and radiance back-propagation for guiding training
(counterpart of ``models/guiding/recording.py``).

Each training wave records its first D scattering vertices per lane into
fixed (R, D, ...) slots; ``propagate`` turns them into incoming-radiance
training samples, walking the slots backwards:

    Li_k = emission_k + direct_{k+1} + w_{k+1} * Li_{k+1}

The records come from the VSPG kernel's record variant
(``ops/vspg_kernels.train_wave``) or from the torch wave
(``integrators/vspg.vspg_wave``), which fills them per event through the
recorders below: ``record_vertex`` opens a slot at a scatter vertex,
``record_direct`` and ``record_emission`` attach light to the newest one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .field import TrainBatch


class SegmentRecord(NamedTuple):
    """(R, D, ...) recording buffers."""

    pos: torch.Tensor  # (R,D,3) vertex position
    wi: torch.Tensor  # (R,D,3) sampled outgoing direction at the vertex
    scatter_w: torch.Tensor  # (R,D,3) f*cos/pdf (or phase weight)
    direct: torch.Tensor  # (R,D,3) NEE contribution scattered at the vertex
    emission: torch.Tensor  # (R,D,3) MIS-weighted emission seen along edge k
    pdf: torch.Tensor  # (R,D) sampling pdf of wi
    distance: torch.Tensor  # (R,D) edge length to the next vertex
    is_volume: torch.Tensor  # (R,D) bool vertex type
    valid: torch.Tensor  # (R,D) bool
    count: torch.Tensor  # (R,) vertices recorded

    @staticmethod
    def make(R, D, *, device="cuda"):
        z = torch.zeros((R, D), device=device)
        z3 = torch.zeros((R, D, 3), device=device)
        f = torch.zeros((R, D), dtype=torch.bool, device=device)
        return SegmentRecord(z3, z3, z3, z3, z3, z, z, f, f,
                             torch.zeros(R, dtype=torch.int32, device=device))


def _at(buf, slot):
    """buf[lane, slot[lane]] for every lane."""
    return buf[torch.arange(buf.shape[0], device=buf.device), slot]


def _set(buf, slot, mask, val):
    """A copy of buf with buf[lane, slot[lane]] = val where mask."""
    lanes = torch.arange(buf.shape[0], device=buf.device)
    old = buf[lanes, slot]
    m = mask if val.dim() == mask.dim() else mask[..., None]
    out = buf.clone()
    out[lanes, slot] = torch.where(m, val, old)
    return out


def _newest(rec):
    """The slot of the most recent vertex, and which lanes have one."""
    D = rec.pos.shape[1]
    slot = torch.clamp(rec.count - 1, 0, D - 1).long()
    return slot, (rec.count > 0) & (rec.count <= D)


def record_vertex(rec: SegmentRecord, mask, pos, wi, scatter_w, pdf,
                  is_volume):
    """Open a vertex slot for the lanes of `mask` (at a real scatter, after
    its direction is sampled), closing the previous vertex's edge with the
    vertex-to-vertex distance."""
    D = rec.pos.shape[1]
    slot = torch.clamp(rec.count, max=D - 1).long()
    in_range = mask & (rec.count < D)
    prev_slot = torch.clamp(rec.count - 1, 0, D - 1).long()
    has_prev = in_range & (rec.count > 0)
    edge = torch.sqrt(torch.clamp(torch.sum(
        (pos - _at(rec.pos, prev_slot)) ** 2, -1), min=0.0))
    distance = _set(rec.distance, prev_slot, has_prev, edge)
    return rec._replace(
        pos=_set(rec.pos, slot, in_range, pos),
        wi=_set(rec.wi, slot, in_range, wi),
        scatter_w=_set(rec.scatter_w, slot, in_range, scatter_w),
        pdf=_set(rec.pdf, slot, in_range, pdf),
        is_volume=_set(rec.is_volume, slot, in_range, is_volume),
        valid=_set(rec.valid, slot, in_range, torch.ones_like(mask)),
        distance=distance,
        count=torch.where(in_range, rec.count + 1, rec.count))


def record_direct(rec: SegmentRecord, mask, contribution):
    """Add an NEE contribution (without the path prefix) to the newest
    vertex."""
    slot, has = _newest(rec)
    ok = mask & has
    return rec._replace(direct=_set(rec.direct, slot, ok,
                                    _at(rec.direct, slot) + contribution))


def record_emission(rec: SegmentRecord, mask, contribution, distance):
    """Add MIS-weighted emission seen along the edge leaving the newest
    vertex; the edge length becomes at least `distance`."""
    slot, has = _newest(rec)
    ok = mask & has
    return rec._replace(
        emission=_set(rec.emission, slot, ok,
                      _at(rec.emission, slot) + contribution),
        distance=_set(rec.distance, slot, ok,
                      torch.maximum(_at(rec.distance, slot), distance)))


def record_edge_distance(rec: SegmentRecord, mask, distance):
    """Set the edge length from the newest vertex to the next event."""
    slot, has = _newest(rec)
    return rec._replace(distance=_set(rec.distance, slot, mask & has,
                                      distance))


def propagate(rec: SegmentRecord) -> TrainBatch:
    """The recorded vertices as N = R*D training samples (invalid slots
    have valid=False and weight 0)."""
    R, D = rec.pdf.shape
    dev = rec.pdf.device
    zero3 = torch.zeros((R, 3), device=dev)
    li = [None] * D
    li_next = zero3
    # slot k's edge carries what vertex k+1 scatters toward it
    for k in reversed(range(D)):
        if k + 1 < D:
            ok = rec.valid[:, k + 1][..., None]
            more = torch.where(ok, rec.direct[:, k + 1]
                               + rec.scatter_w[:, k + 1] * li_next, 0.0)
        else:
            more = zero3
        li_next = rec.emission[:, k] + more
        li[k] = li_next
    li = torch.stack(li, 1)  # (R,D,3)

    def nxt(x):
        return torch.cat([x[:, 1:], torch.zeros_like(x[:, :1])], 1)

    valid_next = nxt(rec.valid)
    # VSP observation: Li_k split by the type of the next event; emission
    # seen along the edge is surface light
    li_lum = torch.mean(li, -1)
    scatter_part = torch.where(valid_next, li_lum - torch.mean(rec.emission,
                                                               -1), 0.0)
    scatter_part = torch.clamp(scatter_part, min=0.0)
    c_vol = torch.where(valid_next & nxt(rec.is_volume), scatter_part, 0.0)
    c_surf = torch.clamp(li_lum - c_vol, min=0.0)
    # EM weight Li / pdf(wi): the fitted density tracks incident radiance
    weight = li_lum / torch.clamp(rec.pdf, min=1e-6)
    valid = rec.valid & (weight > 0) & torch.isfinite(weight)

    def flat(x):
        return x.reshape((R * D,) + tuple(x.shape[2:]))

    return TrainBatch(
        pos=flat(rec.pos), wi=flat(rec.wi), weight=flat(weight),
        radiance=flat(li),
        distance=flat(torch.where(rec.distance > 0, rec.distance, 1e6)),
        is_volume=flat(rec.is_volume), c_vol=flat(c_vol),
        c_surf=flat(c_surf), valid=flat(valid))
