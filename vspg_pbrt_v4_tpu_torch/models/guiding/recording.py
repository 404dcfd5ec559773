"""Path-segment records and radiance back-propagation for guiding training
(counterpart of ``models/guiding/recording.py``).

Each training wave records its first D scattering vertices per lane into
fixed (R, D, ...) slots; ``propagate`` turns them into incoming-radiance
training samples, walking the slots backwards:

    Li_k = emission_k + direct_{k+1} + w_{k+1} * Li_{k+1}

The per-vertex recorders of the JAX package serve only its XLA wave, which
is not ported; here the records come from the VSPG kernel's record variant
(``ops/vspg_kernels.train_wave``).
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
