"""Guided volumetric path tracing options, the per-wave training step and
the guided directional draw (counterpart of
``models/integrators/guided_volpath.py``).

Ported: ``GuidingOptions``, ``train_step``, and ``_guided_sample``, the
one-sample MIS / RIS combination of a base sampler (BSDF or phase
function) with the guiding mixture that the VSPG wave draws its volume
directions with. The guided wave of its own (``guided_bounce``,
``guided_wave``, ``render_guided``) is queued in ROADMAP.md §B.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...utils.math import INV_4PI
from ..guiding import field as gfield


class GuidingOptions(NamedTuple):
    """Static guiding configuration (the integrator's scene-file
    parameters)."""

    mode: str = "ris"  # "mis" | "ris"
    guiding_prob: float = 0.5
    volume_guiding: bool = True
    surface_guiding: bool = True  # guided BSDF draws at non-delta surfaces
    record_depth: int = 8
    train_waves: int = 128
    min_train_weight: float = 128.0
    field_res: int = 16
    n_lobes: int = 8
    # adaptive spatial refinement: extra leaf capacity (0: uniform grid);
    # between waves, coarse cells whose EM mass exceeds refine_threshold
    # split into 2^3 children (guiding/field.refine_field)
    adaptive_extra: int = 0
    refine_threshold: float = 256.0


def train_step(field, batch):
    """One training iteration of the field on a wave's samples."""
    return gfield.field_update(field, batch)


def _to3(x):
    """Guiding and ISGB data as RGB: RGB passes through (spectral mode, which
    would train on the max component, is not ported)."""
    if x.shape[-1] != 3:
        raise NotImplementedError("spectral guiding data is not ported yet")
    return x


def _guided_sample(sampler, use_guide, gopt, dist, base_sample_fn,
                   base_pdf_fn, inc_rad_pdf):
    """One-sample MIS or RIS combination of a base sampler and the guiding
    distribution `dist`.

    base_sample_fn(sampler) -> (sampler, wi, f (R,3), pdf (R,), aux);
    base_pdf_fn(wi) -> the base sampler's pdf at wi; inc_rad_pdf(wi) -> the
    field's incoming-radiance pdf at wi (the RIS target's term). Returns
    (sampler, wi, f, pdf, mis_pdf, base_pdf, aux, valid, took_guide): pdf
    divides beta, mis_pdf goes into r_l for NEE MIS."""
    pg = gopt.guiding_prob
    if gopt.mode == "mis":
        sampler, u_c = sampler.get_1d()
        sampler, u2g = sampler.get_2d()
        take_guide = use_guide & (u_c < pg)
        u_lobe = torch.clamp(u_c / pg, 0.0, 0.999999)
        sampler, wi_b, f_b, pdf_b, aux = base_sample_fn(sampler)
        wi_g, gpdf_g = gfield.dist_sample(dist, u_lobe, u2g)
        wi = torch.where(take_guide[..., None], wi_g, wi_b)
        f = torch.where(take_guide[..., None], torch.zeros_like(f_b), f_b)
        base_pdf = torch.where(take_guide, base_pdf_fn(wi_g), pdf_b)
        guide_pdf = torch.where(take_guide, gpdf_g,
                                gfield.dist_pdf(dist, wi_b))
        pdf = torch.where(use_guide, (1.0 - pg) * base_pdf + pg * guide_pdf,
                          pdf_b)
        valid = torch.where(take_guide, base_pdf > 0, pdf_b > 0) & (pdf > 0)
        return sampler, wi, f, pdf, pdf, base_pdf, aux, valid, take_guide
    sampler, wi_b, f_b, pdf_b, aux = base_sample_fn(sampler)
    sampler, u2g = sampler.get_2d()
    sampler, u_pick = sampler.get_1d()
    wi_g, gpdf_g = gfield.dist_sample(dist, u_pick, u2g)
    bpdf_g = base_pdf_fn(wi_g)
    gpdf_b = gfield.dist_pdf(dist, wi_b)
    irp_b = inc_rad_pdf(wi_b)
    irp_g = inc_rad_pdf(wi_g)
    mis0 = 0.5 * (pdf_b + gpdf_b)
    mis1 = 0.5 * (bpdf_g + gpdf_g)
    target0 = pdf_b * ((1 - pg) * INV_4PI + pg * irp_b)
    target1 = bpdf_g * ((1 - pg) * INV_4PI + pg * irp_g)
    w0 = torch.where(pdf_b > 0, target0 / torch.clamp(mis0, min=1e-20), 0.0)
    w1 = torch.where(bpdf_g > 0, target1 / torch.clamp(mis1, min=1e-20), 0.0)
    sum_w = w0 + w1
    sampler, u_sel = sampler.get_1d()
    pick1 = u_sel * torch.clamp(sum_w, min=1e-20) > w0
    wi = torch.where(pick1[..., None], wi_g, wi_b)
    base_pdf = torch.where(pick1, bpdf_g, pdf_b)
    mis_pdf = torch.where(pick1, mis1, mis0)
    w_sel = torch.where(pick1, w1, w0)
    pdf = w_sel * mis_pdf * 2.0 / torch.clamp(sum_w, min=1e-20)
    ris_valid = use_guide & (sum_w > 0) & (pdf > 0)
    # lanes without guiding keep the plain base sample
    wi = torch.where(use_guide[..., None], wi, wi_b)
    pdf = torch.where(use_guide, pdf, pdf_b)
    mis_pdf = torch.where(use_guide, mis_pdf, pdf_b)
    base_pdf = torch.where(use_guide, base_pdf, pdf_b)
    valid = torch.where(use_guide, ris_valid, pdf_b > 0)
    return (sampler, wi, f_b, pdf, mis_pdf, base_pdf, aux, valid,
            use_guide & pick1)
