"""Guided volumetric path tracer, the fork's GuidedPath / GuidedVolPath
(counterpart of ``models/integrators/guided_volpath.py``).

- ``_guided_sample``: the one-sample MIS (50/50 mixture of the BSDF or
  phase function with the field's vMF mixture) or two-candidate RIS
  combination of a base sampler with the guiding distribution; the VSPG
  wave draws its directions with it too;
- ``guided_bounce``: one path event for every lane in lockstep, the JAX
  package's order of draws: delta tracking, NEE with the guided mixture's
  scatter pdf, the guided phase-function draw (HG product) at volume
  vertices, the guided BSDF draw (cosine product on opaque surfaces) at
  surfaces, Russian roulette; and, in a training wave, the path-segment
  records;
- ``guided_wave``: one wave of camera paths until no lane is alive or
  ``max_events``, then the film and the propagated training batch;
- ``render_guided``: progressive waves with a training barrier, the field
  trained after each wave while it has iterations and weight to spend.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...ops.intersect import offset_ray_origin
from ...utils.math import INV_4PI
from ...utils.sampling import henyey_greenstein, sample_henyey_greenstein
from ...utils.spectrum import average
from ...utils.vecmath import coordinate_system, dot, face_forward, normalize
from ..guiding import field as gfield
from ..guiding import recording as grec
from ..guiding.field import GuidingField
from ..guiding.recording import SegmentRecord
from ..materials import bsdf_f, bsdf_pdf, bsdf_sample
from .volpath import (INF, PathState, VolPathConfig, _combine_ld, _local_ld,
                      _m, _max3, sample_medium_interaction,
                      start_camera_paths, transmittance_ratio_tracking)


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


# ---------------------------------------------------------------------------
# The guided bounce
# ---------------------------------------------------------------------------


class GState(NamedTuple):
    s: PathState
    rec: SegmentRecord


def guided_bounce(scene, cfg: VolPathConfig, gopt: GuidingOptions,
                  field: GuidingField, train: bool, gs: GState) -> GState:
    """One path event for every lane: delta tracking; at a real scatter NEE
    and the guided phase draw; escape with env MIS; emission of an area
    light with MIS after the first hit; interface crossings; at a surface
    NEE and the guided BSDF draw; Russian roulette at surfaces."""
    s = gs.s
    rec = gs.rec
    h = scene.geometry.intersect(s.o, s.d, torch.full_like(s.o[..., 0], INF))
    seg_end = torch.where(h.hit, h.t, INF)

    # ---- medium flight ------------------------------------------------------
    in_medium = s.alive & (s.medium_id >= 0)
    mr = sample_medium_interaction(
        scene, cfg, s.o, s.d, seg_end, s.medium_id, s.hero_idx, s.sampler,
        s.beta, s.r_u, s.r_l, s.L, s.depth, in_medium)
    sampler, beta, r_u, r_l, L, depth = (mr.sampler, mr.beta, mr.r_u, mr.r_l,
                                         mr.L, mr.depth)
    alive = s.alive & ~mr.terminated

    # ---- volume scatter: NEE with the guided scatter pdf, guided draw ------
    scat = mr.scattered & alive
    p_scat = s.o + mr.t_scatter[..., None] * s.d
    wo = -s.d
    dist_v = gfield.volume_distribution(field, p_scat, wo, mr.g_scatter)
    use_guide_v = (scat & dist_v.valid & field.trained
                   & bool(gopt.volume_guiding))

    sampler, u_sel = sampler.get_1d()
    sampler, u2l = sampler.get_2d()
    ls = scene.lights.sample(p_scat, u_sel, u2l)
    ok = scat & ls.valid & (average(ls.L) > 0)
    f_scalar = henyey_greenstein(torch.sum(wo * ls.wi, dim=-1), mr.g_scatter)
    pg = gopt.guiding_prob if gopt.mode == "mis" else 0.5
    scatter_pdf_l = torch.where(
        use_guide_v,
        (1 - pg) * f_scalar + pg * gfield.dist_pdf(dist_v, ls.wi), f_scalar)
    f_hat = f_scalar[..., None] * torch.ones_like(beta)
    ok = ok & (f_scalar > 0)
    sampler, T_ray, tr_l, tr_u = transmittance_ratio_tracking(
        scene, cfg, p_scat, ls.wi, ls.t_shadow, s.medium_id, s.hero_idx,
        sampler, ok)
    Ld = _combine_ld(ls, f_hat, scatter_pdf_l, T_ray, tr_l, tr_u, r_u, beta,
                     ok)
    L = _m(scat, L + Ld, L)

    def phase_base(sampler):
        sampler, u2p = sampler.get_2d()
        wi_p, pdf_p = sample_henyey_greenstein(wo, mr.g_scatter, u2p)
        return sampler, wi_p, pdf_p[..., None] * torch.ones_like(beta), \
            pdf_p, None

    def phase_pdf_at(wi):
        return henyey_greenstein(torch.sum(wo * wi, -1), mr.g_scatter)

    def inc_rad_pdf_v(wi):
        return gfield.incoming_radiance_pdf(field, "volume", p_scat, wi)

    (sampler, wi_v, _, pdf_v, mis_pdf_v, _, _, valid_v, _) = _guided_sample(
        sampler, use_guide_v, gopt, dist_v, phase_base, phase_pdf_at,
        inc_rad_pdf_v)
    alive = alive & ~(scat & ~valid_v)
    scale_v = phase_pdf_at(wi_v) / torch.clamp(pdf_v, min=1e-30)
    beta = _m(scat, beta * scale_v[..., None], beta)
    r_l = _m(scat, r_u / torch.clamp(mis_pdf_v, min=1e-30)[..., None], r_l)
    o_new = _m(scat, p_scat, s.o)
    d_new = _m(scat, wi_v, s.d)
    specular = torch.where(scat, False, s.specular)
    prev_p = _m(scat, p_scat, s.prev_p)

    if train:
        rec = grec.record_vertex(rec, scat, p_scat, wi_v,
                                 scale_v[..., None] * torch.ones_like(beta),
                                 pdf_v, torch.ones_like(scat))
        rec = grec.record_direct(rec, ok, _to3(_local_ld(
            ls, f_hat, scatter_pdf_l, T_ray, tr_l, tr_u, ok)))

    # ---- escape -------------------------------------------------------------
    flew = alive & ~scat
    escaped = flew & ~h.hit
    Le_env = scene.lights.le_escaped(s.d, s.o)
    any_env = average(Le_env) > 0
    first = (s.depth == 0) | s.specular
    ru_avg = torch.clamp(average(r_u), min=1e-30)
    L = _m(escaped & first & any_env, L + beta * Le_env / ru_avg[..., None],
           L)
    r_l_esc = r_l * scene.lights.pdf_li_escaped(s.d, s.prev_p)[..., None]
    denom_esc = torch.clamp(average(r_u + r_l_esc), min=1e-30)
    L = _m(escaped & ~first & any_env,
           L + beta * Le_env / denom_esc[..., None], L)
    if train:
        # the environment's emission at a virtual vertex 1e6 away
        w_mis_env = torch.where(first, torch.ones_like(denom_esc),
                                average(r_u) / denom_esc)
        rec = grec.record_emission(rec, escaped & any_env,
                                   _to3(Le_env * w_mis_env[..., None]),
                                   torch.full_like(denom_esc, 1e6))
    alive = alive & ~escaped

    # ---- surfaces: area-light emission, interfaces --------------------------
    surf = flew & h.hit
    emissive = surf & (h.light_id >= 0)
    Le_surf = scene.lights.le_area(h.light_id, -s.d, h.n)
    has_le = average(Le_surf) > 0
    L = _m(emissive & first & has_le, L + beta * Le_surf / ru_avg[..., None],
           L)
    r_l_area = r_l * scene.lights.pdf_li_area(h.light_id, s.prev_p, h.p,
                                              h.n)[..., None]
    denom_s = torch.clamp(average(r_u + r_l_area), min=1e-30)
    L = _m(emissive & ~first & has_le, L + beta * Le_surf / denom_s[..., None],
           L)
    if train:
        w_mis_srf = torch.where(first, torch.ones_like(denom_s),
                                average(r_u) / denom_s)
        rec = grec.record_emission(rec, emissive & has_le,
                                   _to3(Le_surf * w_mis_srf[..., None]), h.t)

    iface = surf & (h.mat_id < 0)
    new_med_skip = torch.where(dot(s.d, h.n) < 0, h.med_in, h.med_out)
    medium_id = torch.where(iface, new_med_skip, s.medium_id)
    o_new = _m(iface, h.p + 1e-4 * s.d, o_new)

    # ---- surface shading ----------------------------------------------------
    shade = surf & (h.mat_id >= 0)
    depth_hit = shade & (s.depth >= cfg.max_depth)
    alive = alive & ~depth_hit
    shade = shade & ~depth_hit
    if not bool(shade.any()):
        # the JAX bounce draws the surface NEE (1D + 2D), the guided BSDF
        # sample (MIS: 1D + 2D + the BSDF's 1D + 2D; RIS: one more 1D) and
        # the roulette (1D) for every lane; with no shaded lane they only
        # advance the dimension counter
        sampler = sampler.advance(7 if gopt.mode == "mis" else 8)
        return GState(PathState(sampler, o_new, d_new, beta, r_u, r_l, L,
                                depth, alive, specular, s.hero_idx,
                                medium_id, s.eta_scale, prev_p), rec)
    depth = torch.where(shade, depth + 1, depth)
    lanes = scene.materials.gather_textured(scene.textures, h.mat_id, h.uv,
                                            h.p)
    ns = face_forward(h.ns, h.n)
    # the surface half: cosine product on opaque materials only
    is_transmissive = (lanes.mat_type == 2) | (lanes.mat_type == 3)
    ns_cos = torch.where((dot(-s.d, ns) < 0)[..., None], -ns, ns)
    dist_cos = gfield.surface_distribution(field, h.p, ns_cos, True)
    dist_flat = gfield.surface_distribution(field, h.p, ns_cos, False)
    dist_s = gfield.CellDistribution(*(
        None if a is None else torch.where(
            is_transmissive.reshape(is_transmissive.shape
                                    + (1,) * (a.dim() - 1)), b, a)
        for a, b in zip(dist_cos, dist_flat)))
    use_guide_s = (shade & dist_s.valid & field.trained & ~lanes.is_specular
                   & bool(gopt.surface_guiding))
    t1, t2 = coordinate_system(ns)

    def to_local(w):
        return torch.stack([dot(w, t1), dot(w, t2), dot(w, ns)], -1)

    wo_l = to_local(-s.d)
    p_off = offset_ray_origin(h.p, h.n, -s.d)
    sampler, u_sel2 = sampler.get_1d()
    sampler, u2l2 = sampler.get_2d()
    ls2 = scene.lights.sample(p_off, u_sel2, u2l2)
    can_nee = shade & ~lanes.is_specular
    ok2 = can_nee & ls2.valid & (average(ls2.L) > 0)
    wi_l2 = to_local(ls2.wi)
    f_hat2 = (bsdf_f(lanes, wo_l, wi_l2)
              * torch.abs(dot(ls2.wi, ns))[..., None])
    bpdf2 = bsdf_pdf(lanes, wo_l, wi_l2)
    scatter_pdf2 = torch.where(
        use_guide_s, (1 - pg) * bpdf2 + pg * gfield.dist_pdf(dist_s, ls2.wi),
        bpdf2)
    ok2 = ok2 & (_max3(f_hat2) > 0)
    sampler, T_ray2, tr_l2, tr_u2 = transmittance_ratio_tracking(
        scene, cfg, p_off, ls2.wi, ls2.t_shadow, medium_id, s.hero_idx,
        sampler, ok2)
    Ld2 = _combine_ld(ls2, f_hat2, scatter_pdf2, T_ray2, tr_l2, tr_u2, r_u,
                      beta, ok2)
    L = _m(can_nee, L + Ld2, L)

    def bsdf_base(sampler):
        sampler, u_lobe = sampler.get_1d()
        sampler, u2b = sampler.get_2d()
        bs = bsdf_sample(lanes, wo_l, u_lobe, u2b)
        wi_w = normalize(bs.wi[..., 0:1] * t1 + bs.wi[..., 1:2] * t2
                         + bs.wi[..., 2:3] * ns)
        return (sampler, wi_w, bs.f * torch.abs(dot(wi_w, ns))[..., None],
                bs.pdf, bs)

    def bsdf_pdf_at(wi_w):
        return bsdf_pdf(lanes, wo_l, to_local(wi_w))

    def inc_rad_pdf_s(wi_w):
        return gfield.incoming_radiance_pdf(field, "surface", h.p, wi_w)

    (sampler, wi_s, f_s, pdf_s, mis_pdf_s, _, bs_aux, valid_s,
     took_guide_s) = _guided_sample(sampler, use_guide_s, gopt, dist_s,
                                    bsdf_base, bsdf_pdf_at, inc_rad_pdf_s)
    # a guide-drawn direction takes the BSDF's value there
    f_guide = (bsdf_f(lanes, wo_l, to_local(wi_s))
               * torch.abs(dot(wi_s, ns))[..., None])
    f_s = torch.where(took_guide_s[..., None], f_guide, f_s)
    # specular lanes always keep the raw BSDF sample
    bs_ok = shade & valid_s & (pdf_s > 0) & bs_aux.valid
    spec_lane = lanes.is_specular
    bs_ok = torch.where(spec_lane, shade & bs_aux.valid & (bs_aux.pdf > 0),
                        bs_ok)
    alive = alive & ~(shade & ~bs_ok)
    scale_b = f_s / torch.clamp(pdf_s, min=1e-30)[..., None]
    beta = _m(bs_ok, beta * scale_b, beta)
    r_l = _m(bs_ok, r_u / torch.clamp(mis_pdf_s, min=1e-30)[..., None], r_l)
    specular = torch.where(bs_ok, bs_aux.is_specular & ~took_guide_s,
                           specular)
    eta_scale = torch.where(bs_ok & bs_aux.is_transmission & ~took_guide_s,
                            s.eta_scale * (bs_aux.eta * bs_aux.eta),
                            s.eta_scale)
    # a reflection keeps the medium; only a true crossing adopts the far
    # side's label (volpath_bounce)
    wi_front_s = dot(wi_s, h.n) > 0
    crossed_s = bs_ok & (wi_front_s != (dot(s.d, h.n) < 0))
    medium_id = torch.where(crossed_s, torch.where(wi_front_s, h.med_out,
                                                   h.med_in), medium_id)
    o_new = _m(bs_ok, offset_ray_origin(h.p, h.n, wi_s), o_new)
    d_new = _m(bs_ok, wi_s, d_new)
    prev_p = _m(bs_ok, h.p, prev_p)

    if train:
        rec = grec.record_vertex(rec, bs_ok & ~spec_lane, h.p, wi_s,
                                 _to3(scale_b), pdf_s,
                                 torch.zeros_like(bs_ok))
        rec = grec.record_direct(rec, ok2, _to3(_local_ld(
            ls2, f_hat2, scatter_pdf2, T_ray2, tr_l2, tr_u2, ok2)))

    # ---- Russian roulette at surfaces ---------------------------------------
    alive = alive & ~(shade & (_max3(beta) == 0))
    rr_beta = (beta * eta_scale[..., None]
               / torch.clamp(average(r_u), min=1e-30)[..., None])
    rr_max = _max3(rr_beta)
    sampler, u_rr = sampler.get_1d()
    do_rr = shade & (rr_max < 1.0) & (depth > 1)
    q = torch.clamp(1.0 - rr_max, min=0.0)
    rr_kill = do_rr & (u_rr < q)
    alive = alive & ~rr_kill
    beta = _m(do_rr & ~rr_kill,
              beta / torch.clamp(1.0 - q, min=1e-6)[..., None], beta)
    return GState(PathState(sampler, o_new, d_new, beta, r_u, r_l, L, depth,
                            alive, specular, s.hero_idx, medium_id,
                            eta_scale, prev_p), rec)


# ---------------------------------------------------------------------------
# The wave and the progressive render with its training barrier
# ---------------------------------------------------------------------------


def guided_wave(scene, camera, film, film_state, field, cfg, gopt, seed,
                wave_idx, camera_medium, train, spp_per_pass):
    """One wave of `spp_per_pass` samples a pixel (lane l renders pixel
    l // spp_per_pass), stepped until no lane is alive or max_events. Adds
    the samples to `film_state` in lane order (in place) and returns
    (film_state, TrainBatch or None)."""
    dev = film.device
    R = film.npix * spp_per_pass
    lane = torch.arange(R, device=dev)
    pixel_id = lane // spp_per_pass
    sample_index = int(wave_idx) * spp_per_pass + lane % spp_per_pass
    s, fw = start_camera_paths(camera, film, int(seed) & 0xFFFFFFFF,
                               sample_index, pixel_id, int(camera_medium))
    gs = GState(s, SegmentRecord.make(R, gopt.record_depth if train else 1,
                                      device=dev))
    it = 0
    while bool(gs.s.alive.any()) and it < cfg.max_events:
        gs = guided_bounce(scene, cfg, gopt, field, train, gs)
        it += 1
    film_state = film.add_pass(film_state, gs.s.L, fw)
    return film_state, (grec.propagate(gs.rec) if train else None)


def _scene_field(scene, gopt, device):
    """A fresh field over the bounds of the scene's triangles, spheres and
    boxes, padded by 1e-3."""
    g = scene.geometry
    pts = [a.cpu().numpy() for a in (g.tri_p0, g.tri_p1, g.tri_p2, g.box_min,
                                     g.box_max)]
    if g.n_sph:
        c, r = g.sph_c.cpu().numpy(), g.sph_r.cpu().numpy()[:, None]
        pts += [c - r, c + r]
    pts = np.concatenate(pts, 0)
    return GuidingField.make(pts.min(0) - 1e-3, pts.max(0) + 1e-3,
                             res=gopt.field_res, n_lobes=gopt.n_lobes,
                             n_extra=gopt.adaptive_extra, device=device)


def render_guided(scene, camera, film, spp=16, cfg=VolPathConfig(),
                  gopt=GuidingOptions(), seed=0, camera_medium=-1,
                  spp_per_pass=1, field=None, train=True, *, device="cuda"):
    """Progressive guided render on `device`: after each wave the field
    trains on the wave's samples while it has training iterations left
    and the wave carries more than ``min_train_weight``. Returns (image,
    field); a given `field` with train=False guides without training (a
    loaded guiding cache)."""
    if cfg.spectral:
        raise NotImplementedError("the spectral mode is not ported yet")
    if spp % spp_per_pass:
        raise ValueError(f"spp {spp} is not a multiple of spp_per_pass "
                         f"{spp_per_pass}")
    scene, camera, film = scene.to(device), camera.to(device), film.to(device)
    field = (_scene_field(scene, gopt, device) if field is None
             else field.to(device))
    film_state = film.init_state()
    for wave in range(spp // spp_per_pass):
        do_train = train and field.iteration < gopt.train_waves
        film_state, batch = guided_wave(
            scene, camera, film, film_state, field, cfg, gopt, seed, wave,
            camera_medium, do_train, spp_per_pass)
        if do_train:
            total_w = float(torch.sum(torch.where(batch.valid, batch.weight,
                                                  0.0)))
            if total_w > gopt.min_train_weight:
                field = train_step(field, batch)
                if gopt.adaptive_extra:
                    field = gfield.refine_field(field, gopt.refine_threshold)
    return film.image(film_state), field
