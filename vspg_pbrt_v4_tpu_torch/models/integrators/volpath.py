"""Wavefront volumetric path tracer (counterpart of
``models/integrators/volpath.py``): the torch oracle of the port.

Path state lives in per-lane tensors and every lane steps in lockstep with
masks, exactly as in the JAX package: one outer iteration is one path
event, the collision loops of delta tracking and ratio tracking run while
ANY lane is still active, and every draw advances the sampler dimension of
EVERY lane. A lane's random stream therefore depends on its batch; keeping
the same lane pool and the same regeneration order is what lets this
module match the JAX wavefront lane for lane.

``render`` (and ``render_pass`` and ``render_progressive``, which the
scene-file CLI calls) runs passes of ``spp_per_pass`` samples a pixel
through this wavefront on the JAX package's random streams;
``render_persistent`` keeps a lane pool busy and dispatches to the
kernels where a scene is of their class.

Scope: homogeneous, grid and procedural media inside box or triangle
interfaces, flat triangles (by brute force up to 64, through the
geometry's BVH above) and spheres with every material and texture of
``models/materials.py`` and ``models/textures.py`` (subsurface through the
probe relocation of ``models/bssrdf.py`` with ``cfg.sss``), every light of
``models/lights.py``, the cameras of ``models/cameras.py``, RGB
hero-channel mode.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple

import torch

from ...utils.sampling import (henyey_greenstein, sample_exponential,
                               sample_henyey_greenstein)
from ...utils.spectrum import average, hero, sample_hero_channel
from ...ops.intersect import offset_ray_origin
from ...utils.vecmath import coordinate_system, dot, face_forward, normalize
from ..film import pixel_coords
from ..lights import Lights
from ..materials import Materials, bsdf_f, bsdf_pdf, bsdf_sample
from ..media import HomogeneousMedia, Media, seg_init, seg_next
from ..samplers import LaneSampler
from ..shapes import Geometry

INF = float("inf")


def _m(mask, new, old):
    """Masked update, broadcasting mask over trailing dims of new/old."""
    if new.dim() > mask.dim():
        mask = mask[..., None]
    return torch.where(mask, new, old)


def _max3(x):
    return torch.amax(x, dim=-1)


class VolPathConfig(NamedTuple):
    max_depth: int = 32
    spectral: bool = False  # only RGB mode is ported
    max_events: int = 256  # outer path-event iterations
    max_collisions: int = 4096  # delta-tracking runaway guard
    max_shadow_segments: int = 8  # shadow-ray interface crossings
    rr_start_depth: int = 2  # RR when depth > 1 (integrators.cpp:1305)
    sss: bool = False  # subsurface probe relocation (set by the CLI when
    #     the scene has SUBSURFACE materials)


def shading_frame(ns):
    """Orthonormal (t1, t2) of the shading frame about ns (the JAX
    package's, without the fiber tangents of curve hits)."""
    return coordinate_system(ns)


@dataclass(frozen=True)
class Scene:
    geometry: Geometry
    materials: Materials
    media: Media
    lights: Lights
    textures: object = None  # models.textures.Textures or None

    def to(self, device):
        return Scene(self.geometry.to(device), self.materials.to(device),
                     self.media.to(device), self.lights.to(device),
                     None if self.textures is None
                     else self.textures.to(device))


class MediumResult(NamedTuple):
    sampler: LaneSampler
    beta: torch.Tensor
    r_u: torch.Tensor
    r_l: torch.Tensor
    L: torch.Tensor
    depth: torch.Tensor
    scattered: torch.Tensor  # (R,) real scatter happened
    terminated: torch.Tensor  # (R,) absorbed / beta died / depth exceeded
    t_scatter: torch.Tensor  # (R,)
    g_scatter: torch.Tensor  # (R,) phase asymmetry at the scatter point


# ---------------------------------------------------------------------------
# Delta-tracking medium interaction
# ---------------------------------------------------------------------------


def sample_medium_interaction(scene, cfg, o, d, seg_end, medium_id, hero_idx,
                              sampler, beta, r_u, r_l, L, depth, active):
    """Delta tracking along [0, seg_end] of (o, d), all lanes in lockstep,
    with the per-lane majorant segment iterator (VolPathIntegrator's
    SampleT_maj callback, cpu/integrators.cpp:1022-1124)."""
    media = scene.media
    if len(media.grids) == 0 and len(media.procedurals) == 0:
        return _homogeneous_medium_interaction(
            scene, cfg, o, d, seg_end, medium_id, hero_idx, sampler, beta,
            r_u, r_l, L, depth, active)
    it = seg_init(media, medium_id, o, d, seg_end, active)
    t_min = it.t_seg_start
    T_maj = torch.ones_like(beta)
    scattered = torch.zeros_like(active)
    terminated = torch.zeros_like(active)
    t_scatter = torch.zeros_like(seg_end)
    g_scatter = torch.zeros_like(seg_end)
    vol_active = active & ~it.done
    n = 0
    while bool(vol_active.any()) and n < cfg.max_collisions:
        sigma_maj = it.sigma_maj
        maj_h = hero(sigma_maj, hero_idx)
        sampler, u_step = sampler.get_1d()
        t = torch.where(
            maj_h > 0,
            t_min + sample_exponential(u_step, torch.clamp(maj_h, min=1e-30)),
            INF)
        past = t >= it.t_seg_end

        # segment tail: accumulate T_maj, advance the iterator
        tail = vol_active & past
        dt_end = torch.clamp(it.t_seg_end - t_min, 0.0, 3e37)
        T_maj = _m(tail, T_maj * torch.exp(-dt_end[..., None] * sigma_maj),
                   T_maj)
        it = seg_next(media, medium_id, it, tail)
        t_min = torch.where(tail, it.t_seg_start, t_min)
        vol_active_new = vol_active & ~(tail & it.done)

        # tentative collision
        coll = vol_active & ~past
        T_maj = _m(coll, T_maj * torch.exp(-(t - t_min)[..., None] * sigma_maj),
                   T_maj)
        p = o + t[..., None] * d
        mp = media.sample_point(medium_id, p)

        # medium emission (integrators.cpp:1032-1046)
        T_maj_h = hero(T_maj, hero_idx)
        emit = coll & (depth < cfg.max_depth) & (_max3(mp.Le) > 0)
        pdf_e = torch.clamp(maj_h * T_maj_h, min=1e-30)[..., None]
        betap = beta * T_maj / pdf_e
        r_e = r_u * sigma_maj * T_maj / pdf_e
        r_e_avg = average(r_e)
        L_add = (betap * mp.sigma_a * mp.Le
                 / torch.clamp(r_e_avg, min=1e-30)[..., None])
        L = _m(emit & (r_e_avg > 0), L + L_add, L)

        # event probabilities at the hero channel
        sa_h = hero(mp.sigma_a, hero_idx)
        ss_h = hero(mp.sigma_s, hero_idx)
        p_absorb = sa_h / torch.clamp(maj_h, min=1e-30)
        p_scatter = ss_h / torch.clamp(maj_h, min=1e-30)
        sampler, um = sampler.get_1d()
        is_absorb = coll & (um < p_absorb)
        is_scatter = coll & ~is_absorb & (um < p_absorb + p_scatter)
        is_null = coll & ~is_absorb & ~is_scatter

        terminated = terminated | is_absorb
        vol_active_new = vol_active_new & ~is_absorb

        # real scatter (integrators.cpp:1064-1100)
        depth_exceeded = is_scatter & (depth >= cfg.max_depth)
        terminated = terminated | depth_exceeded
        do_scatter = is_scatter & ~depth_exceeded
        depth = torch.where(do_scatter, depth + 1, depth)
        pdf_s = T_maj_h * ss_h
        scale_s = T_maj * mp.sigma_s / torch.clamp(pdf_s, min=1e-30)[..., None]
        beta = _m(do_scatter, beta * scale_s, beta)
        r_u = _m(do_scatter, r_u * scale_s, r_u)
        scattered = scattered | do_scatter
        t_scatter = torch.where(do_scatter, t, t_scatter)
        g_scatter = torch.where(do_scatter, mp.g, g_scatter)
        vol_active_new = vol_active_new & ~is_scatter

        # null scatter (integrators.cpp:1102-1110)
        sigma_n = torch.clamp(sigma_maj - mp.sigma_a - mp.sigma_s, min=0.0)
        sn_h = hero(sigma_n, hero_idx)
        pdf_n = T_maj_h * sn_h
        zero_pdf = pdf_n == 0
        inv_pdf_n = (1.0 / torch.clamp(pdf_n, min=1e-30))[..., None]
        beta = _m(is_null, beta * T_maj * sigma_n * inv_pdf_n, beta)
        beta = _m(is_null & zero_pdf, torch.zeros_like(beta), beta)
        r_u = _m(is_null, r_u * T_maj * sigma_n * inv_pdf_n, r_u)
        r_l = _m(is_null, r_l * T_maj * sigma_maj * inv_pdf_n, r_l)
        died = is_null & ((_max3(beta) == 0) | (_max3(r_u) == 0))
        terminated = terminated | died
        vol_active_new = vol_active_new & ~died
        T_maj = _m(is_null & ~died, torch.ones_like(T_maj), T_maj)
        t_min = torch.where(is_null, t, t_min)
        vol_active = vol_active_new
        n += 1

    # final rescale for lanes that reached the segment end
    ran_to_end = active & ~scattered & ~terminated
    T_maj_h = torch.clamp(hero(T_maj, hero_idx), min=1e-30)
    scale = T_maj / T_maj_h[..., None]
    beta = _m(ran_to_end, beta * scale, beta)
    r_u = _m(ran_to_end, r_u * scale, r_u)
    r_l = _m(ran_to_end, r_l * scale, r_l)
    return MediumResult(sampler, beta, r_u, r_l, L, depth, scattered,
                        terminated, t_scatter, g_scatter)


def _homogeneous_medium_interaction(scene, cfg, o, d, seg_end, medium_id,
                                    hero_idx, sampler, beta, r_u, r_l, L,
                                    depth, active):
    """Closed-form single-step delta tracking for homogeneous-only scenes:
    the majorant equals sigma_t, so one exponential draw decides."""
    media = scene.media
    z = torch.zeros_like(seg_end)
    mp = media.sample_point(medium_id, o)  # constant within the medium
    sigma_maj = mp.sigma_a + mp.sigma_s
    maj_h = hero(sigma_maj, hero_idx)
    in_med = active & media.is_homogeneous(medium_id)
    seg = torch.where(torch.isfinite(seg_end), seg_end, 3e37)

    sampler, u_step = sampler.get_1d()
    t = torch.where(maj_h > 0,
                    sample_exponential(u_step, torch.clamp(maj_h, min=1e-30)),
                    INF)
    coll = in_med & (t < seg)

    # ran-to-end lanes: spectral rescale exp(-seg*(sigma - sigma_h))
    ran = in_med & ~coll
    T_end = torch.exp(-torch.clamp(seg, max=3e37)[..., None] * sigma_maj)
    T_end_h = torch.clamp(hero(T_end, hero_idx), min=1e-30)
    scale_end = T_end / T_end_h[..., None]
    beta = _m(ran, beta * scale_end, beta)
    r_u = _m(ran, r_u * scale_end, r_u)
    r_l = _m(ran, r_l * scale_end, r_l)

    # collision lanes
    T_maj = torch.exp(-t[..., None] * sigma_maj)
    T_maj_h = hero(T_maj, hero_idx)
    emit = coll & (depth < cfg.max_depth) & (_max3(mp.Le) > 0)
    pdf_e = torch.clamp(maj_h * T_maj_h, min=1e-30)[..., None]
    betap = beta * T_maj / pdf_e
    r_e = r_u * sigma_maj * T_maj / pdf_e
    r_e_avg = average(r_e)
    L = _m(emit & (r_e_avg > 0),
           L + betap * mp.sigma_a * mp.Le
           / torch.clamp(r_e_avg, min=1e-30)[..., None], L)

    sa_h = hero(mp.sigma_a, hero_idx)
    ss_h = hero(mp.sigma_s, hero_idx)
    sampler, um = sampler.get_1d()
    p_absorb = sa_h / torch.clamp(maj_h, min=1e-30)
    is_absorb = coll & (um < p_absorb)
    is_scatter = coll & ~is_absorb
    depth_exceeded = is_scatter & (depth >= cfg.max_depth)
    terminated = is_absorb | depth_exceeded
    do_scatter = is_scatter & ~depth_exceeded
    depth = torch.where(do_scatter, depth + 1, depth)
    pdf_s = torch.clamp(T_maj_h * ss_h, min=1e-30)
    scale_s = T_maj * mp.sigma_s / pdf_s[..., None]
    beta = _m(do_scatter, beta * scale_s, beta)
    r_u = _m(do_scatter, r_u * scale_s, r_u)
    return MediumResult(sampler, beta, r_u, r_l, L, depth, do_scatter,
                        terminated, torch.where(coll, t, z), mp.g)


# ---------------------------------------------------------------------------
# NEE with ratio-tracking transmittance (VolPath::SampleLd)
# ---------------------------------------------------------------------------


def transmittance_ratio_tracking(scene, cfg, o, wi, t_max, medium_start,
                                 hero_idx, sampler, active):
    """Spectral transmittance along a shadow ray with rescaled pdfs: walks
    interface segments (an opaque hit occludes) and ratio-tracks null
    collisions in each segment's medium (cpu/integrators.cpp:1374-1422).
    Returns (sampler, T_ray, r_l, r_u)."""
    T_ray = torch.ones_like(o)
    r_l = torch.ones_like(o)
    r_u = torch.ones_like(o)
    t_cur = torch.zeros_like(o[..., 0])
    med_id = medium_start
    seg_active = active
    homog_only = (len(scene.media.grids) == 0
                  and len(scene.media.procedurals) == 0)
    it = 0
    while bool(seg_active.any()) and it < cfg.max_shadow_segments:
        p_cur = o + t_cur[..., None] * wi
        rem = t_max - t_cur
        h = scene.geometry.intersect(p_cur, wi, rem)
        blocked = h.hit & (h.mat_id >= 0) & (h.t < rem)
        T_ray = _m(seg_active & blocked, torch.zeros_like(T_ray), T_ray)
        seg_len = torch.where(h.hit & (h.t < rem), h.t, rem)
        live = seg_active & ~blocked
        if homog_only:
            # analytic homogeneous transmittance: the ratio-tracking
            # expectation with zero variance and no collision loop
            mp_h = scene.media.sample_point(med_id, p_cur)
            in_m = live & scene.media.is_homogeneous(med_id)
            sl = torch.where(torch.isfinite(seg_len), seg_len, 0.0)
            T_seg = torch.exp(-sl[..., None] * (mp_h.sigma_a + mp_h.sigma_s))
            T_ray = _m(in_m, T_ray * T_seg, T_ray)
        else:
            sit = seg_init(scene.media, med_id, p_cur, wi, seg_len, live)
            t_min = sit.t_seg_start
            T_maj = torch.ones_like(T_ray)
            ca = live & ~sit.done
            cit = 0
            while bool(ca.any()) and cit < cfg.max_collisions:
                sigma_maj = sit.sigma_maj
                maj_h = hero(sigma_maj, hero_idx)
                sampler, u_step = sampler.get_1d()
                t = torch.where(
                    maj_h > 0,
                    t_min + sample_exponential(u_step,
                                               torch.clamp(maj_h, min=1e-30)),
                    INF)
                past = t >= sit.t_seg_end
                tail = ca & past
                dt_end = torch.clamp(sit.t_seg_end - t_min, 0.0, 3e37)
                T_maj = _m(tail,
                           T_maj * torch.exp(-dt_end[..., None] * sigma_maj),
                           T_maj)
                sit = seg_next(scene.media, med_id, sit, tail)
                t_min = torch.where(tail, sit.t_seg_start, t_min)
                ca_new = ca & ~(tail & sit.done)

                coll = ca & ~past
                T_maj = _m(coll, T_maj * torch.exp(-(t - t_min)[..., None]
                                                   * sigma_maj), T_maj)
                p = p_cur + t[..., None] * wi
                mp = scene.media.sample_point(med_id, p)
                sigma_n = torch.clamp(sigma_maj - mp.sigma_a - mp.sigma_s,
                                      min=0.0)
                T_maj_h = hero(T_maj, hero_idx)
                pdf = torch.clamp(T_maj_h * maj_h, min=1e-30)[..., None]
                T_ray = _m(coll, T_ray * T_maj * sigma_n / pdf, T_ray)
                r_l = _m(coll, r_l * T_maj * sigma_maj / pdf, r_l)
                r_u = _m(coll, r_u * T_maj * sigma_n / pdf, r_u)

                # transmittance russian roulette (integrators.cpp:1404-1412)
                Tr = T_ray / torch.clamp(average(r_l + r_u),
                                         min=1e-30)[..., None]
                low = coll & (_max3(Tr) < 0.05)
                sampler, u_rr = sampler.get_1d()
                killed = low & (u_rr < 0.75)
                T_ray = _m(killed, torch.zeros_like(T_ray), T_ray)
                T_ray = _m(low & ~killed, T_ray / 0.25, T_ray)

                dead = coll & (_max3(T_ray) == 0)
                ca = ca_new & ~dead
                T_maj = _m(coll & ~dead, torch.ones_like(T_maj), T_maj)
                t_min = torch.where(coll, t, t_min)
                cit += 1
            # final per-segment rescale (integrators.cpp:1416-1419)
            T_maj_h = torch.clamp(hero(T_maj, hero_idx), min=1e-30)
            scale = T_maj / T_maj_h[..., None]
            T_ray = _m(live, T_ray * scale, T_ray)
            r_l = _m(live, r_l * scale, r_l)
            r_u = _m(live, r_u * scale, r_u)

        # cross the interface: switch medium by crossing side
        crossing = live & h.hit & (h.t < rem)
        new_med = torch.where(dot(wi, h.n) < 0, h.med_in, h.med_out)
        med_id = torch.where(crossing, new_med, med_id)
        dead = _max3(T_ray) == 0
        t_cur = torch.where(live, t_cur + seg_len + 1e-4, t_cur)
        seg_active = live & ~dead & crossing & (t_cur < t_max)
        it += 1
    return sampler, T_ray, r_l, r_u


def _combine_ld(ls, f_hat, scatter_pdf, T_ray, tr_l, tr_u, r_p, beta, ok):
    """Final SampleLd contribution (integrators.cpp:1424-1433)."""
    p_l = ls.select_pmf * ls.pdf_dir
    r_l = tr_l * r_p * p_l[..., None]
    r_u = tr_u * r_p * scatter_pdf[..., None]
    denom = torch.where(ls.is_delta, average(r_l), average(r_l + r_u))
    contrib = (beta * f_hat * T_ray * ls.L
               / torch.clamp(denom, min=1e-30)[..., None])
    return torch.where((ok & (denom > 0))[..., None], contrib, 0.0)


def _local_ld(ls, f_hat, scatter_pdf, T_ray, tr_l, tr_u, ok):
    """The NEE estimate without the path prefix (beta, r_p = 1): what the
    training records take as scattered direct light (guiding.h:729)."""
    p_l = ls.select_pmf * ls.pdf_dir
    r_l = tr_l * p_l[..., None]
    r_u = tr_u * scatter_pdf[..., None]
    denom = torch.where(ls.is_delta, average(r_l), average(r_l + r_u))
    local = f_hat * T_ray * ls.L / torch.clamp(denom, min=1e-30)[..., None]
    return torch.where((ok & (denom > 0))[..., None], local, 0.0)


def sample_ld_volume(scene, cfg, p, wo, g, medium_id, hero_idx, sampler,
                     beta, r_p, active):
    """NEE from a medium scatter vertex (SampleLd with the phase function)."""
    sampler, u_sel = sampler.get_1d()
    sampler, u2 = sampler.get_2d()
    ls = scene.lights.sample(p, u_sel, u2)
    ok = active & ls.valid & (average(ls.L) > 0)
    f_scalar = henyey_greenstein(torch.sum(wo * ls.wi, dim=-1), g)
    f_hat = f_scalar[..., None] * torch.ones_like(beta)
    ok = ok & (f_scalar > 0)
    sampler, T_ray, tr_l, tr_u = transmittance_ratio_tracking(
        scene, cfg, p, ls.wi, ls.t_shadow, medium_id, hero_idx, sampler, ok)
    return sampler, _combine_ld(ls, f_hat, f_scalar, T_ray, tr_l, tr_u, r_p,
                                beta, ok)


def sample_ld_surface(scene, cfg, p, n_g, ns, wo_world, lanes, medium_id,
                      hero_idx, sampler, beta, r_p, active):
    """NEE from a surface vertex (SampleLd with the BSDF, evaluated in the
    shading frame)."""
    p_offset = offset_ray_origin(p, n_g, wo_world)
    sampler, u_sel = sampler.get_1d()
    sampler, u2 = sampler.get_2d()
    ls = scene.lights.sample(p_offset, u_sel, u2)
    ok = active & ls.valid & (average(ls.L) > 0)
    t1, t2 = shading_frame(ns)

    def to_local(w):
        return torch.stack([dot(w, t1), dot(w, t2), dot(w, ns)], -1)

    wo_l = to_local(wo_world)
    wi_l = to_local(ls.wi)
    f_hat = bsdf_f(lanes, wo_l, wi_l) * torch.abs(dot(ls.wi, ns))[..., None]
    scatter_pdf = bsdf_pdf(lanes, wo_l, wi_l)
    ok = ok & (_max3(f_hat) > 0)
    sampler, T_ray, tr_l, tr_u = transmittance_ratio_tracking(
        scene, cfg, p_offset, ls.wi, ls.t_shadow, medium_id, hero_idx,
        sampler, ok)
    return sampler, _combine_ld(ls, f_hat, scatter_pdf, T_ray, tr_l, tr_u,
                                r_p, beta, ok)


# ---------------------------------------------------------------------------
# Path state + bounce
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PathState:
    sampler: LaneSampler
    o: torch.Tensor  # (R,3)
    d: torch.Tensor  # (R,3) normalized
    beta: torch.Tensor  # (R,3)
    r_u: torch.Tensor  # (R,3)
    r_l: torch.Tensor  # (R,3)
    L: torch.Tensor  # (R,3)
    depth: torch.Tensor  # (R,) int32
    alive: torch.Tensor  # (R,) bool
    specular: torch.Tensor  # (R,) bool
    hero_idx: torch.Tensor  # (R,) int64
    medium_id: torch.Tensor  # (R,) int32, -1 = vacuum
    eta_scale: torch.Tensor  # (R,)
    prev_p: torch.Tensor  # (R,3) previous scattering vertex


def make_path_state(sampler, o, d, hero_idx, medium_id, pixel_like):
    """Fresh path state for the lanes of `pixel_like`."""
    ones = torch.ones_like(o)
    return PathState(
        sampler=sampler, o=o, d=d, beta=ones, r_u=ones, r_l=ones,
        L=torch.zeros_like(o), depth=torch.zeros_like(pixel_like),
        alive=pixel_like >= 0, specular=pixel_like < 0, hero_idx=hero_idx,
        medium_id=medium_id, eta_scale=torch.ones_like(o[..., 0]),
        prev_p=torch.zeros_like(o))


def volpath_bounce(scene: Scene, cfg: VolPathConfig, s: PathState) -> PathState:
    """One path event for every lane: medium flight, NEE + phase sampling at
    real scatters, escape with env MIS, interface skips, RR."""
    t_far = torch.full_like(s.o[..., 0], INF)
    h = scene.geometry.intersect(s.o, s.d, t_far)
    seg_end = torch.where(h.hit, h.t, INF)

    # ---- medium flight ------------------------------------------------------
    in_medium = s.alive & (s.medium_id >= 0)
    mr = sample_medium_interaction(
        scene, cfg, s.o, s.d, seg_end, s.medium_id, s.hero_idx, s.sampler,
        s.beta, s.r_u, s.r_l, s.L, s.depth, in_medium)
    sampler, beta, r_u, r_l, L, depth = (mr.sampler, mr.beta, mr.r_u, mr.r_l,
                                         mr.L, mr.depth)
    alive = s.alive & ~mr.terminated

    # ---- real-scatter lanes: NEE + phase sample ----------------------------
    scat = mr.scattered & alive
    p_scat = s.o + mr.t_scatter[..., None] * s.d
    wo = -s.d
    sampler, Ld = sample_ld_volume(scene, cfg, p_scat, wo, mr.g_scatter,
                                   s.medium_id, s.hero_idx, sampler, beta,
                                   r_u, scat)
    L = _m(scat, L + Ld, L)
    sampler, u2 = sampler.get_2d()
    wi_p, phase_pdf = sample_henyey_greenstein(wo, mr.g_scatter, u2)
    alive = alive & ~(scat & (phase_pdf <= 0))
    r_l = _m(scat, r_u / torch.clamp(phase_pdf, min=1e-30)[..., None], r_l)
    o_new = _m(scat, p_scat, s.o)
    d_new = _m(scat, wi_p, s.d)
    specular = torch.where(scat, False, s.specular)
    prev_p = _m(scat, p_scat, s.prev_p)

    # ---- non-scattered lanes: escape / surface -----------------------------
    flew = alive & ~scat
    escaped = flew & ~h.hit
    Le_env = scene.lights.le_escaped(s.d, s.o)
    any_env = average(Le_env) > 0
    first = (s.depth == 0) | s.specular
    no_mis = escaped & first & any_env
    L = _m(no_mis, L + beta * Le_env
           / torch.clamp(average(r_u), min=1e-30)[..., None], L)
    with_mis = escaped & ~first & any_env
    r_l_esc = r_l * scene.lights.pdf_li_escaped(s.d, s.prev_p)[..., None]
    denom_esc = torch.clamp(average(r_u + r_l_esc), min=1e-30)
    L = _m(with_mis, L + beta * Le_env / denom_esc[..., None], L)
    alive = alive & ~escaped

    surf = flew & h.hit

    # emissive surface hit (integrators.cpp:1146-1160): no MIS on the first
    # or a specular bounce, else against the light sampler's pdf of the hit
    if scene.lights.n_area:
        emissive = surf & (h.light_id >= 0)
        Le_surf = scene.lights.le_area(h.light_id, -s.d, h.n)
        has_le = average(Le_surf) > 0
        no_mis_s = emissive & first & has_le
        L = _m(no_mis_s, L + beta * Le_surf
               / torch.clamp(average(r_u), min=1e-30)[..., None], L)
        with_mis_s = emissive & ~first & has_le
        p_l_area = scene.lights.pdf_li_area(h.light_id, s.prev_p, h.p, h.n)
        r_l_area = r_l * p_l_area[..., None]
        denom_s = torch.clamp(average(r_u + r_l_area), min=1e-30)
        L = _m(with_mis_s, L + beta * Le_surf / denom_s[..., None], L)

    # interface-only surfaces: skip through, switch medium
    # (integrators.cpp:1168-1171 SkipIntersection + SpawnRay medium logic)
    iface = surf & (h.mat_id < 0)
    new_med_skip = torch.where(dot(s.d, h.n) < 0, h.med_in, h.med_out)
    medium_id = torch.where(iface, new_med_skip, s.medium_id)
    o_new = _m(iface, h.p + 1e-4 * s.d, o_new)

    # ---- surface shading: NEE + BSDF sampling -----------------------------
    shade = surf & (h.mat_id >= 0)
    depth_hit = shade & (s.depth >= cfg.max_depth)
    alive = alive & ~depth_hit
    shade = shade & ~depth_hit
    eta_scale = s.eta_scale
    if not bool(shade.any()):
        # the JAX bounce draws the subsurface split (four 1D, with
        # cfg.sss), the surface NEE (1D + 2D) and the BSDF sample (1D +
        # 2D) for every lane; with no shaded lane they only advance the
        # dimension counter
        sampler = sampler.advance(8 if cfg.sss else 4)
    else:
        depth = torch.where(shade, depth + 1, depth)
        lanes = scene.materials.gather_textured(scene.textures, h.mat_id,
                                                h.uv, h.p)
        ns = face_forward(h.ns, h.n)  # shading normal on the geometric side
        hp, hn = h.p, h.n
        if cfg.sss:
            sampler, beta, alive, shade, lanes, hp, hn, ns = _subsurface(
                scene, s, h, sampler, beta, alive, shade, lanes, ns)
        can_nee = shade & ~lanes.is_specular
        sampler, Ld_s = sample_ld_surface(scene, cfg, hp, hn, ns, -s.d,
                                          lanes, medium_id, s.hero_idx,
                                          sampler, beta, r_u, can_nee)
        L = _m(can_nee, L + Ld_s, L)

        t1, t2 = shading_frame(ns)
        wo_l = torch.stack([dot(-s.d, t1), dot(-s.d, t2), dot(-s.d, ns)], -1)
        sampler, u_lobe = sampler.get_1d()
        sampler, u2b = sampler.get_2d()
        bs = bsdf_sample(lanes, wo_l, u_lobe, u2b)
        bs_ok = shade & bs.valid & (bs.pdf > 0)
        alive = alive & ~(shade & ~bs_ok)
        wi_world = normalize(bs.wi[..., 0:1] * t1 + bs.wi[..., 1:2] * t2
                             + bs.wi[..., 2:3] * ns)
        cos_wi = torch.abs(dot(wi_world, ns))
        scale_b = (bs.f * cos_wi[..., None]
                   / torch.clamp(bs.pdf, min=1e-30)[..., None])
        beta = _m(bs_ok, beta * scale_b, beta)
        r_l = _m(bs_ok, r_u / torch.clamp(bs.pdf, min=1e-30)[..., None], r_l)
        specular = torch.where(bs_ok, bs.is_specular, specular)
        eta_scale = torch.where(bs_ok & bs.is_transmission,
                                s.eta_scale * bs.eta * bs.eta, s.eta_scale)
        # a reflected ray keeps its medium: only a true crossing (wi on the
        # far side of the arrival direction) adopts the far side's label, so
        # that a reflection off an inward-wound face cannot tunnel into the
        # medium behind it (interaction.h SpawnRay)
        wi_front = dot(wi_world, hn) > 0
        crossed = bs_ok & (wi_front != (dot(s.d, hn) < 0))
        medium_id = torch.where(crossed, torch.where(wi_front, h.med_out,
                                                     h.med_in), medium_id)
        o_new = _m(bs_ok, offset_ray_origin(hp, hn, wi_world), o_new)
        d_new = _m(bs_ok, wi_world, d_new)
        prev_p = _m(bs_ok, hp, prev_p)

    # ---- Russian roulette (integrators.cpp:1301-1312) ----------------------
    alive = alive & ~(shade & (_max3(beta) == 0))
    rr_beta = (beta * eta_scale[..., None]
               / torch.clamp(average(r_u), min=1e-30)[..., None])
    rr_max = _max3(rr_beta)
    sampler, u_rr = sampler.get_1d()
    do_rr = (shade | scat) & (rr_max < 1.0) & (depth >= cfg.rr_start_depth)
    q = torch.clamp(1.0 - rr_max, min=0.0)
    rr_kill = do_rr & (u_rr < q)
    alive = alive & ~rr_kill
    beta = _m(do_rr & ~rr_kill,
              beta / torch.clamp(1.0 - q, min=1e-6)[..., None], beta)

    return PathState(sampler, o_new, d_new, beta, r_u, r_l, L, depth, alive,
                     specular, s.hero_idx, medium_id, eta_scale, prev_p)


def _subsurface(scene, s, h, sampler, beta, alive, shade, lanes, ns):
    """The subsurface branch of the bounce (cfg.sss; bssrdf.h
    SeparableBSSRDF as ``models/bssrdf.py`` redesigns it): a Fresnel split
    of the SUBSURFACE lanes into the interface's mirror and the
    transmitted lanes, which a probe ray relocates to their exit point and
    which leave through a Lambertian lobe. A transmitted lane whose probe
    finds no exit dies. Draws u_fr, u_r1, u_r2 and u_phi for every lane,
    as the JAX bounce. Returns (sampler, beta, alive, shade, lanes, the
    shading point, its geometric and shading normals)."""
    from ..bssrdf import sample_exit_point, sp_weight
    from ..materials import (CONDUCTOR, DIFFUSE, SUBSURFACE,
                             fresnel_dielectric)

    is_sss = shade & (lanes.mat_type == SUBSURFACE)
    t1s, t2s = shading_frame(ns)
    sampler, u_fr = sampler.get_1d()
    F_in = fresnel_dielectric(torch.abs(dot(-s.d, ns)), lanes.eta)
    sss_refl = is_sss & (u_fr < F_in)  # the interface's reflection lobe
    sss_trans = is_sss & ~sss_refl
    sampler, u_r1 = sampler.get_1d()
    sampler, u_r2 = sampler.get_1d()
    sampler, u_phi = sampler.get_1d()
    mid = torch.clamp(h.mat_id, min=0).long()
    d_mfp = scene.materials.albedo2[mid]
    sss_ok, p_x, n_x, r_s, cos_x = sample_exit_point(
        scene.geometry, h.p, ns, t1s, t2s, h.mat_id, torch.mean(d_mfp, -1),
        u_r1, u_r2, u_phi, sss_trans)
    w_sp = sp_weight(h.p, p_x, scene.materials.albedo[mid], d_mfp, r_s,
                     cos_x)
    dead_sss = sss_trans & ~sss_ok
    relocated = sss_trans & sss_ok
    beta = _m(relocated, beta * w_sp, beta)
    # transmitted lanes leave through a Lambertian lobe (Sw integrates to
    # one over the hemisphere); reflected lanes become a perfect mirror
    lanes = lanes._replace(
        mat_type=torch.where(sss_refl, CONDUCTOR, torch.where(
            relocated, DIFFUSE, lanes.mat_type)).to(lanes.mat_type.dtype),
        albedo=torch.where(is_sss[..., None], 1.0, lanes.albedo),
        roughness=torch.where(is_sss, 0.0, lanes.roughness))
    return (sampler, beta, alive & ~dead_sss, shade & ~dead_sss, lanes,
            _m(relocated, p_x, h.p), _m(relocated, n_x, h.n),
            _m(relocated, n_x, ns))


# ---------------------------------------------------------------------------
# Camera paths, the pass loops and the persistent wavefront
# ---------------------------------------------------------------------------


def trace_paths(scene, cfg, s: PathState) -> PathState:
    """Run the bounce loop until every lane dies (or max_events)."""
    it = 0
    while bool(s.alive.any()) and it < cfg.max_events:
        s = volpath_bounce(scene, cfg, s)
        it += 1
    return s


def start_camera_paths(camera, film, seed, sample_index, pixel_id,
                       camera_medium, sampler_kind="independent", spp=0):
    """Primary rays + fresh path state for the given pixel lanes, their
    sampler of `sampler_kind` (`spp` its samples a pixel, where the kind
    stratifies over them). A lens system's ray weight multiplies the
    throughput, and a vignetted ray starts dead."""
    pix = pixel_coords(film.resolution, device=pixel_id.device)[pixel_id]
    sampler = LaneSampler.start(seed, pixel_id, sample_index,
                                kind=sampler_kind, spp=spp,
                                nx=film.resolution[0])
    sampler, u_pix = sampler.get_2d()
    offset, filter_w = film.filter.sample(u_pix)
    p_raster = pix.to(torch.float32) + 0.5 + offset
    sampler, u_lens = sampler.get_2d()
    rays = camera.generate_rays(p_raster, u_lens)
    o, d = rays[:2]
    sampler, u_wl = sampler.get_1d()
    hero_idx = sample_hero_channel(u_wl)
    med0 = torch.full(pixel_id.shape, camera_medium, dtype=torch.int32,
                      device=pixel_id.device)
    state = make_path_state(sampler, o, d, hero_idx, med0,
                            pixel_id.to(torch.int32))
    if len(rays) == 3:  # lens-system cameras return a radiance weight
        cam_w = rays[2]
        state = replace(state, beta=state.beta * cam_w[..., None],
                        alive=state.alive & (cam_w > 0))
    return state, filter_w


def render_wave(scene, camera, film, film_state, cfg, seed, sample_index,
                camera_medium=-1):
    """Trace one 1-spp wave over all pixels and add it to the film."""
    pixel_id = torch.arange(film.npix, device=film.device)
    s, fw = start_camera_paths(camera, film, int(seed) & 0xFFFFFFFF,
                               torch.full_like(pixel_id, int(sample_index)),
                               pixel_id, int(camera_medium))
    s = trace_paths(scene, cfg, s)
    return film.add_pass(film_state, s.L, fw)


def render_pass(scene, camera, film, film_state, cfg, seed, wave_idx,
                camera_medium, spp_per_pass, sampler_kind="independent",
                sampler_spp=0):
    """One pass of spp_per_pass samples a pixel added to film_state, on the
    film's device: lane l renders pixel l // spp_per_pass, sample
    wave_idx * spp_per_pass + l % spp_per_pass (the JAX package's random
    streams), drawn by a sampler of `sampler_kind` stratifying over
    `sampler_spp` samples a pixel. Returns (film_state, the traced
    PathState)."""
    lane = torch.arange(film.npix * spp_per_pass, device=film.device)
    pixel_id = lane // spp_per_pass
    sample_index = int(wave_idx) * spp_per_pass + lane % spp_per_pass
    s, fw = start_camera_paths(camera, film, int(seed) & 0xFFFFFFFF,
                               sample_index, pixel_id, int(camera_medium),
                               sampler_kind, int(sampler_spp))
    s = trace_paths(scene, cfg, s)
    return film.add_pass(film_state, s.L, fw), s


def render_progressive(scene, camera, film, cfg=VolPathConfig(), seed=0,
                       camera_medium=-1, spp_per_pass=4, max_spp=1 << 16,
                       time_budget=None, sampler="independent",
                       wave_callback=None, resume_state=None, *,
                       device="cuda"):
    """Pass loop on `device` with a time budget (--time): returns (image,
    spp rendered, FilmState). wave_callback(wave, spp_done, image_fn) runs
    after every pass; resume_state (FilmState, spp_done) continues an
    interrupted render from ``utils.checkpoint``. `sampler` names the
    sampler's kind (its passes stratify over no fixed sample count, as the
    JAX package's)."""
    import time as _time

    scene, camera, film = scene.to(device), camera.to(device), film.to(device)
    t0 = _time.perf_counter()
    if resume_state is not None:
        state, spp_done = resume_state
        state = type(state)(*(x.to(film.device) for x in state))
        wave = spp_done // spp_per_pass
    else:
        state, spp_done, wave = film.init_state(), 0, 0
    while spp_done < max_spp:
        state, _ = render_pass(scene, camera, film, state, cfg, seed, wave,
                               camera_medium, spp_per_pass, sampler)
        spp_done += spp_per_pass
        wave += 1
        if wave_callback is not None:
            wave_callback(wave, spp_done,
                          lambda: film.image(state).cpu().numpy())
        if time_budget is not None:
            float(state.weight_sum[0])  # wait for the pass before the clock
            if _time.perf_counter() - t0 > time_budget:
                break
    return film.image(state), spp_done, state


def render(scene: Scene, camera, film, spp=16, cfg=VolPathConfig(), seed=0,
           camera_medium=-1, spp_per_pass=None, sampler="independent", *,
           device="cuda"):
    """Render on `device` through the lockstep wavefront, spp_per_pass
    samples a pixel a pass (default min(spp, 8)), the JAX package's
    ``render``; returns the (ny, nx, 3) image. `sampler` names the
    sampler's kind: independent, stratified, halton, sobol, paddedsobol,
    zsobol, pmj02bn (stratifying over the spp samples)."""
    if spp_per_pass is None:
        spp_per_pass = min(spp, 8)
    if spp % spp_per_pass:
        raise ValueError(f"spp {spp} is not a multiple of spp_per_pass "
                         f"{spp_per_pass}")
    if cfg.spectral:
        raise NotImplementedError("the spectral mode is not ported yet")
    scene, camera, film = scene.to(device), camera.to(device), film.to(device)
    state = film.init_state()
    for i in range(spp // spp_per_pass):
        state, _ = render_pass(scene, camera, film, state, cfg, seed, i,
                               camera_medium, spp_per_pass, sampler, spp)
    return film.image(state)


def make_fog_box_scene(sigma_a, sigma_s, g=0.0, Le=None, env_L=None,
                       point=None, box=((-1, -1, -1), (1, 1, 1)),
                       world_radius=100.0, *, device):
    """A homogeneous medium in a box interface, lit by an optional point
    light ((position, intensity)) and an optional constant environment."""
    media = HomogeneousMedia.make([sigma_a], [sigma_s],
                                  Le=None if Le is None else [Le], g=[g],
                                  device=device)
    lights = Lights.make(
        point_p=None if point is None else [point[0]],
        point_I=None if point is None else [point[1]],
        env_L=env_L, world_radius=world_radius, device=device)
    geom = Geometry.build(boxes=[dict(bmin=box[0], bmax=box[1], mat=-1,
                                      light=-1, med_in=0, med_out=-1)],
                          device=device)
    return Scene(geom, Materials.build([], device=device), media, lights)


def make_cornell_box_scene(Le=12.0, *, device):
    """The classic Cornell box (a surface-only scene): white floor, ceiling
    and back wall, red left and green right wall, and a ceiling area light
    of two triangles facing down. The interior is x, z in [-1, 1], y in
    [0, 2]; the camera looks from +z."""

    def quad(p00, p10, p11, p01, mat, light=-1):
        return [dict(p0=p00, p1=p10, p2=p11, mat=mat, light=light),
                dict(p0=p00, p1=p11, p2=p01, mat=mat, light=light)]

    white, red, green = 0, 1, 2
    tris = []
    tris += quad((-1, 0, -1), (1, 0, -1), (1, 0, 1), (-1, 0, 1), white)
    tris += quad((-1, 2, 1), (1, 2, 1), (1, 2, -1), (-1, 2, -1), white)
    tris += quad((-1, 0, -1), (1, 0, -1), (1, 2, -1), (-1, 2, -1), white)
    tris += quad((-1, 0, -1), (-1, 0, 1), (-1, 2, 1), (-1, 2, -1), red)
    tris += quad((1, 0, 1), (1, 0, -1), (1, 2, -1), (1, 2, 1), green)
    lq = [(-0.35, 1.99, -0.35), (0.35, 1.99, -0.35),
          (0.35, 1.99, 0.35), (-0.35, 1.99, 0.35)]
    lt = [dict(p0=lq[0], p1=lq[1], p2=lq[3], mat=white, light=0),
          dict(p0=lq[1], p1=lq[2], p2=lq[3], mat=white, light=1)]
    tris += lt
    geom = Geometry.build(triangles=tris, device=device)
    mats = Materials.build([
        dict(type=0, albedo=(0.73, 0.73, 0.73)),
        dict(type=0, albedo=(0.65, 0.05, 0.05)),
        dict(type=0, albedo=(0.12, 0.45, 0.15)),
    ], device=device)
    area = [dict(p0=t["p0"], p1=t["p1"], p2=t["p2"], L=(Le,) * 3)
            for t in lt]
    return Scene(geom, mats, Media.make(device=device),
                 Lights.make(area_tris=area, device=device))


def _select(mask, new, old):
    """Per-lane select over a PathState (the sampler's seed is shared)."""
    fields = {}
    for k in ("o", "d", "beta", "r_u", "r_l", "L", "depth", "alive",
              "specular", "hero_idx", "medium_id", "eta_scale", "prev_p"):
        fields[k] = _m(mask, getattr(new, k), getattr(old, k))
    smp = replace(old.sampler,
                  pixel_id=torch.where(mask, new.sampler.pixel_id,
                                       old.sampler.pixel_id),
                  sample_index=torch.where(mask, new.sampler.sample_index,
                                           old.sampler.sample_index),
                  dim=torch.where(mask, new.sampler.dim, old.sampler.dim))
    return PathState(sampler=smp, **fields)


def render_persistent_wavefront(scene, camera, film, cfg, spp, seed,
                                camera_medium, n_lanes):
    """Persistent-wavefront render (``_render_persistent_jit`` of the JAX
    package): R lanes stay busy; when a path dies its radiance is committed
    and the lane restarts the next (pixel, sample) from a global counter,
    assigned in lane order by an exclusive cumsum over the dead lanes."""
    dev = film.device
    R = n_lanes
    npix = film.npix
    total = npix * spp

    def fresh(global_id, active):
        pixel_id = global_id % npix
        sample_index = global_id // npix
        s, fw = start_camera_paths(camera, film, seed, sample_index, pixel_id,
                                   camera_medium)
        return replace(s, alive=s.alive & active), pixel_id, fw

    gid0 = torch.arange(R, dtype=torch.int64, device=dev)
    s, pixel_id, fw = fresh(gid0, gid0 < total)
    next_ctr = min(R, total)
    film_state = film.init_state()
    it = 0
    while bool(s.alive.any()) and it < spp * cfg.max_events:
        was_alive = s.alive
        s = volpath_bounce(scene, cfg, s)
        died = was_alive & ~s.alive
        film_state = film.add_samples(
            film_state, torch.where(died, pixel_id, 0),
            torch.where(died[..., None], s.L, 0.0),
            torch.where(died, fw, 0.0))
        died_i = died.long()
        rank = torch.cumsum(died_i, 0) - died_i
        new_gid = next_ctr + rank
        has_budget = died & (new_gid < total)
        s2, pixel2, fw2 = fresh(new_gid, has_budget)
        s = _select(has_budget, s2, s)
        pixel_id = torch.where(has_budget, pixel2, pixel_id)
        fw = torch.where(has_budget, fw2, fw)
        next_ctr = min(next_ctr + int(died_i.sum()), total)
        it += 1
    return film.image(film_state)


def render_persistent(scene: Scene, camera, film, spp=16,
                      cfg=VolPathConfig(), seed=0, camera_medium=-1,
                      lanes_per_pixel=2, backend="auto", *, device="cuda"):
    """Persistent render on `device` with the "independent" sampler;
    returns the (ny, nx, 3) image.

    backend "auto" renders with a kernel when the scene is of its class and
    the camera starts in vacuum, in the JAX package's order: first the
    kernels of ``ops/volpath_kernels`` (one box of homogeneous fog or of
    one density grid, with the teaser's triangles or a mesh of up to
    16384, a pinhole camera, point/env lights), then the vacuum surface
    kernel of ``ops/surface_kernels`` (the Cornell class: at most 128 flat
    diffuse triangles, area, point and env lights, no media). On a card a
    kernel that fails to build or launch raises. Otherwise, and with
    backend "torch", it runs the lockstep wavefront of this module with a
    pool of npix * lanes_per_pixel lanes. `lanes_per_pixel` sizes that
    pool only: a kernel sizes its own work items."""
    if backend not in ("auto", "torch"):
        raise ValueError(f"unknown backend {backend!r}")
    if cfg.spectral:
        raise NotImplementedError("the spectral mode is not ported yet")
    scene, camera, film = scene.to(device), camera.to(device), film.to(device)
    if backend == "auto" and camera_medium == -1:
        from ...ops import surface_kernels as _sk
        from ...ops import volpath_kernels as _vk

        c = _vk.extract_constants(scene, camera, film, cfg)
        if c is not None:
            return _vk.render(c, int(spp), seed)
        c = _sk.extract_constants(scene, camera, film, cfg)
        if c is not None and _sk.npix_supported(c):
            return _sk.render_surface(c, int(spp), seed)
    R = film.npix * max(int(lanes_per_pixel), 1)
    return render_persistent_wavefront(scene, camera, film, cfg, int(spp),
                                       int(seed) & 0xFFFFFFFF,
                                       int(camera_medium), R)
