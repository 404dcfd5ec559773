"""GuidedVolPathVSPG, volume scattering probability guiding (counterpart of
``models/integrators/vspg.py``).

``render_vspg`` renders progressively: training waves, after each of which
the ISGB takes the wave's samples, the recorded path segments are
propagated into training samples and, when they carry enough weight,
train the field; the ISGB is denoised at waves 1, 2, 4, 8, ... (by the
à-trous filter or the U-Net, ``VSPGOptions.denoiser``, on either route).
Once training is over the remaining samples render with the field and the
ISGB frozen. The result mixes the parts by their sample counts. Each part
takes one of two routes, where the JAX package takes the same:

- the VSPG kernel (``ops/vspg_kernels``): a training wave of one sample
  per pixel through its record variant when the scene is of the kernel's
  class, ``spp_per_pass == 1`` and the method is not NDS+; the frozen
  render through its render variant in one launch (NDS+ with the
  TrBuffer as extra ISGB rows);
- the torch wave ``vspg_wave`` (the JAX package's XLA wave, lane for lane
  on the same random stream): every other wave, every wave of a scene
  outside the kernel's class, and every wave under ``backend="torch"``.
  Under NDS+ its primary-ray transmittance estimates keep the TrBuffer, a
  running mean over the waves.

The distance samplers of the wave (``sample_distance_vspg``) cover the
homogeneous closed form (VSP-warped or plain), delta tracking, the
resampling route and NDS/NDS+ optical-depth-space sampling. At a surface
with a material the wave takes NEE with the BSDF, the guided BSDF draw
from the field's surface half and guided surface roulette (the teaser
class: the materials of ``models/materials.py``). It intersects through
the geometry's BVH above 64 triangles (the mesh class), and adds the
emission of a triangle area light it hits, with MIS against the light's
NEE after the first hit; both stay outside the kernel's class.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...ops import vspg_kernels as vk
from ...ops.intersect import offset_ray_origin
from ...utils.sampling import (henyey_greenstein, sample_exponential,
                               sample_henyey_greenstein)
from ...utils.spectrum import average, hero
from ...utils.vecmath import coordinate_system, dot, face_forward, normalize
from ..guiding import field as gfield
from ..guiding import isgb as gisgb
from ..guiding import recording as grec
from ..guiding.field import GuidingField
from ..guiding.isgb import ISGB
from ..guiding.recording import SegmentRecord
from ..materials import bsdf_f, bsdf_pdf, bsdf_sample
from ..media import seg_init, seg_next
from . import guided_volpath as gv
from .guided_volpath import GuidingOptions, _guided_sample, _scene_field, _to3
from .volpath import (INF, PathState, VolPathConfig, _combine_ld, _local_ld,
                      _m, _max3, start_camera_paths,
                      transmittance_ratio_tracking)


class VSPGOptions(NamedTuple):
    """Scene-file parameters of the integrator (vspguiding,
    vspprimaryguiding, vspsecondaryguiding, vspsamplingmethod, vspmisratio,
    vspcriterion, guidedrr, ...). The JAX package's ``calculate_tr_buffer``
    has no effect there and is not carried: the TrBuffer is kept under
    NDS+."""

    guide_vsp: bool = True
    guide_primary_vsp: bool = True
    guide_secondary_vsp: bool = True
    sampling_method: str = "resampling"  # "resampling" | "nds" | "nds+"
    vsp_mis_ratio: float = 0.5
    vsp_criterion: str = "variance"  # "variance" | "contribution"
    guide_rr: bool = True
    min_rr_depth: int = 1
    # the guided walk's majorant is scaled only up to -log(1 - cap)
    # expected collisions per segment (importance only: unbiased)
    scale_vsp_cap: float = 0.95
    denoiser: str = "atrous"  # ISGB denoiser: "atrous" | "unet"
    isgb_update_waves: tuple = (1, 2, 4, 8, 16, 32, 64, 128)


class VState(NamedTuple):
    s: PathState
    rec: SegmentRecord
    pixel_id: torch.Tensor  # (R,)
    last_vol: torch.Tensor  # (R,) was the previous vertex a volume vertex
    first_set: torch.Tensor  # (R,) ISGB first-event recorded
    first_vol: torch.Tensor  # (R,)
    first_albedo: torch.Tensor  # (R,3)
    first_normal: torch.Tensor  # (R,3)
    tr_est: torch.Tensor  # (R,3) primary ratio-tracking transmittance
    tr_prev: torch.Tensor  # (R,3) previous waves' TrBuffer (NDS+ input)


class DistanceResult(NamedTuple):
    sampler: object
    beta: torch.Tensor
    r_u: torch.Tensor
    r_l: torch.Tensor
    L: torch.Tensor
    scattered: torch.Tensor
    terminated: torch.Tensor
    t_scatter: torch.Tensor
    g_scatter: torch.Tensor
    albedo_scatter: torch.Tensor  # (R,3) single-scattering albedo
    tr_est: torch.Tensor  # (R,3) ratio-tracking transmittance estimate


def _fdiv(x, s):
    """x / s for a Python number s, rounded once as JAX divides (PyTorch
    multiplies by the reciprocal of a Python divisor)."""
    return x / torch.tensor(s, dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# VSP target lookup
# ---------------------------------------------------------------------------


def lookup_vsp(vopt: VSPGOptions, field: GuidingField, isgb: ISGB, s,
               pixel_id, last_vol):
    """Per-lane (guide, target VSP clipped to [0.001, 0.999]); guide is
    False where no estimate exists."""
    primary = s.depth == 0
    vsp = torch.full_like(s.o[..., 0], -1.0)
    if vopt.guide_vsp and vopt.guide_primary_vsp:
        vsp = torch.where(primary, gisgb.isgb_primary_vsp(isgb, pixel_id),
                          vsp)
    if vopt.guide_vsp and vopt.guide_secondary_vsp and field.trained:
        # the field half of the previous vertex's type at the ray origin,
        # queried along the ray (VolumeScatterProbability(wi))
        var = vopt.vsp_criterion == "variance"
        d_vol = gfield._gather_half(field, field.volume, s.o, var)
        d_srf = gfield._gather_half(field, field.surface, s.o, var)
        v_sec = torch.where(last_vol,
                            gfield.dist_vsp_directional(d_vol, s.d),
                            gfield.dist_vsp_directional(d_srf, s.d))
        vsp = torch.where(~primary, v_sec, vsp)
    return vsp >= 0.0, torch.clamp(vsp, 0.001, 0.999)


# ---------------------------------------------------------------------------
# Distance sampling: homogeneous closed form, delta, resampling, NDS/NDS+
# ---------------------------------------------------------------------------


def sample_distance_vspg(scene, cfg, vopt, o, d, seg_end, medium_id, hero_idx,
                         sampler, beta, r_u, r_l, L, guide, vsp, active,
                         tr_prev=None, depth=None):
    """The paper's SampleDistance over the lane classes: homogeneous
    (closed form, VSP-warped where guided), heterogeneous delta tracking
    (unguided lanes and NDS fallbacks), resampling (guided lanes,
    "resampling") and NDS/NDS+ (guided lanes, "nds"/"nds+"). Absorption
    free: a real collision always scatters, the albedo folded into beta.
    The draws follow the JAX package's order for every lane."""
    media = scene.media
    is_h = media.is_homogeneous(medium_id) & active
    mis = float(vopt.vsp_mis_ratio)

    scattered = torch.zeros_like(active)
    terminated = torch.zeros_like(active)
    t_scatter = torch.zeros_like(seg_end)
    g_scatter = torch.zeros_like(seg_end)
    albedo_sc = torch.zeros_like(beta)
    tr_est = torch.ones_like(beta)

    # ======== homogeneous lanes: closed form ================================
    mp0 = media.sample_point(medium_id, o)  # constant within the medium
    sigma_t = mp0.sigma_a + mp0.sigma_s
    sig_h = hero(sigma_t, hero_idx)
    h_act = is_h & (sig_h > 0) & torch.isfinite(seg_end)
    t_v = sig_h * torch.clamp(seg_end, max=3e37)
    norm_maj = sigma_t / torch.clamp(sig_h, min=1e-30)[..., None]

    sampler, u0 = sampler.get_1d()
    h_guide = h_act & guide
    delta_lane = ~h_guide | (u0 > mis)
    u_r = torch.where(
        h_guide,
        torch.where(delta_lane, _fdiv(u0 - mis, max(1 - mis, 1e-6)),
                    _fdiv(u0, max(mis, 1e-6))),
        u0)
    u_r = torch.clamp(u_r, 0.0, 0.999999)
    one_m_e = 1.0 - torch.exp(-t_v)
    # warped lanes: P(scatter) = vsp
    warp_scatter = u_r < vsp
    dist_w = -torch.log1p(-torch.where(warp_scatter, u_r, 0.0) * one_m_e
                          / torch.clamp(vsp, min=1e-4))
    dist_w = torch.where(warp_scatter, dist_w, INF)
    # delta lanes: the plain exponential in optical depth
    dist_d = -torch.log1p(-u_r)
    dist_tau = torch.where(delta_lane, dist_d, dist_w)
    h_scatter = h_act & (dist_tau < t_v - 1e-5)
    h_pass = h_act & ~h_scatter

    # tpScaleFactor and the one-sample MIS factor r_u_factor
    tp_sc = (one_m_e[..., None] * torch.ones_like(beta)
             / torch.clamp(vsp, min=1e-4)[..., None])
    tp_pa = (torch.exp(-t_v[..., None] * norm_maj)
             / torch.clamp(1 - vsp, min=1e-4)[..., None])
    tp = torch.where(h_scatter[..., None], tp_sc, tp_pa)
    r_u_factor = torch.where(h_guide[..., None],
                             mis / torch.clamp(tp, min=1e-30) + (1.0 - mis),
                             torch.ones_like(tp))

    t_h = dist_tau / torch.clamp(sig_h, min=1e-30)
    T_spec = torch.exp(-torch.clamp(dist_tau, 0.0, 80.0)[..., None]
                       * norm_maj)
    pdf_h = torch.clamp(hero(T_spec, hero_idx) * sig_h, min=1e-30)
    beta = _m(h_scatter, beta * T_spec * mp0.sigma_s / pdf_h[..., None],
              beta)
    r_u = _m(h_scatter, r_u * T_spec * sigma_t / pdf_h[..., None]
             * r_u_factor, r_u)
    scattered = scattered | h_scatter
    t_scatter = torch.where(h_scatter, t_h, t_scatter)
    g_scatter = torch.where(h_scatter, mp0.g, g_scatter)
    albedo_sc = _m(h_scatter, mp0.sigma_s / torch.clamp(sigma_t, min=1e-30),
                   albedo_sc)
    # pass-through: the transmittance of the whole segment
    T_pass = torch.exp(-torch.clamp(t_v, max=80.0)[..., None] * norm_maj)
    Tp_h = torch.clamp(hero(T_pass, hero_idx), min=1e-30)
    scale_p = T_pass / Tp_h[..., None]
    beta = _m(h_pass, beta * scale_p, beta)
    r_u = _m(h_pass, r_u * scale_p * r_u_factor, r_u)
    r_l = _m(h_pass, r_l * scale_p * r_u_factor, r_l)
    # the homogeneous ratio-tracking estimate is binary: keep the analytic
    # value in the TrBuffer
    tr_est = _m(is_h, T_pass, tr_est)

    # ======== heterogeneous NDS / NDS+ lanes (guided) ========================
    het = active & ~is_h & (medium_id >= 0)
    use_nds = vopt.sampling_method in ("nds", "nds+") and mis > 0
    nds_fallback = torch.zeros_like(het)
    if use_nds:
        het_ods = het & guide
        if tr_prev is None:
            tr_prev = torch.ones_like(beta)
        if depth is None:
            depth = torch.zeros_like(medium_id)
        (sampler, beta, r_u, r_l, o_scat, o_term, o_t, o_g, o_alb, o_tr,
         nds_fallback) = _heterogeneous_ods(
             scene, cfg, vopt, o, d, seg_end, medium_id, hero_idx, sampler,
             beta, r_u, r_l, vsp, tr_prev, depth, het_ods)
        scattered = scattered | o_scat
        terminated = terminated | o_term
        t_scatter = torch.where(o_scat, o_t, t_scatter)
        g_scatter = torch.where(o_scat, o_g, g_scatter)
        albedo_sc = _m(o_scat, o_alb, albedo_sc)
        tr_est = _m(het_ods & ~nds_fallback, o_tr, tr_est)

    # ======== heterogeneous delta lanes (unguided and NDS fallbacks) ========
    if use_nds:
        guided_route = guide & ~nds_fallback
    else:
        guided_route = guide & (vopt.sampling_method == "resampling")
    (sampler, beta, r_u, r_l, d_scat, d_term, d_t, d_g,
     d_alb) = _heterogeneous_delta(scene, cfg, o, d, seg_end, medium_id,
                                   hero_idx, sampler, beta, r_u, r_l,
                                   het & ~guided_route)
    scattered = scattered | d_scat
    terminated = terminated | d_term
    t_scatter = torch.where(d_scat, d_t, t_scatter)
    g_scatter = torch.where(d_scat, d_g, g_scatter)
    albedo_sc = _m(d_scat, d_alb, albedo_sc)

    # ======== heterogeneous resampling lanes (guided) =======================
    if vopt.sampling_method == "resampling":
        het_rs = het & guide
        (sampler, beta, r_u, r_l, rs_scat, rs_term, rs_t, rs_g, rs_alb,
         rs_tr) = _heterogeneous_resampling(
             scene, cfg, vopt, o, d, seg_end, medium_id, hero_idx, sampler,
             beta, r_u, r_l, vsp, het_rs)
        scattered = scattered | rs_scat
        terminated = terminated | rs_term
        t_scatter = torch.where(rs_scat, rs_t, t_scatter)
        g_scatter = torch.where(rs_scat, rs_g, g_scatter)
        albedo_sc = _m(rs_scat, rs_alb, albedo_sc)
        tr_est = _m(het_rs, rs_tr, tr_est)

    return DistanceResult(sampler, beta, r_u, r_l, L, scattered, terminated,
                          t_scatter, g_scatter, albedo_sc, tr_est)


def _majorant_depth(media, cfg, medium_id, o, d, seg_end, hero_idx, active):
    """Hero-channel majorant optical depth of each lane's segment (the
    prepass of the resampling and NDS routes)."""
    it = seg_init(media, medium_id, o, d, seg_end, active)
    total = torch.zeros_like(seg_end)
    n = 0
    while bool((~it.done).any()) and n < cfg.max_collisions:
        live = ~it.done
        total = total + torch.where(
            live, hero(it.sigma_maj, hero_idx)
            * torch.clamp(it.t_seg_end - it.t_seg_start, 0.0, 3e37), 0.0)
        it = seg_next(media, medium_id, it, live)
        n += 1
    return total


def _heterogeneous_ods(scene, cfg, vopt, o, d, seg_end, medium_id, hero_idx,
                       sampler, beta, r_u, r_l, vsp, tr_prev, depth, active):
    """NDS / NDS+ optical-depth-space distance sampling
    (media_sampleTMaj.h:251-491). The whole segment is one interval of
    hero-channel optical depth t_v (majorant prepass); NDS extends it to
    t_n = -log(1 - (1 - e^-t_v)/vsp) and draws tentative collisions from
    the truncated exponential on [0, t_n); the truncation renormalisations
    gather in tp, and the one-sample MIS weight against plain delta
    tracking is r_u_factor = mis/tp + (1 - mis). With probability 1 - mis a
    lane draws plain exponential candidates instead (the defensive
    mixture). NDS+ raises a primary ray's real-collision probability to
    p^(1/(1+Tr)), Tr from the previous waves' TrBuffer, and compensates
    r_u exactly. Lanes whose vsp lies below 1 - e^-t_v are returned in
    `fallback` for delta tracking."""
    media = scene.media
    mis = float(vopt.vsp_mis_ratio)
    eps = 1e-5

    t_v = _majorant_depth(media, cfg, medium_id, o, d, seg_end, hero_idx,
                          active)
    one_m_e = -torch.expm1(-t_v)
    # NDS cannot lower the scatter probability below delta tracking's
    fallback = active & (vsp < one_m_e)
    act = active & ~fallback & (t_v > 0)
    t_n = -torch.log1p(-torch.clamp(one_m_e / torch.clamp(vsp, min=1e-4),
                                    max=1.0 - 1e-7))
    if vopt.sampling_method == "nds+":
        nds_plus = act & (depth == 0)
    else:
        nds_plus = torch.zeros_like(act)
    inv_gamma = torch.where(
        nds_plus, 1.0 / (1.0 + torch.clamp(hero(tr_prev, hero_idx), 0.0, 1.0)),
        1.0)

    # the defensive-MIS technique pick
    sampler, u0 = sampler.get_1d()
    dt_lane = u0 > mis
    u_cur = torch.where(dt_lane, _fdiv(u0 - mis, max(1.0 - mis, 1e-6)),
                        _fdiv(u0, max(mis, 1e-6)))
    u_cur = torch.clamp(u_cur, 0.0, 1.0 - 1e-7)

    # the walk in optical-depth space
    it = seg_init(media, medium_id, o, d, seg_end, act)
    z = torch.zeros_like(seg_end)
    T_maj = torch.ones_like(beta)
    tp = torch.ones_like(beta)
    tr_ratio = torch.ones_like(beta)
    t_min = it.t_seg_start
    t_v_cur, t_n_cur, rem = t_v, t_n, z - 1.0
    scattered = torch.zeros_like(act)
    terminated = torch.zeros_like(act)
    passed = torch.zeros_like(act)
    live = act & ~it.done
    t_sc, g_sc, alb = z, z, torch.zeros_like(beta)
    n = 0
    while bool(live.any()) and n < cfg.max_collisions:
        sigma_maj = it.sigma_maj
        maj_h = hero(sigma_maj, hero_idx)
        norm_maj = sigma_maj / torch.clamp(maj_h, min=1e-30)[..., None]

        # -- draw a candidate where none is pending -------------------------
        need = live & (rem < 0) & ~passed & (maj_h > 0)
        step_scale = -torch.expm1(-torch.clamp(t_n_cur, min=0.0)[..., None]
                                  * norm_maj)
        step_h = hero(step_scale, hero_idx)
        dist = torch.where(dt_lane, -torch.log1p(-u_cur),
                           -torch.log1p(-u_cur * torch.clamp(
                               step_h, 0.0, 1.0 - 1e-7)))
        tp = _m(need, tp * torch.clamp(step_scale, min=1e-30), tp)
        pass_now = need & ((t_v_cur - dist < eps) | (dist <= 0))
        tail = -torch.expm1(-torch.clamp(t_n - t_v, min=0.0))
        tp = _m(pass_now, tp / torch.clamp(tail, min=1e-30)[..., None], tp)
        passed = passed | pass_now
        rem = torch.where(need & ~pass_now, dist, rem)

        # -- consume the current segment or land inside it -------------------
        dt_end = torch.clamp(it.t_seg_end - t_min, 0.0, 3e37)
        seg_tau = dt_end * maj_h
        consume = live & (passed | (rem > seg_tau + eps) | (maj_h <= 0))
        T_maj = _m(consume, T_maj * torch.exp(-dt_end[..., None] * sigma_maj),
                   T_maj)
        t_v_cur = torch.where(consume, t_v_cur - seg_tau, t_v_cur)
        t_n_cur = torch.where(consume, t_n_cur - seg_tau, t_n_cur)
        rem = torch.where(consume & ~passed, rem - seg_tau, rem)
        it = seg_next(media, medium_id, it, consume)
        t_min = torch.where(consume, it.t_seg_start, t_min)
        live = live & ~(consume & it.done)

        # -- tentative collision ---------------------------------------------
        arrive = live & ~consume & ~passed & (rem >= 0)
        t = t_min + rem / torch.clamp(maj_h, min=1e-30)
        T_maj = _m(arrive, T_maj * torch.exp(-rem[..., None] * norm_maj),
                   T_maj)
        t_v_cur = torch.where(arrive, t_v_cur - rem, t_v_cur)
        t_n_cur = torch.where(arrive, t_n_cur - rem, t_n_cur)
        rem = torch.where(arrive, -1.0, rem)
        t_min = torch.where(arrive, t, t_min)
        sampler, u_next = sampler.get_1d()
        u_cur = torch.where(arrive, u_next, u_cur)

        mp = media.sample_point(medium_id, o + t[..., None] * d)
        sigma_t = mp.sigma_a + mp.sigma_s
        st_h = hero(sigma_t, hero_idx)
        p_scat = st_h / torch.clamp(maj_h, min=1e-30)
        p_scat_b = torch.where(nds_plus, torch.clamp(p_scat, 1e-30, 1.0)
                               ** inv_gamma, p_scat)
        sampler, um = sampler.get_1d()
        is_real = arrive & (um < p_scat_b)
        is_null = arrive & ~is_real

        T_maj_h = hero(T_maj, hero_idx)
        r_u_factor = mis / torch.clamp(tp, min=1e-30) + (1.0 - mis)
        pdf_r = torch.clamp(T_maj_h * st_h, min=1e-30)
        beta = _m(is_real, beta * T_maj * mp.sigma_s / pdf_r[..., None], beta)
        ru_r = r_u * T_maj * sigma_t / pdf_r[..., None] * r_u_factor
        comp_r = (sigma_maj * p_scat_b[..., None]
                  / torch.clamp(sigma_t, min=1e-30))
        ru_r = torch.where((is_real & nds_plus)[..., None], ru_r * comp_r,
                           ru_r)
        r_u = _m(is_real, ru_r, r_u)
        scattered = scattered | is_real
        t_sc = torch.where(is_real, t, t_sc)
        g_sc = torch.where(is_real, mp.g, g_sc)
        alb = _m(is_real, mp.sigma_s / torch.clamp(sigma_t, min=1e-30), alb)
        live = live & ~is_real

        sigma_n = torch.clamp(sigma_maj - sigma_t, min=0.0)
        sn_h = hero(sigma_n, hero_idx)
        pdf_n = T_maj_h * sn_h
        inv_pdf = 1.0 / torch.clamp(pdf_n, min=1e-30)
        beta = _m(is_null, beta * T_maj * sigma_n * inv_pdf[..., None], beta)
        beta = _m(is_null & (pdf_n == 0), torch.zeros_like(beta), beta)
        ru_n = r_u * T_maj * sigma_n * inv_pdf[..., None]
        comp_n = (sigma_maj * (1.0 - p_scat_b)[..., None]
                  / torch.clamp(sigma_n, min=1e-30))
        ru_n = torch.where((is_null & nds_plus)[..., None], ru_n * comp_n,
                           ru_n)
        r_u = _m(is_null, ru_n, r_u)
        r_l = _m(is_null, r_l * T_maj * sigma_maj * inv_pdf[..., None], r_l)
        tr_ratio = _m(is_null, tr_ratio * sigma_n
                      / torch.clamp(sigma_maj, min=1e-30), tr_ratio)
        died = is_null & ((_max3(beta) == 0) | (_max3(r_u) == 0))
        terminated = terminated | died
        live = live & ~died
        T_maj = _m(is_null & ~died, torch.ones_like(T_maj), T_maj)
        n += 1

    # pass-through or ran out (integrator :1080-1091)
    ran_out = act & ~scattered & ~terminated
    T_maj_h = torch.clamp(hero(T_maj, hero_idx), min=1e-30)
    scale = T_maj / T_maj_h[..., None]
    r_u_factor_end = mis / torch.clamp(tp, min=1e-30) + (1.0 - mis)
    beta = _m(ran_out, beta * scale, beta)
    r_u = _m(ran_out, r_u * scale * r_u_factor_end, r_u)
    r_l = _m(ran_out, r_l * scale * r_u_factor_end, r_l)
    return (sampler, beta, r_u, r_l, scattered, terminated, t_sc, g_sc, alb,
            tr_ratio, fallback)


def _heterogeneous_delta(scene, cfg, o, d, seg_end, medium_id, hero_idx,
                         sampler, beta, r_u, r_l, active):
    """Absorption-free delta tracking over the majorant segment iterator."""
    media = scene.media
    it = seg_init(media, medium_id, o, d, seg_end, active)
    z = torch.zeros_like(seg_end)
    t_min = it.t_seg_start
    T_maj = torch.ones_like(beta)
    scattered = torch.zeros_like(active)
    terminated = torch.zeros_like(active)
    t_sc, g_sc, alb = z, z, torch.zeros_like(beta)
    act = active & ~it.done
    n = 0
    while bool(act.any()) and n < cfg.max_collisions:
        sigma_maj = it.sigma_maj
        maj_h = hero(sigma_maj, hero_idx)
        sampler, u_step = sampler.get_1d()
        t = torch.where(maj_h > 0, t_min + sample_exponential(
            u_step, torch.clamp(maj_h, min=1e-30)), INF)
        past = t >= it.t_seg_end
        tail = act & past
        dt_end = torch.clamp(it.t_seg_end - t_min, 0.0, 3e37)
        T_maj = _m(tail, T_maj * torch.exp(-dt_end[..., None] * sigma_maj),
                   T_maj)
        it = seg_next(media, medium_id, it, tail)
        t_min = torch.where(tail, it.t_seg_start, t_min)
        act_new = act & ~(tail & it.done)

        coll = act & ~past
        T_maj = _m(coll, T_maj * torch.exp(-(t - t_min)[..., None]
                                           * sigma_maj), T_maj)
        mp = media.sample_point(medium_id, o + t[..., None] * d)
        sigma_t = mp.sigma_a + mp.sigma_s
        st_h = hero(sigma_t, hero_idx)
        p_scatter = st_h / torch.clamp(maj_h, min=1e-30)
        sampler, um = sampler.get_1d()
        is_real = coll & (um < p_scatter)
        is_null = coll & ~is_real

        T_maj_h = hero(T_maj, hero_idx)
        pdf_r = torch.clamp(T_maj_h * st_h, min=1e-30)
        beta = _m(is_real, beta * T_maj * mp.sigma_s / pdf_r[..., None], beta)
        r_u = _m(is_real, r_u * T_maj * sigma_t / pdf_r[..., None], r_u)
        scattered = scattered | is_real
        t_sc = torch.where(is_real, t, t_sc)
        g_sc = torch.where(is_real, mp.g, g_sc)
        alb = _m(is_real, mp.sigma_s / torch.clamp(sigma_t, min=1e-30), alb)
        act_new = act_new & ~is_real

        sigma_n = torch.clamp(sigma_maj - sigma_t, min=0.0)
        pdf_n = T_maj_h * hero(sigma_n, hero_idx)
        inv_pdf = 1.0 / torch.clamp(pdf_n, min=1e-30)
        beta = _m(is_null, beta * T_maj * sigma_n * inv_pdf[..., None], beta)
        beta = _m(is_null & (pdf_n == 0), torch.zeros_like(beta), beta)
        r_u = _m(is_null, r_u * T_maj * sigma_n * inv_pdf[..., None], r_u)
        r_l = _m(is_null, r_l * T_maj * sigma_maj * inv_pdf[..., None], r_l)
        died = is_null & ((_max3(beta) == 0) | (_max3(r_u) == 0))
        terminated = terminated | died
        act = act_new & ~died
        T_maj = _m(is_null & ~died, torch.ones_like(T_maj), T_maj)
        t_min = torch.where(is_null, t, t_min)
        n += 1

    ran_out = active & ~scattered & ~terminated
    T_maj_h = torch.clamp(hero(T_maj, hero_idx), min=1e-30)
    scale = T_maj / T_maj_h[..., None]
    beta = _m(ran_out, beta * scale, beta)
    r_u = _m(ran_out, r_u * scale, r_u)
    r_l = _m(ran_out, r_l * scale, r_l)
    return (sampler, beta, r_u, r_l, scattered, terminated, t_sc, g_sc, alb)


def _heterogeneous_resampling(scene, cfg, vopt, o, d, seg_end, medium_id,
                              hero_idx, sampler, beta, r_u, r_l, vsp,
                              active):
    """The resampling route (media_sampleTMaj.h:120-247): walk every
    tentative collision to the segment end with the ratio-tracking
    transmittance, reservoir-pick one volume candidate, weigh the surface
    candidate so the volume-event probability meets the (defensively
    MIS'd) target VSP. As in the JAX package, a pass-through also takes the
    null chain's light-strategy pdfs into r_l (the reference leaves r_l
    alone there, which brightens an absorbing furnace)."""
    media = scene.media
    total_len = _majorant_depth(media, cfg, medium_id, o, d, seg_end,
                                hero_idx, active)
    act = active & (total_len > 0)

    # majorant scale for the zero-volume-candidate compensation
    min_total = -torch.log(torch.clamp(1.0 - vsp, min=1e-6))
    maj_scale = torch.where(act & (min_total > total_len),
                            min_total / torch.clamp(total_len, min=1e-30),
                            1.0)
    total_eff = torch.maximum(total_len, min_total)
    vol_ratio_comp = vsp / torch.clamp(1.0 - torch.exp(-total_eff), min=1e-6)

    it = seg_init(media, medium_id, o, d, seg_end, act)
    z = torch.zeros_like(seg_end)
    T_maj = torch.ones_like(beta)
    tr_ratio = torch.ones_like(beta)
    beta_rs = torch.ones_like(beta)
    r_u_rs = torch.ones_like(beta)
    r_l_rs = torch.ones_like(beta)
    w_sum = z
    c_p = torch.zeros_like(o)
    c_g, c_wi, c_ste = z, z, z
    c_alb = torch.zeros_like(beta)
    c_num = torch.ones_like(beta)
    c_den = torch.ones_like(beta)
    has_c = torch.zeros_like(act)
    t_min = it.t_seg_start
    live = act & ~it.done
    n = 0
    while bool(live.any()) and n < cfg.max_collisions:
        sigma_maj = it.sigma_maj * maj_scale[..., None]
        maj_h = hero(sigma_maj, hero_idx)
        sampler, u_step = sampler.get_1d()
        t = torch.where(maj_h > 0, t_min + sample_exponential(
            u_step, torch.clamp(maj_h, min=1e-30)), INF)
        past = t >= it.t_seg_end
        tail = live & past
        dt_end = torch.clamp(it.t_seg_end - t_min, 0.0, 3e37)
        T_maj = _m(tail, T_maj * torch.exp(-dt_end[..., None] * sigma_maj),
                   T_maj)
        it = seg_next(media, medium_id, it, tail)
        t_min = torch.where(tail, it.t_seg_start, t_min)
        live_new = live & ~(tail & it.done)

        coll = live & ~past
        T_maj = _m(coll, T_maj * torch.exp(-(t - t_min)[..., None]
                                           * sigma_maj), T_maj)
        p = o + t[..., None] * d
        mp = media.sample_point(medium_id, p)
        sigma_t = mp.sigma_a + mp.sigma_s
        sigma_n = torch.clamp(sigma_maj - sigma_t, min=0.0)
        # candidate weight: (sigma_t / sigma_maj * trRatioEst)[hero]
        wi = hero(sigma_t / torch.clamp(sigma_maj, min=1e-30) * tr_ratio,
                  hero_idx)
        wi = torch.where(coll, wi, 0.0)
        w_sum_new = w_sum + wi
        sampler, u_res = sampler.get_1d()
        take = coll & (wi > 0) & (u_res < wi / torch.clamp(w_sum_new,
                                                            min=1e-30))
        T_maj_h = hero(T_maj, hero_idx)
        st_h = hero(sigma_t, hero_idx)
        pdf = torch.clamp(T_maj_h * st_h, min=1e-30)
        num = beta_rs * T_maj * mp.sigma_s / pdf[..., None]
        den = r_u_rs * T_maj * sigma_t / pdf[..., None]
        c_p = _m(take, p, c_p)
        c_g = torch.where(take, mp.g, c_g)
        c_alb = _m(take, mp.sigma_s / torch.clamp(sigma_t, min=1e-30), c_alb)
        c_wi = torch.where(take, wi, c_wi)
        c_ste = torch.where(take, wi, c_ste)  # sigmaTTrEst == wi at selection
        c_num = _m(take, num, c_num)
        c_den = _m(take, den, c_den)
        has_c = has_c | take
        w_sum = torch.where(coll, w_sum_new, w_sum)

        # null-collision bookkeeping: the walk always continues
        pdf_n = torch.clamp(T_maj_h * hero(sigma_n, hero_idx), min=1e-30)
        beta_rs = _m(coll, beta_rs * T_maj * sigma_n / pdf_n[..., None],
                     beta_rs)
        r_u_rs = _m(coll, r_u_rs * T_maj * sigma_n / pdf_n[..., None],
                    r_u_rs)
        r_l_rs = _m(coll, r_l_rs * T_maj * sigma_maj / pdf_n[..., None],
                    r_l_rs)
        tr_ratio = _m(coll, tr_ratio * sigma_n
                      / torch.clamp(sigma_maj, min=1e-30), tr_ratio)
        T_maj = _m(coll, torch.ones_like(T_maj), T_maj)
        t_min = torch.where(coll, t, t_min)
        live = live_new
        n += 1

    T_maj_h = torch.clamp(hero(T_maj, hero_idx), min=1e-30)
    beta_rs = beta_rs * T_maj / T_maj_h[..., None]
    r_u_rs = r_u_rs * T_maj / T_maj_h[..., None]
    r_l_rs = r_l_rs * T_maj / T_maj_h[..., None]

    tr_h = hero(tr_ratio, hero_idx)
    # the surface candidate (integrator :735-747)
    adj = act & (tr_h < 1) & (tr_h > 0) & (w_sum > 0)
    vol_ratio = (vol_ratio_comp * vopt.vsp_mis_ratio
                 + (1.0 - tr_h) * (1.0 - vopt.vsp_mis_ratio))
    surf_wi = torch.where(
        adj, (1.0 - vol_ratio) / torch.clamp(vol_ratio, min=1e-6) * w_sum,
        tr_h)
    w_total = w_sum + surf_wi

    dead = act & (w_total <= 0)
    sampler, u_pick = sampler.get_1d()
    pick_surf = act & ~dead & (u_pick < surf_wi / torch.clamp(w_total,
                                                               min=1e-30))
    pick_vol = act & ~dead & ~pick_surf & has_c
    dead = dead | (act & ~pick_surf & ~has_c)

    # the selected candidate's resampling factor w_total * sigmaTTrEst / wi
    sel_wi = torch.where(pick_surf, surf_wi, c_wi)
    sel_ste = torch.where(pick_surf, tr_h, c_ste)
    sel_num = _m(pick_surf, beta_rs, c_num)
    sel_den = _m(pick_surf, r_u_rs, c_den)
    factor = w_total * sel_ste / torch.clamp(sel_wi, min=1e-30)
    beta = _m(act & ~dead, beta * sel_num * factor[..., None], beta)
    r_u = _m(act & ~dead, r_u * sel_den, r_u)
    r_l = _m(pick_surf, r_l * r_l_rs, r_l)

    bad = act & ~dead & (
        (~torch.isfinite(beta)).any(-1) | (~torch.isfinite(r_u)).any(-1)
        | (~torch.isfinite(r_l)).any(-1))
    dead = dead | bad
    t_c = torch.where(pick_vol, torch.sum((c_p - o) * d, -1),
                      torch.zeros_like(w_sum))
    return (sampler, beta, r_u, r_l, pick_vol & ~bad, dead, t_c, c_g, c_alb,
            tr_ratio)


# ---------------------------------------------------------------------------
# Guided Russian roulette (openpgl util::GuidedRussianRoulette)
# ---------------------------------------------------------------------------

_LUM_W = (0.2126, 0.7152, 0.0722)


def guided_rr_survival(beta, adjoint, pixel_estimate, min_survival=0.1):
    """clamp(lum(beta * adjoint) / lum(pixel estimate), min_survival, 1),
    Rec.709 luminance."""
    w = torch.tensor(_LUM_W, dtype=beta.dtype, device=beta.device)
    num = torch.sum(beta * adjoint * w, -1)
    den = torch.clamp(torch.sum(pixel_estimate * w, -1), min=1e-6)
    return torch.clamp(num / den, min_survival, 1.0)


def throughput_rr_survival(beta, r_u):
    """StandardThroughputBasedRussianRoulette."""
    tp = torch.amax(beta / torch.clamp(average(r_u), min=1e-30)[..., None],
                    -1)
    return torch.clamp(tp, 0.0, 1.0)


# ---------------------------------------------------------------------------
# The VSPG bounce and wave
# ---------------------------------------------------------------------------


def vspg_bounce(scene, cfg: VolPathConfig, gopt: GuidingOptions,
                vopt: VSPGOptions, field: GuidingField, isgb: ISGB,
                train: bool, gs: VState) -> VState:
    """One path event for every lane: VSP-guided distance sampling, then at
    a volume vertex NEE, guided RR and the guided phase-function draw;
    escape with env MIS; interface crossings; at a surface NEE with the
    BSDF, the guided BSDF draw and guided RR."""
    s = gs.s
    rec = gs.rec
    h = scene.geometry.intersect(s.o, s.d, torch.full_like(s.o[..., 0], INF))
    seg_end = torch.where(h.hit, h.t, INF)

    # ---- VSP-guided distance sampling --------------------------------------
    in_medium = s.alive & (s.medium_id >= 0)
    guide, vsp = lookup_vsp(vopt, field, isgb, s, gs.pixel_id, gs.last_vol)
    dr = sample_distance_vspg(
        scene, cfg, vopt, s.o, s.d, seg_end, s.medium_id, s.hero_idx,
        s.sampler, s.beta, s.r_u, s.r_l, s.L, guide & in_medium, vsp,
        in_medium, tr_prev=gs.tr_prev, depth=s.depth)
    sampler, beta, r_u, r_l, L = dr.sampler, dr.beta, dr.r_u, dr.r_l, dr.L
    depth = s.depth
    alive = s.alive & ~dr.terminated

    # depth guard of scatter events (reference: depth++ >= maxDepth)
    scat_raw = dr.scattered & alive
    depth_exceeded = scat_raw & (depth >= cfg.max_depth)
    alive = alive & ~depth_exceeded
    scat = scat_raw & ~depth_exceeded
    depth = torch.where(scat, depth + 1, depth)

    p_scat = s.o + dr.t_scatter[..., None] * s.d
    wo = -s.d

    # ISGB first-event data (volume)
    first_now_v = scat & ~gs.first_set & (s.depth == 0)
    first_set = gs.first_set | first_now_v
    first_vol = torch.where(first_now_v, True, gs.first_vol)
    first_albedo = _m(first_now_v, _to3(dr.albedo_scatter), gs.first_albedo)
    first_normal = _m(first_now_v, wo, gs.first_normal)
    # the primary transmittance estimate for the TrBuffer
    tr_est = _m((s.depth == 0) & in_medium, _to3(dr.tr_est), gs.tr_est)

    # ---- volume vertex: NEE, guided RR, guided phase draw ------------------
    dist_v = gfield.volume_distribution(field, p_scat, wo, dr.g_scatter)
    use_guide_v = (scat & dist_v.valid & field.trained
                   & bool(gopt.volume_guiding))

    sampler, u_sel = sampler.get_1d()
    sampler, u2l = sampler.get_2d()
    ls = scene.lights.sample(p_scat, u_sel, u2l)
    ok = scat & ls.valid & (average(ls.L) > 0)
    f_scalar = henyey_greenstein(torch.sum(wo * ls.wi, dim=-1), dr.g_scatter)
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

    # guided RR at volume vertices, before the direction draw
    pixel_est = gisgb.isgb_contribution(isgb, gs.pixel_id)
    if vopt.guide_rr:
        survival = torch.where(
            dist_v.valid & (torch.mean(pixel_est, -1) > 0),
            guided_rr_survival(_to3(beta), dist_v.flux, pixel_est), 1.0)
    else:
        survival = throughput_rr_survival(beta, r_u)
    do_rr_v = scat & (depth > vopt.min_rr_depth) & (survival < 1.0)
    sampler, u_rrv = sampler.get_1d()
    kill_v = do_rr_v & (u_rrv >= survival)
    alive = alive & ~kill_v
    beta = _m(do_rr_v & ~kill_v,
              beta / torch.clamp(survival, min=1e-3)[..., None], beta)

    def phase_base(sampler):
        sampler, u2p = sampler.get_2d()
        wi_p, pdf_p = sample_henyey_greenstein(wo, dr.g_scatter, u2p)
        return sampler, wi_p, pdf_p[..., None] * torch.ones_like(beta), \
            pdf_p, None

    def phase_pdf_at(wi):
        return henyey_greenstein(torch.sum(wo * wi, -1), dr.g_scatter)

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
    last_vol = torch.where(scat, True, gs.last_vol)

    if train:
        rec = grec.record_vertex(rec, scat, p_scat, wi_v,
                                 scale_v[..., None] * torch.ones_like(beta),
                                 pdf_v, torch.ones_like(scat))
        rec = grec.record_direct(rec, ok, _to3(_local_ld(
            ls, f_hat, scatter_pdf_l, T_ray, tr_l, tr_u, ok)))

    # ---- escape ------------------------------------------------------------
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
        w_mis_env = torch.where(first, torch.ones_like(denom_esc),
                                average(r_u) / denom_esc)
        rec = grec.record_emission(rec, escaped & any_env,
                                   _to3(Le_env * w_mis_env[..., None]),
                                   torch.full_like(denom_esc, 1e6))
    alive = alive & ~escaped

    # ---- surfaces: emission of an area light, with MIS after the first
    # hit; interfaces switch the medium ---------------------------------------
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

    shade = surf & (h.mat_id >= 0)
    depth_hit = shade & (s.depth >= cfg.max_depth)
    alive = alive & ~depth_hit
    shade = shade & ~depth_hit
    if not bool(shade.any()):
        # the JAX bounce draws the surface NEE (1D + 2D), the guided BSDF
        # sample (MIS: 1D + 2D + the BSDF's 1D + 2D; RIS: one more 1D) and
        # the surface roulette (1D) for every lane; with no shaded lane
        # they only advance the dimension counter
        sampler = sampler.advance(7 if gopt.mode == "mis" else 8)
        s2 = PathState(sampler, o_new, d_new, beta, r_u, r_l, L, depth,
                       alive, specular, s.hero_idx, medium_id, s.eta_scale,
                       prev_p)
        return VState(s2, rec, gs.pixel_id, last_vol, first_set, first_vol,
                      first_albedo, first_normal, tr_est, gs.tr_prev)
    depth = torch.where(shade, depth + 1, depth)
    lanes = scene.materials.gather_textured(scene.textures, h.mat_id, h.uv,
                                            h.p)
    ns = face_forward(h.ns, h.n)

    # ISGB first-event data (surface)
    first_now_s = shade & ~first_set & (s.depth == 0)
    first_set = first_set | first_now_s
    first_vol = torch.where(first_now_s, False, first_vol)
    first_albedo = _m(first_now_s, _to3(lanes.albedo), first_albedo)
    first_normal = _m(first_now_s, ns, first_normal)

    # the surface half: cosine product for opaque surfaces only
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
    f_guide = (bsdf_f(lanes, wo_l, to_local(wi_s))
               * torch.abs(dot(wi_s, ns))[..., None])
    f_s = torch.where(took_guide_s[..., None], f_guide, f_s)
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
    last_vol = torch.where(bs_ok, False, last_vol)

    if train:
        rec = grec.record_vertex(rec, bs_ok & ~spec_lane, h.p, wi_s,
                                 _to3(scale_b), pdf_s,
                                 torch.zeros_like(bs_ok))
        rec = grec.record_direct(rec, ok2, _to3(_local_ld(
            ls2, f_hat2, scatter_pdf2, T_ray2, tr_l2, tr_u2, ok2)))

    # surface roulette (guided or throughput)
    alive = alive & ~(shade & (_max3(beta) == 0))
    dist_srr = gfield._gather_half(field, field.surface, h.p)
    if vopt.guide_rr:
        survival_s = torch.where(
            dist_srr.valid & (torch.mean(pixel_est, -1) > 0),
            guided_rr_survival(_to3(beta), dist_srr.flux, pixel_est), 1.0)
        survival_s = torch.where(specular, 0.95, survival_s)
    else:
        survival_s = throughput_rr_survival(beta, r_u)
    do_rr_s = shade & (depth > vopt.min_rr_depth) & (survival_s < 1.0)
    sampler, u_rrs = sampler.get_1d()
    kill_s = do_rr_s & (u_rrs >= survival_s)
    alive = alive & ~kill_s
    beta = _m(do_rr_s & ~kill_s,
              beta / torch.clamp(survival_s, min=1e-3)[..., None], beta)

    s2 = PathState(sampler, o_new, d_new, beta, r_u, r_l, L, depth, alive,
                   specular, s.hero_idx, medium_id, eta_scale, prev_p)
    return VState(s2, rec, gs.pixel_id, last_vol, first_set, first_vol,
                  first_albedo, first_normal, tr_est, gs.tr_prev)


def vspg_wave(scene, camera, film, film_state, field, isgb, cfg, gopt, vopt,
              seed, wave_idx, camera_medium, train, spp_per_pass,
              tr_buffer=None, pixel_id=None, pixel_base=None):
    """One wave of `spp_per_pass` samples per pixel; lane l renders pixel
    l // spp_per_pass. Adds the samples to `film_state` (in place) and to
    the ISGB. Returns (film_state, isgb, TrainBatch or None, the lanes'
    primary transmittance estimates (R, 3)).

    With `pixel_id` (the sharded render, ``parallel/mesh.py``) the lanes
    cover those image pixels, lane l sample l % spp_per_pass of its pixel,
    and `film_state`, `isgb` and `tr_buffer` hold only the rows from image
    pixel `pixel_base` on (default pixel_id[0]), which they index by
    pixel_id - pixel_base."""
    dev = film.device
    if pixel_id is None:
        R = film.npix * spp_per_pass
        lane = torch.arange(R, device=dev)
        pixel_id = lane // spp_per_pass
        local_pid = pixel_id
    else:
        R = pixel_id.shape[0]
        lane = torch.arange(R, device=dev)
        base = pixel_id[0] if pixel_base is None else int(pixel_base)
        local_pid = pixel_id - base
    sample_index = int(wave_idx) * spp_per_pass + lane % spp_per_pass
    s, fw = start_camera_paths(camera, film, int(seed) & 0xFFFFFFFF,
                               sample_index, pixel_id, int(camera_medium))
    rec = SegmentRecord.make(R, gopt.record_depth if train else 1,
                             device=dev)
    z3 = torch.zeros_like(s.o)
    f = pixel_id < 0
    tr_prev = (torch.ones_like(s.o) if tr_buffer is None
               else tr_buffer[local_pid])
    # VState.pixel_id indexes the (possibly sharded) ISGB rows: local ids
    gs = VState(s, rec, local_pid, f, f, f, z3, z3, torch.ones_like(s.o),
                tr_prev)
    it = 0
    while bool(gs.s.alive.any()) and it < cfg.max_events:
        gs = vspg_bounce(scene, cfg, gopt, vopt, field, isgb, train, gs)
        it += 1
    film_state = film.add_samples(film_state, local_pid, gs.s.L, fw)
    isgb = gisgb.isgb_add_samples(isgb, local_pid, _to3(gs.s.L),
                                  gs.first_albedo, gs.first_normal,
                                  gs.first_vol, pixel_id >= 0,
                                  half=int(wave_idx) % 2)
    batch = grec.propagate(gs.rec) if train else None
    return film_state, isgb, batch, gs.tr_est


# ---------------------------------------------------------------------------
# The progressive render loop
# ---------------------------------------------------------------------------


def render_vspg(scene, camera, film, spp=16, cfg=VolPathConfig(),
                gopt=GuidingOptions(), vopt=VSPGOptions(), seed=0,
                spp_per_pass=1, field=None, isgb=None, train=True,
                camera_medium=-1, backend="auto", *, device="cuda"):
    """Progressive VSPG render on `device`; returns (image, field, isgb).

    backend "auto" takes the VSPG kernel where the JAX package takes its
    Pallas kernel (the scene in ``ops/vspg_kernels.supports``; training
    waves only at spp_per_pass == 1 and not under NDS+), the torch wave
    elsewhere; "torch" runs every wave through the torch wave (the JAX
    package's use_pallas=False)."""
    if backend not in ("auto", "torch"):
        raise ValueError(f"unknown backend {backend!r}")
    if cfg.spectral:
        raise NotImplementedError("the spectral mode is not ported yet")
    scene, camera, film = scene.to(device), camera.to(device), film.to(device)
    field = (_scene_field(scene, gopt, device) if field is None
             else field.to(device))
    isgb = (ISGB.make(film.resolution, vopt.vsp_criterion, vopt.denoiser,
                      device=device) if isgb is None else isgb.to(device))
    kernel_ok = backend == "auto" and vk.supports(scene, camera, film, cfg,
                                                  gopt, vopt, field)
    npix = film.npix
    pid = torch.arange(npix, device=film.device)
    film_state = film.init_state()
    # NDS+ feeds the previous waves' primary transmittance back in, a
    # running mean over the waves from the unbiased-anyway guess Tr = 1
    tr_buffer = (torch.ones((npix, 3), device=film.device)
                 if vopt.sampling_method == "nds+" else None)
    n_tr = 0
    spp_done = 0
    kimg_sum, kimg_spp = None, 0
    for wave in range(spp // spp_per_pass):
        do_train = train and field.iteration < gopt.train_waves
        if not do_train and kernel_ok:
            break  # the remaining samples render through the frozen kernel
        if do_train and kernel_ok and spp_per_pass == 1 and tr_buffer is None:
            img_w, seg, f_alb, f_nrm, f_vol, L_raw = vk.train_wave(
                scene, camera, film, cfg, gopt, vopt, field, isgb,
                seed=(int(seed) + wave * 7919 + 1) & 0xFFFFFFFF)
            spp_done += 1
            kimg_spp += 1
            kimg_sum = img_w if kimg_sum is None else kimg_sum + img_w
            isgb = gisgb.isgb_add_samples(isgb, pid, L_raw, f_alb, f_nrm,
                                          f_vol, pid >= 0, half=wave % 2)
            batch = grec.propagate(seg)
        else:
            spp_done += spp_per_pass
            film_state, isgb, batch, tr = vspg_wave(
                scene, camera, film, film_state, field, isgb, cfg, gopt,
                vopt, seed, wave, camera_medium, do_train, spp_per_pass,
                tr_buffer)
            if tr_buffer is not None:
                tr_pix = tr.reshape(npix, spp_per_pass, 3).mean(1)
                tr_buffer = (tr_pix if n_tr == 0
                             else (tr_buffer * n_tr + tr_pix) / (n_tr + 1))
                n_tr += 1
        if do_train:
            total_w = float(torch.sum(torch.where(batch.valid, batch.weight,
                                                  0.0)))
            if total_w > gopt.min_train_weight:
                field = gv.train_step(field, batch)
                if gopt.adaptive_extra:
                    field = gfield.refine_field(field, gopt.refine_threshold)
        if (wave + 1) in vopt.isgb_update_waves:
            isgb = gisgb.isgb_update(isgb)
    remaining = spp - spp_done
    parts = []
    if spp_done - kimg_spp > 0:
        parts.append((film.image(film_state), spp_done - kimg_spp))
    if kimg_spp:
        parts.append((kimg_sum / kimg_spp, kimg_spp))
    if remaining > 0:
        if not kernel_ok:
            raise ValueError(f"spp {spp} is not a multiple of spp_per_pass "
                             f"{spp_per_pass}, and the kernel does not serve "
                             "the rest")
        img_k = vk.render_frozen(scene, camera, film, remaining, cfg, gopt,
                                 vopt, field, isgb,
                                 seed=(int(seed) + 0x9E3779B9) & 0xFFFFFFFF,
                                 tr_buffer=tr_buffer)
        parts.append((img_k, remaining))
    img = sum(im * w for im, w in parts) / sum(w for _, w in parts)
    return img, field, isgb
