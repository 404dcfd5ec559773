"""GuidedVolPathVSPG, volume scattering probability guiding (counterpart of
``models/integrators/vspg.py``), kernel route.

``render_vspg`` renders progressively: training waves of one sample per
pixel go through the record variant of the VSPG kernel; after each, the
ISGB takes the wave's samples, the recorded path segments are propagated
into training samples and, when they carry enough weight, train the
field; the ISGB is denoised at waves 1, 2, 4, 8, ... Once training is
over, the remaining samples render with the field and the ISGB frozen,
through the kernel's render variant in one launch. The result mixes the
training images and the frozen image by their sample counts.

The XLA-style VSPG wave of the JAX package (``vspg_wave``,
``vspg_bounce``, ``sample_distance_vspg``) is not ported: what only it
serves raises ``NotImplementedError`` here (ROADMAP.md §B).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...ops import vspg_kernels as vk
from ..guiding import isgb as gisgb
from ..guiding import recording as grec
from ..guiding.field import GuidingField
from ..guiding.isgb import ISGB
from . import guided_volpath as gv
from .guided_volpath import GuidingOptions
from .volpath import VolPathConfig


class VSPGOptions(NamedTuple):
    """Scene-file parameters of the integrator (vspguiding,
    vspprimaryguiding, vspsecondaryguiding, vspsamplingmethod, vspmisratio,
    vspcriterion, guidedrr, ...). The JAX package's
    ``calculate_tr_buffer`` serves NDS+ only and waits for it."""

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


def _scene_field(scene, gopt, device):
    """A fresh field over the scene's box bounds, padded by 1e-3."""
    g = scene.geometry
    pts = np.concatenate([g.box_min.cpu().numpy(), g.box_max.cpu().numpy()],
                         0)
    return GuidingField.make(pts.min(0) - 1e-3, pts.max(0) + 1e-3,
                             res=gopt.field_res, n_lobes=gopt.n_lobes,
                             n_extra=gopt.adaptive_extra, device=device)


def render_vspg(scene, camera, film, spp=16, cfg=VolPathConfig(),
                gopt=GuidingOptions(), vopt=VSPGOptions(), seed=0,
                spp_per_pass=1, field=None, isgb=None, train=True, *,
                device="cuda"):
    """Progressive VSPG render on `device`: training waves through the
    record kernel, then the frozen-field render kernel. Returns (image,
    field, isgb)."""
    if vopt.sampling_method != "resampling":
        raise NotImplementedError(
            f"sampling_method {vopt.sampling_method!r} is not ported yet "
            "(ROADMAP.md §B: NDS/NDS+, B3b/B4b)")
    scene, camera, film = scene.to(device), camera.to(device), film.to(device)
    field = (_scene_field(scene, gopt, device) if field is None
             else field.to(device))
    isgb = (ISGB.make(film.resolution, vopt.vsp_criterion, vopt.denoiser,
                      device=device) if isgb is None else isgb.to(device))
    if not vk.supports(scene, camera, film, cfg, gopt, vopt, field):
        raise NotImplementedError(
            "scene outside the VSPG kernel's class: the XLA wave that "
            "serves it is not ported yet (ROADMAP.md §B)")
    npix = film.npix
    pid = torch.arange(npix, device=film.device)
    spp_done = 0
    kimg_sum = None
    for wave in range(spp // spp_per_pass):
        if not (train and field.iteration < gopt.train_waves):
            break  # the remaining samples render through the frozen kernel
        if spp_per_pass != 1:
            raise NotImplementedError(
                "training with spp_per_pass > 1 runs the XLA wave, which is "
                "not ported yet (ROADMAP.md §B)")
        img_w, seg, f_alb, f_nrm, f_vol, L_raw = vk.train_wave(
            scene, camera, film, cfg, gopt, vopt, field, isgb,
            seed=(int(seed) + wave * 7919 + 1) & 0xFFFFFFFF)
        spp_done += 1
        kimg_sum = img_w if kimg_sum is None else kimg_sum + img_w
        isgb = gisgb.isgb_add_samples(isgb, pid, L_raw, f_alb, f_nrm, f_vol,
                                      pid >= 0, half=wave % 2)
        batch = grec.propagate(seg)
        total_w = float(torch.sum(torch.where(batch.valid, batch.weight,
                                              0.0)))
        if total_w > gopt.min_train_weight:
            field = gv.train_step(field, batch)
        if (wave + 1) in vopt.isgb_update_waves:
            isgb = gisgb.isgb_update(isgb)
    remaining = spp - spp_done
    parts = []
    if spp_done:
        parts.append((kimg_sum / spp_done, spp_done))
    if remaining > 0:
        img_k = vk.render_frozen(scene, camera, film, remaining, cfg, gopt,
                                 vopt, field, isgb,
                                 seed=(int(seed) + 0x9E3779B9) & 0xFFFFFFFF)
        parts.append((img_k, remaining))
    img = sum(im * w for im, w in parts) / sum(w for _, w in parts)
    return img, field, isgb
