"""RGB hero-channel helpers and the blackbody reduced to RGB on the host
(counterpart of ``utils/spectrum.py``, RGB mode only)."""

from __future__ import annotations

import numpy as np
import torch


def sample_hero_channel(u):
    """Hero channel index from the wavelength sample u (spectrum.h:383)."""
    return torch.clamp(torch.floor(u * 3.0).to(torch.int64), max=2)


def hero(s, channel_idx):
    """Select the hero channel of a (...,3) spectrum -> (...)."""
    return torch.gather(s, -1, channel_idx[..., None])[..., 0]


def average(s):
    return torch.mean(s, dim=-1)


# -- host spectral -> RGB reduction -----------------------------------------


def blackbody(lam_nm, T):
    """Planck's law at wavelengths lam_nm [nm] and temperature T [K], in
    float64 on the host."""
    lam = np.asarray(lam_nm, np.float64) * 1e-9
    c, h, kb = 299792458.0, 6.62606957e-34, 1.3806488e-23
    with np.errstate(over="ignore", divide="ignore"):
        le = (2 * h * c * c) / (lam**5 * (np.exp((h * c) / (lam * kb * T))
                                          - 1))
    return np.where(T <= 0, 0.0, le)


def blackbody_normalized_rgb(T):
    """Blackbody emission at T, peak-normalized, reduced to linear sRGB
    (BlackbodySpectrum -> ToRGBUnbounded in RGB mode)."""
    from .colorspace import spectrum_samples_to_rgb

    lam_max = 2.8977721e-3 / max(T, 1e-6) * 1e9
    norm = 1.0 / blackbody(lam_max, T)
    lams = np.arange(360.0, 831.0, 5.0)
    return spectrum_samples_to_rgb(lams, blackbody(lams, T) * norm)
