"""RGB hero-channel helpers (counterpart of ``utils/spectrum.py``, RGB
mode only)."""

from __future__ import annotations

import torch


def sample_hero_channel(u):
    """Hero channel index from the wavelength sample u (spectrum.h:383)."""
    return torch.clamp(torch.floor(u * 3.0).to(torch.int64), max=2)


def hero(s, channel_idx):
    """Select the hero channel of a (...,3) spectrum -> (...)."""
    return torch.gather(s, -1, channel_idx[..., None])[..., 0]


def average(s):
    return torch.mean(s, dim=-1)
