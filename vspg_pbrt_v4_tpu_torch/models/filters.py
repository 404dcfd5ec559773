"""Reconstruction filters (counterpart of ``models/filters.py``): the box
filter only, sampled in closed form with weight 1."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..utils.device import OnDevice


@dataclass(frozen=True)
class Filter(OnDevice):
    kind: str = "box"
    radius: float = 0.5

    @staticmethod
    def make(kind="box", radius=None, *, device=None):
        """Box filter; `device` is accepted for a uniform constructor
        signature (the box filter holds no tensors)."""
        if kind != "box":
            raise NotImplementedError(f"filter {kind!r} is not ported yet")
        return Filter("box", float(0.5 if radius is None else radius))

    def sample(self, u2):
        """u2 (R,2) -> (offset (R,2) from the pixel center, weight (R,))."""
        offset = (u2 - 0.5) * 2.0 * self.radius
        return offset, torch.ones_like(u2[..., 0])
