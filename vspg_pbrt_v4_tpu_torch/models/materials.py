"""Surface materials (counterpart of ``models/materials.py``): only the
container a Scene holds. This package's scenes are medium containers whose
surfaces are interfaces (``mat == -1``); surface shading comes with the
scenes that have surfaces, so ``volpath_bounce`` raises on a hit with
``mat >= 0``."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..utils.device import OnDevice


@dataclass(frozen=True)
class Materials(OnDevice):
    mat_type: torch.Tensor  # (M,) int32 material kind ids

    @staticmethod
    def build(mats=(), *, device):
        """mats: list of dicts {type, ...}; only the kind is kept."""
        return Materials(torch.as_tensor([int(m["type"]) for m in mats],
                                         dtype=torch.int32, device=device))

    @property
    def n(self):
        return self.mat_type.shape[0]
