"""Albedo textures (counterpart of ``models/textures.py``): the uv checker
(``textures.h`` CheckerTexture: two colours alternating over the scaled uv
lattice) and the constant texture the JAX package's empty bank holds. The
image, procedural-noise and nested kinds are not ported; building a bank
that holds one raises ``NotImplementedError``."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..utils.device import OnDevice

CONSTANT = 0
CHECKER = 1
PORTED_KINDS = (CONSTANT, CHECKER)


@dataclass(frozen=True)
class Textures(OnDevice):
    kind: torch.Tensor  # (T,) int32
    c0: torch.Tensor  # (T,3) constant value / checker colour of even cells
    c1: torch.Tensor  # (T,3) checker colour of odd cells
    uvscale: torch.Tensor  # (T,2)

    @staticmethod
    def build(textures=(), *, device):
        """textures: list of dicts {kind, c0, c1, uvscale}; an empty list
        gives one constant white row, as in the JAX package."""
        textures = list(textures) or [dict(kind=CONSTANT, c0=(1.0, 1.0, 1.0))]
        kinds = [int(t.get("kind", CONSTANT)) for t in textures]
        Textures.check_kinds(kinds)

        def rows(key, default):
            return torch.as_tensor([t.get(key, default) for t in textures],
                                   dtype=torch.float32, device=device)

        return Textures(torch.as_tensor(kinds, dtype=torch.int32,
                                        device=device),
                        rows("c0", (1, 1, 1)), rows("c1", (0, 0, 0)),
                        rows("uvscale", (1, 1)))

    @staticmethod
    def check_kinds(kinds):
        bad = sorted({int(k) for k in kinds} - set(PORTED_KINDS))
        if bad:
            raise NotImplementedError(f"texture kinds {bad} are not ported "
                                      "(constant and checker are)")


def eval_texture(bank: Textures, tex_id, uv):
    """(R,) texture ids + (R,2) uv -> (R,3) rgb; tex_id < 0 gives ones."""
    tid = torch.clamp(tex_id, min=0).long()
    k = bank.kind[tid]
    c0 = bank.c0[tid]
    su = uv * bank.uvscale[tid]
    par = (torch.floor(su[..., 0]) + torch.floor(su[..., 1])).to(
        torch.int32) % 2
    out = torch.where(((k == CHECKER) & (par != 0))[..., None], bank.c1[tid],
                      c0)
    return torch.where((tex_id >= 0)[..., None], out, torch.ones_like(out))
