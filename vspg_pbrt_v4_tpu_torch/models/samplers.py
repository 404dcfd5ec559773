"""Per-lane sampler state (counterpart of ``models/samplers.py``
``LaneSampler``, the ``"independent"`` kind only).

A lane's state is (pixel_id, sample_index, dim); every draw bumps ``dim``
for every lane, as in the JAX package, so a lane's random stream depends on
how many draws its batch made.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ..utils import rng


@dataclass(frozen=True)
class LaneSampler:
    seed: int  # uint32 value
    pixel_id: torch.Tensor  # (R,) int64 holding uint32 values
    sample_index: torch.Tensor  # (R,) int64
    dim: torch.Tensor  # (R,) int64

    @staticmethod
    def start(seed, pixel_id, sample_index, kind="independent"):
        if kind != "independent":
            raise NotImplementedError(f"sampler {kind!r} is not ported yet")
        pid = pixel_id.to(torch.int64)
        sidx = torch.broadcast_to(torch.as_tensor(sample_index,
                                                  device=pid.device), pid.shape)
        return LaneSampler(int(seed) & 0xFFFFFFFF, pid,
                           sidx.to(torch.int64), torch.zeros_like(pid))

    def _draw(self, lane):
        return rng.uniform4(self.seed, self.pixel_id, self.sample_index,
                            self.dim * 4 + lane)[0]

    def get_1d(self):
        u = self._draw(0)
        return replace(self, dim=self.dim + 1), u

    def get_2d(self):
        u = torch.stack([self._draw(0), self._draw(1)], dim=-1)
        return replace(self, dim=self.dim + 1), u

    def advance(self, n):
        """Skip `n` draws whose values nobody reads."""
        return replace(self, dim=self.dim + n)
