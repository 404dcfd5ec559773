"""Per-lane sampler state (counterpart of ``models/samplers.py``
``LaneSampler``, every kind of it).

A lane's state is (pixel_id, sample_index, dim); every draw bumps ``dim``
for every lane, as in the JAX package, so a lane's random stream depends on
how many draws its batch made. The kinds, each draw for draw the JAX
package's (its salts, its draw order):

- "independent": pcg4d counter hashing (IndependentSampler);
- "stratified": a Latin hypercube over spp from a stateless random
  permutation of the sample index per (pixel, dim, sub-dimension), plus
  jitter;
- "paddedsobol": Owen-scrambled Sobol' dimensions 0 and 1 over a
  per-(pixel, dim) permutation of the sample index;
- "sobol": full-dimensional Sobol' (generated direction numbers,
  ``utils/lowdiscrepancy.sobol_u32``), Owen-scrambled per (pixel, dim);
- "zsobol": Morton-shuffled Sobol' (the Morton index from the film's
  width ``nx`` and log2 spp); with ``nx == 0`` the padded kind;
- "halton": scrambled radical inverses in the first prime bases;
- "pmj02bn" / "pmj02": per-pixel progressive (0,2) pairs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import torch

from ..utils import rng
from ..utils.lowdiscrepancy import (encode_morton2, fast_owen_scramble,
                                    permutation_element,
                                    scrambled_radical_inverse, sobol_dim0,
                                    sobol_dim1, sobol_u32,
                                    u32_to_unit_float, zsobol_shuffled_index)

_PADDED = ("paddedsobol", "zsobol", "halton")
_PMJ = ("pmj02bn", "pmj02")


@dataclass(frozen=True)
class LaneSampler:
    seed: int  # uint32 value
    pixel_id: torch.Tensor  # (R,) int64 holding uint32 values
    sample_index: torch.Tensor  # (R,) int64
    dim: torch.Tensor  # (R,) int64
    kind: str = "independent"
    spp: int = 0
    nx: int = 0  # the film's width (zsobol's Morton index)

    @staticmethod
    def start(seed, pixel_id, sample_index, kind="independent", spp=0, nx=0):
        pid = pixel_id.to(torch.int64)
        sidx = torch.broadcast_to(torch.as_tensor(sample_index,
                                                  device=pid.device), pid.shape)
        return LaneSampler(int(seed) & 0xFFFFFFFF, pid,
                           sidx.to(torch.int64), torch.zeros_like(pid),
                           str(kind), int(spp), int(nx))

    def _dim_seed(self, salt):
        return rng.hash_u32(self.pixel_id, self.dim, self.seed, salt)

    def _permuted_index(self, salt=0x9FA1):
        if self.spp <= 1:
            return self.sample_index
        return permutation_element(self.sample_index, self.spp,
                                   self._dim_seed(salt))

    def _draw(self, lane):
        """One scalar draw for sub-dimension `lane` of the current dim."""
        if self.kind == "independent":
            return rng.uniform4(self.seed, self.pixel_id, self.sample_index,
                                self.dim * 4 + lane)[0]
        if self.kind == "stratified":
            # a distinct permutation per sub-dimension avoids a diagonal
            # u1-u2 correlation
            idx = self._permuted_index(0x9FA1 + 0x632B * lane)
            jit = rng.uniform4(self.seed, self.pixel_id, self.sample_index,
                               self.dim * 4 + lane)[0]
            n = torch.tensor(float(max(self.spp, 1)), device=jit.device)
            return torch.clamp((idx.to(torch.float32) + jit) / n,
                               max=0.99999994)
        if self.kind == "halton":
            return scrambled_radical_inverse(
                lane, self.sample_index,
                self._dim_seed(0x6A09 + 0x9E37 * lane))
        if self.kind == "zsobol" and self.nx > 0:
            px = self.pixel_id % self.nx
            py = self.pixel_id // self.nx
            log2spp = max(int(math.ceil(math.log2(max(self.spp, 1)))), 0)
            res_bits = int(math.ceil(math.log2(max(self.nx, 2))))
            n_d4 = (2 * res_bits + log2spp + 1) // 2 + 1
            morton = (((encode_morton2(px, py) << log2spp) & 0xFFFFFFFF)
                      | (self.sample_index & ((1 << log2spp) - 1)))
            idx = zsobol_shuffled_index(morton, n_d4, self._dim_seed(0x2F8B))
            v = sobol_dim1(idx) if lane == 1 else sobol_dim0(idx)
            return u32_to_unit_float(
                fast_owen_scramble(v, self._dim_seed(0x55 + lane)))
        if self.kind in _PMJ:
            v = (sobol_dim1(self.sample_index) if lane == 1
                 else sobol_dim0(self.sample_index))
            return u32_to_unit_float(fast_owen_scramble(
                v, self._dim_seed(0x2B7E + 0x9E37 * lane)))
        if self.kind == "sobol":
            d_idx = self.dim * 4 + lane
            v = sobol_u32(self.sample_index, d_idx)
            # per-(pixel, dimension) Owen scramble, independent of the
            # sample index, so each pixel's sequence stays a (0,2)-net
            return u32_to_unit_float(fast_owen_scramble(
                v, rng.hash_u32(self.pixel_id, d_idx, self.seed, 0x50B01)))
        if self.kind in _PADDED:
            idx = self._permuted_index()
            v = sobol_dim1(idx) if lane == 1 else sobol_dim0(idx)
            return u32_to_unit_float(
                fast_owen_scramble(v, self._dim_seed(0x55 + lane)))
        raise ValueError(f"unknown sampler kind {self.kind}")

    def get_1d(self):
        u = self._draw(0)
        return replace(self, dim=self.dim + 1), u

    def get_2d(self):
        u = torch.stack([self._draw(0), self._draw(1)], dim=-1)
        return replace(self, dim=self.dim + 1), u

    def get_3d(self):
        u = torch.stack([self._draw(0), self._draw(1), self._draw(2)],
                        dim=-1)
        return replace(self, dim=self.dim + 1), u

    def get_4d(self):
        us = (self._draw(0), self._draw(1), self._draw(2), self._draw(3))
        return replace(self, dim=self.dim + 1), us

    def advance(self, n):
        """Skip `n` draws whose values nobody reads."""
        return replace(self, dim=self.dim + n)
