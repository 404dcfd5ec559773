"""RGB film with scatter-add accumulation (counterpart of
``models/film.py``). ``index_add_`` takes the place of JAX's
``.at[pixel_id].add``; it updates the state's buffers in place."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..utils.device import OnDevice
from .filters import Filter


class FilmState(NamedTuple):
    rgb_sum: torch.Tensor  # (npix, 3) weighted radiance sum
    weight_sum: torch.Tensor  # (npix,) filter weight sum


@dataclass(frozen=True)
class RGBFilm(OnDevice):
    sensor_matrix: torch.Tensor  # (3,3)
    filter: Filter
    resolution: tuple  # (nx, ny)
    imaging_ratio: float
    max_component: float

    @staticmethod
    def make(resolution, imaging_ratio=1.0, sensor_matrix=None,
             max_component=math.inf, filter=None, *, device):
        if sensor_matrix is None:
            sensor_matrix = np.eye(3, dtype=np.float32)
        return RGBFilm(
            torch.as_tensor(np.asarray(sensor_matrix, np.float32),
                            device=device),
            Filter.make("box") if filter is None else filter,
            (int(resolution[0]), int(resolution[1])),
            float(imaging_ratio), float(max_component))

    @property
    def npix(self):
        return self.resolution[0] * self.resolution[1]

    @property
    def device(self):
        return self.sensor_matrix.device

    def init_state(self) -> FilmState:
        z = dict(dtype=torch.float32, device=self.device)
        return FilmState(torch.zeros((self.npix, 3), **z),
                         torch.zeros((self.npix,), **z))

    def add_samples(self, state: FilmState, pixel_id, L, weight) -> FilmState:
        """Scatter-add samples; NaN/Inf scrub as in RayIntegrator."""
        bad = torch.any(~torch.isfinite(L), dim=-1)
        L = torch.where(bad[..., None], 0.0, L)
        L = torch.clamp(L, max=self.max_component)
        rgb = self.imaging_ratio * L
        state.rgb_sum.index_add_(0, pixel_id, rgb * weight[..., None])
        state.weight_sum.index_add_(0, pixel_id, weight)
        return state

    def add_pass(self, state: FilmState, L, weight) -> FilmState:
        """Add a pass of k samples a pixel laid out pixel by pixel (lane
        p * k + j holds sample j of pixel p), each pixel's samples in lane
        order: the order of ``add_samples`` on the CPU, and the same bits
        on every run on a card, where ``index_add_`` adds in no fixed
        order."""
        bad = torch.any(~torch.isfinite(L), dim=-1)
        L = torch.where(bad[..., None], 0.0, L)
        L = torch.clamp(L, max=self.max_component)
        rgb = (self.imaging_ratio * L * weight[..., None]).reshape(
            self.npix, -1, 3)
        w = weight.reshape(self.npix, -1)
        for j in range(w.shape[1]):
            state.rgb_sum.add_(rgb[:, j])
            state.weight_sum.add_(w[:, j])
        return state

    def image(self, state: FilmState):
        """Final (ny, nx, 3) image."""
        w = torch.clamp(state.weight_sum, min=1e-12)[..., None]
        rgb = (state.rgb_sum / w) @ self.sensor_matrix.T
        nx, ny = self.resolution
        return rgb.reshape(ny, nx, 3)


def pixel_coords(resolution, *, device):
    """(npix, 2) integer pixel coordinates in raster order (x fastest)."""
    nx, ny = resolution
    gy, gx = torch.meshgrid(torch.arange(ny, device=device),
                            torch.arange(nx, device=device), indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)
