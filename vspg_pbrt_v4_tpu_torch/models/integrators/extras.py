"""Auxiliary render passes (counterpart of ``models/integrators/extras.py``,
the guiding-cache view only)."""

from __future__ import annotations

import torch

from ...utils import rng
from .volpath import start_camera_paths


def render_guiding_gbuffer(scene, camera, film, field):
    """Guiding-cache ids at each pixel's first hit (pbrt's GuidedGBufferFilm
    view): ((ny, nx, 3) colors hashed from the cell id, black where the
    camera ray escapes; (ny, nx) cell ids), on the film's device."""
    pixel_id = torch.arange(film.npix, device=film.device)
    s, _ = start_camera_paths(camera, film, 0, torch.zeros_like(pixel_id),
                              pixel_id, -1)
    h = scene.geometry.intersect(s.o, s.d, torch.full_like(s.o[..., 0],
                                                           torch.inf))
    cid = field.cell_id(h.p)
    u = rng.uniform3(0xC0FFEE, cid, 1, 2)
    rgb = torch.where(h.hit[..., None], u, 0.0)
    nx, ny = film.resolution
    return rgb.reshape(ny, nx, 3), cid.reshape(ny, nx)
