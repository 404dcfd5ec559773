"""Pinhole perspective camera (counterpart of ``models/cameras.py``
``PerspectiveCamera`` with ``lens_radius == 0``)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..utils import transform as tr
from ..utils.device import OnDevice
from ..utils.vecmath import normalize


@dataclass(frozen=True)
class PerspectiveCamera(OnDevice):
    camera_to_world: tr.Transform
    raster_to_camera: tr.Transform  # pixel coords -> camera-space near plane
    lens_radius: float
    focal_distance: float
    resolution: tuple  # (nx, ny)

    @staticmethod
    def make(camera_to_world, fov_deg, resolution, lens_radius=0.0,
             focal_distance=1e6, screen_window=None, *, device):
        if lens_radius > 0:
            raise NotImplementedError("thin-lens cameras are not ported yet")
        nx, ny = resolution
        aspect = nx / ny
        if screen_window is None:
            if aspect > 1:
                screen = (-aspect, aspect, -1.0, 1.0)
            else:
                screen = (-1.0, 1.0, -1.0 / aspect, 1.0 / aspect)
        else:
            screen = screen_window
        cam_to_screen = tr.perspective(fov_deg, device=device)
        screen_to_raster = (
            tr.scale(nx, ny, 1.0, device=device)
            @ tr.scale(1.0 / (screen[1] - screen[0]),
                       1.0 / (screen[2] - screen[3]), 1.0, device=device)
            @ tr.translate(-screen[0], -screen[3], 0.0, device=device))
        raster_to_camera = cam_to_screen.inverse() @ screen_to_raster.inverse()
        return PerspectiveCamera(camera_to_world.to(device), raster_to_camera,
                                 float(lens_radius), float(focal_distance),
                                 (int(nx), int(ny)))

    def generate_rays(self, p_raster, u_lens=None):
        """p_raster (...,2) continuous pixel coords -> world (o, d),
        d normalized. u_lens is unused: the camera is a pinhole."""
        p_film = torch.cat([p_raster, torch.zeros_like(p_raster[..., :1])], -1)
        d_cam = normalize(tr.apply_point(self.raster_to_camera, p_film))
        o = tr.apply_point(self.camera_to_world, torch.zeros_like(d_cam))
        d = normalize(tr.apply_vector(self.camera_to_world, d_cam))
        return o, d
