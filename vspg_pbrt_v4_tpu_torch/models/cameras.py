"""Cameras (counterpart of ``models/cameras.py``): batched ray generation
from pixel positions and lens draws.

- ``PerspectiveCamera``: the pinhole, or with ``lens_radius > 0`` the thin
  lens focused at ``focal_distance`` (a concentric-disk draw on the lens);
- ``OrthographicCamera``;
- ``SphericalCamera``: the equirectangular environment camera;
- ``RealisticCamera``: a lens system of spherical interfaces and an
  aperture stop, from lens rows or the built-in singlet; its
  ``generate_rays`` returns (o, d, weight), the weight the ray's
  radiometric factor (0 for a vignetted ray).

A shutter interval (motion blur) is not ported; the builder and
``convert`` refuse it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..utils import transform as tr
from ..utils.device import OnDevice
from ..utils.math import PI
from ..utils.sampling import sample_uniform_disk_concentric
from ..utils.vecmath import normalize


def _film_point(p_raster):
    return torch.cat([p_raster, torch.zeros_like(p_raster[..., :1])], -1)


def _screen_to_raster(nx, ny, screen, device):
    return (tr.scale(nx, ny, 1.0, device=device)
            @ tr.scale(1.0 / (screen[1] - screen[0]),
                       1.0 / (screen[2] - screen[3]), 1.0, device=device)
            @ tr.translate(-screen[0], -screen[3], 0.0, device=device))


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
        raster_to_camera = (cam_to_screen.inverse()
                            @ _screen_to_raster(nx, ny, screen,
                                                device).inverse())
        return PerspectiveCamera(camera_to_world.to(device), raster_to_camera,
                                 float(lens_radius), float(focal_distance),
                                 (int(nx), int(ny)))

    def generate_rays(self, p_raster, u_lens=None):
        """p_raster (...,2) continuous pixel coords, u_lens (...,2) the lens
        draw (read only by a thin lens) -> world (o, d), d normalized; the
        weight is 1."""
        p_cam = tr.apply_point(self.raster_to_camera, _film_point(p_raster))
        d_cam = normalize(p_cam)
        o_cam = torch.zeros_like(d_cam)
        if self.lens_radius > 0:
            p_lens = self.lens_radius * sample_uniform_disk_concentric(u_lens)
            fd = torch.tensor(self.focal_distance, dtype=torch.float32,
                              device=d_cam.device)
            ft = fd / d_cam[..., 2]
            p_focus = ft[..., None] * d_cam
            o_cam = torch.cat([p_lens, torch.zeros_like(p_lens[..., :1])], -1)
            d_cam = normalize(p_focus - o_cam)
        o = tr.apply_point(self.camera_to_world, o_cam)
        d = normalize(tr.apply_vector(self.camera_to_world, d_cam))
        return o, d


@dataclass(frozen=True)
class OrthographicCamera(OnDevice):
    camera_to_world: tr.Transform
    raster_to_camera: tr.Transform
    resolution: tuple

    @staticmethod
    def make(camera_to_world, resolution, screen_window=(-1.0, 1.0, -1.0, 1.0),
             *, device):
        nx, ny = resolution
        cam_to_screen = tr.orthographic(device=device)
        raster_to_camera = (cam_to_screen.inverse()
                            @ _screen_to_raster(nx, ny, screen_window,
                                                device).inverse())
        return OrthographicCamera(camera_to_world.to(device),
                                  raster_to_camera, (int(nx), int(ny)))

    def generate_rays(self, p_raster, u_lens=None):
        p_cam = tr.apply_point(self.raster_to_camera, _film_point(p_raster))
        d_cam = torch.zeros_like(p_cam)
        d_cam[..., 2] = 1.0
        o = tr.apply_point(self.camera_to_world, p_cam)
        d = normalize(tr.apply_vector(self.camera_to_world, d_cam))
        return o, d


@dataclass(frozen=True)
class SphericalCamera(OnDevice):
    """Equirectangular environment camera."""

    camera_to_world: tr.Transform
    resolution: tuple

    def generate_rays(self, p_raster, u_lens=None):
        nx, ny = self.resolution
        f = dict(dtype=torch.float32, device=p_raster.device)
        u = p_raster[..., 0] / torch.tensor(float(nx), **f)
        v = p_raster[..., 1] / torch.tensor(float(ny), **f)
        theta = PI * v
        phi = 2.0 * PI * u
        d_cam = torch.stack([torch.sin(theta) * torch.cos(phi),
                             torch.sin(theta) * torch.sin(phi),
                             torch.cos(theta)], -1)
        o = tr.apply_point(self.camera_to_world, torch.zeros_like(d_cam))
        d = normalize(tr.apply_vector(self.camera_to_world, d_cam))
        return o, d


@dataclass(frozen=True)
class RealisticCamera(OnDevice):
    """Lens-system camera: rays start on the film plane, pass through a
    sampled point of the rear element and refract through every spherical
    interface; vignetted rays get weight 0.

    Film on the optical axis at z = 0, looking down +z, interface apexes at
    z > 0 toward the scene. Lens rows run front (scene side) to back, as in
    pbrt's .dat files: [curvature radius, thickness, eta, aperture
    diameter], in meters. The weight is cos^4(theta) A_rear / z_rear^2."""

    camera_to_world: tr.Transform
    radius: torch.Tensor  # (E,) curvature radii (0 = aperture stop)
    z_apex: torch.Tensor  # (E,) interface apex z (film at 0)
    eta_behind: torch.Tensor  # (E,) IOR on the film side of each interface
    ap_radius: torch.Tensor  # (E,) clear aperture radius
    film_w: float
    film_h: float
    resolution: tuple

    @staticmethod
    def make(camera_to_world, lens_rows, resolution, film_diag=0.035,
             aperture_diameter=None, film_distance=None, *, device):
        """lens_rows: (E,4) front-to-back [radius, thickness, eta,
        aperture_diameter] in meters; a row's thickness is the gap to the
        next row (the last row's the gap to the film, unless film_distance
        overrides it)."""
        rows = np.asarray(lens_rows, np.float64)
        E = rows.shape[0]
        if aperture_diameter is not None:
            for i in range(E):
                if rows[i, 0] == 0:
                    rows[i, 3] = aperture_diameter
        thick = rows[:, 1].copy()
        if film_distance is not None:
            thick[-1] = film_distance
        # apex z: the gaps accumulated from the film plane backwards
        z = np.zeros(E)
        acc = 0.0
        for i in range(E - 1, -1, -1):
            acc += thick[i]
            z[i] = acc
        eta = np.where(rows[:, 2] == 0, 1.0, rows[:, 2])
        nx, ny = resolution
        aspect = nx / ny
        film_h = film_diag / np.sqrt(1 + aspect**2)
        film_w = aspect * film_h

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        # pbrt's lens tables put the scene toward -z; this axis points the
        # other way, which mirrors the curvature signs
        return RealisticCamera(camera_to_world.to(device), t(-rows[:, 0]),
                               t(z), t(eta), t(rows[:, 3] / 2),
                               float(film_w), float(film_h),
                               (int(nx), int(ny)))

    @staticmethod
    def simple_lens(camera_to_world, resolution, focal=0.05,
                    aperture_diameter=0.01, focus_distance=2.0,
                    film_diag=0.035, *, device):
        """A thin biconvex singlet (n = 1.5, lensmaker R = f) focused at
        focus_distance by a secant search on the film distance (the
        scene builder's fallback without a lens file)."""
        n = 1.5
        R = focal  # R1 = -R2: thin-lens f = R for n = 1.5
        th = 0.003

        def build(di):
            rows = [[R, th, n, aperture_diameter * 2.5],
                    [-R, di, 0.0, aperture_diameter * 2.5]]
            cam = RealisticCamera.make(camera_to_world, rows, resolution,
                                       film_diag=film_diag, device=device)
            return replace(cam, ap_radius=torch.tensor(
                [aperture_diameter * 1.25, aperture_diameter / 2],
                dtype=torch.float32, device=device))

        def axial_focus(di):
            """1/z of the axis crossing of centre-film rays."""
            cam = build(di)
            nx, ny = cam.resolution
            k = 16
            pr = torch.tensor([[nx / 2.0, ny / 2.0]],
                              device=device).repeat(k, 1)
            u = torch.stack([torch.linspace(0.3, 0.7, k, device=device),
                             torch.full((k,), 0.5, device=device)], -1)
            o, d, w = (x.cpu().numpy() for x in cam.generate_rays(pr, u))
            ok = w > 0
            if not ok.any():
                return 0.0
            tx = -o[ok, 0] / np.where(np.abs(d[ok, 0]) < 1e-12, 1e-12,
                                      d[ok, 0])
            z = float(np.median(o[ok, 2] + tx * d[ok, 2]))
            return 1.0 / z if z > 0 else -1.0

        target = 1.0 / max(focus_distance, focal * 1.05)
        d0, d1 = focal * 1.002, focal * 1.1
        f0 = axial_focus(d0) - target
        f1 = axial_focus(d1) - target
        for _ in range(8):  # secant iterations
            if abs(f1 - f0) < 1e-12:
                break
            d2 = d1 - f1 * (d1 - d0) / (f1 - f0)
            d2 = min(max(d2, focal * 1.0005), focal * 1.5)
            d0, f0 = d1, f1
            d1, f1 = d2, axial_focus(d2) - target
        return build(d1)

    def generate_rays(self, p_raster, u_lens):
        nx, ny = self.resolution
        dev = p_raster.device
        f32 = dict(dtype=torch.float32, device=dev)
        # film point (rotated 180 degrees: the lens inverts the image)
        fx = -(p_raster[..., 0] / torch.tensor(float(nx), **f32) - 0.5) \
            * self.film_w
        fy = (p_raster[..., 1] / torch.tensor(float(ny), **f32) - 0.5) \
            * self.film_h
        zero = torch.zeros_like(fx)
        p_film = torch.stack([fx, fy, zero], -1)
        # a point of the rear element's disk
        rear_z = self.z_apex[-1]
        rear_r = self.ap_radius[-1]
        pl = rear_r * sample_uniform_disk_concentric(u_lens)
        p_rear = torch.stack([pl[..., 0], pl[..., 1],
                              torch.broadcast_to(rear_z, fx.shape)], -1)
        d = normalize(p_rear - p_film)
        o = p_film
        ok = torch.ones(fx.shape, dtype=torch.bool, device=dev)
        n_cur = torch.ones(fx.shape, **f32)  # air before the rear element
        one = torch.tensor(1.0, **f32)
        tiny = torch.tensor(1e-9, **f32)
        for i in range(self.radius.shape[0] - 1, -1, -1):  # rear to front
            r = self.radius[i]
            za = self.z_apex[i]
            is_stop = r == 0
            t_plane = (za - o[..., 2]) / torch.where(
                torch.abs(d[..., 2]) < 1e-9, tiny, d[..., 2])
            # the sphere's centre on the axis at za + r
            zc = za + r
            centre = torch.stack(
                [zero, zero, torch.broadcast_to(zc, fx.shape)], -1)
            oc = o - centre
            b = torch.sum(oc * d, -1)
            c = torch.sum(oc * oc, -1) - r * r
            disc = b * b - c
            sq = torch.sqrt(torch.clamp(disc, min=0.0))
            # toward +z a cap centred on the film side (r < 0) is crossed
            # at the far root, r > 0 at the near one
            use_far = (d[..., 2] > 0) ^ (r > 0)
            t_sph = torch.where(use_far, -b + sq, -b - sq)
            t = torch.where(is_stop, t_plane, t_sph)
            ok = ok & torch.where(is_stop, True, disc >= 0) & (t > 1e-9)
            p = o + t[..., None] * d
            ok = ok & (p[..., 0] ** 2 + p[..., 1] ** 2
                       <= self.ap_radius[i] ** 2)
            # refract (not at the stop)
            n_hit = normalize(p - centre)
            n_hit = torch.where((torch.sum(n_hit * d, -1) > 0)[..., None],
                                -n_hit, n_hit)
            # the medium in front of interface i: row i - 1's gap, air
            # before the front element
            n_next = torch.broadcast_to(
                self.eta_behind[i - 1] if i > 0 else one, fx.shape)
            ratio = n_cur / torch.where(is_stop, n_cur, n_next)
            cos_i = -torch.sum(n_hit * d, -1)
            sin2_t = ratio ** 2 * torch.clamp(1.0 - cos_i ** 2, min=0.0)
            tir = sin2_t > 1.0
            cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
            d_ref = normalize(ratio[..., None] * d
                              + (ratio * cos_i - cos_t)[..., None] * n_hit)
            d = torch.where(is_stop, d, torch.where(tir[..., None], d, d_ref))
            ok = ok & (is_stop | ~tir)
            o = p
            n_cur = torch.where(is_stop, n_cur, n_next)
        # the radiometric weight (pbrt RealisticCamera::GenerateRay)
        d0 = normalize(p_rear - p_film)
        cos4 = d0[..., 2] ** 4
        area = math.pi * rear_r ** 2
        w = torch.where(ok, cos4 * area / torch.clamp(rear_z, min=1e-9) ** 2,
                        0.0)
        o_w = tr.apply_point(self.camera_to_world, o)
        d_w = normalize(tr.apply_vector(self.camera_to_world, d))
        return o_w, d_w, w
