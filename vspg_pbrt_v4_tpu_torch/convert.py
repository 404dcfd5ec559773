"""Build this package's scene objects from the JAX package's.

``from_jax(scene, camera, film, cfg, device)`` reads the JAX objects'
leaves through ``np.asarray`` and attribute access only, so both packages
can render one scene in the tests. It imports no JAX: ``np.asarray`` of a
JAX array needs none. Objects outside the ported scope raise
``NotImplementedError`` instead of being converted partly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models.cameras import (OrthographicCamera, PerspectiveCamera,
                             RealisticCamera, SphericalCamera)
from .models.film import RGBFilm
from .models.filters import Filter
from .models.integrators.volpath import Scene, VolPathConfig
from .models.lights import Lights
from .models.lightsamplers import LightBVH
from .models.materials import Materials
from .models.media import (CloudMedium, EarthMedium, GridMedium, Media,
                           RGBGridMedium)
from .models.portal_light import PortalLight
from .models.shapes import Geometry
from .models.textures import Textures
from .ops.bvh import bvh_from_arrays
from .utils.transform import Transform


def _t(x, device, dtype=None):
    a = np.asarray(x)
    if dtype is None:
        dtype = torch.float32 if a.dtype.kind == "f" else torch.int32
    return torch.as_tensor(a.copy(), dtype=dtype, device=device)


def _count(x):
    return 0 if x is None else int(np.asarray(x).shape[0])


def _geometry(g, device):
    others = (_count(g.dsk_c) + _count(g.cyl_c) + _count(g.blp_p00)
              + _count(g.crv_p0))
    if others or getattr(g, "inst", None) is not None:
        raise NotImplementedError("only boxes, spheres and triangles are "
                                  "ported")
    T = _count(g.tri_p0)

    def uv(x, default):
        # a JAX geometry without uv arrays maps the hit to barycentrics
        if x is None or _count(x) == 0:
            return np.tile(np.float32(default), (T, 1))
        return x

    return Geometry(
        _t(g.box_min, device), _t(g.box_max, device), _t(g.box_mat, device),
        _t(g.box_light, device), _t(g.box_med_in, device),
        _t(g.box_med_out, device), _t(g.tri_p0, device),
        _t(g.tri_p1, device), _t(g.tri_p2, device), _t(g.tri_n0, device),
        _t(g.tri_n1, device), _t(g.tri_n2, device),
        _t(uv(g.tri_uv0, (1, 0)), device, torch.float32),
        _t(uv(g.tri_uv1, (0, 1)), device, torch.float32),
        _t(uv(g.tri_uv2, (0, 0)), device, torch.float32),
        _t(g.tri_mat, device, torch.int32),
        _t(g.tri_light, device, torch.int32),
        _t(g.tri_med_in, device, torch.int32),
        _t(g.tri_med_out, device, torch.int32),
        _t(g.sph_c, device, torch.float32), _t(g.sph_r, device, torch.float32),
        _t(g.sph_mat, device, torch.int32), _t(g.sph_light, device, torch.int32),
        _t(g.sph_med_in, device, torch.int32),
        _t(g.sph_med_out, device, torch.int32), _tri_bvh(g.tri_bvh, device))


def _tri_bvh(bvh, device):
    """The JAX geometry's triangle BVH, the very same tree, or None."""
    if bvh is None:
        return None
    if type(bvh).__name__ != "BVH":
        raise NotImplementedError(f"the {type(bvh).__name__} aggregate is "
                                  "not ported (only the BVH)")
    return bvh_from_arrays(bvh, device=device)


def _materials(m, device):
    """Every field of the JAX Materials, the measured bank included."""
    f32, i32 = torch.float32, torch.int32
    return Materials(
        _t(m.mat_type, device, i32), _t(m.albedo, device, f32),
        _t(m.eta, device, f32), _t(m.roughness, device, f32),
        _t(m.albedo_tex, device, i32), _t(m.albedo2, device, f32),
        _t(m.roughness2, device, f32), _t(m.mix_m1, device, i32),
        _t(m.mix_m2, device, i32), _t(m.mix_amount, device, f32),
        _t(m.meas_id, device, i32),
        None if m.meas_bank is None else _t(m.meas_bank, device, f32))


def _textures(tex, device):
    """Every field of the JAX Textures, the image atlas included."""
    if tex is None:
        return None
    f32, i32 = torch.float32, torch.int32
    return Textures(
        _t(tex.kind, device, i32), _t(tex.c0, device, f32),
        _t(tex.c1, device, f32), _t(tex.uvscale, device, f32),
        _t(tex.image_id, device, i32), _t(tex.inner, device, i32),
        _t(tex.inner2, device, i32), _t(tex.params, device, f32),
        _t(tex.atlas, device, f32), _t(tex.c2, device, f32),
        _t(tex.c3, device, f32), bool(tex.has_images))


def _media(m, device):
    """Homogeneous block, then grids, then procedurals: the JAX Media's
    medium ids."""
    procs = []
    for pm in getattr(m, "procedurals", ()):
        cls = {"CloudMedium": CloudMedium,
               "EarthMedium": EarthMedium}.get(type(pm).__name__)
        if cls is None:
            raise NotImplementedError(f"{type(pm).__name__} is not ported")
        procs.append(cls(*(_t(getattr(pm, f), device, torch.float32)
                           for f in cls.__dataclass_fields__)))
    grids = []
    for gm in m.grids:
        if type(gm).__name__ == "RGBGridMedium":
            grids.append(RGBGridMedium(
                *(_t(getattr(gm, f), device, torch.float32)
                  for f in list(RGBGridMedium.__dataclass_fields__)[:-2]),
                tuple(int(v) for v in gm.res),
                tuple(int(v) for v in gm.maj_res)))
            continue
        if type(gm).__name__ != "GridMedium":
            raise NotImplementedError(f"{type(gm).__name__} is not ported")
        grids.append(GridMedium(
            _t(gm.density, device), _t(gm.sigma_a, device),
            _t(gm.sigma_s, device), _t(gm.Le, device), _t(gm.g, device),
            _t(gm.b_min, device), _t(gm.b_max, device),
            _t(gm.majorant, device), tuple(int(v) for v in gm.res),
            tuple(int(v) for v in gm.maj_res)))
    return Media(_t(m.h_sigma_a, device), _t(m.h_sigma_s, device),
                 _t(m.h_Le, device), _t(m.h_g, device), tuple(grids),
                 tuple(procs))


def _arrays(obj, cls, device, skip=()):
    """The array fields of `cls` read from `obj`: float32, bool or int64
    tensors by the array's kind."""
    out = {}
    for f in dataclasses.fields(cls):
        a = getattr(obj, f.name)
        if f.name in skip or a is None or isinstance(a, (bool, int, float)):
            continue
        kind = np.asarray(a).dtype.kind
        out[f.name] = _t(a, device, torch.float32 if kind == "f" else
                         torch.bool if kind == "b" else torch.int64)
    return out


def _lights(li, device):
    """Every field of a JAX ``Lights``, with its light BVH and portal."""
    bvh = portal = None
    if li.bvh is not None:
        bvh = LightBVH(**_arrays(li.bvh, LightBVH, device),
                       max_depth=int(li.bvh.max_depth))
    if li.portal is not None:
        portal = PortalLight(**_arrays(li.portal, PortalLight, device))
    return Lights(**_arrays(li, Lights, device, skip=("bvh", "portal")),
                  has_env=bool(li.has_env), has_env_img=bool(li.has_env_img),
                  world_radius=float(li.world_radius), bvh=bvh, portal=portal)


def _transform(t, device):
    return Transform(_t(t.m, device), _t(t.m_inv, device))


def _camera(cam, device):
    kind = type(cam).__name__
    if kind == "PerspectiveCamera":
        if cam.shutter_close > cam.shutter_open:
            raise NotImplementedError("motion blur is not ported yet")
        return PerspectiveCamera(_transform(cam.camera_to_world, device),
                                 _transform(cam.raster_to_camera, device),
                                 float(cam.lens_radius),
                                 float(cam.focal_distance),
                                 tuple(int(v) for v in cam.resolution))
    res = tuple(int(v) for v in cam.resolution)
    c2w = _transform(cam.camera_to_world, device)
    if kind == "OrthographicCamera":
        return OrthographicCamera(c2w, _transform(cam.raster_to_camera,
                                                  device), res)
    if kind == "SphericalCamera":
        return SphericalCamera(c2w, res)
    if kind == "RealisticCamera":
        return RealisticCamera(c2w, _t(cam.radius, device),
                               _t(cam.z_apex, device),
                               _t(cam.eta_behind, device),
                               _t(cam.ap_radius, device), float(cam.film_w),
                               float(cam.film_h), res)
    raise NotImplementedError(f"camera {kind} is not ported")


def _film(film, device):
    if type(film).__name__ != "RGBFilm":
        raise NotImplementedError("only RGBFilm is ported")
    f = film.filter
    tables = ((_t(f.table_cdf, device), _t(f.table_sign, device))
              if f.kind == "mitchell" else (None, None))
    return RGBFilm(_t(film.sensor_matrix, device),
                   Filter(f.kind, float(f.radius), float(f.sigma), *tables),
                   tuple(int(v) for v in film.resolution),
                   float(film.imaging_ratio), float(film.max_component))


def from_jax(scene, camera, film, cfg, device):
    """(Scene, camera, RGBFilm, VolPathConfig) of this package
    holding the values of the given JAX objects, on `device`."""
    port_scene = Scene(_geometry(scene.geometry, device),
                       _materials(scene.materials, device),
                       _media(scene.media, device),
                       _lights(scene.lights, device),
                       _textures(getattr(scene, "textures", None), device))
    return (port_scene, _camera(camera, device), _film(film, device),
            VolPathConfig(**cfg._asdict()))


def _half_from_jax(h, device):
    from .models.guiding.field import FieldHalf

    return FieldHalf(*(_t(getattr(h, f), device, torch.float32)
                       for f in FieldHalf.__dataclass_fields__))


def field_from_jax(field, device="cuda"):
    """This package's GuidingField holding the values of a JAX one, the
    adaptive field's indirection arrays and leaf centres included."""
    from .models.guiding.field import GuidingField

    return GuidingField(_t(field.b_min, device, torch.float32),
                        _t(field.b_max, device, torch.float32),
                        _half_from_jax(field.surface, device),
                        _half_from_jax(field.volume, device),
                        int(field.iteration), int(field.res),
                        int(field.n_lobes), n_extra=int(field.n_extra),
                        leaf_of=_t(field.leaf_of, device, torch.int64),
                        refined=_t(field.refined, device, torch.bool),
                        child_base=_t(field.child_base, device, torch.int64),
                        n_leaves=int(field.n_leaves),
                        leaf_center=_t(field.leaf_center, device,
                                       torch.float32))


def isgb_from_jax(isgb, device="cuda"):
    """This package's ISGB holding the values of a JAX one, the U-Net's
    state (parameters and Adam's moments) included."""
    from .models.guiding import denoiser as dn
    from .models.guiding.isgb import _ARRAYS, ISGB

    net = None
    if isgb.net is not None:
        params, (m, v) = isgb.net
        net = dn.state_from_jax(params, m, v, device)
    return ISGB(*(_t(getattr(isgb, f), device, torch.float32)
                  for f in _ARRAYS), bool(isgb.ready),
                tuple(int(r) for r in isgb.resolution),
                str(isgb.vsp_criterion), str(isgb.denoiser), net)


def options_from_jax(gopt, vopt):
    """(GuidingOptions, VSPGOptions) of this package with the values of the
    JAX package's options tuples. ``VSPGOptions.calculate_tr_buffer`` is
    dropped: the JAX package defines it and reads it nowhere."""
    from .models.integrators.guided_volpath import GuidingOptions
    from .models.integrators.vspg import VSPGOptions

    def pick(cls, opt):
        return cls(**{k: v for k, v in opt._asdict().items()
                      if k in cls._fields})

    return pick(GuidingOptions, gopt), pick(VSPGOptions, vopt)
