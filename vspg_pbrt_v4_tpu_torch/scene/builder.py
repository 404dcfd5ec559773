"""Graphics-state scene builder: directives -> this package's render setup
(counterpart of the JAX package's ``scene/builder.py``, for the part of
it this package serves).

A CTM and attribute stack walks the directive list as the JAX builder
does, collecting shapes with their material, area light and medium
interface, lights and media, then builds the scene, camera and film on
the requested device. It builds trianglemesh, plymesh, loopsubdiv and
sphere shapes; every material of the JAX builder (diffuse, conductor,
dielectric, thindielectric, diffusetransmission, coateddiffuse and
plastic, coatedconductor, cooktorrance, subsurface, hair, mix of two
named materials, measured from a MERL file) and every texture (constant,
checkerboard, imagemap, scale, mix, fbm, wrinkled, windy, marble, dots,
bilerp, uv, and ptex baked into a face atlas whose rects rewrite the
bound mesh's corner uvs); point, spot,
goniometric, projection and distant lights, triangle area lights, the
constant or image ``infinite`` light (a lat-long image resampled to an
equal-area square) with an optional ``portal``, blackbody spectra, and
the uniform, power and bvh light samplers; homogeneous, uniform-grid
(inline or from an ``.npz`` gridfile), ``nanovdb`` (an ``.nvdb`` file),
``rgbgrid``, procedural ``cloud`` and ``earth`` media (the earth's
heightmap an image file); the perspective camera (pinhole or thin lens),
the orthographic, spherical and realistic cameras (a ``lensfile`` read in
millimetres, else the built-in singlet); the ``rgb`` film; the box,
triangle, gaussian and mitchell filters; and every sampler the JAX
package names (independent, stratified, halton, sobol, paddedsobol,
zsobol, pmj02bn).

Where the JAX builder warns and degrades (an unknown shape, light,
medium, texture, material, camera or filter type), this one warns or
degrades in the same way. Where the JAX builder builds something this
package does not serve yet (other shapes, instancing, motion blur, the
spectral film), it raises ``NotImplementedError`` naming the directive, its
type and its ``file:line`` (ROADMAP.md §A 8). Asset files (PLY meshes,
image textures, light images, volume grids, heightmaps) load on
background threads from
the start of the build (``scene/assets.py``).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple

import numpy as np
import torch

from ..models.cameras import (OrthographicCamera, PerspectiveCamera,
                              RealisticCamera, SphericalCamera)
from ..models.film import RGBFilm
from ..models.filters import Filter
from ..models.integrators.volpath import Scene
from ..models.lights import Lights, equal_area_texel
from ..models.materials import (COATED_CONDUCTOR, COATED_DIFFUSE, CONDUCTOR,
                                COOK_TORRANCE, DIELECTRIC, DIFFUSE,
                                DIFFUSE_TRANS, HAIR, MEASURED, MIX,
                                SUBSURFACE, THIN_DIELECTRIC, Materials,
                                hair_sigma_a_from_reflectance, load_merl_brdf)
from ..models.media import (CloudMedium, EarthMedium, GridMedium, Media,
                            RGBGridMedium)
from ..models.portal_light import PortalLight
from ..models.shapes import Geometry
from ..models import textures as T
from ..models.textures import (Textures, build_face_atlas,
                               load_face_textures)
from ..utils import transform as tr
from ..utils.envmap import latlong_to_equal_area
from . import assets
from .parser import ParameterDictionary, PbrtError

# what the JAX builder builds and this package does not serve yet
_UNPORTED_SHAPES = ("disk", "cylinder", "curve", "bilinearmesh", "bilinear")
_FILTERS = ("box", "triangle", "gaussian", "mitchell")


class RenderSetup(NamedTuple):
    scene: Scene
    camera: object  # one of models/cameras.py
    film: RGBFilm
    integrator: str
    integrator_params: dict
    sampler: str
    spp: int
    camera_medium: int
    outfile: str


def _unported(d, what, kind):
    return NotImplementedError(
        f"{d.loc}: {d.name} {what} \"{kind}\" is not ported yet "
        "(ROADMAP.md §A 8)")


class _GState:
    def __init__(self):
        self.ctm = tr.identity(device="cpu")
        self.material = 0
        self.area_light = None  # pending AreaLightSource params
        self.medium_in = -1
        self.medium_out = -1

    def copy(self):
        g = _GState()
        g.__dict__.update(self.__dict__)
        return g


def _xf_pts(ctm, pts):
    """Points through the CTM in float32, as the JAX builder does."""
    return tr.apply_point(ctm, torch.as_tensor(
        np.asarray(pts, np.float32))).numpy()


def _xf_nrm(ctm, ns):
    n = tr.apply_normal(ctm, torch.as_tensor(
        np.asarray(ns, np.float32))).numpy()
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    return n / np.maximum(ln, 1e-20)


def _env_fn(env_L, env_img):
    """The environment's radiance along directions (N,3) (numpy): the
    equal-area image's texel, else the constant."""
    if env_img is None:
        const = np.asarray(env_L, np.float32)
        return lambda dirs: np.broadcast_to(const, (len(dirs), 3))
    eimg = np.asarray(env_img, np.float32)

    def env_fn(dirs):
        iy, ix = equal_area_texel(torch.as_tensor(
            np.asarray(dirs, np.float32)), eimg.shape[0])
        return eimg[iy.numpy(), ix.numpy()]

    return env_fn


def _load_ply(fname):
    try:
        return assets.get_ply(fname)
    except (OSError, ValueError):
        return None


def build_render_setup(directives, spp_override=None, res_override=None, *,
                       device="cuda"):
    """RenderSetup of this package's scene, camera and film on `device`,
    with the integrator name and parameters, the sampler, spp, the camera
    medium (-1: vacuum) and the film's file name."""
    assets.prefetch(directives)
    st = _GState()
    stack = []

    tris = []
    tri_meshes = []  # whole-mesh array bundles (meshes without a light)
    spheres = []
    mats = [dict(type=DIFFUSE, albedo=(0.5, 0.5, 0.5))]  # default material
    named_mats = {}
    measured_bank = []  # measured BRDF tables (MERL .binary)
    area_tris = []
    point_lights = []
    spot_lights = []
    gonio_lights = []
    proj_lights = []
    distant_lights = []
    env_L = env_img = portal_corners = None
    homog_media = []
    grid_media = []
    proc_media = []
    named_media = {}
    camera_directive = None
    cam_to_world = tr.identity(device="cpu")
    film_params = None
    integrator = "volpath"
    integrator_params = {}
    sampler = "independent"
    spp = 16
    filter_directive = None
    textures = []
    tex_images = []  # the image textures' arrays, atlas order
    named_textures = {}
    ptex_rects_by_tex = {}  # texture id -> its faces' atlas rects
    face_atlas_rects = {}  # material id -> its texture's face rects
    named_coord_systems = {}

    def warn(msg, loc):
        warnings.warn(f"{loc}: {msg}")

    def add_material(d, mtype, p):
        """Append the material's row; a row whose albedo is a face atlas
        keeps the atlas's face rects for the meshes bound to it."""
        mats.append(_make_material(d, mtype, p, warn, named_textures,
                                   named_mats, measured_bank))
        tref = mats[-1].get("albedo_tex", -1)
        if tref in ptex_rects_by_tex:
            face_atlas_rects[len(mats) - 1] = ptex_rects_by_tex[tref]
        return len(mats) - 1

    def handle_shape(d, p, st):
        stype = d.args[0]
        has_light = st.area_light is not None
        if has_light:
            lp = st.area_light
            L_area = (lp.get_rgb("L", np.asarray([1.0, 1, 1]))
                      * lp.get_float("scale", 1.0))
            two = lp.get_bool("twosided", False)
        mat_id = st.material

        def add_mesh(Pw, idx, Nw=None, UV=None, rects=None):
            """A mesh without a light (and without face rects) as one
            array bundle, else triangle by triangle: triangle i of a mesh
            whose material's texture is a face atlas takes face i's rect
            (pbrt's Ptex faceIndex), as in the JAX builder."""
            if not has_light and rects is None:
                bund = dict(p0=Pw[idx[:, 0]], p1=Pw[idx[:, 1]],
                            p2=Pw[idx[:, 2]], mat=mat_id,
                            med_in=st.medium_in, med_out=st.medium_out)
                if Nw is not None:
                    bund.update(n0=Nw[idx[:, 0]], n1=Nw[idx[:, 1]],
                                n2=Nw[idx[:, 2]])
                if UV is not None:
                    bund.update(uv0=UV[idx[:, 0]], uv1=UV[idx[:, 1]],
                                uv2=UV[idx[:, 2]])
                tri_meshes.append(bund)
                return
            for t_i, (a, b, c) in enumerate(idx):
                light_id = -1
                if has_light:
                    light_id = len(area_tris)
                    area_tris.append(dict(p0=Pw[a], p1=Pw[b], p2=Pw[c],
                                          L=L_area, twosided=two))
                trid = dict(p0=Pw[a], p1=Pw[b], p2=Pw[c], mat=mat_id,
                            light=light_id, med_in=st.medium_in,
                            med_out=st.medium_out)
                if Nw is not None:
                    trid.update(n0=Nw[a], n1=Nw[b], n2=Nw[c])
                if rects is not None and t_i < len(rects):
                    u0, v0, u1, v1 = rects[t_i]
                    # the face's barycentric corners onto its atlas rect
                    trid.update(uv0=(u1, v0), uv1=(u0, v1), uv2=(u0, v0))
                elif UV is not None:
                    trid.update(uv0=UV[a], uv1=UV[b], uv2=UV[c])
                tris.append(trid)

        if stype == "sphere":
            r = p.get_float("radius", 1.0)
            c = _xf_pts(st.ctm, np.zeros(3))
            if has_light:
                warn("sphere area light approximated by geometry only "
                     "(NEE samples triangles)", d.loc)
            spheres.append(dict(c=c, r=r, mat=mat_id, light=-1,
                                med_in=st.medium_in, med_out=st.medium_out))
        elif stype == "trianglemesh":
            P = p.get_floats("P")
            idx = p.get_ints("indices")
            if P is None or idx is None:
                raise PbrtError(
                    "trianglemesh requires \"P\" and \"indices\"", d.loc)
            N = p.get_floats("N")
            UV = p.get_floats("uv")
            if UV is None:
                UV = p.get_floats("st")
            add_mesh(_xf_pts(st.ctm, P.reshape(-1, 3)), idx.reshape(-1, 3),
                     _xf_nrm(st.ctm, N.reshape(-1, 3)) if N is not None
                     else None,
                     UV.reshape(-1, 2) if UV is not None else None,
                     face_atlas_rects.get(mat_id))
        elif stype == "loopsubdiv":
            from ..utils.loopsubdiv import subdivide

            P = p.get_floats("P").reshape(-1, 3)
            idx = p.get_ints("indices").reshape(-1, 3)
            Pl, Fl, Nl = subdivide(P, idx, levels=p.get_int("levels", 3))
            add_mesh(_xf_pts(st.ctm, Pl), np.asarray(Fl),
                     _xf_nrm(st.ctm, Nl))
        elif stype == "plymesh":
            fname = p.get_string("filename")
            mesh = _load_ply(fname) if fname else None
            if mesh is None:
                warn(f"plymesh '{fname}' could not be loaded; skipped",
                     d.loc)
            elif has_light:
                # the JAX builder drops a light mesh's uvs here
                add_mesh(_xf_pts(st.ctm, mesh["P"]), mesh["indices"],
                         _xf_nrm(st.ctm, mesh["N"]) if "N" in mesh
                         else None)
            else:
                add_mesh(_xf_pts(st.ctm, mesh["P"]), mesh["indices"],
                         _xf_nrm(st.ctm, mesh["N"]) if "N" in mesh
                         else None, mesh.get("uv"))
        elif stype in _UNPORTED_SHAPES:
            raise _unported(d, "shape", stype)
        else:
            warn(f"shape '{stype}' unsupported; skipped", d.loc)

    for d in directives:
        name = d.name
        p = ParameterDictionary(d.params)
        try:
            if name == "LookAt":
                a = d.args
                st.ctm = st.ctm @ tr.look_at(a[0:3], a[3:6], a[6:9],
                                             device="cpu").inverse()
            elif name == "Translate":
                st.ctm = st.ctm @ tr.translate(*d.args, device="cpu")
            elif name == "Scale":
                st.ctm = st.ctm @ tr.scale(*d.args, device="cpu")
            elif name == "Rotate":
                st.ctm = st.ctm @ tr.rotate(d.args[0], d.args[1:4],
                                            device="cpu")
            elif name in ("Transform", "ConcatTransform"):
                m = np.asarray(d.args, np.float32).reshape(4, 4).T
                t = tr.from_matrix(m, device="cpu")
                st.ctm = t if name == "Transform" else st.ctm @ t
            elif name == "Identity":
                st.ctm = tr.identity(device="cpu")
            elif name == "ActiveTransform":
                if (d.args[0] if d.args else "All").lower() != "all":
                    raise _unported(d, "(motion blur)", d.args[0])
            elif name == "TransformTimes":
                pass  # shutter times only matter with motion blur
            elif name == "Camera":
                camera_directive = (d.args[0], p, d)
                cam_to_world = st.ctm.inverse()
            elif name == "Film":
                film_type = d.args[0] if d.args else "rgb"
                if film_type == "spectral":
                    raise _unported(d, "type", film_type)
                if film_type not in ("rgb", "gbuffer"):
                    warnings.warn(f"film '{film_type}' unsupported; using "
                                  "rgb")
                film_params = p
            elif name == "Sampler":
                sampler = d.args[0]
                spp = p.get_int("pixelsamples", 16)
            elif name == "Integrator":
                integrator = d.args[0]
                integrator_params = dict(d.params)
            elif name in ("Filter", "PixelFilter"):
                filter_directive = (d.args[0] if d.args else "box", p)
            elif name == "Accelerator":
                accel = d.args[0] if d.args else "bvh"
                if accel == "kdtree":
                    raise _unported(d, "type", accel)
                if accel != "bvh":
                    warn(f"unknown accelerator '{accel}', using bvh", d.loc)
            elif name in ("ColorSpace", "WorldEnd", "ReverseOrientation"):
                pass  # sRGB built-in; the JAX builder flips no normal
            elif name == "WorldBegin":
                st = _GState()
            elif name in ("AttributeBegin", "TransformBegin"):
                stack.append(st.copy())
            elif name in ("AttributeEnd", "TransformEnd"):
                st = stack.pop()
            elif name == "Material":
                mtype = d.args[0] if d.args else ""
                if mtype in ("", "none", "interface"):
                    st.material = -1  # medium interface / no BSDF
                else:
                    st.material = add_material(d, mtype, p)
            elif name == "MakeNamedMaterial":
                named_mats[d.args[0]] = add_material(
                    d, p.get_string("type", "diffuse"), p)
            elif name == "NamedMaterial":
                st.material = named_mats.get(d.args[0], 0)
            elif name == "AreaLightSource":
                st.area_light = p
            elif name == "LightSource":
                ltype = d.args[0]
                scale = p.get_float("scale", 1.0)
                if ltype == "point":
                    I_ = p.get_rgb("I", np.asarray([1.0, 1, 1])) * scale
                    frm = p.get_point3("from", np.zeros(3))
                    point_lights.append((_xf_pts(st.ctm, frm), I_))
                elif ltype == "spot":
                    I_ = p.get_rgb("I", np.asarray([1.0, 1, 1])) * scale
                    frm = p.get_point3("from", np.zeros(3))
                    to = p.get_point3("to", np.asarray([0, 0, 1.0]))
                    cone = p.get_float("coneangle", 30.0)
                    delta = p.get_float("conedeltaangle", 5.0)
                    spot_lights.append(dict(
                        p=_xf_pts(st.ctm, frm), I=I_,
                        dir=_xf_pts(st.ctm, to) - _xf_pts(st.ctm, frm),
                        cos_total=float(np.cos(np.radians(cone))),
                        cos_start=float(np.cos(np.radians(cone - delta)))))
                elif ltype in ("goniometric", "projection"):
                    I_ = p.get_rgb("I", np.asarray([1.0, 1, 1])) * scale
                    fname = p.get_string("filename")
                    try:
                        img = assets.get_image(fname)
                    except Exception as ex:  # noqa: BLE001 - any load failure warns
                        warn(f"{ltype} image '{fname}' failed ({ex}); "
                             "uniform", d.loc)
                        img = np.ones((2, 2, 3), np.float32)
                    light = dict(p=_xf_pts(st.ctm, np.zeros(3)), I=I_,
                                 img=img, rot=st.ctm.m_inv.numpy().astype(
                                     np.float32)[:3, :3])
                    if ltype == "goniometric":
                        gonio_lights.append(light)
                    else:
                        proj_lights.append(dict(
                            light, fov_deg=p.get_float("fov", 90.0)))
                elif ltype == "distant":
                    L = p.get_rgb("L", np.asarray([1.0, 1, 1])) * scale
                    frm = p.get_point3("from", np.zeros(3))
                    to = p.get_point3("to", np.asarray([0, 0, 1.0]))
                    distant_lights.append(
                        (_xf_pts(st.ctm, to) - _xf_pts(st.ctm, frm), L))
                elif ltype == "infinite":
                    fname = p.get_string("filename")
                    if fname is not None:
                        img = assets.get_image(fname) * scale
                        if img.shape[0] != img.shape[1]:
                            img = latlong_to_equal_area(img)
                        env_img = img
                    else:
                        L = p.get_rgb("L", None)
                        if L is None:
                            L = p.get_rgb("radiance", np.asarray([1.0, 1, 1]))
                        env_L = L * scale
                    prt = p.get_floats("portal")
                    if prt is not None and len(prt) == 12:
                        portal_corners = _xf_pts(
                            st.ctm, np.asarray(prt, np.float32).reshape(4, 3))
                else:
                    warn(f"light '{ltype}' unsupported; ignored", d.loc)
            elif name == "MakeNamedMedium":
                mname = d.args[0]
                mtype = p.get_string("type", "homogeneous")
                if mtype == "homogeneous":
                    homog_media.append(dict(
                        sigma_a=p.get_rgb("sigma_a", np.asarray([1.0, 1, 1]))
                        * p.get_float("scale", 1.0),
                        sigma_s=p.get_rgb("sigma_s", np.asarray([1.0, 1, 1]))
                        * p.get_float("scale", 1.0),
                        Le=p.get_rgb("Le", np.zeros(3)),
                        g=p.get_float("g", 0.0)))
                    named_media[mname] = ("homog", len(homog_media) - 1)
                elif mtype in ("uniformgrid", "grid", "nanovdb"):
                    gridfile = p.get_string("gridfile",
                                            p.get_string("filename", ""))
                    grid_media.append(_grid_medium(st.ctm, p, gridfile,
                                                   mtype))
                    named_media[mname] = ("grid", len(grid_media) - 1)
                elif mtype == "rgbgrid":
                    grid_media.append(_rgb_grid_medium(st.ctm, p))
                    named_media[mname] = ("grid", len(grid_media) - 1)
                elif mtype == "cloud":
                    b0 = _xf_pts(st.ctm, p.get_point3("p0", np.zeros(3)))
                    b1 = _xf_pts(st.ctm, p.get_point3("p1", np.ones(3)))
                    scale = p.get_float("scale", 1.0)
                    proc_media.append(CloudMedium.make(
                        sigma_a=p.get_rgb("sigma_a", np.asarray([1.0, 1, 1]))
                        * scale,
                        sigma_s=p.get_rgb("sigma_s", np.asarray([1.0, 1, 1]))
                        * scale,
                        g=p.get_float("g", 0.0),
                        p0=np.minimum(b0, b1), p1=np.maximum(b0, b1),
                        density=p.get_float("density", 1.0),
                        wispiness=p.get_float("wispiness", 1.0),
                        frequency=p.get_float("frequency", 5.0),
                        device=device))
                    named_media[mname] = ("proc", len(proc_media) - 1)
                elif mtype == "earth":
                    proc_media.append(_earth_medium(st.ctm, p, d, warn,
                                                    device))
                    named_media[mname] = ("proc", len(proc_media) - 1)
                else:
                    warn(f"medium '{mtype}' unsupported; ignored (media: "
                         "homogeneous, uniformgrid, nanovdb, rgbgrid, "
                         "cloud, earth)", d.loc)
            elif name == "MediumInterface":
                def mid(nm):
                    if not nm or nm not in named_media:
                        return -1
                    kind, idx = named_media[nm]
                    if kind == "homog":
                        return idx
                    return (10_000 if kind == "grid" else 20_000) + idx

                st.medium_in = mid(d.args[0] if len(d.args) > 0 else "")
                st.medium_out = mid(d.args[1] if len(d.args) > 1 else "")
            elif name in ("ObjectBegin", "ObjectEnd", "ObjectInstance"):
                raise _unported(d, "(instancing)",
                                d.args[0] if d.args else "")
            elif name == "Shape":
                handle_shape(d, p, st)
            elif name == "Texture":
                tname = d.args[0]
                row = _texture_row(d, p, warn, named_textures, tex_images,
                                   len(textures), ptex_rects_by_tex)
                textures.append(row)
                named_textures[tname] = len(textures) - 1
            elif name == "CoordinateSystem":
                named_coord_systems[d.args[0]] = st.ctm
            elif name == "CoordSysTransform":
                if d.args[0] in named_coord_systems:
                    st.ctm = named_coord_systems[d.args[0]]
                else:
                    warn(f"unknown coordinate system '{d.args[0]}'", d.loc)
            else:
                warn(f"unknown directive '{name}' ignored", d.loc)
        except NotImplementedError as e:
            if str(e).startswith(d.loc):
                raise
            raise NotImplementedError(f"{d.loc}: {name}: {e}") from None

    # remap medium ids: the homogeneous block, the grids, the procedurals
    n_h, n_g = len(homog_media), len(grid_media)

    def remap(m):
        if m >= 20_000:
            return n_h + n_g + (m - 20_000)
        return n_h + (m - 10_000) if m >= 10_000 else m

    for it in (*tris, *spheres, *tri_meshes):
        it["med_in"] = remap(it["med_in"])
        it["med_out"] = remap(it["med_out"])

    geometry = Geometry.build(triangles=tris, spheres=spheres,
                              tri_meshes=tri_meshes, device=device)
    materials = Materials.build(
        mats, np.stack(measured_bank) if measured_bank else None,
        device=device)
    tex_bank = (Textures.build(textures, tex_images, device=device)
                if textures else None)
    media = Media.make(homogeneous=homog_media or None,
                       grids=tuple(grid_media),
                       procedurals=tuple(proc_media), device=device)
    # world radius from the geometry's extent
    pts = []
    for lst, keys in ((tris, ("p0", "p1", "p2")), (spheres, ("c",))):
        for it in lst:
            for k in keys:
                pts.append(np.asarray(it[k], np.float32))
    for b in tri_meshes:
        if np.asarray(b["p0"]).shape[0]:
            for k in ("p0", "p1", "p2"):
                pts.append(np.abs(np.asarray(b[k], np.float32)).max(0))
    world_r = 2.0 * float(np.abs(np.asarray(pts)).max()) if pts else 100.0
    lsampler = "uniform"
    if "lightsampler" in integrator_params:
        lsampler = str(integrator_params["lightsampler"][1][0])
    lights = Lights.make(
        point_p=[pl[0] for pl in point_lights] or None,
        point_I=[pl[1] for pl in point_lights] or None,
        distant_dir=[dl[0] for dl in distant_lights] or None,
        distant_L=[dl[1] for dl in distant_lights] or None,
        area_tris=area_tris or None, env_L=env_L, env_img=env_img,
        world_radius=max(world_r, 10.0), sampler=lsampler,
        spots=spot_lights or None, gonios=gonio_lights or None,
        projections=proj_lights or None, device=device)
    if portal_corners is not None and (env_L is not None
                                       or env_img is not None):
        lights = dataclasses.replace(lights, portal=PortalLight.make(
            _env_fn(env_L, env_img), portal_corners, res=128, device=device))
    scene = Scene(geometry, materials, media, lights, tex_bank)

    nx = res_override[0] if res_override else (
        film_params.get_int("xresolution", 1280) if film_params else 1280)
    ny = res_override[1] if res_override else (
        film_params.get_int("yresolution", 720) if film_params else 720)
    outfile = (film_params.get_string("filename", "out.exr")
               if film_params else "out.exr")
    film_filter = Filter.make("box", device=device)
    if filter_directive is not None:
        fname, fp = filter_directive
        # an unknown filter is the box, as in the JAX builder
        film_filter = Filter.make(fname if fname in _FILTERS else "box",
                                  radius=fp.get_float("xradius", None),
                                  sigma=fp.get_float("sigma", 0.5),
                                  device=device)
    film = RGBFilm.make((nx, ny), filter=film_filter, device=device)
    camera = _camera(camera_directive, cam_to_world, (nx, ny), device)
    return RenderSetup(scene, camera, film, integrator, integrator_params,
                       sampler, spp_override or spp, -1, outfile)


def _camera(camera_directive, cam_to_world, res, device):
    """The Camera directive's camera, as the JAX builder makes it; a
    perspective camera's shutter interval (motion blur) is refused."""
    ctype, cp, cd = camera_directive if camera_directive else (
        "perspective", None, None)
    if ctype == "perspective":
        fov = cp.get_float("fov", 90.0) if cp else 90.0
        if cp and (cp.get_float("shutteropen", 0.0)
                   != cp.get_float("shutterclose", 0.0)):
            raise _unported(cd, "(motion blur)", ctype)
        return PerspectiveCamera.make(
            cam_to_world, fov, res,
            lens_radius=cp.get_float("lensradius", 0.0) if cp else 0.0,
            focal_distance=cp.get_float("focaldistance", 1e6) if cp else 1e6,
            device=device)
    if ctype == "orthographic":
        return OrthographicCamera.make(cam_to_world, res, device=device)
    if ctype == "spherical":
        return SphericalCamera(cam_to_world.to(device), tuple(res))
    if ctype == "realistic":
        lensfile = cp.get_string("lensfile") if cp else None
        ap = cp.get_float("aperturediameter", 1.0) / 1000.0 if cp else 1e-3
        focus = cp.get_float("focusdistance", 10.0) if cp else 10.0
        if lensfile:
            rows = []
            with open(lensfile) as f:
                for line in f:
                    line = line.split("#")[0].strip()
                    if line:
                        v = [float(x) for x in line.split()]
                        # lens files are in millimetres
                        rows.append([v[0] / 1000, v[1] / 1000, v[2],
                                     v[3] / 1000])
            return RealisticCamera.make(cam_to_world, rows, res,
                                        aperture_diameter=ap, device=device)
        return RealisticCamera.simple_lens(cam_to_world, res,
                                           aperture_diameter=ap,
                                           focus_distance=focus,
                                           device=device)
    warnings.warn(f"camera '{ctype}' unsupported; using perspective")
    return PerspectiveCamera.make(cam_to_world, 90.0, res, device=device)


def _grid_medium(ctm, p, gridfile, mtype):
    """A density-grid medium: from a NanoVDB file (type "nanovdb" or a
    gridfile ending in .nvdb; its world bounds, else the unit cube, and
    densityoffset added), from an npz gridfile (density, bmin, bmax) or
    inline, with the JAX builder's majorant resolution: 64 from a file, 16
    inline (media.cpp:252 against :574)."""
    if gridfile.endswith(".nvdb") or mtype == "nanovdb":
        dens, p0, p1 = assets.get_volume(gridfile)
        if p0 is None:
            p0, p1 = np.zeros(3), np.ones(3)
        dens = dens + p.get_float("densityoffset", 0.0)
    elif gridfile:
        z = np.load(gridfile)
        dens = np.asarray(z["density"], np.float32)
        p0 = np.asarray(z["bmin"] if "bmin" in z.files else np.zeros(3),
                        np.float32)
        p1 = np.asarray(z["bmax"] if "bmax" in z.files else np.ones(3),
                        np.float32)
    else:
        dens = p.get_floats("density")
        nx, ny, nz = (p.get_int(k, 1) for k in ("nx", "ny", "nz"))
        p0 = p.get_point3("p0", np.zeros(3))
        p1 = p.get_point3("p1", np.ones(3))
        dens = dens.reshape(nz, ny, nx).transpose(2, 1, 0)  # pbrt order
    b0, b1 = _xf_pts(ctm, p0), _xf_pts(ctm, p1)
    scale = p.get_float("scale", 1.0)
    return GridMedium.make(
        dens, p.get_rgb("sigma_a", np.asarray([1.0, 1, 1])) * scale,
        p.get_rgb("sigma_s", np.asarray([1.0, 1, 1])) * scale,
        np.minimum(b0, b1), np.maximum(b0, b1), g=p.get_float("g", 0.0),
        maj_res=64 if gridfile else 16,
        majorant_scale=p.get_float("majorantscale", 1.0), device="cpu")


def _rgb_grid_medium(ctm, p):
    """An RGB-grid medium from inline (nz, ny, nx, 3) sigma_a, sigma_s and
    optional Le grids in pbrt's order, reordered to (nx, ny, nz, 3); scale
    multiplies sigma_a and sigma_s, Lescale the emission."""
    nx, ny, nz = (p.get_int(k, 1) for k in ("nx", "ny", "nz"))
    scale = p.get_float("scale", 1.0)

    def rgb_grid(key):
        vals = p.get_floats(key)
        if vals is None or vals.size == 0:
            return np.zeros((nx, ny, nz, 3), np.float32)
        return vals.reshape(nz, ny, nx, 3).transpose(2, 1, 0, 3) * scale

    b0 = _xf_pts(ctm, p.get_point3("p0", np.zeros(3)))
    b1 = _xf_pts(ctm, p.get_point3("p1", np.ones(3)))
    le = p.get_floats("Le")
    return RGBGridMedium.make(
        rgb_grid("sigma_a"), rgb_grid("sigma_s"), np.minimum(b0, b1),
        np.maximum(b0, b1),
        Le=(le.reshape(nz, ny, nx, 3).transpose(2, 1, 0, 3)
            if le is not None and le.size else None),
        Le_scale=p.get_float("Lescale", 1.0), g=p.get_float("g", 0.0),
        majorant_scale=p.get_float("majorantscale", 1.0), device="cpu")


def _earth_medium(ctm, p, d, warn, device):
    """The fork's earth medium; a heightmap that fails to load warns and
    leaves a constant shell, as in the JAX builder."""
    b0 = _xf_pts(ctm, p.get_point3("p0", -2 * np.ones(3)))
    b1 = _xf_pts(ctm, p.get_point3("p1", 2 * np.ones(3)))
    hm = None
    hm_file = p.get_string("heightmap", "")
    if hm_file:
        try:
            im = assets.get_image(hm_file)
            hm = im.mean(-1) if im.ndim == 3 else im
        except Exception as ex:  # noqa: BLE001 - any load failure warns
            warn(f"earth heightmap '{hm_file}' failed ({ex}); constant "
                 "shell", d.loc)
    return EarthMedium.make(
        sigma_a_atm=p.get_rgb("sigma_a_atmosphere", np.ones(3)),
        sigma_s_atm=p.get_rgb("sigma_s_atmosphere", np.ones(3)),
        sigma_a_cloud=p.get_rgb("sigma_a_cloud", np.zeros(3)),
        sigma_s_cloud=p.get_rgb("sigma_s_cloud", np.zeros(3)),
        g=p.get_float("g", 0.0), p0=np.minimum(b0, b1),
        p1=np.maximum(b0, b1),
        center=_xf_pts(ctm, p.get_point3("center", np.zeros(3))),
        inner_r_atm=p.get_float("innerradius_atmosphere", 1.0),
        inner_r_cloud=p.get_float("innerradius_cloud", 1.0),
        outer_r_atm=p.get_float("outerradius_atmosphere", 1.0),
        outer_r_cloud=p.get_float("outerradius_cloud", 1.0),
        decay=p.get_float("decay", 1.0),
        majorant_scale=p.get_float("majorantscale", 1.0),
        density_offset=p.get_float("densityoffset", 0.0),
        rotation_y=p.get_float("rotationy", 0.0), heightmap=hm,
        scale_atm=p.get_float("scale_atmosphere", 1.0),
        scale_cloud=p.get_float("scale_cloud", 1.0), device=device)


def _texture_row(d, p, warn, named_textures, tex_images, tex_id,
                 ptex_rects_by_tex):
    """The texture table's row of a Texture directive, as the JAX builder
    makes it: an image loads through the asset prefetch into tex_images,
    a ptex file's faces bake into one atlas image whose face rects go to
    ptex_rects_by_tex[tex_id]; a file that fails to load and an unknown
    class warn and give a constant."""
    tclass = d.args[2]

    def uvscale():
        return (p.get_float("uscale", 1.0), p.get_float("vscale", 1.0))

    if tclass == "constant":
        return dict(kind=T.CONSTANT,
                    c0=tuple(p.get_rgb("value", np.ones(3))))
    if tclass in ("checkerboard", "checker"):
        return dict(kind=T.CHECKER, c0=tuple(p.get_rgb("tex1", np.ones(3))),
                    c1=tuple(p.get_rgb("tex2", np.zeros(3))),
                    uvscale=uvscale())
    if tclass == "imagemap":
        fname = p.get_string("filename")
        try:
            tex_images.append(assets.get_image(fname))
        except Exception as ex:  # noqa: BLE001 - any load failure warns
            warn(f"imagemap '{fname}' failed to load ({ex}); using "
                 "constant", d.loc)
            return dict(kind=T.CONSTANT, c0=(0.5, 0.5, 0.5))
        return dict(kind=T.IMAGE, image_id=len(tex_images) - 1,
                    uvscale=uvscale())
    if tclass == "scale":
        return dict(kind=T.SCALE, c0=tuple(p.get_rgb("scale", np.ones(3))),
                    inner=named_textures.get(p.get_string("tex", ""), -1))
    if tclass == "mix":
        amt = p.get_float("amount", 0.5)
        return dict(kind=T.MIX, c0=(amt, amt, amt),
                    inner=named_textures.get(p.get_string("tex1", ""), -1),
                    inner2=named_textures.get(p.get_string("tex2", ""), -1))
    if tclass in ("fbm", "wrinkled", "windy", "marble"):
        kind = {"fbm": T.FBM, "wrinkled": T.WRINKLED, "windy": T.WINDY,
                "marble": T.MARBLE}[tclass]
        return dict(kind=kind, octaves=p.get_int("octaves", 8),
                    omega=p.get_float("roughness", 0.5),
                    scale=p.get_float("scale", 1.0),
                    variation=p.get_float("variation", 0.2))
    if tclass == "dots":
        return dict(kind=T.DOTS, c0=tuple(p.get_rgb("outside", np.ones(3))),
                    c1=tuple(p.get_rgb("inside", np.zeros(3))),
                    uvscale=uvscale())
    if tclass == "bilerp":
        return dict(kind=T.BILERP, c0=tuple(p.get_rgb("v00", np.zeros(3))),
                    c1=tuple(p.get_rgb("v01", np.zeros(3))),
                    c2=tuple(p.get_rgb("v10", np.ones(3))),
                    c3=tuple(p.get_rgb("v11", np.ones(3))), uvscale=uvscale())
    if tclass == "uv":
        return dict(kind=T.UV)
    if tclass == "ptex":
        fname = p.get_string("filename")
        try:
            atlas, rects = build_face_atlas(load_face_textures(fname))
        except Exception as ex:  # noqa: BLE001 - any load failure warns
            warn(f"ptex '{fname}' failed to load ({ex}); using constant",
                 d.loc)
            return dict(kind=T.CONSTANT, c0=(0.5, 0.5, 0.5))
        tex_images.append(atlas)
        ptex_rects_by_tex[tex_id] = rects
        return dict(kind=T.IMAGE, image_id=len(tex_images) - 1,
                    uvscale=(1.0, 1.0))
    warn(f"texture type '{tclass}' unsupported; constant grey", d.loc)
    return dict(kind=T.CONSTANT, c0=(0.5, 0.5, 0.5))


def _make_material(d, mtype, p, warn, named_textures, named_mats,
                   measured_bank):
    """One material row (the JAX builder's ``_make_material``): its
    defaults, warnings and fallbacks to diffuse. A measured material's
    table goes to measured_bank."""
    grey = dict(type=DIFFUSE, albedo=(0.5, 0.5, 0.5))

    def tex_of(pname):
        if pname in p.params and p.params[pname][0] == "texture":
            return named_textures.get(str(p.params[pname][1][0]), -1)
        return -1

    def rgb(name, default):
        return tuple(p.get_rgb(name, np.asarray([default] * 3)))

    if mtype == "diffuse":
        t = tex_of("reflectance")
        if t >= 0:
            return dict(type=DIFFUSE, albedo=(1.0, 1.0, 1.0), albedo_tex=t)
        return dict(type=DIFFUSE, albedo=rgb("reflectance", 0.5))
    if mtype == "conductor":
        refl = p.get_rgb("reflectance", None)
        if refl is None:
            refl = np.asarray([0.9, 0.7, 0.4])  # generic metal F0
        return dict(type=CONDUCTOR, albedo=tuple(refl),
                    roughness=p.get_float("roughness", 0.0))
    if mtype == "dielectric":
        return dict(type=DIELECTRIC, eta=p.get_float("eta", 1.5),
                    roughness=p.get_float("roughness", 0.0))
    if mtype == "thindielectric":
        return dict(type=THIN_DIELECTRIC, eta=p.get_float("eta", 1.5))
    if mtype == "diffusetransmission":
        return dict(type=DIFFUSE_TRANS, albedo=rgb("reflectance", 0.25),
                    albedo2=rgb("transmittance", 0.25))
    if mtype in ("coateddiffuse", "plastic"):
        return dict(type=COATED_DIFFUSE, albedo=rgb("reflectance", 0.5),
                    roughness=p.get_float("roughness", 0.0),
                    eta=p.get_float("interface.eta",
                                    p.get_float("eta", 1.5)),
                    albedo_tex=tex_of("reflectance"))
    if mtype == "coatedconductor":
        refl = p.get_rgb("conductor.reflectance", None)
        if refl is None:
            refl = np.asarray([0.9, 0.7, 0.4])
        return dict(type=COATED_CONDUCTOR, albedo=tuple(refl),
                    roughness=p.get_float("conductor.roughness", 0.01),
                    roughness2=p.get_float("interface.roughness",
                                           p.get_float("roughness", 0.0)),
                    eta=p.get_float("interface.eta", 1.5))
    if mtype == "cooktorrance":
        rough = p.get_float("roughness", 0.0)
        rough = max(p.get_float("uroughness", rough),
                    p.get_float("vroughness", rough))
        return dict(type=COOK_TORRANCE, albedo=rgb("reflectance", 0.5),
                    roughness=rough, eta=p.get_float("eta", 1.5),
                    albedo_tex=tex_of("reflectance"))
    if mtype == "subsurface":
        # the mean free path from sigma_a and sigma_s (d ~ 1 / sigma_t'),
        # else given directly
        sig_s = p.get_rgb("sigma_s", None)
        sig_a = p.get_rgb("sigma_a", None)
        g = p.get_float("g", 0.0)
        scale = p.get_float("scale", 1.0)
        if sig_s is not None and sig_a is not None:
            sig_sp = np.asarray(sig_s) * (1.0 - g) * scale
            sig_t = sig_sp + np.asarray(sig_a) * scale
            A = sig_sp / np.maximum(sig_t, 1e-6)
            d_mfp = 1.0 / np.maximum(sig_t, 1e-6)
        else:
            A = np.asarray(p.get_rgb("reflectance", np.asarray([0.5] * 3)))
            d_mfp = np.asarray(p.get_rgb("mfp", np.asarray([1.0] * 3)))
        return dict(type=SUBSURFACE, albedo=tuple(A), albedo2=tuple(d_mfp),
                    eta=p.get_float("eta", 1.33))
    if mtype == "hair":
        # sigma_a directly, else from a reflectance, else from melanin
        beta_m = p.get_float("beta_m", 0.3)
        beta_n = p.get_float("beta_n", 0.3)
        sig = p.get_rgb("sigma_a", None)
        if sig is None:
            refl = p.get_rgb("reflectance", p.get_rgb("color", None))
            if refl is not None:
                sig = hair_sigma_a_from_reflectance(refl, beta_n)
            else:
                ce = p.get_float("eumelanin", 1.3)
                cp = p.get_float("pheomelanin", 0.0)
                sig = (ce * np.asarray([0.419, 0.697, 1.37])
                       + cp * np.asarray([0.187, 0.4, 1.05]))
        return dict(type=HAIR, albedo2=tuple(np.asarray(sig, np.float64)),
                    eta=p.get_float("eta", 1.55), roughness=beta_m,
                    roughness2=beta_n,
                    mix_amount=float(np.radians(p.get_float("alpha", 2.0))))
    if mtype == "mix":
        names = [str(n) for n in p.params.get("materials", ("string", []))[1]]
        if len(names) == 2:
            # amount is the probability of the second material
            # (materials.h MixMaterial::ChooseMaterial)
            return dict(type=MIX, mix_m1=named_mats.get(names[1], 0),
                        mix_m2=named_mats.get(names[0], 0),
                        mix_amount=p.get_float("amount", 0.5))
        warn("mix material needs two named materials; using diffuse", d.loc)
        return grey
    if mtype == "measured":
        fn = p.get_string("filename", None)
        if fn is None:
            warn('measured material needs "string filename"; using diffuse',
                 d.loc)
            return grey
        try:
            tbl = load_merl_brdf(str(fn))
        except Exception as ex:  # noqa: BLE001 - any load failure warns
            warn(f"measured BRDF '{fn}' failed to load ({ex}); using "
                 "diffuse", d.loc)
            return grey
        measured_bank.append(tbl)
        return dict(type=MEASURED, meas_id=len(measured_bank) - 1)
    warn(f"material '{mtype}' unsupported; using diffuse", d.loc)
    return grey
