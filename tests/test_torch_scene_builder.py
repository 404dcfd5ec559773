"""The port's scene builder (``vspg_pbrt_v4_tpu_torch/scene/builder.py``)
against the JAX package's: ``build_render_setup(..., device="cpu")``
equals ``convert.from_jax`` of the JAX builder's setup field for field
(ints exact, floats within 1e-6 relative) on the shipped fog box and
Cornell box (spheres, area lights), a uniform-grid string with an area
light (inline and npz grids, a homogeneous medium, textures, the
transform directives), a loopsubdiv string above 64 triangles (the BVH
array for array) and the spp and resolution overrides. Also: spheres
intersected lane for lane with JAX on 4096 rays, the refusals of what
the port does not serve, and every kernel predicate refusing a scene
with one sphere."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vspg_pbrt_v4_tpu.models.integrators import volpath as jv
from vspg_pbrt_v4_tpu.models.shapes import Geometry as JGeometry
from vspg_pbrt_v4_tpu.scene import build_render_setup as jbuild
from vspg_pbrt_v4_tpu.scene import parse_pbrt_file as jparse_file
from vspg_pbrt_v4_tpu.scene import parse_pbrt_string as jparse
from vspg_pbrt_v4_tpu_torch import convert
from vspg_pbrt_v4_tpu_torch.models.film import RGBFilm
from vspg_pbrt_v4_tpu_torch.models.guiding.field import GuidingField
from vspg_pbrt_v4_tpu_torch.models.integrators import guided_volpath as tgv
from vspg_pbrt_v4_tpu_torch.models.integrators import volpath as tv
from vspg_pbrt_v4_tpu_torch.models.integrators import vspg as tvspg
from vspg_pbrt_v4_tpu_torch.models.shapes import Geometry
from vspg_pbrt_v4_tpu_torch.ops import surface_kernels as sk
from vspg_pbrt_v4_tpu_torch.ops import volpath_kernels as vk
from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as gk
from vspg_pbrt_v4_tpu_torch.scene import build_render_setup as tbuild
from vspg_pbrt_v4_tpu_torch.scene import parse_pbrt_file as tparse_file
from vspg_pbrt_v4_tpu_torch.scene import parse_pbrt_string as tparse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GRID = '''
Integrator "guidedvolpathvspg" "string isgbdenoiser" "atrous"
  "string lightsampler" "power"
Sampler "independent" "integer pixelsamples" [8]
Film "rgb" "integer xresolution" [12] "integer yresolution" [10]
  "string filename" "grid.exr"
PixelFilter "box" "float xradius" [0.5]
LookAt 0 0.5 -4  0 0 0  0 1 0
Camera "perspective" "float fov" [35]
WorldBegin
LightSource "point" "rgb I" [3 3 3] "point3 from" [0 1.5 0]
LightSource "infinite" "rgb L" [0.1 0.1 0.1] "float scale" [2]
MakeNamedMedium "smoke" "string type" "uniformgrid"
  "integer nx" [4] "integer ny" [3] "integer nz" [2]
  "float density" [0 1 2 3 4 5 6 7 8 9 10 11 12 13 14 15 16 17 18 19 20 21
                   22 23]
  "rgb sigma_a" [0.1 0.1 0.1] "rgb sigma_s" [0.9 0.8 0.7] "float g" [0.2]
  "point3 p0" [-1 -1 -1] "point3 p1" [1 1 1] "float scale" [0.5]
MakeNamedMedium "file" "string type" "uniformgrid" "string gridfile" "GRIDFILE"
  "rgb sigma_s" [1 1 1] "float majorantscale" [1.5]
MakeNamedMedium "haze" "string type" "homogeneous"
  "rgb sigma_a" [0.01 0.01 0.01] "rgb sigma_s" [0.1 0.1 0.1]
  "rgb Le" [0.01 0 0]
Texture "checks" "spectrum" "checkerboard" "float uscale" [4]
  "rgb tex1" [1 0 0] "rgb tex2" [0 0 1]
Texture "grey" "spectrum" "constant" "rgb value" [0.3 0.3 0.3]
MakeNamedMaterial "ct" "string type" "cooktorrance" "float roughness" [0.3]
  "rgb reflectance" [0.6 0.5 0.4]
AttributeBegin
  Material "interface"
  MediumInterface "smoke" "haze"
  Shape "trianglemesh" "point3 P" [-1 -1 -1  1 -1 -1  1 1 -1  -1 1 -1]
    "integer indices" [0 1 2  0 2 3]
AttributeEnd
AttributeBegin
  MediumInterface "file" ""
  Translate 0.2 0 0
  Rotate 30 0 1 0
  Scale 0.5 0.5 0.5
  CoordinateSystem "local"
  AreaLightSource "diffuse" "rgb L" [4 3 2] "bool twosided" true
  Material "diffuse" "texture reflectance" "checks"
  Shape "trianglemesh" "point3 P" [-1 0.8 -1  1 0.8 -1  1 0.8 1  -1 0.8 1]
    "integer indices" [0 1 2  0 2 3]
    "normal N" [0 -1 0  0 -1 0  0 -1 0  0 -1 0]
    "float uv" [0 0  1 0  1 1  0 1]
AttributeEnd
AttributeBegin
  CoordSysTransform "local"
  NamedMaterial "ct"
  Shape "sphere" "float radius" [0.3]
  Material "conductor" "float roughness" [0.2]
  ConcatTransform 1 0 0 0  0 1 0 0  0 0 1 0  0.1 -0.5 0 1
  Shape "sphere" "float radius" [0.2]
  Material "dielectric" "float eta" [1.33]
  Shape "trianglemesh" "point3 P" [0 -1 0  0.5 -1 0  0 -0.5 0]
    "integer indices" [0 1 2]
AttributeEnd
'''

LOOP = '''
Film "rgb" "integer xresolution" [8] "integer yresolution" [8]
LookAt 0 0 -4  0 0 0  0 1 0
Camera "perspective" "float fov" [30]
WorldBegin
LightSource "point" "rgb I" [5 5 5] "point3 from" [0 2 0]
Material "diffuse" "rgb reflectance" [0.5 0.6 0.7]
AttributeBegin
  Rotate 20 1 1 0
  Shape "loopsubdiv" "integer levels" [2]
    "point3 P" [-0.5 -0.5 -0.5  0.5 -0.5 -0.5  -0.5 0.5 -0.5  0.5 0.5 -0.5
                -0.5 -0.5 0.5  0.5 -0.5 0.5  -0.5 0.5 0.5  0.5 0.5 0.5]
    "integer indices" [0 1 3  0 3 2  4 6 7  4 7 5  0 4 5  0 5 1
                       2 3 7  2 7 6  0 2 6  0 6 4  1 5 7  1 7 3]
AttributeEnd
'''


def _same(t, j, path):
    """The port's object `t` equals `j` (the converted JAX object)."""
    if isinstance(t, torch.Tensor):
        a, b = t.numpy(), j.numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=0, err_msg=path)
        else:
            np.testing.assert_array_equal(a, b, err_msg=path)
    elif dataclasses.is_dataclass(t):
        for f in dataclasses.fields(t):
            _same(getattr(t, f.name), getattr(j, f.name), f"{path}.{f.name}")
    elif isinstance(t, tuple):
        assert len(t) == len(j), path
        for i, (x, y) in enumerate(zip(t, j)):
            _same(x, y, f"{path}[{i}]")
    else:
        assert t == j, (path, t, j)


def _check_alike(ts, js):
    scene, cam, film, _ = convert.from_jax(js.scene, js.camera, js.film,
                                           jv.VolPathConfig(), "cpu")
    _same(ts.scene, scene, "scene")
    _same(ts.camera, cam, "camera")
    _same(ts.film, film, "film")
    assert (ts.integrator, ts.integrator_params, ts.sampler, ts.spp,
            ts.camera_medium, ts.outfile) == (
        js.integrator, js.integrator_params, js.sampler, js.spp,
        js.camera_medium, js.outfile)


@pytest.mark.parametrize("name", ["fogbox.pbrt", "cornell.pbrt"])
@pytest.mark.parametrize("override", [None, (12, (24, 16))])
def test_scene_files_build_alike(name, override):
    path = os.path.join(REPO, "scenes", name)
    spp, res = override or (None, None)
    ts = tbuild(tparse_file(path), spp, res, device="cpu")
    _check_alike(ts, jbuild(jparse_file(path), spp, res))
    if override:
        assert ts.spp == 12 and ts.film.resolution == (24, 16)
    if name == "cornell.pbrt":
        g = ts.scene.geometry
        assert (g.n_tri, g.n_sph, ts.scene.lights.n_area) == (12, 2, 2)


def test_grid_string_builds_alike(tmp_path):
    """Inline and npz grids, a homogeneous medium, the medium-id remap,
    textures, named materials, a two-sided area light with normals and
    uvs, spheres, and the transform directives."""
    rng = np.random.default_rng(3)
    gridfile = str(tmp_path / "g.npz")
    np.savez(gridfile, density=rng.uniform(0, 2, (8, 4, 4)).astype(
        np.float32), bmin=np.float32([-1, -1, -1]),
        bmax=np.float32([1, 0.5, 1]))
    text = GRID.replace("GRIDFILE", gridfile)
    ts = tbuild(tparse(text), device="cpu")
    _check_alike(ts, jbuild(jparse(text)))
    s = ts.scene
    assert s.lights.n_area == 2 and bool(s.lights.area_twosided.all())
    assert [gm.maj_res for gm in s.media.grids] == [(4, 3, 2), (8, 4, 4)]
    assert s.media.n_homog == 1 and s.textures is not None
    # media ids: the homogeneous block, then the grids; the light's
    # triangles come first, then the mesh bundles
    assert s.geometry.tri_med_in.tolist()[:4] == [2, 2, 1, 1]
    assert s.geometry.tri_med_out.tolist()[:4] == [-1, -1, 0, 0]
    assert s.geometry.n_sph == 2


HEADER = '''
Film "rgb" "integer xresolution" [12] "integer yresolution" [8]
LookAt 0.2 0.1 -4  0 0 0  0 1 0
{camera}
{sampler}
{filter}
WorldBegin
LightSource "point" "rgb I" [5 5 5] "point3 from" [0 2 0]
Shape "trianglemesh" "point3 P" [-1 -1 0  1 -1 0  0 1 0]
  "integer indices" [0 1 2]
'''

# the header directives the port builds since the samplers, filters and
# cameras were ported (each was refused before)
HEADERS = {
    "zsobol": dict(sampler='Sampler "zsobol" "integer pixelsamples" [4]'),
    "halton": dict(sampler='Sampler "halton"'),
    "sobol": dict(sampler='Sampler "sobol" "integer pixelsamples" [8]'),
    "paddedsobol": dict(sampler='Sampler "paddedsobol"'),
    "pmj02bn": dict(sampler='Sampler "pmj02bn"'),
    "stratified": dict(sampler='Sampler "stratified"'),
    "gaussian": dict(filter='PixelFilter "gaussian" "float xradius" [1.2] '
                            '"float sigma" [0.4]'),
    "triangle": dict(filter='PixelFilter "triangle"'),
    "mitchell": dict(filter='PixelFilter "mitchell" "float xradius" [1.5]'),
    "unknown filter": dict(filter='PixelFilter "lanczos"'),
    "thin lens": dict(camera='Camera "perspective" "float fov" [40] '
                             '"float lensradius" [0.1] '
                             '"float focaldistance" [3.5]'),
    "orthographic": dict(camera='Camera "orthographic"'),
    "spherical": dict(camera='Camera "spherical"'),
    "realistic": dict(camera='Camera "realistic" "string lensfile" "LENS" '
                             '"float aperturediameter" [8]'),
    "simple lens": dict(camera='Camera "realistic" '
                               '"float aperturediameter" [4] '
                               '"float focusdistance" [2]'),
}


@pytest.mark.parametrize("case", list(HEADERS))
def test_header_directives_build_alike(case, tmp_path):
    """Each sampler, filter and camera that the port once refused builds
    as the JAX builder builds it (converted field for field): the lens
    file's rows read in millimetres, the singlet focused without one, an
    unknown filter the box."""
    lens = tmp_path / "lens.dat"
    lens.write_text("# radius thickness eta aperture (mm)\n"
                    "40 4 1.6 20\n0 3 0 12\n-40 50 1.5 20\n")
    parts = dict(camera='Camera "perspective" "float fov" [35]',
                 sampler='Sampler "independent"',
                 filter='PixelFilter "box"')
    parts.update(HEADERS[case])
    text = HEADER.format(**parts).replace("LENS", str(lens))
    ts = tbuild(tparse(text), device="cpu")
    _check_alike(ts, jbuild(jparse(text)))
    kind = {"camera": type(ts.camera).__name__, "filter": ts.film.filter.kind,
            "sampler": ts.sampler}[next(iter(HEADERS[case]))]
    assert kind.lower().startswith(
        {"thin lens": "perspective", "simple lens": "realistic",
         "unknown filter": "box"}.get(case, case)), kind


def test_loopsubdiv_builds_alike():
    """192 triangles: the mesh class, its BVH array for array."""
    ts = tbuild(tparse(LOOP), device="cpu")
    js = jbuild(jparse(LOOP))
    assert ts.scene.geometry.n_tri == 192
    assert ts.scene.geometry.tri_bvh is not None
    _check_alike(ts, js)


def test_transforms_match_jax():
    """Rotate, Transform, the composition and the point and normal maps
    against the JAX package's utils/transform.py, in float32."""
    from vspg_pbrt_v4_tpu.utils import transform as jtr
    from vspg_pbrt_v4_tpu_torch.utils import transform as ttr

    m = np.float32([[0.9, 0.1, 0, 0.5], [0, 1.2, 0.3, -1], [0.2, 0, 0.8, 2],
                    [0, 0, 0, 1]])
    jt = (jtr.rotate(37.0, (1, 2, 0.5)) @ jtr.from_matrix(m)
          @ jtr.translate(0.1, -0.2, 0.3) @ jtr.scale(2, 1, 0.5))
    tt = (ttr.rotate(37.0, (1, 2, 0.5), device="cpu")
          @ ttr.from_matrix(m, device="cpu")
          @ ttr.translate(0.1, -0.2, 0.3, device="cpu")
          @ ttr.scale(2, 1, 0.5, device="cpu"))
    np.testing.assert_array_equal(tt.m.numpy(), np.asarray(jt.m))
    np.testing.assert_array_equal(tt.m_inv.numpy(), np.asarray(jt.m_inv))
    np.testing.assert_array_equal(ttr.identity(device="cpu").m.numpy(),
                                  np.asarray(jtr.identity().m))
    v = np.random.default_rng(1).normal(size=(64, 3)).astype(np.float32)
    for tfn, jfn in ((ttr.apply_point, jtr.apply_point),
                     (ttr.apply_normal, jtr.apply_normal)):
        np.testing.assert_allclose(tfn(tt, torch.as_tensor(v)).numpy(),
                                   np.asarray(jfn(jt, jnp.asarray(v))),
                                   rtol=1e-6, atol=1e-6)


def test_spheres_lane_for_lane():
    """intersect and intersect_p on 4096 rays through triangles, opaque
    and interface spheres and a box, against the JAX package."""
    rng = np.random.default_rng(0)
    tris = [dict(p0=rng.uniform(-1, 1, 3), p1=rng.uniform(-1, 1, 3),
                 p2=rng.uniform(-1, 1, 3), mat=0) for _ in range(5)]
    sph = [dict(c=(-0.45, 0.4, -0.4), r=0.4, mat=1, light=-1),
           dict(c=(0.5, 0.35, 0.3), r=0.35, mat=-1, med_in=0),
           dict(c=(0.0, -0.5, 0.2), r=0.25, mat=0)]
    box = [dict(bmin=(-1, -1, -1), bmax=(1, 1, 1), mat=-1, med_in=0)]
    jg = JGeometry.build(triangles=tris, spheres=sph, boxes=box)
    tg = Geometry.build(box, tris, sph, device="cpu")
    _same(tg, convert._geometry(jg, "cpu"), "geometry")
    o = rng.uniform(-2, 2, (4096, 3)).astype(np.float32)
    d = rng.normal(size=(4096, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    jh = jax.jit(jg.intersect)(jnp.asarray(o), jnp.asarray(d),
                               jnp.full(4096, jnp.inf))
    th = tg.intersect(torch.as_tensor(o), torch.as_tensor(d))
    hit = np.asarray(jh.hit)
    assert 0.2 < hit.mean() and (np.asarray(jh.prim_id) == 5).any()
    for f in th._fields:
        a, b = np.asarray(getattr(jh, f)), getattr(th, f).numpy()
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b[hit], a[hit], rtol=1e-5, atol=1e-6,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)
    t_max = rng.uniform(0.1, 3, 4096).astype(np.float32)
    np.testing.assert_array_equal(
        tg.intersect_p(torch.as_tensor(o), torch.as_tensor(d),
                       torch.as_tensor(t_max)).numpy(),
        np.asarray(jax.jit(jg.intersect_p)(jnp.asarray(o), jnp.asarray(d),
                                           jnp.asarray(t_max))))


REFUSED = {
    "disk": 'Shape "disk" "float radius" [1]',
    "cylinder": 'Shape "cylinder" "float radius" [1]',
    "curve": 'Shape "curve" "point3 P" [0 0 0 1 0 0 1 1 0 0 1 0]',
    "instancing": 'ObjectBegin "a"',
    "motion blur": ('Camera "perspective" "float shutteropen" [0] '
                    '"float shutterclose" [1]'),
    "bilinearmesh": ('Shape "bilinearmesh" "point3 P" '
                     '[0 0 0 1 0 0 0 1 0 1 1 0]'),
    "spectral": 'Film "spectral"',
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_unported_directives_raise(case):
    """What the JAX builder builds and the port does not serve raises
    NotImplementedError naming the directive, its type and its
    file:line."""
    ds = tparse("WorldBegin\n" + REFUSED[case] + "\n")
    want = f"<string>:2: {REFUSED[case].split()[0]}"
    with pytest.raises(NotImplementedError) as e:
        tbuild(ds, device="cpu")
    assert str(e.value).startswith(want), str(e.value)
    assert case.split()[-1] in str(e.value)


MEDIA_BODY = '''
LookAt 0 0 -4  0 0 0  0 1 0
Camera "perspective" "float fov" [30]
Film "rgb" "integer xresolution" [8] "integer yresolution" [8]
WorldBegin
LightSource "infinite" "rgb L" [0.5 0.5 0.5]
AttributeBegin
  Translate 0.25 0 0
  Scale 1 2 1
  MakeNamedMedium "m" {medium}
AttributeEnd
AttributeBegin
  MediumInterface "m" ""
  Material ""
  Shape "sphere" "float radius" [1.2]
AttributeEnd
'''


def _media_text(case, tmp_path):
    """A scene text whose medium is of the kind `case` names; its files
    (a NanoVDB grid, a PNG heightmap) written under tmp_path."""
    from vspg_pbrt_v4_tpu_torch.tools.nvdb import write_nvdb
    from vspg_pbrt_v4_tpu_torch.utils.image import write_png

    rng = np.random.default_rng(8)
    if case == "nanovdb":
        path = str(tmp_path / "g.nvdb")
        write_nvdb(path, rng.uniform(0, 2, (16, 8, 8)).astype(np.float32),
                   index_origin=(-8, -8, 0), voxel_size=0.125)
        return ('"string type" "nanovdb" "string filename" "%s" '
                '"rgb sigma_s" [1 2 3] "float densityoffset" [0.5] '
                '"float majorantscale" [1.25]' % path)
    if case == "rgbgrid":
        n = 2 * 3 * 4 * 3
        vals = " ".join(f"{v:.4f}" for v in rng.uniform(0, 2, n))
        le = " ".join(f"{v:.4f}" for v in rng.uniform(0, 1, n))
        return ('"string type" "rgbgrid" "integer nx" [2] "integer ny" [3] '
                '"integer nz" [4] "point3 p0" [-1 -1 -1] "point3 p1" '
                f'[1 0.5 1] "float sigma_a" [{vals}] "float sigma_s" '
                f'[{vals}] "float Le" [{le}] "float Lescale" [2] '
                '"float scale" [1.5] "float g" [0.3] '
                '"float majorantscale" [1.1]')
    if case in ("earth", "earth heightmap fails"):
        path = str(tmp_path / "hm.png")
        if case == "earth":
            write_png(path, rng.uniform(0, 1, (8, 16, 3)))
        return ('"string type" "earth" "rgb sigma_a_atmosphere" [0.1 0.2 '
                '0.3] "rgb sigma_s_atmosphere" [1 1.5 2] "rgb sigma_a_cloud" '
                '[0.5 0.5 0.5] "rgb sigma_s_cloud" [2 2 2] "point3 p0" '
                '[-1.5 -1.5 -1.5] "point3 p1" [1.5 1.5 1.5] "point3 center" '
                '[0 0.1 0] "float innerradius_atmosphere" [0.5] '
                '"float outerradius_atmosphere" [1.2] '
                '"float innerradius_cloud" [0.6] "float outerradius_cloud" '
                '[0.9] "float decay" [0.25] "float densityoffset" [0.01] '
                '"float rotationy" [45] "float majorantscale" [1.2] '
                '"float scale_atmosphere" [0.5] "float scale_cloud" [2] '
                f'"float g" [0.1] "string heightmap" "{path}"')
    raise ValueError(case)


@pytest.mark.parametrize("case", ["nanovdb", "rgbgrid", "earth",
                                  "earth heightmap fails", "cloud file"])
def test_media_build_alike(case, tmp_path):
    """The media the port once refused build as in the JAX builder, every
    field equal (floats within 1e-6): a NanoVDB grid file with its
    densityoffset and majorantscale, an inline RGB grid with Le under a
    CTM, the earth medium with a PNG heightmap (its channels averaged) and
    with one that fails to load (the same warning, a constant shell), and
    the shipped cloud scene file with its cloud swapped for the earth
    medium."""
    if case == "cloud file":
        with open(os.path.join(REPO, "scenes", "cloud_vspg.pbrt")) as f:
            text = f.read().replace('"string type" "cloud"',
                                    '"string type" "earth"')
    else:
        text = MEDIA_BODY.format(medium=_media_text(case, tmp_path))
    if case == "earth heightmap fails":
        with pytest.warns(UserWarning) as rec:
            ts = tbuild(tparse(text), device="cpu")
        msgs = [str(w.message) for w in rec]
        with pytest.warns(UserWarning) as rec_j:
            js = jbuild(jparse(text))
        assert any("earth heightmap" in m and "constant shell" in m
                   for m in msgs), msgs
        assert sorted(msgs) == sorted(str(w.message) for w in rec_j)
    else:
        ts, js = tbuild(tparse(text), device="cpu"), jbuild(jparse(text))
    _check_alike(ts, js)
    media = ts.scene.media
    kind = {"nanovdb": "GridMedium", "rgbgrid": "RGBGridMedium"}.get(
        case, "EarthMedium")
    held = media.grids if kind != "EarthMedium" else media.procedurals
    assert [type(m).__name__ for m in held] == [kind]
    if case == "earth":
        assert tuple(held[0].heightmap.shape) == (8, 16)
    if case == "earth heightmap fails":
        assert tuple(held[0].heightmap.shape) == (1, 1)


def test_unknown_types_warn_and_degrade():
    """Where the JAX builder warns and degrades, so does the port, in the
    same words."""
    ds = tparse('WorldBegin\nShape "teapot"\nMaterial "velvet"\n'
                'LightSource "laser"\nShape "sphere"\n')
    with pytest.warns(UserWarning) as rec:
        ts = tbuild(ds, device="cpu")
    msgs = [str(w.message) for w in rec]
    assert "<string>:2: shape 'teapot' unsupported; skipped" in msgs
    assert "<string>:3: material 'velvet' unsupported; using diffuse" in msgs
    assert "<string>:4: light 'laser' unsupported; ignored" in msgs
    assert ts.scene.geometry.n_sph == 1
    assert int(ts.scene.geometry.sph_mat[0]) == 1


def _with_sphere(scene):
    g = scene.geometry
    sph = Geometry.build(spheres=[dict(c=(0, 0, 0), r=0.1, mat=0)],
                            device="cpu")
    return dataclasses.replace(scene, geometry=dataclasses.replace(
        g, **{f: getattr(sph, f) for f in ("sph_c", "sph_r", "sph_mat",
                                           "sph_light", "sph_med_in",
                                           "sph_med_out")}))


def test_kernel_predicates_refuse_a_sphere():
    """B1, B2a-c, B3/B4 and B5 see no sphere: each predicate takes the
    scene without it and refuses it with one."""
    cfg = tv.VolPathConfig()
    cam = vk.bench_camera(16, device="cpu")
    film = RGBFilm.make((16, 16), device="cpu")
    fog = vk.make_fog_box_scene(device="cpu")
    assert vk.extract_constants(fog, cam, film, cfg) is not None
    assert vk.extract_constants(_with_sphere(fog), cam, film, cfg) is None
    cloud = vk.make_cloud64_scene(device="cpu")
    gopt, vopt = tgv.GuidingOptions(field_res=4), tvspg.VSPGOptions()
    field = GuidingField.make((-1,) * 3, (1,) * 3, res=4, device="cpu")
    assert gk.supports(cloud, cam, film, cfg, gopt, vopt, field)
    assert not gk.supports(_with_sphere(cloud), cam, film, cfg, gopt, vopt,
                           field)
    corn = tv.make_cornell_box_scene(device="cpu")
    ccam, cfilm = sk.cornell_view(16, 16, device="cpu")
    assert sk.extract_constants(corn, ccam, cfilm, cfg) is not None
    assert sk.extract_constants(_with_sphere(corn), ccam, cfilm,
                                cfg) is None


LIGHTS_BODY = '''
Integrator "volpath" "integer maxdepth" [5] "string lightsampler" "{sampler}"
Sampler "independent" "integer pixelsamples" [8]
Film "rgb" "integer xresolution" [16] "integer yresolution" [16]
LookAt 0 1 -3.5  0 0.8 0  0 1 0
Camera "perspective" "float fov" [45]
WorldBegin
{lights}
Material "diffuse" "rgb reflectance" [0.6 0.55 0.5]
Shape "trianglemesh" "point3 P" [-2 0 -2  2 0 -2  2 0 2  -2 0 2]
  "integer indices" [0 2 1  0 3 2]
Shape "trianglemesh" "point3 P" [-2 0 2  2 0 2  2 2.5 2  -2 2.5 2]
  "integer indices" [0 2 1  0 3 2]
AttributeBegin
  Translate 0.3 1.6 0.4
  AreaLightSource "diffuse" "blackbody L" [3200] "float scale" [2]
  Shape "trianglemesh" "point3 P" [-0.2 0 -0.2  0.2 0 -0.2  0 0 0.2]
    "integer indices" [0 1 2]
AttributeEnd
'''


def light_lines(case, tmp):
    """The LightSource lines of a case; the images it reads written as
    PFMs into `tmp`: a goniometric equal-area map, a 12x20 projected image
    and a 2:1 lat-long environment."""
    from vspg_pbrt_v4_tpu_torch.utils.image import write_pfm

    rs = np.random.default_rng(18)
    files = {"gonio": rs.uniform(0.2, 1.0, (8, 8, 3)),
             "proj": rs.uniform(0.2, 1.0, (12, 20, 3)),
             "env": rs.uniform(0.0, 1.0, (16, 32, 3)) ** 2,
             "envsq": rs.uniform(0.0, 1.0, (16, 16, 3))}
    for name, img in files.items():
        write_pfm(os.path.join(tmp, name + ".pfm"), img.astype(np.float32))
    lines = {
        "point blackbody": 'LightSource "point" "blackbody I" [5500] '
                           '"point3 from" [0 2 0]',
        "spot": ('AttributeBegin\n  Translate 0.2 0 0\n  LightSource "spot" '
                 '"rgb I" [4 4 4] "point3 from" [0 1.8 0] "point3 to" '
                 '[0.2 0 0.1] "float coneangle" [40] "float conedeltaangle" '
                 '[8]\nAttributeEnd'),
        "goniometric": ('AttributeBegin\n  Translate 0.3 1.5 0\n  Rotate 30 '
                        '1 0 0\n  LightSource "goniometric" "rgb I" [2 2 2] '
                        f'"string filename" "{tmp}/gonio.pfm"\nAttributeEnd'),
        "projection": ('AttributeBegin\n  Translate -0.3 2 0\n  Rotate 90 '
                       '1 0 0\n  LightSource "projection" "rgb I" [3 3 3] '
                       f'"float fov" [50] "string filename" "{tmp}/proj.pfm"'
                       '\nAttributeEnd'),
        "distant": ('LightSource "distant" "rgb L" [1 0.9 0.8] "point3 from" '
                    '[1 2 1] "point3 to" [0 0 0] "float scale" [0.5]'),
        "image infinite": ('LightSource "infinite" "string filename" '
                           f'"{tmp}/env.pfm" "float scale" [0.7]'),
        "image infinite square": ('LightSource "infinite" "string filename" '
                                  f'"{tmp}/envsq.pfm"'),
        "portal": ('LightSource "infinite" "rgb L" [0.4 0.5 0.6] '
                   '"point3 portal" [-1 0.5 2  1 0.5 2  1 2 2  -1 2 2]'),
        "portal image": ('LightSource "infinite" "string filename" '
                         f'"{tmp}/envsq.pfm" "point3 portal" '
                         '[-1 0.5 2  -1 2 2  1 2 2  1 0.5 2]'),
    }
    if case == "all":
        return "\n".join(v for k, v in lines.items()
                         if not k.startswith("portal")
                         and k != "image infinite square")
    if case == "goniometric missing":
        return lines["goniometric"].replace(f"{tmp}/gonio.pfm",
                                            f"{tmp}/missing.pfm")
    return lines[case]


LIGHT_CASES = ("point blackbody", "spot", "goniometric",
               "goniometric missing", "projection", "distant",
               "image infinite", "image infinite square", "portal",
               "portal image", "all", "all bvh")


@pytest.mark.parametrize("case", LIGHT_CASES)
def test_lights_build_alike(case, tmp_path):
    """Every LightSource kind, blackbody spectra (a point light's I and an
    area light's L), the image environment (a 2:1 lat-long PFM resampled
    to an equal-area square, and a square one read as is), portals on a
    constant and on an image environment, and the bvh light sampler build
    as in the JAX builder: the lights field for field through
    ``convert.from_jax`` (the BVH and the portal too; floats within 1e-6),
    the same warning where a goniometric image fails to load."""
    sampler = "bvh" if case == "all bvh" else "power"
    text = LIGHTS_BODY.format(
        sampler=sampler,
        lights=light_lines(case.replace(" bvh", ""), str(tmp_path)))
    if case == "goniometric missing":
        with pytest.warns(UserWarning) as rec:
            ts = tbuild(tparse(text), device="cpu")
        with pytest.warns(UserWarning) as rec_j:
            js = jbuild(jparse(text))
        msgs = sorted(str(w.message) for w in rec)
        assert msgs == sorted(str(w.message) for w in rec_j)
        assert any("goniometric image" in m and "uniform" in m
                   for m in msgs), msgs
    else:
        ts, js = tbuild(tparse(text), device="cpu"), jbuild(jparse(text))
    _check_alike(ts, js)
    li = ts.scene.lights
    assert li.n_area == 1 and float(li.area_L[0].min()) > 0
    assert (li.bvh is not None) == (case == "all bvh")
    assert (li.portal is not None) == case.startswith("portal")
    if case.startswith("all"):
        assert (li.n_point, li.n_spot, li.n_gonio, li.n_proj,
                li.n_distant) == (1, 1, 1, 1, 1) and li.has_env_img
        assert li.env_img.shape == (16, 16, 3)
    assert li.beyond_kernels == (case != "point blackbody")
