"""B5, the vacuum surface kernel module (``ops/surface_kernels.py``):
``render_surface_plain`` against the JAX package's Pallas surface kernel
run in interpret mode, pixel for pixel (same random stream and formulas),
on the bench's Cornell box, the box with every light type of the class
and the floor under an env of tests/test_pallas_surface.py; the integer
pixel index at a width that is not a power of two; the class predicate
against ``pallas_surface.supports``; the constant-table layout against
``csrc/path_surface.cu``; a floor furnace; and the CPU dispatch of
``render_persistent``."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from vspg_pbrt_v4_tpu.models import materials as M
from vspg_pbrt_v4_tpu.models.cameras import PerspectiveCamera
from vspg_pbrt_v4_tpu.models.film import RGBFilm
from vspg_pbrt_v4_tpu.models.integrators import volpath as jv
from vspg_pbrt_v4_tpu.models.lights import Lights as JLights
from vspg_pbrt_v4_tpu.models.media import Media as JMedia
from vspg_pbrt_v4_tpu.models.shapes import Geometry as JGeometry
from vspg_pbrt_v4_tpu.ops import pallas_surface as ps
from vspg_pbrt_v4_tpu.utils import transform as jtr
from vspg_pbrt_v4_tpu_torch.convert import from_jax
from vspg_pbrt_v4_tpu_torch.models.integrators import volpath as tv
from vspg_pbrt_v4_tpu_torch.ops import surface_kernels as sk

RES = 16
CFG = jv.VolPathConfig(max_depth=8, max_events=24)


def view(nx=RES, ny=RES, eye=sk.CORNELL_EYE, at=sk.CORNELL_AT):
    cam = PerspectiveCamera.make(jtr.look_at(eye, at, (0, 1, 0)),
                                 sk.CORNELL_FOV, (nx, ny))
    return cam, RGBFilm.make((nx, ny))


def cornell_tris(scene):
    g = scene.geometry
    return [dict(p0=tuple(np.asarray(g.tri_p0[i]).tolist()),
                 p1=tuple(np.asarray(g.tri_p1[i]).tolist()),
                 p2=tuple(np.asarray(g.tri_p2[i]).tolist()),
                 mat=int(g.tri_mat[i]), light=int(g.tri_light[i]))
            for i in range(g.tri_p0.shape[0])]


def cornell_area(scene):
    li = scene.lights
    return [dict(p0=tuple(np.asarray(li.area_p0[i]).tolist()),
                 p1=tuple(np.asarray(li.area_p1[i]).tolist()),
                 p2=tuple(np.asarray(li.area_p2[i]).tolist()),
                 L=tuple(np.asarray(li.area_L[i]).tolist()))
            for i in range(li.n_area)]


def jax_cornell_lit():
    """The JAX twin of ``surface_kernels.make_cornell_lit_scene``."""
    base = jv.make_cornell_box_scene()
    tris = cornell_tris(base) + [dict(sk.LIT_TRI, mat=0, light=2)]
    area = cornell_area(base) + [dict(sk.LIT_TRI, L=sk.LIT_TRI_L,
                                      twosided=True)]
    lights = JLights.make(point_p=[sk.LIT_POINT[0]],
                          point_I=[sk.LIT_POINT[1]], env_L=sk.LIT_ENV,
                          world_radius=100.0, area_tris=area)
    return jv.Scene(JGeometry.build(triangles=tris), base.materials,
                    JMedia.make(), lights)


def jax_floor():
    """tests/test_pallas_surface.py's floor: albedo (0.7, 0.5, 0.3) under a
    unit env."""
    return jv.Scene(JGeometry.build(triangles=list(sk.FLOOR_TRIS)),
                    M.Materials.build([dict(type=0,
                                            albedo=(0.7, 0.5, 0.3))]),
                    JMedia.make(), JLights.make(env_L=[1.0] * 3,
                                                world_radius=100.0))


SCENES = {
    "cornell": (jv.make_cornell_box_scene, {}),
    "cornell lit": (jax_cornell_lit, {}),
    "floor": (jax_floor, dict(eye=sk.FLOOR_EYE, at=sk.FLOOR_AT)),
}


@pytest.fixture(scope="module")
def pallas():
    """Interpret-mode Pallas renders at 4 spp, seed 3, made once a
    module: {(name, nx, ny): (jax scene, camera, film, image)}."""
    cache = {}

    def get(name, nx=RES, ny=RES):
        key = (name, nx, ny)
        if key not in cache:
            make, kw = SCENES[name]
            scene = make()
            cam, film = view(nx, ny, **kw)
            img = np.asarray(ps.render_surface_pallas(
                scene, cam, film, 4, CFG, 3, interpret=True))
            cache[key] = (scene, cam, film, img)
        return cache[key]
    return get


def agree(img, ref, rtol=1e-4, atol=1e-7):
    d = np.abs(img - ref)
    return ((d <= rtol * np.abs(ref)) | (d <= atol)).all(-1)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_plain_matches_pallas_interpret(pallas, name):
    """Same stream, same formulas: per pixel (1e-4 relative or 1e-7
    absolute, on at least 98% of pixels, B1's CPU bar)."""
    scene, cam, film, ref = pallas(name)
    c = sk.extract_constants(*from_jax(scene, cam, film, CFG, "cpu"))
    assert c is not None and sk.npix_supported(c)
    counts = {}
    img = sk.render_surface_plain(c, 4, 3, counts).numpy()
    frac = agree(img, ref).mean()
    print(f"{name}: {frac:.4f} of pixels agree, mean {img.mean():.5f}")
    assert frac >= 0.98, frac
    assert ref.mean() > 0
    assert counts["samples"] == RES * RES * 4
    assert counts["tri_tests"] == counts["iters"] * c.n_tri
    assert counts["shades"] > 0 and counts["shadow_tests"] > 0


def test_pixel_index_at_a_width_not_a_power_of_two(pallas):
    """At 24x16 the Pallas kernel takes a float floor for the row and the
    port an integer division: every pixel agrees."""
    scene, cam, film, ref = pallas("cornell", 24, 16)
    c = sk.extract_constants(*from_jax(scene, cam, film, CFG, "cpu"))
    img = sk.render_surface_plain(c, 4, 3).numpy()
    assert img.shape == (16, 24, 3)
    assert agree(img, ref).all()


def _class_cases():
    """(jax scene, camera, film, cfg) per case, and whether the JAX class
    holds it."""
    corn = jv.make_cornell_box_scene
    cam, film = view()
    metal = M.Materials.build([dict(type=M.CONDUCTOR, albedo=(0.73,) * 3,
                                    roughness=0.0),
                               dict(type=0, albedo=(0.65, 0.05, 0.05)),
                               dict(type=0, albedo=(0.12, 0.45, 0.15))])
    nine = [dict(p0=(-0.9 + 0.2 * i, 1.99, -0.1), p1=(-0.8 + 0.2 * i, 1.99,
                                                      -0.1),
                 p2=(-0.85 + 0.2 * i, 1.99, 0.1), L=(1.0,) * 3)
            for i in range(9)]

    def lights(**kw):
        return corn()._replace(lights=JLights.make(**kw))

    return {
        "cornell": ((corn(), cam, film, CFG), True),
        "cornell lit": ((jax_cornell_lit(), cam, film, CFG), True),
        "floor": ((jax_floor(), *view(eye=sk.FLOOR_EYE, at=sk.FLOOR_AT),
                   CFG), True),
        "fog box": ((jv.make_fog_box_scene([0.1] * 3, [0.4] * 3,
                                           env_L=[0.1] * 3), cam, film, CFG),
                    False),
        "conductor": ((corn()._replace(materials=metal), cam, film, CFG),
                      False),
        "nine area lights": ((lights(area_tris=nine), cam, film, CFG), False),
        "two point lights": ((lights(area_tris=cornell_area(corn()),
                                     point_p=[(0, 1, 0), (0, 1.5, 0)],
                                     point_I=[(1, 1, 1)] * 2), cam, film,
                              CFG), False),
        "power selection": ((lights(area_tris=cornell_area(corn()),
                                    point_p=[(0, 1, 0)], point_I=[(1, 1, 1)],
                                    sampler="power"), cam, film, CFG),
                            False),
        "no light": ((lights(), cam, film, CFG), False),
        "npix not a multiple of 128": ((corn(), *view(10, 10), CFG), False),
        "medium label": ((corn()._replace(geometry=JGeometry.build(
            triangles=[dict(t, med_out=0) for t in cornell_tris(corn())])),
            cam, film, CFG), False),
    }


@pytest.mark.parametrize("case", sorted(_class_cases()))
def test_supports_matches_pallas(case):
    (scene, cam, film, cfg), want = _class_cases()[case]
    assert ps.supports(scene, cam, film, cfg) is want
    assert sk.supports(*from_jax(scene, cam, film, cfg, "cpu")) is want


def test_constant_layout_matches_source():
    """csrc/path_surface.cu declares the same table layouts."""
    src = (Path(sk.__file__).parent.parent / "csrc"
           / "path_surface.cu").read_text()
    pat = r"S_\w+|ST_\w+|N_SCONST"
    decl = {m[0]: int(m[1]) for m in re.findall(
        r"\b(" + pat + r")\s*=\s*(\d+)", src)}
    names = [n for n in dir(sk) if re.fullmatch(pat, n)]
    assert len(names) == len(decl) == 24 + 7 + 1
    for n in names:
        assert decl[n] == getattr(sk, n), n
    assert int(re.search(r"MAX_SURF_TRIS = (\d+)", src)[1]) == sk.MAX_TRIS
    # each per-light and per-material block fits before the next
    assert sk.S_AP0 - sk.S_ALB == 3 * sk.MAX_MATS
    assert sk.S_AAREA - sk.S_AL == 3 * sk.MAX_AREA_LIGHTS
    assert sk.S_LP - sk.S_ATWO == sk.MAX_AREA_LIGHTS


def test_floor_furnace_plain():
    """A Lambertian plane under a unit env reflects albedo * 1 in every
    pixel (3%)."""
    scene = sk.make_floor_scene(device="cpu")
    cam, film = sk.cornell_view(32, 32, sk.FLOOR_EYE, sk.FLOOR_AT,
                                device="cpu")
    c = sk.extract_constants(scene, cam, film, tv.VolPathConfig(max_depth=8))
    img = sk.render_surface_plain(c, 16, 3)
    mean = img.reshape(-1, 3).mean(0).numpy()
    assert np.isfinite(img.numpy()).all()
    assert np.allclose(mean, [0.7, 0.5, 0.3], rtol=0.03), mean


def test_render_persistent_uses_plain_on_cpu():
    """On CPU tensors the wrapper and render_persistent's dispatch run the
    plain version and launch nothing."""
    scene = tv.make_cornell_box_scene(device="cpu")
    cam, film = sk.cornell_view(RES, RES, device="cpu")
    cfg = tv.VolPathConfig(max_depth=8, max_events=24)
    c = sk.extract_constants(scene, cam, film, cfg)
    before = dict(sk.LAUNCHES)
    plain = sk.render_surface_plain(c, 2, 4)
    assert torch.equal(sk.render_surface(c, 2, 4), plain)
    auto = tv.render_persistent(scene, cam, film, spp=2, cfg=cfg, seed=4,
                                lanes_per_pixel=1, device="cpu")
    assert torch.equal(auto, plain)
    assert sk.LAUNCHES == before == {"surface": before["surface"]}
    assert sk.LAUNCHES["surface"] == 0
    assert plain.mean() > 0
