"""B2a, the grid-cloud kernel module: ``render_grid_plain`` against the JAX
package's XLA path on a 16^3 cloud (same estimator, different random
streams: means agree within Monte Carlo error), the scattering furnace and
the CPU dispatch of the wrapper."""

import numpy as np
import torch

from vspg_pbrt_v4_tpu.models.cameras import PerspectiveCamera
from vspg_pbrt_v4_tpu.models.film import RGBFilm as JFilm
from vspg_pbrt_v4_tpu.models.integrators import volpath as jv
from vspg_pbrt_v4_tpu.models.lights import Lights as JLights
from vspg_pbrt_v4_tpu.models.materials import Materials as JMaterials
from vspg_pbrt_v4_tpu.models.media import GridMedium as JGrid
from vspg_pbrt_v4_tpu.models.media import Media as JMedia
from vspg_pbrt_v4_tpu.models.shapes import Geometry as JGeometry
from vspg_pbrt_v4_tpu.utils import transform as jtr
from vspg_pbrt_v4_tpu_torch.convert import from_jax
from vspg_pbrt_v4_tpu_torch.models.integrators import volpath as tv
from vspg_pbrt_v4_tpu_torch.ops import volpath_kernels as vk

RES = 16
CFG = jv.VolPathConfig(max_depth=16, max_events=64)
QUADRANTS = (np.s_[:8, :8], np.s_[8:, 8:], np.s_[:8, 8:], np.s_[8:, :8])


def cloud_setup(sa=(0.1, 0.1, 0.1), ss=(1.5, 1.8, 2.1), g=0.3,
                env=(0.3, 0.35, 0.4), point=((0.0, 1.8, 0.0), (6.0,) * 3)):
    """The 16^3 sphere cloud of tests/test_pallas_volpath.py, with its
    density rounded to bf16 so that the Pallas kernel's bf16 table holds
    the same field."""
    n = 16
    x = np.linspace(-1, 1, n)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    dens = np.clip(1.0 - np.sqrt(X**2 + Y**2 + Z**2), 0, 1).astype(
        np.float32) * 3.0
    dens = (dens.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
    gm = JGrid.make(dens, list(sa), list(ss), (-1, -1, -1), (1, 1, 1), g=g,
                    maj_res=8)
    lights = JLights.make(point_p=None if point is None else [point[0]],
                          point_I=None if point is None else [point[1]],
                          env_L=list(env), world_radius=100.0)
    geom = JGeometry.build(boxes=[dict(bmin=(-1, -1, -1), bmax=(1, 1, 1),
                                       mat=-1, light=-1, med_in=0,
                                       med_out=-1)])
    scene = jv.Scene(geom, JMaterials.build([]), JMedia.make(grids=(gm,)),
                     lights)
    cam = PerspectiveCamera.make(jtr.look_at((0, 0, -4), (0, 0, 0),
                                             (0, 1, 0)), 30.0, (RES, RES))
    return scene, cam, JFilm.make((RES, RES))


def assert_mc_agree(img, ref):
    """Mean within 3% and quadrant means within 6% (the bands of
    tests/test_pallas_volpath.py): a 256-spp plain render against a 64-spp
    reference leaves the reference's noise, about 1-2.5% per quadrant."""
    assert np.isfinite(img).all()
    rel = abs(img.mean() - ref.mean()) / ref.mean()
    assert rel < 0.03, (img.mean(), ref.mean())
    for sl in QUADRANTS:
        a, b = ref[sl].mean(), img[sl].mean()
        assert abs(b - a) / a < 0.06, (sl, a, b)


def plain_render(scene, cam, film, spp, seed, cfg=CFG):
    c = vk.extract_constants(*from_jax(scene, cam, film, cfg, "cpu"))
    assert c.kind == "grid"
    return vk.render_grid_plain(c, spp, seed).numpy()


def test_grid_plain_matches_xla():
    scene, cam, film = cloud_setup()
    ref = np.asarray(jv.render(scene, cam, film, spp=64, cfg=CFG, seed=3,
                               spp_per_pass=8))
    assert_mc_agree(plain_render(scene, cam, film, 256, 7), ref)


def test_grid_furnace():
    """Scattering-only cloud in a uniform env: the image is 0.6 up to the
    ~1.2% of energy in paths deeper than max_depth=16; 2.5% budget as in
    tests/test_pallas_volpath.py."""
    scene, cam, film = cloud_setup(sa=(0, 0, 0), ss=(2.0, 2.0, 2.0), g=0.0,
                                   env=(0.6, 0.6, 0.6), point=None)
    img = plain_render(scene, cam, film, 64, 1)
    assert np.isfinite(img).all()
    assert abs(img.mean() - 0.6) / 0.6 < 0.025, img.mean()


def test_grid_wrapper_and_auto_dispatch_use_plain_on_cpu():
    scene = vk.make_cloud64_scene(device="cpu")
    cam = vk.bench_camera(RES, device="cpu")
    from vspg_pbrt_v4_tpu_torch.models.film import RGBFilm

    film = RGBFilm.make((RES, RES), device="cpu")
    cfg = tv.VolPathConfig(max_depth=32, max_events=128, max_collisions=2048)
    c = vk.extract_constants(scene, cam, film, cfg)
    assert c.kind == "grid" and tuple(c.density.shape) == (64, 64, 64)
    before = dict(vk.LAUNCHES)
    plain = vk.render_grid_plain(c, 1, 4)
    assert torch.equal(vk.render_grid(c, 1, 4), plain)
    auto = tv.render_persistent(scene, cam, film, spp=1, cfg=cfg, seed=4,
                                device="cpu")
    assert torch.equal(auto, plain)
    assert vk.LAUNCHES == before
    assert plain.mean() > 0


def test_grid_class_refuses_area_lights():
    """B2 and the VSPG kernel shade no emission: a cloud with an emissive
    triangle leaves both classes and renders through the torch wavefront,
    which adds its light."""
    from vspg_pbrt_v4_tpu_torch.models.integrators.guided_volpath import \
        GuidingOptions
    from vspg_pbrt_v4_tpu_torch.models.integrators.vspg import VSPGOptions
    from vspg_pbrt_v4_tpu_torch.models.lights import Lights
    from vspg_pbrt_v4_tpu_torch.models.shapes import Geometry
    from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk

    scene, cam, film = cloud_setup()
    ts, tc, tf, tcfg = from_jax(scene, cam, film, CFG, "cpu")
    gopt, vopt = GuidingOptions(), VSPGOptions()
    assert vk.extract_constants(ts, tc, tf, tcfg) is not None
    assert sk.supports(ts, tc, tf, tcfg, gopt, vopt, None)
    tri = dict(p0=(-0.3, 0.5, -0.3), p1=(0.3, 0.5, -0.3), p2=(0.0, 0.5, 0.3))
    lit = ts.__class__(
        Geometry.build([dict(bmin=(-1, -1, -1), bmax=(1, 1, 1), mat=-1,
                             light=-1, med_in=0, med_out=-1)],
                       [dict(tri, mat=0, light=0, med_in=0, med_out=0)],
                       device="cpu"),
        ts.materials, ts.media,
        Lights.make(env_L=[0.3, 0.35, 0.4], world_radius=100.0,
                    area_tris=[dict(tri, L=(4.0,) * 3, twosided=True)],
                    device="cpu"))
    assert vk.extract_constants(lit, tc, tf, tcfg) is None
    assert not sk.supports(lit, tc, tf, tcfg, gopt, vopt, None)
    before = dict(vk.LAUNCHES)
    dark = ts.__class__(lit.geometry, lit.materials, lit.media,
                        Lights.make(env_L=[0.3, 0.35, 0.4],
                                    world_radius=100.0, device="cpu"))
    imgs = [tv.render_persistent(s, tc, tf, spp=2, cfg=tcfg, seed=4,
                                 device="cpu") for s in (lit, dark)]
    assert vk.LAUNCHES == before
    assert imgs[0].mean() > imgs[1].mean() > 0
