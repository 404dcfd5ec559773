"""The torch VSPG wave on the two scene classes it gained: triangle area
lights (the emission of a hit light, with MIS against its NEE after the
first hit, and its record rows) and the mesh class (the 144 triangles of
tests/test_teaser_kernel.py's ``_mesh_scene(1)``, through the BVH), in
one scene: the mesh with an emissive quad above it. One training
``vspg_wave`` and one frozen wave against the JAX package's XLA wave on
the same random stream (each JAX wave a compile of its own): the film
image, the ISGB sums and the propagated training batch, lane by lane. ``render_vspg``
takes both classes now; the VSPG kernel still refuses them. These
replace the two cases of tests/test_torch_vspg_render.py that asserted
the refusals."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from vspg_pbrt_v4_tpu.models.integrators import vspg as jvspg
from vspg_pbrt_v4_tpu.models.lights import Lights as JLights
from vspg_pbrt_v4_tpu.models.shapes import Geometry as JGeometry
from vspg_pbrt_v4_tpu_torch import convert
from vspg_pbrt_v4_tpu_torch.models.integrators import vspg as tvspg
from vspg_pbrt_v4_tpu_torch.models.integrators.volpath import VolPathConfig
from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as vk

from test_teaser_kernel import _mesh_scene
from test_torch_vspg_distance import synthetic_guiding
from test_torch_vspg_kernel import GOPT, RES, lanes_close
from test_torch_vspg_wave import CFG, GOPT2, SPP_PER_PASS, _batch_rows, \
    _isgb_rows

VOPT = jvspg.VSPGOptions()
# a 0.4-wide emissive quad in the cloud above the mesh, facing down,
# one-sided
QUAD = [(-0.2, 0.8, -0.2), (0.2, 0.8, -0.2), (0.2, 0.8, 0.2),
        (-0.2, 0.8, 0.2)]


def mesh_area_setup(with_light=True):
    """_mesh_scene(1) (144 triangles, a BVH) with, by default, the
    emissive quad in it: two more triangles and two triangle area lights
    beside its point light and environment."""
    scene, cam, film, _, n_tri = _mesh_scene(1)
    assert n_tri == 144 and scene.geometry.tri_bvh is not None
    if not with_light:
        return scene, cam, film
    g = scene.geometry
    q = QUAD
    quad = [dict(p0=q[0], p1=q[1], p2=q[2], mat=0, light=0),
            dict(p0=q[0], p1=q[2], p2=q[3], mat=0, light=1)]

    def rows(k):
        return [np.asarray(getattr(g, f"tri_{k}"))[i] for i in range(n_tri)]

    tris = [dict(p0=a, p1=b, p2=c, mat=int(m), light=-1, med_in=int(mi),
                 med_out=int(mo))
            for a, b, c, m, mi, mo in zip(rows("p0"), rows("p1"), rows("p2"),
                                          rows("mat"), rows("med_in"),
                                          rows("med_out"))]
    geom = JGeometry.build(triangles=quad + tris, boxes=[dict(
        bmin=(-1, -1, -1), bmax=(1, 1, 1), mat=-1, light=-1, med_in=0,
        med_out=-1)])
    li = scene.lights
    lights = JLights.make(point_p=np.asarray(li.point_p),
                          point_I=np.asarray(li.point_I),
                          env_L=np.asarray(li.env_L), world_radius=100.0,
                          area_tris=[dict(p0=t["p0"], p1=t["p1"],
                                          p2=t["p2"], L=(4.0, 3.0, 2.0))
                                     for t in quad])
    return scene._replace(geometry=geom, lights=lights), cam, film


@pytest.fixture(scope="module")
def guiding():
    return synthetic_guiding(5, res=GOPT.field_res, film_res=(RES, RES))


@pytest.mark.parametrize("train", [True, False])
def test_wave_matches_jax(train, guiding):
    """One wave of 2 spp per pixel on a trained field and a ready ISGB,
    training (record rows, emission rows among them, propagated) or
    frozen."""
    scene, cam, film = mesh_area_setup()
    jf, ji, tf, ti = guiding
    fs_j, ji2, batch_j, _ = jvspg.vspg_wave(
        scene, cam, film, film.init_state(), jf, ji, CFG, GOPT2, VOPT,
        jnp.uint32(3), jnp.int32(1), -1, train, SPP_PER_PASS, None)
    ts, tc, tfilm, tcfg = convert.from_jax(scene, cam, film, CFG, "cpu")
    tg, tv = convert.options_from_jax(GOPT2, VOPT)
    assert ts.geometry.tri_bvh is not None and ts.lights.n_area == 2
    fs_t, ti2, batch_t, _ = tvspg.vspg_wave(
        ts, tc, tfilm, tfilm.init_state(), tf, ti, tcfg, tg, tv, 3, 1, -1,
        train, SPP_PER_PASS, None)
    img_j = np.asarray(film.image(fs_j)).reshape(RES * RES, 3)
    img_t = tfilm.image(fs_t).numpy().reshape(RES * RES, 3)
    assert np.isfinite(img_t).all() and img_t.mean() > 0
    checks = {"image": (img_t, img_j),
              "isgb": (_isgb_rows(ti2), _isgb_rows(ji2))}
    if train:
        assert bool(batch_t.valid.any())
        checks["batch"] = (_batch_rows(batch_t), _batch_rows(batch_j))
    else:
        assert batch_t is None
    for name, (t, j) in checks.items():
        frac = lanes_close(t, j)
        print(f"wave (train={train}) {name}: {frac:.4f} of lanes within "
              "1e-4")
        assert frac >= 0.95, (name, frac)


def test_area_light_is_seen():
    """The quad's emission reaches the image: the port's frozen wave on a
    fresh field reads darker with the quad's radiance zeroed."""
    from vspg_pbrt_v4_tpu_torch.models.guiding.isgb import ISGB

    scene, cam, film = mesh_area_setup()
    ts, tc, tfilm, tcfg = convert.from_jax(scene, cam, film,
                                           CFG._replace(max_depth=2), "cpu")
    tg, tv = convert.options_from_jax(GOPT2, VOPT)
    means = []
    for scale in (1.0, 0.0):
        lights = dataclasses.replace(ts.lights,
                                     area_L=ts.lights.area_L * scale)
        scene_t = dataclasses.replace(ts, lights=lights)
        fs = tvspg.vspg_wave(
            scene_t, tc, tfilm, tfilm.init_state(),
            tvspg._scene_field(scene_t, tg, "cpu"),
            ISGB.make(tfilm.resolution, tv.vsp_criterion, tv.denoiser,
                      device="cpu"),
            tcfg, tg, tv, 3, 0, -1, False, SPP_PER_PASS, None)[0]
        means.append(float(tfilm.image(fs).mean()))
    assert means[0] > means[1] * 1.02, means


@pytest.mark.parametrize("with_light", [True, False])
def test_render_vspg_takes_the_class(with_light):
    """render_vspg renders the mesh, with and without the area light,
    through the torch wave (the raises it had are gone); the kernel's
    predicate refuses both."""
    scene, cam, film = mesh_area_setup(with_light)
    ts, tc, tfilm, tcfg = convert.from_jax(scene, cam, film,
                                           CFG._replace(max_depth=3), "cpu")
    tg, tv = convert.options_from_jax(GOPT._replace(train_waves=1), VOPT)
    field = tvspg._scene_field(ts, tg, "cpu")
    assert not vk.supports(ts, tc, tfilm, tcfg, tg, tv, field)
    img, _, _ = tvspg.render_vspg(ts, tc, tfilm, spp=2, cfg=tcfg, gopt=tg,
                                  vopt=tv, seed=1, device="cpu")
    assert tuple(img.shape) == (RES, RES, 3)
    assert bool(img.isfinite().all()) and float(img.mean()) > 0


def test_kernel_refuses_area_lights():
    """The cloud with one emissive triangle: outside the VSPG kernel's
    class (it shades no emission), inside it without the light."""
    from vspg_pbrt_v4_tpu_torch.models.film import RGBFilm
    from vspg_pbrt_v4_tpu_torch.models.lights import Lights
    from vspg_pbrt_v4_tpu_torch.models.shapes import Geometry
    from vspg_pbrt_v4_tpu_torch.ops import volpath_kernels as pk

    cloud = pk.make_cloud64_scene(device="cpu")
    tri = dict(p0=(-0.2, 0.5, -0.2), p1=(0.2, 0.5, -0.2),
               p2=(0.0, 0.5, 0.2))
    g = cloud.geometry
    box = dict(bmin=g.box_min[0].tolist(), bmax=g.box_max[0].tolist(),
               mat=-1, light=-1, med_in=0, med_out=-1)
    lit = dataclasses.replace(
        cloud, geometry=Geometry.build([box], [dict(tri, mat=0, light=0)],
                                       device="cpu"),
        lights=Lights.make(env_L=[0.2] * 3, world_radius=100.0,
                           area_tris=[dict(tri, L=(5.0,) * 3)],
                           device="cpu"))
    cam, film = pk.bench_camera(16, device="cpu"), RGBFilm.make(
        (16, 16), device="cpu")
    tg, tv = convert.options_from_jax(GOPT, VOPT)
    field = tvspg._scene_field(lit, tg, "cpu")
    cfg = VolPathConfig(max_depth=8)
    plain = dataclasses.replace(cloud, geometry=Geometry.build(
        [box], [dict(tri, mat=0)], device="cpu"))
    assert vk.supports(plain, cam, film, cfg, tg, tv, field)
    assert not vk.supports(lit, cam, film, cfg, tg, tv, field)
