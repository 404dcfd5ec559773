"""The hand-written kernels shade point lights and a constant environment
(B1, B2a-c, B3/B4) or those and triangle area lights (B5), each picked by
a uniform table. A spot, goniometric, projection or distant light, an
image environment, a portal or the BVH light sampler sends a render to
the torch wavefront in the JAX package (``pallas_volpath.py:286-295``,
``pallas_surface.py:100-107``), and so in the port: here the bench fog box
(B1), the bench cloud64 grid (B2a, B3a) and the Cornell box (B5), each
with one such light added, are refused by the JAX gates and by the port's
predicates, and ``render_persistent`` and ``render_vspg(backend="auto")``
on CPU tensors take the torch route (equal to ``backend="torch"`` bit for
bit). Without the added light every predicate takes its scene."""

import numpy as np
import pytest
import torch

from vspg_pbrt_v4_tpu.models import media as jm
from vspg_pbrt_v4_tpu.models.cameras import PerspectiveCamera
from vspg_pbrt_v4_tpu.models.film import RGBFilm as JFilm
from vspg_pbrt_v4_tpu.models.guiding import field as jfield
from vspg_pbrt_v4_tpu.models.integrators import volpath as jv
from vspg_pbrt_v4_tpu.models.lights import Lights as JLights
from vspg_pbrt_v4_tpu.models.portal_light import PortalLight as JPortal
from vspg_pbrt_v4_tpu.ops import pallas_surface as jps
from vspg_pbrt_v4_tpu.ops import pallas_volpath as jpv
from vspg_pbrt_v4_tpu.ops import pallas_vspg as jpg
from vspg_pbrt_v4_tpu.utils import transform as jtr
from vspg_pbrt_v4_tpu_torch import convert
from vspg_pbrt_v4_tpu_torch.models.guiding.field import GuidingField
from vspg_pbrt_v4_tpu_torch.models.integrators import volpath as tv
from vspg_pbrt_v4_tpu_torch.models.integrators import vspg as tvspg
from vspg_pbrt_v4_tpu_torch.ops import surface_kernels as sk
from vspg_pbrt_v4_tpu_torch.ops import volpath_kernels as vk
from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as gk

from test_torch_vspg_kernel import GOPT, VOPT

RES = 16
CFG = jv.VolPathConfig(max_depth=6, max_events=32)
ONES = np.ones((4, 4, 3), np.float32)
# one light of each kind the kernels refuse, as Lights.make arguments
ADDED = {
    "none": {},
    "spot": dict(spots=[dict(p=(0.0, 1.5, 0.0), I=(3.0,) * 3,
                             dir=(0.0, -1.0, 0.0))]),
    "goniometric": dict(gonios=[dict(p=(0.3, 1.2, 0.2), I=(2.0,) * 3,
                                     img=ONES)]),
    "projection": dict(projections=[dict(p=(-0.3, 1.2, 0.2), I=(2.0,) * 3,
                                         img=ONES, fov_deg=45.0)]),
    "distant": dict(distant_dir=[(0.2, -1.0, 0.1)],
                    distant_L=[(1.0, 1.0, 1.0)]),
    "image environment": dict(env_img=ONES * 0.2),
    "portal": {},
    "bvh sampler": dict(sampler="bvh"),
}


def _base_scenes():
    """The bench fog box, the bench cloud64 grid and the Cornell box."""
    fog = jv.make_fog_box_scene([0.05] * 3, [0.5, 0.6, 0.7], g=0.3,
                                env_L=[0.1, 0.12, 0.15],
                                point=((0.0, 0.8, 0.0), (5.0,) * 3))
    gm = jm.GridMedium.make(vk.cloud64_density(), [0.1] * 3, [2.0] * 3,
                            (-1, -1, -1), (1, 1, 1), g=0.3, maj_res=8)
    cloud = fog._replace(media=jm.Media.make(grids=(gm,)), lights=JLights.make(
        point_p=[(0.0, 1.8, 0.0)], point_I=[(8.0,) * 3],
        env_L=[0.1, 0.12, 0.15], world_radius=100.0))
    return {"fog box": fog, "cloud64": cloud,
            "cornell": jv.make_cornell_box_scene()}


def _with(scene, case):
    """`scene` with the light of `case` added beside its own lights."""
    li = scene.lights
    kw = dict(world_radius=float(li.world_radius))
    if li.n_point:
        kw.update(point_p=np.asarray(li.point_p), point_I=np.asarray(
            li.point_I))
    if li.n_area:
        kw["area_tris"] = [dict(p0=np.asarray(li.area_p0)[i],
                                p1=np.asarray(li.area_p1)[i],
                                p2=np.asarray(li.area_p2)[i],
                                L=np.asarray(li.area_L)[i],
                                twosided=bool(np.asarray(li.area_twosided)[i]))
                           for i in range(li.n_area)]
    if li.has_env or case == "portal":
        kw["env_L"] = np.asarray(li.env_L) if li.has_env else (0.1,) * 3
    lights = JLights.make(**kw, **ADDED[case])
    if case == "portal":
        lights = lights.replace(portal=JPortal.make(
            lambda d: np.full((len(d), 3), 0.1, np.float32),
            [(-0.5, 2.5, -0.5), (0.5, 2.5, -0.5), (0.5, 2.5, 0.5),
             (-0.5, 2.5, 0.5)], res=8))
    return scene._replace(lights=lights)


def _view(name):
    eye, at = ((0, 1, 3.2), (0, 1, 0)) if name == "cornell" else (
        (0, 0, -4), (0, 0, 0))
    cam = PerspectiveCamera.make(jtr.look_at(eye, at, (0, 1, 0)), 30.0,
                                 (RES, RES))
    return cam, JFilm.make((RES, RES))


def _spy(monkeypatch, calls):
    """Count every kernel route's entry; the wavefront's runs."""
    def counted(name, fn):
        def wrapped(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        return wrapped

    for mod, name in ((vk, "render"), (sk, "render_surface"),
                      (tvspg.vk, "train_wave"), (tvspg.vk, "render_frozen"),
                      (tv, "render_persistent_wavefront"),
                      (tvspg, "vspg_wave")):
        monkeypatch.setattr(mod, name, counted(name, getattr(mod, name)))


@pytest.mark.parametrize("case", list(ADDED))
def test_kernel_gates_refuse_the_new_lights(case, monkeypatch):
    jgopt = GOPT._replace(field_res=4, train_waves=1)
    jfld = jfield.GuidingField.make((-1,) * 3, (1,) * 3, res=4)
    tgopt, tvopt = convert.options_from_jax(jgopt, VOPT)
    tfld = GuidingField.make((-1,) * 3, (1,) * 3, res=4, device="cpu")
    want = case == "none"
    for name, base in _base_scenes().items():
        scene = _with(base, case)
        cam, film = _view(name)
        ts, tc, tf, tcfg = convert.from_jax(scene, cam, film, CFG, "cpu")
        assert ts.lights.beyond_kernels == (not want), name
        if name == "cornell":
            assert jps.supports(scene, cam, film, CFG) is want
            assert sk.supports(ts, tc, tf, tcfg) is want
            assert (sk.extract_constants(ts, tc, tf, tcfg) is not None) \
                == want
        else:
            assert (jpv.extract_constants(scene, cam, film, CFG)
                    is not None) == want, name
            assert (vk.extract_constants(ts, tc, tf, tcfg) is not None) \
                == want, name
        if name == "cloud64":
            assert jpg.supports(scene, cam, film, CFG, jgopt, VOPT,
                                jfld) is want
            assert gk.supports(ts, tc, tf, tcfg, tgopt, tvopt, tfld) is want
        if want:
            continue
        # the routes on CPU tensors: the torch wavefront, no kernel entry
        calls = {}
        with monkeypatch.context() as m:
            _spy(m, calls)
            img = tv.render_persistent(ts, tc, tf, spp=1, cfg=tcfg, seed=3,
                                       device="cpu")
            assert calls == {"render_persistent_wavefront": 1}, calls
            ref = tv.render_persistent(ts, tc, tf, spp=1, cfg=tcfg, seed=3,
                                       backend="torch", device="cpu")
            assert torch.equal(img, ref) and bool(torch.isfinite(img).all())
            if name == "cloud64":
                calls.clear()
                img, field, _ = tvspg.render_vspg(ts, tc, tf, 2, tcfg,
                                                  tgopt, tvopt, seed=4,
                                                  device="cpu")
                assert calls == {"vspg_wave": 2}, calls
                assert field.iteration == 1
                assert bool(torch.isfinite(img).all()) and img.mean() > 0
