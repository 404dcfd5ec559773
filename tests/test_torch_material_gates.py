"""The triangle kernels shade the kinds diffuse, conductor, smooth
dielectric and CookTorrance, with a checker the only albedo texture (B2b,
B2c, B3c/B4c), and B5 diffuse untextured triangles; the JAX gates say so
(``pallas_volpath.py:223-242``, ``pallas_vspg.py:2936-2947``,
``pallas_surface.py:96-98``). The port's predicates read their own
``volpath_kernels.KERNEL_KINDS``, not the materials module's list of
ported kinds, so that they refuse exactly what the JAX gates refuse: here
the teaser class (the 48 machine triangles in the bench's cloud64 grid)
with its first material replaced by each other kind (a rough dielectric,
kinds 3 to 10, a mix of two kernel kinds) or textured by each kind but
the checker, and the Cornell box with its white walls so replaced, through
``extract_constants``, ``_tris_supported``, ``vspg_kernels.supports`` and
``surface_kernels.supports`` against the JAX gates; and the routes on CPU
tensors for two of the cases: the torch wavefront and the torch wave, no
kernel entry."""

import numpy as np
import pytest
import torch

from vspg_pbrt_v4_tpu.models import materials as jmat
from vspg_pbrt_v4_tpu.models import textures as jtex
from vspg_pbrt_v4_tpu.models.guiding import field as jfield
from vspg_pbrt_v4_tpu.models.shapes import Geometry as JGeometry
from vspg_pbrt_v4_tpu.ops import pallas_surface as jps
from vspg_pbrt_v4_tpu.ops import pallas_volpath as jpv
from vspg_pbrt_v4_tpu.ops import pallas_vspg as jpg
from vspg_pbrt_v4_tpu_torch import convert
from vspg_pbrt_v4_tpu_torch.models.guiding.field import GuidingField
from vspg_pbrt_v4_tpu_torch.models.integrators import volpath as tv
from vspg_pbrt_v4_tpu_torch.models.integrators import vspg as tvspg
from vspg_pbrt_v4_tpu_torch.ops import surface_kernels as sk
from vspg_pbrt_v4_tpu_torch.ops import volpath_kernels as vk
from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as gk

from test_torch_light_gates import CFG, _base_scenes, _spy, _view
from test_torch_vspg_kernel import GOPT, VOPT

BOX = dict(bmin=(-1, -1, -1), bmax=(1, 1, 1), mat=-1, light=-1, med_in=0,
           med_out=-1)
IMG = np.random.default_rng(0).uniform(0, 1, (4, 6, 3)).astype(np.float32)
# the first material row of each case (None: the kernel class itself)
KINDS = {
    "kernel kinds": None,
    "rough dielectric": dict(type=2, eta=1.5, roughness=0.2),
    "diffuse transmission": dict(type=3, albedo=(0.5, 0.4, 0.3),
                                 albedo2=(0.2, 0.2, 0.2)),
    "thin dielectric": dict(type=4, eta=1.5),
    "coated diffuse": dict(type=5, albedo=(0.6, 0.3, 0.2), roughness=0.1),
    "coated conductor": dict(type=6, albedo=(0.9, 0.7, 0.4),
                             roughness=0.2, roughness2=0.05),
    "mix": dict(type=7, mix_m1=1, mix_m2=2, mix_amount=0.5),
    "hair": dict(type=8, albedo2=(0.4, 0.6, 1.2), roughness=0.3,
                 roughness2=0.3),
    "subsurface": dict(type=9, albedo=(0.8,) * 3, albedo2=(0.2,) * 3),
    "measured": dict(type=10, meas_id=0),
}
TEXTURES = {"checker": dict(kind=1, c0=(0.65, 0.3, 0.2), c1=(0.9,) * 3,
                            uvscale=(4.0, 4.0)),
            "constant": dict(kind=0, c0=(0.4, 0.5, 0.6)),
            "imagemap": dict(kind=2, image_id=0),
            "scale": dict(kind=3, c0=(0.5,) * 3, inner=0),
            "mix": dict(kind=4, c0=(0.5,) * 3, inner=0, inner2=0),
            "fbm": dict(kind=5), "wrinkled": dict(kind=6),
            "marble": dict(kind=7), "dots": dict(kind=8), "uv": dict(kind=9),
            "windy": dict(kind=10),
            "bilerp": dict(kind=11, c2=(1, 1, 1), c3=(0, 0, 1))}
CASES = [("kind", k) for k in KINDS] + [("texture", t) for t in TEXTURES]


def _materials(case):
    """The JAX Materials and Textures of a case: the machines' smooth
    materials, the first row replaced (a kind case) or textured (a texture
    case)."""
    rows = [dict(r) for r in vk.MACHINE_MATERIALS["smooth"]]
    what, name = case
    tex = None
    if what == "kind" and KINDS[name] is not None:
        rows[0] = KINDS[name]
    elif what == "texture":
        rows[0] = dict(rows[0], albedo_tex=0)
        tex = jtex.Textures.build([TEXTURES[name]], [IMG])
    bank = jmat.make_lambertian_table((0.5,) * 3)[None]
    return jmat.Materials.build(rows, measured_tables=bank), tex


def _teaser(case):
    cloud = _base_scenes()["cloud64"]
    mats, tex = _materials(case)
    geom = JGeometry.build(boxes=[BOX], triangles=vk.machine_tris())
    return cloud._replace(geometry=geom, materials=mats, textures=tex)


def _cornell(case):
    """The Cornell box (three diffuse rows) with its white row replaced
    or textured as the case's first row."""
    corn = _base_scenes()["cornell"]
    mats, tex = _materials(case)
    rows = [dict(type=0, albedo=tuple(np.asarray(corn.materials.albedo)[i]))
            for i in range(3)]
    what, name = case
    if what == "kind" and KINDS[name] is not None:
        rows[0] = KINDS[name]
    elif what == "texture":
        rows[0] = dict(rows[0], albedo_tex=0)
    return corn._replace(materials=jmat.Materials.build(
        rows + [dict(type=1), dict(type=2)],
        measured_tables=mats.meas_bank), textures=tex)


@pytest.mark.parametrize("case", CASES, ids=[f"{w} {n}" for w, n in CASES])
def test_gates_refuse_as_jax(case):
    want = case in (("kind", "kernel kinds"), ("texture", "checker"))
    jgopt = GOPT._replace(field_res=4, train_waves=1)
    jfld = jfield.GuidingField.make((-1,) * 3, (1,) * 3, res=4)
    tgopt, tvopt = convert.options_from_jax(jgopt, VOPT)
    tfld = GuidingField.make((-1,) * 3, (1,) * 3, res=4, device="cpu")
    scene = _teaser(case)
    cam, film = _view("cloud64")
    ts, tc, tf, tcfg = convert.from_jax(scene, cam, film, CFG, "cpu")
    assert (jpv.extract_constants(scene, cam, film, CFG) is not None) == want
    assert (vk.extract_constants(ts, tc, tf, tcfg) is not None) == want
    assert vk._tris_supported(ts) == want
    # the VSPG kernel shades no texture, the checker neither
    want_g = case == ("kind", "kernel kinds")
    assert jpg.supports(scene, cam, film, CFG, jgopt, VOPT, jfld) is want_g
    assert gk.supports(ts, tc, tf, tcfg, tgopt, tvopt, tfld) is want_g
    corn = _cornell(case)
    ccam, cfilm = _view("cornell")
    cs, ccam_t, cfilm_t, ccfg = convert.from_jax(corn, ccam, cfilm, CFG,
                                                 "cpu")
    want_s = case == ("kind", "kernel kinds")
    assert jps.supports(corn, ccam, cfilm, CFG) is want_s
    assert sk.supports(cs, ccam_t, cfilm_t, ccfg) is want_s


@pytest.mark.parametrize("case", [("kind", "coated diffuse"),
                                  ("texture", "fbm")],
                         ids=["coated diffuse", "fbm"])
def test_routes_take_torch(case, monkeypatch):
    """render_persistent and render_vspg(backend="auto") on a refused
    teaser scene: no kernel entry, equal to backend="torch" bit for
    bit."""
    tgopt, tvopt = convert.options_from_jax(
        GOPT._replace(field_res=4, train_waves=1), VOPT)
    cam, film = _view("cloud64")
    ts, tc, tf, tcfg = convert.from_jax(_teaser(case), cam, film, CFG,
                                        "cpu")
    calls = {}
    _spy(monkeypatch, calls)
    img = tv.render_persistent(ts, tc, tf, spp=1, cfg=tcfg, seed=3,
                               device="cpu")
    assert calls == {"render_persistent_wavefront": 1}, calls
    ref = tv.render_persistent(ts, tc, tf, spp=1, cfg=tcfg, seed=3,
                               backend="torch", device="cpu")
    assert torch.equal(img, ref) and bool(torch.isfinite(img).all())
    calls.clear()
    img, field, _ = tvspg.render_vspg(ts, tc, tf, 2, tcfg, tgopt, tvopt,
                                      seed=4, device="cpu")
    assert calls == {"vspg_wave": 2}, calls
    assert bool(torch.isfinite(img).all()) and img.mean() > 0
