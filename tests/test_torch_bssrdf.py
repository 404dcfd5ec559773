"""The port's subsurface scattering (``models/bssrdf.py`` and the
``cfg.sss`` branch of the volpath bounce) against the JAX package's: the
profile, its sampling and the Fresnel moment lane for lane, the probe
ray's exit points on a flat slab (triangles) and on a sphere, the
estimator's weight, and ``volpath.render(cfg.sss=True)`` of a subsurface
slab and sphere pixel for pixel with the JAX XLA render on one sampler
stream; and the non-slow checks of tests/test_bssrdf.py on the port.

Tolerances: the profile functions within 1e-6 relative (1e-6 absolute);
the exit points' flags exactly and their points, normals, radii and
cosines within 1e-5 (1e-5 absolute: a probe's hit distance is 2h -
float32 rounding), against the compiled JAX function, whose probe height
XLA contracts into an FMA (``models/bssrdf.py``; the port computes it
so); the render as tests/test_torch_lights_render.py: at least 0.99 of
the pixels within 1e-3 relative (or 1e-6 absolute) and the image means
within 1e-4 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vspg_pbrt_v4_tpu.models import bssrdf as jb
from vspg_pbrt_v4_tpu.models.cameras import PerspectiveCamera
from vspg_pbrt_v4_tpu.models.film import RGBFilm
from vspg_pbrt_v4_tpu.models.integrators import volpath as jv
from vspg_pbrt_v4_tpu.models.lights import Lights
from vspg_pbrt_v4_tpu.models.materials import Materials
from vspg_pbrt_v4_tpu.models.media import HomogeneousMedia
from vspg_pbrt_v4_tpu.models.shapes import Geometry as JGeometry
from vspg_pbrt_v4_tpu.utils import transform as tr
from vspg_pbrt_v4_tpu_torch import convert
from vspg_pbrt_v4_tpu_torch.models import bssrdf as tb
from vspg_pbrt_v4_tpu_torch.models.integrators import volpath as tv
from vspg_pbrt_v4_tpu_torch.models.shapes import Geometry as TGeometry

R = 4096


def _t(x):
    return torch.as_tensor(np.array(x))


def test_profile_matches_jax():
    rng = np.random.default_rng(0)
    r = rng.uniform(0, 5, R).astype(np.float32)
    d = rng.uniform(0.05, 2, R).astype(np.float32)
    u1, u2 = (rng.uniform(0, 1, R).astype(np.float32) for _ in range(2))
    eta = rng.uniform(0.7, 2.0, R).astype(np.float32)
    cos = rng.uniform(-1, 1, R).astype(np.float32)
    alb = rng.uniform(0, 1, R).astype(np.float32)
    for t, j in ((tb.sr_area_pdf(_t(r), _t(d)), jb.sr_area_pdf(r, d)),
                 (tb.sample_sr(_t(u1), _t(u2), _t(d)),
                  jb.sample_sr(u1, u2, d)),
                 (tb.fresnel_moment1(_t(eta)), jb.fresnel_moment1(eta)),
                 (tb.sw(_t(cos), _t(eta)), jb.sw(cos, eta)),
                 (tb.burley_s(_t(alb)), jb.burley_s(alb))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-6)


def test_sample_sr_matches_pdf():
    """r ~ sample_sr follows sr_area_pdf (200k samples, 50 bins)."""
    gen = torch.Generator().manual_seed(0)
    d = 0.7
    r = tb.sample_sr(torch.rand(200000, generator=gen),
                     torch.rand(200000, generator=gen), torch.tensor(d))
    hist, edges = np.histogram(r.numpy(), bins=50, range=(0, 8 * d),
                               density=True)
    centers = 0.5 * (edges[:-1] + edges[1:])
    pdf = tb.sr_area_pdf(_t(centers), torch.tensor(d)).numpy()
    mask = pdf > 0.05
    assert np.abs(hist[mask] / pdf[mask] - 1.0).max() < 0.12


SLAB = [dict(p0=(-50, 0, -50), p1=(50, 0, -50), p2=(50, 0, 50), mat=0,
             light=-1, med_in=-1, med_out=-1),
        dict(p0=(-50, 0, -50), p1=(50, 0, 50), p2=(-50, 0, 50), mat=0,
             light=-1, med_in=-1, med_out=-1)]
SPHERE = [dict(c=(0.0, -1.0, 0.0), r=1.0, mat=0, light=-1, med_in=-1,
               med_out=-1)]


@pytest.mark.parametrize("shape", ["slab", "sphere"])
def test_exit_points_match_jax(shape):
    """Probe-ray exits from the top of a flat slab (mean radius 2.5 d,
    normals up) and of a unit sphere (probes through the whole sphere),
    and sp_weight at them."""
    rng = np.random.default_rng(1)
    kw = dict(triangles=SLAB) if shape == "slab" else dict(spheres=SPHERE)
    jg = JGeometry.build(**kw)
    tg = TGeometry.build(**kw, device="cpu")
    p = np.zeros((R, 3), np.float32)
    ns = np.tile(np.float32([0, 1, 0]), (R, 1))
    t1 = np.tile(np.float32([1, 0, 0]), (R, 1))
    t2 = np.tile(np.float32([0, 0, 1]), (R, 1))
    d = np.full(R, 0.5 if shape == "slab" else 0.1, np.float32)
    u = rng.uniform(0, 1, (3, R)).astype(np.float32)
    active = rng.uniform(size=R) < 0.9
    mid = np.zeros(R, np.int32)
    jo = jax.jit(jb.sample_exit_point)(jg, p, ns, t1, t2, mid, d, *u, active)
    to = tb.sample_exit_point(tg, *(_t(x) for x in (p, ns, t1, t2, mid, d)),
                              *(_t(x) for x in u), _t(active))
    ok = to[0].numpy()
    np.testing.assert_array_equal(ok, np.asarray(jo[0]))
    assert ok.mean() > 0.85
    for a, b in zip(to[1:], jo[1:]):
        np.testing.assert_allclose(a.numpy()[ok], np.asarray(b)[ok],
                                   rtol=1e-5, atol=1e-5)
    if shape == "slab":
        r = np.linalg.norm(to[1].numpy()[ok][:, [0, 2]], axis=-1)
        assert abs(r.mean() - 2.5 * 0.5) / (2.5 * 0.5) < 0.1
        np.testing.assert_allclose(to[2].numpy()[ok][:, 1], 1.0, atol=1e-4)
    alb = rng.uniform(0.2, 1, (R, 3)).astype(np.float32)
    dd = np.stack([d, 0.5 * d, 2 * d], -1)
    np.testing.assert_allclose(
        tb.sp_weight(_t(p), to[1], _t(alb), _t(dd), to[3], to[4]).numpy(),
        np.asarray(jb.sp_weight(p, jo[1], alb, dd, jo[3], jo[4])),
        rtol=1e-4, atol=1e-6)


def _sss_scene(A=0.8):
    """A subsurface slab with a subsurface sphere on it under a unit
    environment, the camera looking down at both."""
    geom = JGeometry.build(triangles=[dict(t, mat=0) for t in SLAB],
                           spheres=[dict(c=(0.3, 0.4, 0.2), r=0.4, mat=1,
                                         light=-1, med_in=-1, med_out=-1)])
    mats = Materials.build([
        dict(type=9, albedo=(A, A, A), albedo2=(0.3, 0.2, 0.1), eta=1.33),
        dict(type=9, albedo=(0.9, 0.6, 0.4), albedo2=(0.05, 0.1, 0.2),
             eta=1.4)])
    lights = Lights.make(env_L=[1.0, 1.0, 1.0], world_radius=100.0,
                         point_p=[(1.0, 2.0, -1.0)], point_I=[(2.0,) * 3])
    media = HomogeneousMedia.make(jnp.zeros((1, 3)), jnp.zeros((1, 3)))
    cam = PerspectiveCamera.make(tr.look_at((0, 3, -3), (0, 0, 0), (0, 1, 0)),
                                 fov_deg=40.0, resolution=(16, 16))
    return jv.Scene(geom, mats, media, lights), cam, RGBFilm.make((16, 16))


def test_sss_render_matches_jax():
    scene, cam, film = _sss_scene()
    cfg = jv.VolPathConfig(sss=True, max_depth=8)
    ref = np.asarray(jv.render(scene, cam, film, spp=4, cfg=cfg, seed=5,
                               spp_per_pass=4))
    ts, tc, tf, tcfg = convert.from_jax(scene, cam, film, cfg, "cpu")
    assert tcfg.sss
    img = tv.render(ts, tc, tf, spp=4, cfg=tcfg, seed=5, spp_per_pass=4,
                    device="cpu").numpy()
    assert np.isfinite(img).all()
    diff = np.abs(img - ref)
    ok = ((diff <= 1e-3 * np.abs(ref)) | (diff <= 1e-6)).all(-1)
    print(f"{ok.mean():.4f} of pixels within 1e-3, means {img.mean():.6f} "
          f"and {ref.mean():.6f}")
    assert ok.mean() >= 0.99, ok.mean()
    assert abs(img.mean() - ref.mean()) <= 1e-4 * ref.mean()
    # the subsurface branch changed the image: the same scene without it
    plain = tv.render(ts, tc, tf, spp=4, cfg=tcfg._replace(sss=False),
                      seed=5, spp_per_pass=4, device="cpu").numpy()
    assert np.abs(plain - img).max() > 1e-2


def test_parser_subsurface():
    """Material "subsurface" from sigma_s and sigma_a: the port's row
    equals the JAX builder's."""
    from vspg_pbrt_v4_tpu.scene import build_render_setup as jbuild
    from vspg_pbrt_v4_tpu.scene import parse_pbrt_string as jparse
    from vspg_pbrt_v4_tpu_torch.scene import build_render_setup as tbuild
    from vspg_pbrt_v4_tpu_torch.scene import parse_pbrt_string as tparse

    txt = """
    Film "rgb" "integer xresolution" [8] "integer yresolution" [8]
    WorldBegin
    Material "subsurface" "rgb sigma_s" [2 2 2] "rgb sigma_a" [0.02 0.1 0.4]
      "float g" [0.3]
    Shape "sphere" "float radius" [1]
    Material "subsurface" "rgb reflectance" [0.7 0.6 0.5] "rgb mfp" [1 2 3]
    Shape "sphere" "float radius" [0.5]
    """
    tm_ = tbuild(tparse(txt), device="cpu").scene.materials
    jm_ = jbuild(jparse(txt)).scene.materials
    assert tm_.mat_type.tolist() == [0, 9, 9]
    for f in ("albedo", "albedo2", "eta"):
        np.testing.assert_array_equal(getattr(tm_, f).numpy(),
                                      np.asarray(getattr(jm_, f)), f)
