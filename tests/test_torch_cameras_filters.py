"""The port's cameras (the thin lens, orthographic, spherical and
realistic ones) and filters (triangle, gaussian, mitchell and the box)
against the JAX package's, ray for ray and offset for offset on
numpy-seeded pixel positions and draws; and ``volpath.render`` with a
gaussian filter, a full-dimensional Sobol' sampler and a thin lens against
JAX's render of the same fog box, pixel for pixel. (The JAX package's
zsobol kind draws eagerly but not under ``jit``, where its numpy digit
table is indexed by a traced array, ``utils/lowdiscrepancy.py:351``: its
``render`` cannot take it, so zsobol is held draw for draw in
tests/test_torch_samplers.py and the port's zsobol render by its own
tests here.)"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vspg_pbrt_v4_tpu.models import cameras as jc
from vspg_pbrt_v4_tpu.models.film import RGBFilm as JFilm
from vspg_pbrt_v4_tpu.models.filters import Filter as JFilter
from vspg_pbrt_v4_tpu.models.integrators import volpath as jv
from vspg_pbrt_v4_tpu.utils import transform as jtr
from vspg_pbrt_v4_tpu_torch import convert
from vspg_pbrt_v4_tpu_torch.models import cameras as tc
from vspg_pbrt_v4_tpu_torch.models.filters import Filter
from vspg_pbrt_v4_tpu_torch.models.integrators import volpath as tv
from vspg_pbrt_v4_tpu_torch.utils import transform as ttr

from test_torch_volpath import fog_scene

N = 1024
RES = (24, 16)
EYE, AT, UP = (0.3, 0.2, -4.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0)
# a three-element lens with a stop, front to back, in meters: [curvature
# radius, thickness, eta, aperture diameter]
LENS = [[0.04, 0.004, 1.6, 0.02], [0.0, 0.003, 0.0, 0.012],
        [-0.04, 0.05, 1.5, 0.02]]


def _jax_camera(kind):
    c2w = jtr.look_at(EYE, AT, UP)
    if kind == "thin lens":
        return jc.PerspectiveCamera.make(c2w, 35.0, RES, lens_radius=0.15,
                                         focal_distance=3.5)
    if kind == "orthographic":
        return jc.OrthographicCamera.make(c2w, RES)
    if kind == "spherical":
        return jc.SphericalCamera(c2w, RES)
    if kind == "realistic":
        return jc.RealisticCamera.make(c2w, LENS, RES, aperture_diameter=0.01)
    return jc.RealisticCamera.simple_lens(c2w, RES, aperture_diameter=0.004,
                                          focus_distance=2.0)


def _port_camera(kind):
    c2w = ttr.look_at(EYE, AT, UP, device="cpu")
    if kind == "thin lens":
        return tc.PerspectiveCamera.make(c2w, 35.0, RES, lens_radius=0.15,
                                         focal_distance=3.5, device="cpu")
    if kind == "orthographic":
        return tc.OrthographicCamera.make(c2w, RES, device="cpu")
    if kind == "spherical":
        return tc.SphericalCamera(c2w, RES)
    if kind == "realistic":
        return tc.RealisticCamera.make(c2w, LENS, RES, aperture_diameter=0.01,
                                       device="cpu")
    return tc.RealisticCamera.simple_lens(c2w, RES, aperture_diameter=0.004,
                                          focus_distance=2.0, device="cpu")


CAMERAS = ("thin lens", "orthographic", "spherical", "realistic",
           "simple lens")


@pytest.mark.parametrize("kind", CAMERAS)
def test_camera_rays_match_jax(kind):
    """Origins, directions and (lens systems) weights within 2e-5 of
    JAX's; the port's camera built by itself and converted from JAX's
    (``convert``) give the same rays; the lens system's weight is 0 on its
    vignetted rays and positive on at least a sixth of them."""
    rng = np.random.default_rng(4)
    p = (rng.uniform(0, 1, (N, 2)) * RES).astype(np.float32)
    u = rng.uniform(0, 1, (N, 2)).astype(np.float32)
    jr = _jax_camera(kind).generate_rays(jnp.asarray(p), jnp.asarray(u))
    cams = [_port_camera(kind),
            convert.from_jax(fog_scene(), _jax_camera(kind), JFilm.make(RES),
                             jv.VolPathConfig(), "cpu")[1]]
    for cam in cams:
        tr_ = cam.generate_rays(torch.as_tensor(p), torch.as_tensor(u))
        assert len(tr_) == len(jr)
        for a, b in zip(tr_, jr):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5,
                                       atol=2e-5, err_msg=kind)
    if len(jr) == 3:
        w = tr_[2].numpy()
        assert (w >= 0).all() and (w > 0).mean() > 1 / 6, (w > 0).mean()


@pytest.mark.parametrize("kind", ("box", "triangle", "gaussian",
                                  "mitchell"))
def test_filter_samples_match_jax(kind):
    """Offsets within 1e-6 of JAX's, the gaussian's within 1e-5 relative
    (torch's inverse error function and JAX's part by a few ulps in the
    tails), weights equal, at the default radius and at radius 1.25
    (sigma 0.4)."""
    rng = np.random.default_rng(5)
    u = rng.uniform(0, 1, (N, 2)).astype(np.float32)
    for radius, sigma in ((None, 0.5), (1.25, 0.4)):
        jo, jw = JFilter.make(kind, radius=radius, sigma=sigma).sample(
            jnp.asarray(u))
        to, tw = Filter.make(kind, radius=radius, sigma=sigma).sample(
            torch.as_tensor(u))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo),
                                   rtol=1e-5 if kind == "gaussian" else 0,
                                   atol=1e-6, err_msg=kind)
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        r = Filter.make(kind, radius=radius).radius
        assert np.abs(to.numpy()).max() <= r
    if kind == "mitchell":
        assert (tw.numpy() < 0).any()  # the negative lobes' sign weight


def test_render_lens_gaussian_sobol_matches_jax():
    """``volpath.render`` of the fog box through a thin lens with a
    gaussian filter and the sobol sampler at 16x16x4: at least 0.99 of
    pixels within 1e-3 relative or 1e-6 absolute of JAX's render."""
    res, spp = (16, 16), 4
    cam = jc.PerspectiveCamera.make(jtr.look_at((0, 0, -4), (0, 0, 0),
                                                (0, 1, 0)), 30.0, res,
                                    lens_radius=0.2, focal_distance=3.0)
    film = JFilm.make(res, filter=JFilter.make("gaussian"))
    cfg = jv.VolPathConfig(max_depth=8, max_events=32)
    scene = fog_scene()
    ref = np.asarray(jv.render(scene, cam, film, spp=spp, cfg=cfg, seed=2,
                               sampler="sobol"))
    ts, tcam, tf, tcfg = convert.from_jax(scene, cam, film, cfg, "cpu")
    assert tf.filter.kind == "gaussian" and tcam.lens_radius == 0.2
    img = tv.render(ts, tcam, tf, spp=spp, cfg=tcfg, seed=2,
                    sampler="sobol", device="cpu").numpy()
    d = np.abs(img - ref)
    frac = ((d <= 1e-3 * np.abs(ref)) | (d <= 1e-6)).all(-1).mean()
    print(f"render (thin lens, gaussian, sobol): {frac:.4f} of pixels "
          "within 1e-3 of JAX")
    assert np.isfinite(img).all() and frac >= 0.99, frac


@pytest.mark.parametrize("sampler", ["zsobol", "halton", "pmj02bn"])
def test_render_low_discrepancy_means_agree(sampler):
    """The port's renders with the low-discrepancy kinds estimate what the
    independent sampler's does: the fog box at 16x16x16 within four
    standard errors of the per-pixel differences from the independent
    render."""
    cam = jc.PerspectiveCamera.make(jtr.look_at((0, 0, -4), (0, 0, 0),
                                                (0, 1, 0)), 30.0, (16, 16))
    ts, tcam, tf, tcfg = convert.from_jax(
        fog_scene(), cam, JFilm.make((16, 16)),
        jv.VolPathConfig(max_depth=8, max_events=32), "cpu")
    imgs = [tv.render(ts, tcam, tf, spp=16, cfg=tcfg, seed=s, sampler=k,
                      device="cpu").numpy()
            for s, k in ((3, sampler), (4, "independent"))]
    diff = (imgs[0] - imgs[1]).mean(-1).reshape(-1)
    err = diff.std(ddof=1) / np.sqrt(diff.size)
    assert np.isfinite(imgs[0]).all()
    assert abs(diff.mean()) <= 4.0 * err, (diff.mean(), err)
