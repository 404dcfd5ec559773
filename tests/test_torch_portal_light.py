"""The portal light of the port (``models/portal_light.py``) against the
JAX package's on the same seeded inputs: ``PortalLight.make``'s warped
image and summed-area table, ``uv_of_dir``, ``dir_of_uv``,
``image_bounds``, the windowed sampling (``sample_li``), ``le`` and
``pdf_li``, and a ``Lights`` environment seen through the portal
(``sample``, ``le_escaped``, ``pdf_li_escaped``).

Tolerance: floats within rtol 1e-5 and atol 1e-6; flags exact. The
sampled directions agree within 1e-5 on 99.5% of the lanes and within
1e-4 on all: the window's bounds come from arctangents an ulp apart, the
20 bisection steps compare a summed-area integral with u, and where the
window is dim an ulp of that integral moves the inverse by up to an ulp
over the luminance density. Lanes whose uv lies within 1e-4 of a texel
edge of the 128^2 warped image, or whose sampled direction moved beyond
1e-5, may read a neighbouring texel; they are
counted and left out of the radiance and pdf comparison (pdfs within
rtol 1e-4: the window's integral is a difference of table entries).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vspg_pbrt_v4_tpu.models.lights import Lights as JLights
from vspg_pbrt_v4_tpu.models.portal_light import PortalLight as JPortal
from vspg_pbrt_v4_tpu_torch.models.lights import Lights
from vspg_pbrt_v4_tpu_torch.models.portal_light import PortalLight

N = 4096
RES = 128
# a window in the plane z = 1, its normal +z toward the sky
CORNERS = [(-0.5, 0.5, 1.0), (0.5, 0.5, 1.0), (0.5, 1.5, 1.0),
           (-0.5, 1.5, 1.0)]


def sky(dirs):
    """A smooth sky with a bright sun toward (0.3, 0.5, 0.8)."""
    d = np.asarray(dirs, np.float64)
    sun = np.asarray([0.3, 0.5, 0.8]) / np.linalg.norm([0.3, 0.5, 0.8])
    s = np.exp(40.0 * (d @ sun - 1.0))[:, None] * np.asarray([20, 18, 12])
    base = np.stack([0.2 + 0.3 * d[:, 1].clip(0), 0.3 + 0.2 * d[:, 2],
                     0.5 + 0.3 * d[:, 0]], -1)
    return (base + s).astype(np.float32)


@pytest.fixture(scope="module")
def portals():
    return (JPortal.make(sky, CORNERS, res=RES),
            PortalLight.make(sky, CORNERS, res=RES, device="cpu"))


def _inputs(seed):
    rs = np.random.default_rng(seed)
    p = rs.uniform((-1, 0, -1), (1, 2, 0.9), (N, 3)).astype(np.float32)
    u2 = rs.uniform(0, 1, (N, 2)).astype(np.float32)
    w = rs.normal(size=(N, 3))
    w[:, 2] = np.abs(w[:, 2]) * 2  # mostly toward the window's side
    w = (w / np.linalg.norm(w, axis=-1, keepdims=True)).astype(np.float32)
    return p, u2, w


def _close(a, b, mask=None, rtol=1e-5, atol=1e-6, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    if mask is not None:
        a, b = a[mask], b[mask]
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=what)


def _bisected(t, j):
    """Lanes whose sampled directions agree within 1e-5 (99.5% of them
    must; all within 1e-4)."""
    t, j = np.asarray(t), np.asarray(j)
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-4)
    same = (np.abs(t - j) <= 1e-5).all(-1)
    assert same.mean() >= 0.995
    return same


def _edge(uv):
    x = np.asarray(uv, np.float64) * RES
    return (np.abs(x - np.round(x)) < 1e-4).any(-1)


def test_make_matches_jax(portals):
    jp, tp = portals
    for f in ("img", "sat", "p0", "p1", "p2", "p3", "x_axis", "y_axis",
              "z_axis"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)), err_msg=f)
    assert tp.img.shape == (RES, RES, 3) and tp.sat.shape == (RES + 1,) * 2
    assert abs(float(tp.sat[-1, -1]) - 1.0) < 1e-6


def test_uv_maps_match_jax(portals):
    """``uv_of_dir`` (uv, valid, Jacobian), ``dir_of_uv`` and its round
    trip, ``image_bounds`` from points in the room."""
    jp, tp = portals
    p, u2, w = _inputs(1)
    tuv, tv, tj = tp.uv_of_dir(torch.from_numpy(w))
    juv, jv, jj = jp.uv_of_dir(jnp.asarray(w))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    _close(tuv, juv, what="uv")
    _close(tj, jj, what="jacobian")
    d = tp.dir_of_uv(torch.from_numpy(u2))
    _close(d, jp.dir_of_uv(jnp.asarray(u2)), what="dir")
    inner = (np.abs(u2 - 0.5) < 0.45).all(-1)
    _close(tp.uv_of_dir(d)[0], u2, mask=inner, atol=1e-5, what="round trip")
    tlo, thi, tok = tp.image_bounds(torch.from_numpy(p))
    jlo, jhi, jok = jp.image_bounds(jnp.asarray(p))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    _close(tlo, jlo, what="lo")
    _close(thi, jhi, what="hi")
    assert tok.numpy().all() and (thi.numpy() > tlo.numpy()).all()


def test_sample_le_and_pdf_match_jax(portals):
    """``sample_li`` through the window from points in the room, ``le``
    (with and without the ray origins) and ``pdf_li`` at the sampled and at
    random directions."""
    jp, tp = portals
    p, u2, w = _inputs(2)
    twi, tL, tpdf, tok = tp.sample_li(torch.from_numpy(p),
                                      torch.from_numpy(u2))
    jwi, jL, jpdf, jok = jp.sample_li(jnp.asarray(p), jnp.asarray(u2))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert tok.numpy().mean() > 0.99
    same = _bisected(twi, jwi)
    uv = np.asarray(jp.uv_of_dir(jwi)[0])
    edge = _edge(uv) | ~same
    assert edge.mean() < 1e-2
    _close(tL, jL, mask=~edge, what="L")
    _close(tpdf, jpdf, mask=~edge, rtol=1e-4, what="pdf")
    # every sampled direction passes through the window
    ts_ = (1.0 - p[:, 2]) / np.asarray(jwi)[:, 2]
    hit = p + ts_[:, None] * np.asarray(jwi)
    assert (np.abs(hit[:, 0]) <= 0.5 + 1e-4).all()
    assert (np.abs(hit[:, 1] - 1.0) <= 0.5 + 1e-4).all()
    for d, o in ((w, None), (w, p), (np.asarray(jwi), p)):
        edge = _edge(np.asarray(jp.uv_of_dir(jnp.asarray(d))[0]))
        tle = tp.le(torch.from_numpy(d),
                    None if o is None else torch.from_numpy(o))
        jle = jp.le(jnp.asarray(d), None if o is None else jnp.asarray(o))
        _close(tle, jle, mask=~edge, what="le")
        if o is not None:
            tpl = tp.pdf_li(torch.from_numpy(o), torch.from_numpy(d))
            jpl = jp.pdf_li(jnp.asarray(o), jnp.asarray(d))
            _close(tpl, jpl, mask=~edge, rtol=1e-4, what="pdf_li")
            assert ((tpl.numpy() > 0) == (tle.numpy() > 0).any(-1)).mean() \
                > 0.99


@pytest.mark.parametrize("sampler", ["uniform", "bvh"])
def test_lights_through_the_portal_match_jax(portals, sampler):
    """A constant environment with a point light, the environment seen
    through the portal: ``Lights.sample``, ``le_escaped(d, o)`` and
    ``pdf_li_escaped(d, ref_p)`` lane for lane."""
    jp, tp = portals
    kw = dict(point_p=[(0.0, 1.5, 0.0)], point_I=[(1.0, 1.0, 1.0)],
              env_L=(0.5, 0.5, 0.5), world_radius=20.0, sampler=sampler)
    jl = JLights.make(**kw).replace(portal=jp)
    tl = dataclasses.replace(Lights.make(**kw, device="cpu"), portal=tp)
    assert tl.beyond_kernels
    p, u2, w = _inputs(3)
    u = np.random.default_rng(4).uniform(0, 1, N).astype(np.float32)
    ts = tl.sample(torch.from_numpy(p), torch.from_numpy(u),
                   torch.from_numpy(u2))
    js = jl.sample(jnp.asarray(p), jnp.asarray(u), jnp.asarray(u2))
    for f in ("light_idx", "valid", "is_delta"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    env = np.asarray(js.light_idx) == tl.n_lights - 1
    assert 0.3 < env.mean() < 0.7
    edge = (_edge(np.asarray(jp.uv_of_dir(js.wi)[0]))
            | ~_bisected(ts.wi, js.wi)) & env
    _close(ts.L, js.L, mask=~edge, what="L")
    _close(ts.pdf_dir, js.pdf_dir, mask=~edge, rtol=1e-4, what="pdf")
    _close(ts.select_pmf, js.select_pmf, what="pmf")
    edge = _edge(np.asarray(jp.uv_of_dir(jnp.asarray(w))[0]))
    _close(tl.le_escaped(torch.from_numpy(w), torch.from_numpy(p)),
           jl.le_escaped(jnp.asarray(w), jnp.asarray(p)), mask=~edge)
    _close(tl.pdf_li_escaped(torch.from_numpy(w), torch.from_numpy(p)),
           jl.pdf_li_escaped(jnp.asarray(w), jnp.asarray(p)), mask=~edge,
           rtol=1e-4)
