"""Triangle area lights of the port against the JAX package's
``models/lights.py``: the selection table (uniform and power), ``sample``
(its area branch beside point and env lights), ``le_area`` and
``pdf_li_area`` on the same seeded numpy inputs, the sqrt-free triangle
warp, and ``convert.from_jax`` carrying the area lights of the Cornell
box."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vspg_pbrt_v4_tpu.models.cameras import PerspectiveCamera
from vspg_pbrt_v4_tpu.models.film import RGBFilm
from vspg_pbrt_v4_tpu.models.integrators import volpath as jv
from vspg_pbrt_v4_tpu.models.lights import Lights as JLights
from vspg_pbrt_v4_tpu.utils import sampling as jsampling
from vspg_pbrt_v4_tpu.utils import transform as jtr
from vspg_pbrt_v4_tpu_torch.convert import from_jax
from vspg_pbrt_v4_tpu_torch.models.lights import Lights
from vspg_pbrt_v4_tpu_torch.utils.sampling import sample_uniform_triangle

N = 4096
AREA = [
    dict(p0=(-0.35, 1.99, -0.35), p1=(0.35, 1.99, -0.35),
         p2=(-0.35, 1.99, 0.35), L=(12.0, 12.0, 12.0)),
    dict(p0=(-0.6, 0.3, -0.2), p1=(-0.2, 0.3, -0.6), p2=(-0.4, 0.9, -0.4),
         L=(3.0, 2.0, 1.0), twosided=True),
    dict(p0=(0.8, 0.2, 0.5), p1=(0.8, 1.2, 0.5), p2=(0.8, 0.2, -0.5),
         L=(0.5, 1.0, 2.0)),
]
POINT = dict(point_p=[(0.3, 1.5, 0.2)], point_I=[(2.0, 2.0, 2.0)])
ENV = dict(env_L=(0.2, 0.3, 0.4), world_radius=100.0)
# lights beside the three area lights
MIXES = {"area": {}, "area+point": POINT, "area+env": ENV,
         "area+point+env": dict(POINT, **ENV)}


def both(mix, sampler="uniform"):
    kw = dict(MIXES[mix], area_tris=AREA, sampler=sampler)
    return JLights.make(**kw), Lights.make(**kw, device="cpu")


def close(a, b, rtol=1e-5, atol=1e-6):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def inputs(seed):
    """Reference points inside the box around the lights, selection and
    2D draws, outgoing directions and normals, seeded."""
    rs = np.random.default_rng(seed)
    ref_p = rs.uniform((-1, 0, -1), (1, 2, 1), (N, 3)).astype(np.float32)
    u_sel = rs.uniform(0, 1, N).astype(np.float32)
    u2 = rs.uniform(0, 1, (N, 2)).astype(np.float32)
    wo = rs.normal(size=(N, 3))
    n = rs.normal(size=(N, 3))
    wo = (wo / np.linalg.norm(wo, axis=-1, keepdims=True)).astype(np.float32)
    n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    return ref_p, u_sel, u2, wo, n


@pytest.mark.parametrize("sampler", ["uniform", "power"])
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_make_selection_table_matches_jax(mix, sampler):
    jl, tl = both(mix, sampler)
    assert tl.n_area == jl.n_area == 3
    assert tl.base_area == jl.base_area
    assert tl.n_lights == jl.n_lights
    close(tl.select_pmf_table, jl.select_pmf_table, rtol=1e-6, atol=0)
    close(tl.select_cdf, jl.select_cdf, rtol=1e-6, atol=0)
    for f in ("area_p0", "area_p1", "area_p2", "area_L"):
        close(getattr(tl, f), getattr(jl, f), rtol=0, atol=0)
    assert np.array_equal(tl.area_twosided.numpy(),
                          np.asarray(jl.area_twosided))
    if sampler == "power":
        # proportional to power: not the uniform table
        pmf = tl.select_pmf_table
        assert float(pmf.max() - pmf.min()) > 0.1 * float(pmf.max())


def test_bvh_light_sampler_builds():
    """The area lights under ``sampler="bvh"``: the light BVH's arrays
    equal JAX's, topology and trails exactly."""
    jl, tl = both("area", "bvh")
    assert tl.bvh is not None and jl.bvh is not None
    assert tl.bvh.max_depth == jl.bvh.max_depth
    for f in ("bmin", "bmax", "axis", "phi", "cos_o", "cos_e"):
        close(getattr(tl.bvh, f), getattr(jl.bvh, f), rtol=1e-6, atol=0)
    for f in ("two_sided", "child1", "leaf_light", "trail", "trail_node"):
        assert np.array_equal(getattr(tl.bvh, f).numpy(),
                              np.asarray(getattr(jl.bvh, f))), f


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_sample_matches_jax(mix):
    """Every field of the light sample, lane for lane; area lanes include
    one-sided lights seen from behind (pdf 0, invalid) and the two-sided
    light from both sides."""
    jl, tl = both(mix)
    ref_p, u_sel, u2, _, _ = inputs(1)
    js = jl.sample(jnp.asarray(ref_p), jnp.asarray(u_sel), jnp.asarray(u2))
    ts = tl.sample(torch.from_numpy(ref_p), torch.from_numpy(u_sel),
                   torch.from_numpy(u2))
    for f in ("wi", "L", "select_pmf", "t_shadow"):
        close(getattr(ts, f), getattr(js, f))
    # the solid-angle pdf divides by |cos| at the light: wi agrees to about
    # 1.2e-7 a component (the JAX package's CPU sqrt is not correctly
    # rounded), which moves cos by up to ~4e-7, so the pdf's relative bar
    # is 1e-5 + 4e-7 / |cos| (only grazing lanes, |cos| < 0.04, feel it)
    on_area = np.asarray(js.area_id) >= 0
    cos = np.where(on_area, np.abs(np.sum(np.asarray(js.n_light)
                                          * np.asarray(js.wi), -1)), 1.0)
    pdf_t, pdf_j = ts.pdf_dir.numpy(), np.asarray(js.pdf_dir)
    bar = (1e-5 + 4e-7 / np.maximum(cos, 1e-30)) * np.abs(pdf_j) + 1e-6
    assert (np.abs(pdf_t - pdf_j) <= bar).all()
    assert (cos[on_area] < 1e-3).mean() < 0.01
    for f in ("is_delta", "valid"):
        assert np.array_equal(getattr(ts, f).numpy(),
                              np.asarray(getattr(js, f))), f
    area = (u_sel >= np.asarray(jl.select_cdf)[jl.base_area - 1]
            if jl.base_area else np.ones(N, bool))
    area &= u_sel < np.asarray(jl.select_cdf)[jl.base_area + jl.n_area - 1]
    valid = ts.valid.numpy()
    assert valid[area].any() and not valid[area].all()


@pytest.mark.parametrize("mix", ["area", "area+point+env"])
def test_le_area_and_pdf_li_area_match_jax(mix):
    """Emission toward wo (one-sided against n unless two-sided) and the
    MIS pdf of hitting a point of the light from ref_p, with light ids -1
    (no light) to 2."""
    jl, tl = both(mix)
    ref_p, u_sel, u2, wo, n = inputs(2)
    lid = np.random.default_rng(3).integers(-1, 3, N).astype(np.int32)
    b = np.asarray(jsampling.sample_uniform_triangle(jnp.asarray(u2)))
    ai = np.clip(lid, 0, 2)
    p_hit = sum(b[:, k:k + 1] * np.asarray([AREA[i][f"p{k}"] for i in ai],
                                           np.float32) for k in range(3))
    p_hit = p_hit.astype(np.float32)
    le_j = jl.le_area(jnp.asarray(lid), jnp.asarray(wo), jnp.asarray(n))
    le_t = tl.le_area(torch.from_numpy(lid), torch.from_numpy(wo),
                      torch.from_numpy(n))
    close(le_t, le_j, rtol=0, atol=0)
    pdf_j = jl.pdf_li_area(jnp.asarray(lid), jnp.asarray(ref_p),
                           jnp.asarray(p_hit), jnp.asarray(n))
    pdf_t = tl.pdf_li_area(torch.from_numpy(lid), torch.from_numpy(ref_p),
                           torch.from_numpy(p_hit), torch.from_numpy(n))
    close(pdf_t, pdf_j)
    assert (np.asarray(pdf_t)[lid < 0] == 0).all()
    assert (np.asarray(le_t)[lid == 1] > 0).all()  # two-sided


def test_sample_uniform_triangle_matches_jax():
    u2 = np.random.default_rng(4).uniform(0, 1, (N, 2)).astype(np.float32)
    b = sample_uniform_triangle(torch.from_numpy(u2))
    close(b, jsampling.sample_uniform_triangle(jnp.asarray(u2)), rtol=0,
          atol=0)
    assert (b.numpy() >= 0).all()


def test_from_jax_carries_cornell_area_lights():
    scene = jv.make_cornell_box_scene()
    cam = PerspectiveCamera.make(jtr.look_at((0, 1, 3.2), (0, 1, 0),
                                             (0, 1, 0)), 45.0, (16, 16))
    ts = from_jax(scene, cam, RGBFilm.make((16, 16)), jv.VolPathConfig(),
                  "cpu")[0]
    li, tl = scene.lights, ts.lights
    assert tl.n_area == li.n_area == 2 and tl.n_point == 0
    assert not tl.has_env
    for f in ("area_p0", "area_p1", "area_p2", "area_L", "select_pmf_table",
              "select_cdf"):
        close(getattr(tl, f), getattr(li, f), rtol=0, atol=0)
    assert tl.area_twosided.dtype == torch.bool
    assert np.array_equal(tl.area_twosided.numpy(),
                          np.asarray(li.area_twosided))
    assert np.array_equal(ts.geometry.tri_light.numpy(),
                          np.asarray(scene.geometry.tri_light))
