"""Every light kind of the port's ``models/lights.py`` against the JAX
package's on the same seeded numpy inputs: ``Lights.make``'s fields and
selection tables (uniform and power) over a mix of every kind, each field
of ``sample`` per kind and mixed, the goniometric and projection image
lookups, the image environment (``sample``, ``le_escaped``,
``pdf_li_escaped``, ``sample_env_dir``, ``env_pdf_dir``), ``sample_le``,
``latlong_to_equal_area``, ``equal_area_square_to_sphere`` and the
blackbody reduced to RGB.

Tolerance: floats within rtol 1e-5 and atol 1e-6; indices and flags
exact. An image lookup whose texel coordinate lies within 1e-4 of a texel
edge may round to the neighbouring texel on one side (the two packages'
CPU transcendentals differ by an ulp); such lanes are counted, must be
under 0.1%, and are left out of the comparison of the looked-up value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vspg_pbrt_v4_tpu.models.lights import Lights as JLights
from vspg_pbrt_v4_tpu.utils import envmap as jenvmap
from vspg_pbrt_v4_tpu.utils import spectrum as jspectrum
from vspg_pbrt_v4_tpu.utils import vecmath as jvm
from vspg_pbrt_v4_tpu.utils.colorspace import convert_rgb as jconvert_rgb
from vspg_pbrt_v4_tpu.utils.colorspace import srgb_decode as jsrgb_decode
from vspg_pbrt_v4_tpu.utils.colorspace import srgb_encode as jsrgb_encode
from vspg_pbrt_v4_tpu_torch.models.lights import Lights
from vspg_pbrt_v4_tpu_torch.utils import colorspace, envmap, spectrum
from vspg_pbrt_v4_tpu_torch.utils import vecmath as tvm

N = 4096


def _rot(axis, deg):
    a = np.asarray(axis, np.float64)
    a /= np.linalg.norm(a)
    t = np.radians(deg)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(t) * K + (1 - np.cos(t)) * K @ K


_IMG = np.random.default_rng(7)
POINT = dict(point_p=[(0.3, 1.5, 0.2), (-0.5, 1.2, -0.3)],
             point_I=[(2.0, 2.0, 2.0), (1.0, 3.0, 2.0)])
SPOT = dict(spots=[
    dict(p=(0.0, 1.8, 0.0), I=(5.0, 4.0, 3.0), dir=(0.1, -1.0, 0.2),
         cos_total=float(np.cos(np.radians(35))),
         cos_start=float(np.cos(np.radians(25)))),
    dict(p=(-0.8, 1.0, 0.5), I=(2.0, 2.0, 2.0), dir=(1.0, -0.5, -0.3))])
GONIO = dict(gonios=[
    dict(p=(0.5, 1.6, -0.4), I=(3.0, 3.0, 3.0),
         img=_IMG.uniform(0.1, 1.0, (16, 16, 3)).astype(np.float32),
         rot=_rot((1, 2, 0.5), 40)),
    dict(p=(-0.4, 0.2, 0.6), I=(1.0, 2.0, 1.0),
         img=_IMG.uniform(0.0, 2.0, (8, 8)).astype(np.float32))])
PROJ = dict(projections=[
    # looking down: world -y is the light's +z
    dict(p=(-0.2, 1.9, 0.1), I=(4.0, 4.0, 4.0),
         img=_IMG.uniform(0.1, 1.0, (12, 20, 3)).astype(np.float32),
         fov_deg=70.0, rot=_rot((1, 0, 0), -90)),
    dict(p=(0.6, 0.4, -0.9), I=(2.0, 1.0, 1.0),
         img=_IMG.uniform(0.0, 1.0, (6, 6)).astype(np.float32),
         rot=_rot((0, 1, 0), 20))])
DISTANT = dict(distant_dir=[(0.3, -1.0, 0.2), (-0.5, -0.5, -0.7)],
               distant_L=[(1.0, 0.9, 0.8), (0.2, 0.3, 0.4)])
AREA = dict(area_tris=[
    dict(p0=(-0.35, 1.99, -0.35), p1=(0.35, 1.99, -0.35),
         p2=(-0.35, 1.99, 0.35), L=(12.0, 12.0, 12.0)),
    dict(p0=(-0.6, 0.3, -0.2), p1=(-0.2, 0.3, -0.6), p2=(-0.4, 0.9, -0.4),
         L=(3.0, 2.0, 1.0), twosided=True)])
ENV = dict(env_L=(0.2, 0.3, 0.4), world_radius=100.0)
ENV_IMG = dict(env_img=(_IMG.uniform(0.0, 1.0, (32, 32, 3)) ** 3
                        ).astype(np.float32), world_radius=100.0)
ALL = dict(**POINT, **SPOT, **GONIO, **PROJ, **DISTANT, **AREA)
MIXES = {"point": POINT, "spot": SPOT, "gonio": GONIO, "proj": PROJ,
         "distant": DISTANT, "area": AREA, "env": ENV, "env_img": ENV_IMG,
         "all": dict(ALL, **ENV_IMG), "all_const_env": dict(ALL, **ENV)}


def both(mix, sampler="uniform"):
    kw = dict(MIXES[mix], sampler=sampler)
    return JLights.make(**kw), Lights.make(**kw, device="cpu")


def close(a, b, rtol=1e-5, atol=1e-6, mask=None, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if mask is not None:
        a, b = a[mask], b[mask]
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=what)


def exact(a, b, what=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)


def inputs(seed, n=N):
    rs = np.random.default_rng(seed)
    ref_p = rs.uniform((-1, 0, -1), (1, 2, 1), (n, 3)).astype(np.float32)
    u_sel = rs.uniform(0, 1, n).astype(np.float32)
    u2 = rs.uniform(0, 1, (n, 2)).astype(np.float32)
    w = rs.normal(size=(n, 3))
    w = (w / np.linalg.norm(w, axis=-1, keepdims=True)).astype(np.float32)
    return ref_p, u_sel, u2, w


def jt(*xs):
    return [jnp.asarray(x) for x in xs]


def tt(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def edge_lanes(sq, size):
    """Lanes whose texel coordinates sq * size lie within 1e-4 of an
    integer."""
    x = np.asarray(sq, np.float64) * np.asarray(size, np.float64)
    return (np.abs(x - np.round(x)) < 1e-4).any(-1)


def ea_square(w):
    return np.asarray(jvm.equal_area_sphere_to_square(jnp.asarray(w)))


@pytest.mark.parametrize("sampler", ["uniform", "power"])
@pytest.mark.parametrize("env", ["env", "env_img"])
def test_make_matches_jax(sampler, env):
    """Every array field equal to JAX's, the layout's bases and counts, and
    the selection pmf and cdf over every kind."""
    kw = dict(ALL, **(ENV if env == "env" else ENV_IMG), sampler=sampler)
    jl, tl = JLights.make(**kw), Lights.make(**kw, device="cpu")
    for f in ("n_point", "n_spot", "n_gonio", "n_proj", "n_distant",
              "n_area", "base_gonio", "base_proj", "base_distant",
              "base_area", "n_lights", "n_infinite", "has_env",
              "has_env_img", "world_radius"):
        assert getattr(tl, f) == getattr(jl, f), f
    assert tl.n_lights == 2 * 5 + 2 + 1
    for f in ("point_p", "point_I", "spot_p", "spot_I", "spot_dir",
              "spot_cos_total", "spot_cos_start", "gonio_p", "gonio_I",
              "gonio_r", "gonio_img", "proj_p", "proj_I", "proj_r",
              "proj_img", "proj_tan", "distant_dir", "distant_L", "area_p0",
              "area_p1", "area_p2", "area_L", "area_twosided", "env_L",
              "env_img", "env_pmf", "env_cdf"):
        exact(getattr(tl, f).numpy(), getattr(jl, f), f)
    close(tl.select_pmf_table, jl.select_pmf_table, rtol=1e-6, atol=0)
    close(tl.select_cdf, jl.select_cdf, rtol=1e-6, atol=0)
    pmf = tl.select_pmf_table.numpy()
    assert abs(pmf.sum() - 1) < 1e-5
    if sampler == "power":
        assert pmf.max() - pmf.min() > 0.1 * pmf.max()
    assert tl.beyond_kernels and tl.bvh is None and tl.portal is None


@pytest.mark.parametrize("mix,sampler", [(m, "uniform") for m in MIXES]
                         + [("all", "power")])
def test_sample_matches_jax(mix, sampler):
    """Every field of the light sample lane for lane, per kind and mixed;
    area lanes that graze their light (|cos| < 1e-3) are left out of the
    pdf (the pdf divides by |cos|)."""
    jl, tl = both(mix, sampler)
    ref_p, u_sel, u2, _ = inputs(1)
    js = jl.sample(*jt(ref_p, u_sel, u2))
    ts = tl.sample(*tt(ref_p, u_sel, u2))
    for f in ("is_delta", "valid", "area_id", "light_idx"):
        exact(getattr(ts, f).numpy(), getattr(js, f), f)
    idx = np.asarray(js.light_idx)
    keep = np.ones(N, bool)
    # texel lookups: the goniometric image at -wi in light space, the image
    # environment at the sampled direction
    if tl.n_gonio:
        gi = np.clip(idx - tl.base_gonio, 0, tl.n_gonio - 1)
        wl = np.einsum("nij,nj->ni", np.asarray(jl.gonio_r)[gi],
                       -np.asarray(js.wi))
        on = (idx >= tl.base_gonio) & (idx < tl.base_proj)
        keep &= ~(on & edge_lanes(ea_square(wl / np.linalg.norm(
            wl, axis=-1, keepdims=True)), tl.gonio_img.shape[1]))
    cos = np.abs(np.sum(np.asarray(js.n_light) * np.asarray(js.wi), -1))
    graze = (np.asarray(js.area_id) >= 0) & (cos < 1e-3)
    assert (~keep).mean() < 1e-3 and graze.mean() < 1e-2
    for f in ("wi", "select_pmf", "t_shadow", "n_light"):
        close(getattr(ts, f), getattr(js, f), what=f)
    close(ts.L, js.L, mask=keep, what="L")
    close(ts.pdf_dir, js.pdf_dir, mask=keep & ~graze, what="pdf_dir")
    valid = ts.valid.numpy()
    assert valid.mean() > 0.3
    # under the uniform table every light of the mix was picked and lit
    # some lane (the power table gives the environment nearly all lanes)
    for i in range(tl.n_lights if sampler == "uniform" else 0):
        assert (valid & (idx == i)).any(), i
        assert (ts.L.numpy()[valid & (idx == i)] > 0).any(), i


@pytest.mark.parametrize("kind", ["gonio", "proj"])
def test_image_scales_match_jax(kind):
    """``_gonio_scale`` and ``_proj_scale`` at random emission directions,
    each light of the mix; for projection lights about half the lanes lie
    outside the frustum (zero)."""
    jl, tl = both(kind)
    _, _, _, w = inputs(2)
    n = tl.n_gonio if kind == "gonio" else tl.n_proj
    li = np.random.default_rng(3).integers(0, n, N)
    fn = "_gonio_scale" if kind == "gonio" else "_proj_scale"
    got = getattr(tl, fn)(torch.from_numpy(li), torch.from_numpy(w)).numpy()
    want = np.asarray(getattr(jl, fn)(jnp.asarray(li), jnp.asarray(w)))
    if kind == "gonio":
        wl = np.einsum("nij,nj->ni", np.asarray(jl.gonio_r)[li], w)
        edge = edge_lanes(ea_square(wl / np.linalg.norm(wl, axis=-1,
                                                        keepdims=True)),
                          tl.gonio_img.shape[1])
    else:
        wl = np.einsum("nij,nj->ni", np.asarray(jl.proj_r)[li], w)
        z = np.where(np.abs(wl[:, 2]) < 1e-9, 1e-9, wl[:, 2])
        tanf = np.asarray(jl.proj_tan)[li]
        uv = 0.5 * (wl[:, :2] / z[:, None] / tanf[:, None] + 1.0)
        edge = edge_lanes(uv, np.asarray(jl.proj_img.shape[1:3])[::-1])
        inside = (wl[:, 2] > 0) & (uv >= 0).all(-1) & (uv < 1).all(-1)
        assert 0.1 < inside.mean() < 0.6 and (got[~inside] == 0).all()
    assert edge.mean() < 1e-3
    close(got, want, mask=~edge)
    assert (got > 0).any()


@pytest.mark.parametrize("sampler", ["uniform", "power", "bvh"])
def test_image_environment_matches_jax(sampler):
    """The equal-area image environment beside the other lights:
    ``sample_env_dir`` and ``env_pdf_dir`` (no selection pmf),
    ``le_escaped`` and ``pdf_li_escaped`` (with it, from the table or the
    BVH's share of the infinite lights)."""
    jl, tl = both("all", sampler)
    assert (tl.bvh is not None) == (sampler == "bvh")
    _, _, u2, w = inputs(4)
    jd, jL, jpdf = jl.sample_env_dir(jnp.asarray(u2))
    td, tL, tpdf = tl.sample_env_dir(torch.from_numpy(u2))
    close(td, jd, what="wl")
    exact(tL.numpy(), jL, "Le")
    close(tpdf, jpdf, what="pdf")
    assert (tL.numpy() > 0).any(-1).mean() > 0.99
    # the texel's pdf at a direction inside it
    edge = edge_lanes(ea_square(w), tl.env_img.shape[0])
    assert edge.mean() < 1e-3
    close(tl.env_pdf_dir(torch.from_numpy(w)),
          jl.env_pdf_dir(jnp.asarray(w)), mask=~edge)
    close(tl.le_escaped(torch.from_numpy(w)), jl.le_escaped(jnp.asarray(w)),
          mask=~edge)
    close(tl.pdf_li_escaped(torch.from_numpy(w)),
          jl.pdf_li_escaped(jnp.asarray(w)), mask=~edge)


@pytest.mark.parametrize("mix", ["all", "all_const_env", "area"])
def test_sample_le_matches_jax(mix):
    """Emitted rays of the finite lights (the environment left out): the
    origin, direction, throughput, normal and flags."""
    jl, tl = both(mix, "power")
    rs = np.random.default_rng(5)
    u_sel, u_side = rs.uniform(0, 1, (2, N)).astype(np.float32)
    u2a, u2b = rs.uniform(0, 1, (2, N, 2)).astype(np.float32)
    got = tl.sample_le(*tt(u_sel, u_side, u2a, u2b))
    want = jl.sample_le(*jt(u_sel, u_side, u2a, u2b))
    names = ("p", "d", "alpha", "n_light", "is_area", "valid", "alpha_pos")
    for name, g, w_ in zip(names, got, want):
        if np.asarray(w_).dtype == bool:
            exact(g.numpy(), w_, name)
    # the goniometric lanes' image lookups at the sampled direction
    keep = np.ones(N, bool)
    if tl.n_gonio:
        n_emit = tl.n_lights - 1
        cdf = np.cumsum(np.asarray(jl.select_pmf_table)[:n_emit]
                        / np.asarray(jl.select_pmf_table)[:n_emit].sum())
        idx = np.minimum((u_sel[:, None] >= cdf).sum(-1), n_emit - 1)
        gi = np.clip(idx - tl.base_gonio, 0, tl.n_gonio - 1)
        wl = np.einsum("nij,nj->ni", np.asarray(jl.gonio_r)[gi],
                       np.asarray(want[1]))
        on = (idx >= tl.base_gonio) & (idx < tl.base_proj)
        keep &= ~(on & edge_lanes(ea_square(wl / np.linalg.norm(
            wl, axis=-1, keepdims=True)), tl.gonio_img.shape[1]))
    assert keep.mean() > 0.999
    for name, g, w_ in zip(names, got, want):
        if np.asarray(w_).dtype != bool:
            close(g, w_, mask=keep, what=name)
    assert got[5].numpy().mean() > 0.9


def test_equal_area_maps_match_jax():
    """``equal_area_square_to_sphere`` on a grid and random points (unit
    vectors), its inverse round trip, and ``latlong_to_equal_area`` of
    2:1 images of heights 16 and 24 to squares of their own height."""
    rs = np.random.default_rng(6)
    p = np.concatenate([rs.uniform(0, 1, (N, 2)),
                        np.stack(np.meshgrid(np.linspace(0, 1, 17),
                                             np.linspace(0, 1, 17)),
                                 -1).reshape(-1, 2)]).astype(np.float32)
    d = tvm.equal_area_square_to_sphere(torch.from_numpy(p))
    close(d, jvm.equal_area_square_to_sphere(jnp.asarray(p)))
    close(torch.linalg.norm(d, dim=-1), np.ones(len(p), np.float32))
    inner = (np.abs(p - 0.5) < 0.499).all(-1)
    close(tvm.equal_area_sphere_to_square(d), p, atol=1e-5, mask=inner)
    for h in (16, 24):
        img = rs.uniform(0, 1, (h, 2 * h, 3)).astype(np.float32)
        got = envmap.latlong_to_equal_area(img)
        exact(got, jenvmap.latlong_to_equal_area(img), f"h={h}")
        assert got.shape == (h, h, 3)


def test_blackbody_and_colorspace_match_jax():
    """The blackbody reduced to RGB at five temperatures (float64 against
    the JAX package's float32 CIE fits: rtol 1e-5), Planck's law, and the
    colour-space helpers."""
    for T in (1000.0, 2700.0, 3200.0, 6500.0, 12000.0):
        got = spectrum.blackbody_normalized_rgb(T)
        want = jspectrum.blackbody_normalized_rgb(T)
        close(got, want)
        assert got.dtype == np.float64
    lam = np.linspace(360, 830, 50)
    close(spectrum.blackbody(lam, 5000.0), jspectrum.blackbody(lam, 5000.0),
          rtol=1e-12, atol=0)
    assert (spectrum.blackbody(lam, 0.0) == 0).all()
    x = np.random.default_rng(8).uniform(-0.1, 1.2, (64, 3)).astype(
        np.float32)
    close(colorspace.srgb_encode(x), jsrgb_encode(jnp.asarray(x)))
    close(colorspace.srgb_decode(x.clip(0, 1)),
          jsrgb_decode(jnp.asarray(x.clip(0, 1))))
    for dst in ("aces2065-1", "rec2020", "dci-p3"):
        close(colorspace.convert_rgb(x, "srgb", dst),
              jconvert_rgb(jnp.asarray(x), "srgb", dst))
