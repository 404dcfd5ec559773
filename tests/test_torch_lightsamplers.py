"""The BVH light sampler of the port (``models/lightsamplers.py``) against
the JAX package's: ``build_light_bvh``'s arrays equal (topology and bit
trails exactly), ``bvh_select`` and ``bvh_pmf`` at 4096 points, the pmf
summing to one over the lights, and ``Lights`` under ``sampler="bvh"``
(``sample``'s top level between the infinite lights and the tree,
``pdf_li_area``, ``pdf_li_escaped``) lane for lane, with
``convert.from_jax`` carrying the tree.

Tolerance: pmfs within rtol 1e-5 on 99.9% of the lanes and within 1e-3
on every lane. ``_importance`` takes the arccos of a cosine that the two
packages may round an ulp apart; near cos = 1 an ulp (6e-8) moves the
angle by up to 3.5e-4, which moves a branch's share by up to that much
relative. Light indices are exact, except on lanes whose uniform lies
within 1e-6 of a branch edge (JAX's own pick moves when u moves by 1e-6),
which must be under 0.5% of the lanes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vspg_pbrt_v4_tpu.models import lightsamplers as jls
from vspg_pbrt_v4_tpu.models.lights import Lights as JLights
from vspg_pbrt_v4_tpu_torch.convert import _lights as convert_lights
from vspg_pbrt_v4_tpu_torch.models import lightsamplers as tls
from vspg_pbrt_v4_tpu_torch.models.lights import Lights

N = 4096
_RS = np.random.default_rng(11)


def _area(n):
    """n small emissive triangles on the ceiling (y = 2, facing down) and
    a few two-sided ones on a wall."""
    c = _RS.uniform((-1, 1.95, -1), (1, 2.0, 1), (n, 3))
    tris = []
    for i, ci in enumerate(c):
        e = _RS.uniform(0.02, 0.08, 2)
        wall = i % 7 == 0
        p0 = ci if not wall else np.array([1.0, ci[1] - 1.2, ci[2]])
        p1 = p0 + ((e[0], 0, 0) if not wall else (0, e[0], 0))
        p2 = p0 + (0, 0, e[1])
        tris.append(dict(p0=tuple(p0), p1=tuple(p1), p2=tuple(p2),
                         L=tuple(_RS.uniform(20.0, 200.0, 3)), twosided=wall))
    return tris


def _rot():
    q = np.linalg.qr(_RS.normal(size=(3, 3)))[0]
    return q * np.sign(np.linalg.det(q))


MANY = dict(
    point_p=_RS.uniform((-1, 0.2, -1), (1, 1.8, 1), (6, 3)).tolist(),
    point_I=_RS.uniform(0.05, 0.3, (6, 3)).tolist(),
    spots=[dict(p=(0.2, 1.9, -0.3), I=(6.0, 5.0, 4.0), dir=(0, -1, 0.1)),
           dict(p=(-0.9, 1.0, 0.8), I=(3.0, 3.0, 3.0), dir=(1, -0.2, -1),
                cos_total=0.5, cos_start=0.7)],
    gonios=[dict(p=(0.7, 1.5, 0.7), I=(2.0, 2.0, 2.0),
                 img=_RS.uniform(0.2, 1.0, (8, 8, 3)).astype(np.float32),
                 rot=_rot())],
    projections=[dict(p=(-0.3, 1.7, 0.5), I=(3.0, 3.0, 3.0),
                      img=_RS.uniform(0.2, 1.0, (8, 8, 3)).astype(np.float32),
                      fov_deg=60.0, rot=_rot())],
    area_tris=_area(48))
INFINITE = {"none": {},
            "distant+env": dict(distant_dir=[(0.2, -1, 0.3)],
                                distant_L=[(0.5, 0.5, 0.5)],
                                env_L=(0.1, 0.12, 0.15), world_radius=50.0)}


@pytest.fixture(scope="module", params=sorted(INFINITE))
def lights(request):
    kw = dict(MANY, **INFINITE[request.param], sampler="bvh")
    return JLights.make(**kw), Lights.make(**kw, device="cpu")


def _points(seed, n=N):
    rs = np.random.default_rng(seed)
    p = rs.uniform((-1.2, -0.2, -1.2), (1.2, 2.2, 1.2), (n, 3))
    return p.astype(np.float32), rs.uniform(0, 1, n).astype(np.float32)


def pmf_close(got, want, mask=None):
    """rtol 1e-5 on 99.9% of the lanes, 1e-3 on all (module docstring)."""
    got, want = np.asarray(got), np.asarray(want)
    if mask is not None:
        got, want = got[mask], want[mask]
    err = np.abs(got - want)
    assert (err <= 1e-5 * np.abs(want) + 1e-7).mean() >= 0.999
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-7)


def _edges(fn, p, u, eps=1e-6):
    """Lanes whose pick `fn(p, u)` (JAX) moves when u moves by eps."""
    lo = np.asarray(fn(jnp.asarray(p), jnp.asarray(np.clip(u - eps, 0, 1))))
    hi = np.asarray(fn(jnp.asarray(p), jnp.asarray(np.clip(u + eps, 0, 1))))
    return lo != hi


def test_build_matches_jax(lights):
    jl, tl = lights
    jb, tb = jl.bvh, tl.bvh
    L = 6 + 2 + 1 + 1 + 48
    assert tb.max_depth == jb.max_depth and tb.bmin.shape[0] == 2 * L - 1
    for f in ("bmin", "bmax", "axis", "phi", "cos_o", "cos_e", "two_sided",
              "child1", "leaf_light", "trail", "trail_node"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    assert tb.trail.dtype == torch.int64
    # every finite light is a leaf once; the infinite ones are not in it
    leaves = tb.leaf_light.numpy()
    finite = sorted(leaves[leaves >= 0])
    assert finite == list(range(tl.base_distant)) + list(
        range(tl.base_area, tl.base_area + tl.n_area))
    assert tls.build_light_bvh(Lights.make(env_L=(1, 1, 1),
                                           device="cpu")) is None


def test_select_and_pmf_match_jax(lights):
    """``bvh_select`` (index, pmf, remaining u) and ``bvh_pmf`` at the
    picked and at random lights."""
    jl, tl = lights
    p, u = _points(1)
    ji, jp, ju = jls.bvh_select(jl.bvh, jnp.asarray(p), jnp.asarray(u))
    ti, tp, tu = tls.bvh_select(tl.bvh, torch.from_numpy(p),
                                torch.from_numpy(u))
    edge = _edges(lambda a, b: jls.bvh_select(jl.bvh, a, b)[0], p, u)
    assert edge.mean() < 5e-3
    keep = ~edge
    np.testing.assert_array_equal(ti.numpy()[keep], np.asarray(ji)[keep])
    pmf_close(tp, jp, keep)
    # each level divides u by the branch's probability, so the remaining
    # u carries an ulp's difference times 1 / pmf
    bar = 1e-6 / np.maximum(np.asarray(jp), 1e-6)
    assert (np.abs(tu.numpy() - np.asarray(ju))[keep] <= bar[keep]).all()
    assert len(np.unique(ti.numpy())) > 40 and (tp.numpy() > 0).mean() > 0.9
    # the pmf of the picked light replays its trail to the same value
    np.testing.assert_allclose(
        tls.bvh_pmf(tl.bvh, torch.from_numpy(p), ti).numpy()[ti.numpy() >= 0],
        tp.numpy()[ti.numpy() >= 0], rtol=1e-5, atol=1e-7)
    gl = np.random.default_rng(2).integers(-1, tl.n_lights, N)
    pmf_close(tls.bvh_pmf(tl.bvh, torch.from_numpy(p), torch.from_numpy(gl)),
              jls.bvh_pmf(jl.bvh, jnp.asarray(p), jnp.asarray(gl)))


def test_pmf_sums_to_one(lights):
    """Over every finite light the pmf sums to one at 256 points in the
    room. Above the ceiling the down-facing lights have no importance, and
    the descents that enter a subtree whose children both vanish die (pmf
    0, index -1, in both packages): there the sum is the share of 4096
    stratified uniforms whose descent lives."""
    _, tl = lights
    finite = [i for i in range(tl.n_lights)
              if i < tl.base_distant or tl.base_area <= i
              < tl.base_area + tl.n_area]

    def total(p):
        pt = torch.from_numpy(p)
        return sum(tls.bvh_pmf(tl.bvh, pt, torch.full((len(p),), i))
                   for i in finite).numpy()

    p, _ = _points(3, 256)
    p[:, 1] = 0.1 + 1.8 * (p[:, 1] + 0.2) / 2.4  # y in [0.1, 1.9]
    np.testing.assert_allclose(total(p), 1.0, rtol=0, atol=1e-5)
    above = np.random.default_rng(8).uniform((-1, 2.05, -1), (1, 2.3, 1),
                                             (8, 3)).astype(np.float32)
    u = (np.arange(4096, dtype=np.float32) + 0.5) / 4096
    idx, _, _ = tls.bvh_select(tl.bvh, torch.from_numpy(np.repeat(above, 4096,
                                                                  0)),
                               torch.from_numpy(np.tile(u, 8)))
    lives = (idx.numpy().reshape(8, 4096) >= 0).mean(1)
    want = total(above)
    assert (want < 0.99).any()
    np.testing.assert_allclose(lives, want, rtol=0, atol=2e-3)
    # the infinite lights have no leaf: pmf 0
    pt = torch.from_numpy(p)
    for i in range(tl.base_distant, tl.base_area):
        assert (tls.bvh_pmf(tl.bvh, pt, torch.full((256,), i)) == 0).all()


def test_lights_under_bvh_match_jax(lights):
    """``Lights.sample`` under the BVH sampler (the infinite lights picked
    uniformly with probability n_inf/(n_inf+1)), ``pdf_li_area`` through
    ``bvh_pmf`` and ``pdf_li_escaped``'s share, lane for lane; and
    ``convert.from_jax``'s lights carry the tree."""
    jl, tl = lights
    p, u = _points(4)
    u2 = np.random.default_rng(5).uniform(0, 1, (N, 2)).astype(np.float32)
    js = jl.sample(jnp.asarray(p), jnp.asarray(u), jnp.asarray(u2))
    ts = tl.sample(torch.from_numpy(p), torch.from_numpy(u),
                   torch.from_numpy(u2))
    edge = _edges(lambda a, b: jl.sample(a, b, jnp.asarray(u2)).light_idx,
                  p, u)
    assert edge.mean() < 5e-3
    keep = ~edge
    for f in ("light_idx", "area_id", "is_delta", "valid"):
        np.testing.assert_array_equal(getattr(ts, f).numpy()[keep],
                                      np.asarray(getattr(js, f))[keep],
                                      err_msg=f)
    for f in ("wi", "t_shadow", "L"):
        np.testing.assert_allclose(getattr(ts, f).numpy()[keep],
                                   np.asarray(getattr(js, f))[keep],
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    pmf_close(ts.select_pmf, js.select_pmf, keep)
    ok = keep & (np.abs(np.sum(np.asarray(js.n_light) * np.asarray(js.wi),
                               -1)) > 1e-3)
    ok |= keep & (np.asarray(js.area_id) < 0)
    np.testing.assert_allclose(ts.pdf_dir.numpy()[ok],
                               np.asarray(js.pdf_dir)[ok], rtol=1e-5,
                               atol=1e-6)
    if tl.n_infinite:
        picked = ts.light_idx.numpy()
        inf = (picked >= tl.base_distant) & (picked < tl.base_area)
        inf |= picked == tl.n_lights - 1
        share = tl.n_infinite / (tl.n_infinite + 1.0)
        assert abs(inf.mean() - share) < 0.03
    # pdf_li_area at points on the area lights, from the reference points
    lid = np.random.default_rng(6).integers(-1, tl.n_area, N)
    ai = np.clip(lid, 0, tl.n_area - 1)
    b = np.random.default_rng(7).dirichlet((1, 1, 1), N).astype(np.float32)
    p_hit = (b[:, :1] * tl.area_p0.numpy()[ai] + b[:, 1:2]
             * tl.area_p1.numpy()[ai] + b[:, 2:] * tl.area_p2.numpy()[ai])
    n_hit = np.cross(tl.area_p1.numpy()[ai] - tl.area_p0.numpy()[ai],
                     tl.area_p2.numpy()[ai] - tl.area_p0.numpy()[ai])
    n_hit = (n_hit / np.linalg.norm(n_hit, axis=-1, keepdims=True)).astype(
        np.float32)
    args = (lid.astype(np.int32), p, p_hit.astype(np.float32), n_hit)
    to_h = p_hit - p
    cos = np.abs(np.sum(n_hit * to_h, -1)) / np.linalg.norm(to_h, axis=-1)
    # the pdf divides by |cos| at the light: grazing lanes are left out
    got = tl.pdf_li_area(*(torch.from_numpy(a) for a in args)).numpy()
    want = np.asarray(jl.pdf_li_area(*(jnp.asarray(a) for a in args)))
    assert (cos < 1e-3).mean() < 1e-2 and (got > 0).mean() > 0.5
    pmf_close(got, want, cos >= 1e-3)
    d = -n_hit
    np.testing.assert_allclose(
        tl.pdf_li_escaped(torch.from_numpy(d), torch.from_numpy(p)).numpy(),
        np.asarray(jl.pdf_li_escaped(jnp.asarray(d), jnp.asarray(p))),
        rtol=1e-6, atol=0)
    conv = convert_lights(jl, "cpu")
    for f in ("bmin", "phi", "child1", "trail", "trail_node"):
        np.testing.assert_array_equal(getattr(conv.bvh, f).numpy(),
                                      getattr(tl.bvh, f).numpy(), err_msg=f)
    assert conv.bvh.max_depth == tl.bvh.max_depth
