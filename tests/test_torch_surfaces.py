"""The surface modules of the port against the JAX package's on the same
numpy-seeded inputs: ray_triangle and the brute-force triangle
intersection, the BSDFs of the teaser materials (diffuse, smooth and rough
conductor, smooth dielectric, CookTorrance), the checker texture and the
surface half of the guiding field.

Tolerances: intersection ids and hit flags exactly; ray_triangle 1e-6
relative, 1e-6 absolute; the hit record's floats 1e-5 (both sides run the
same float32 formulas, XLA contracting some into FMAs, which moves the
interpolated uv by up to 8e-6); BSDF values 1e-5 relative, BSDF samples
1e-4; the guiding product 2e-5, as
for ``product_with_vmf`` in tests/test_torch_guiding.py."""

import dataclasses
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vspg_pbrt_v4_tpu.models import materials as jm
from vspg_pbrt_v4_tpu.models import textures as jtex
from vspg_pbrt_v4_tpu.models.guiding import field as jfield
from vspg_pbrt_v4_tpu.models.shapes import Geometry as JGeometry
from vspg_pbrt_v4_tpu.ops import intersect as jis
from vspg_pbrt_v4_tpu_torch.convert import field_from_jax
from vspg_pbrt_v4_tpu_torch.models import materials as tm
from vspg_pbrt_v4_tpu_torch.models import textures as ttex
from vspg_pbrt_v4_tpu_torch.models.guiding import field as tfield
from vspg_pbrt_v4_tpu_torch.models.shapes import Geometry as TGeometry
from vspg_pbrt_v4_tpu_torch.ops import intersect as tis

from test_torch_guiding import _dirs, _jax_trained_field

N = 2048


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(t, j, rtol, atol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)


def _tris(rng, n=24):
    c = rng.uniform(-0.8, 0.8, (n, 1, 3))
    v = (c + rng.uniform(-0.4, 0.4, (n, 3, 3))).astype(np.float32)
    return [dict(p0=v[i, 0], p1=v[i, 1], p2=v[i, 2], mat=i % 3,
                 med_in=-1, med_out=0, uv0=(0.1 * i, 0.5), uv1=(1.0, 0.2),
                 uv2=(0.3, 0.9)) for i in range(n)]


def _rays(rng, tris=None):
    """Rays from around the box; with `tris`, from inside it (outside, the
    box face is the closest hit), three in four aimed near a random
    triangle's centroid."""
    o = rng.uniform(-2.5, 2.5, (N, 3)).astype(np.float32)
    if tris is not None:
        o = o * np.float32(0.38)
    tgt = rng.uniform(-0.8, 0.8, (N, 3)).astype(np.float32)
    if tris is not None:
        c = np.stack([(t["p0"] + t["p1"] + t["p2"]) / 3 for t in tris])
        pick = rng.integers(0, len(tris), N)
        aim = rng.uniform(0, 1, N) < 0.75
        tgt[aim] = c[pick[aim]] + rng.uniform(-0.05, 0.05, (aim.sum(), 3))
    d = tgt - o
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
        np.float32)


def test_ray_triangle_matches_jax():
    rng = np.random.default_rng(1)
    o, d = _rays(rng)
    tri = _tris(rng, 1)[0]
    p = [np.broadcast_to(tri[k], (N, 3)) for k in ("p0", "p1", "p2")]
    t_max = np.full(N, np.inf, np.float32)
    t_max[::5] = 2.0
    th = tis.ray_triangle(_t(o), _t(d), _t(t_max), *(_t(x) for x in p))
    jh = jis.ray_triangle(o, d, t_max, *p)
    m = th[0].numpy()
    np.testing.assert_array_equal(m, np.asarray(jh[0]))
    assert m.any()
    for a, b in zip(th[1:4], jh[1:4]):  # t, b0, b1 where the ray hits
        _close(a[m], np.asarray(b)[m], 1e-6, 1e-6)
    _close(th[4], jh[4], 1e-6, 1e-6)


BOX = [dict(bmin=(-1, -1, -1), bmax=(1, 1, 1), mat=-1, light=-1, med_in=0,
            med_out=-1)]


def test_intersect_matches_jax():
    """Brute-force closest hit over triangles and a box: every field of
    the hit record, and intersect_p's occlusion."""
    rng = np.random.default_rng(2)
    tris = _tris(rng)
    o, d = _rays(rng, tris)
    tg = TGeometry.build(BOX, tris, device="cpu")
    jg = JGeometry.build(triangles=tris, boxes=BOX)
    th = tg.intersect(_t(o), _t(d))
    jh = jg.intersect(jnp.asarray(o), jnp.asarray(d), jnp.full(N, jnp.inf))
    for f in ("hit", "mat_id", "light_id", "med_in", "med_out", "prim_id"):
        np.testing.assert_array_equal(getattr(th, f).numpy(),
                                      np.asarray(getattr(jh, f)))
    m = th.hit.numpy()
    assert ((th.prim_id.numpy() >= 0) & (th.prim_id.numpy() < len(tris))).sum() > N // 4
    for f in ("t", "p", "n", "ns", "uv"):
        _close(getattr(th, f)[m], np.asarray(getattr(jh, f))[m], 1e-5, 1e-5)
    t_max = rng.uniform(0.5, 4.0, N).astype(np.float32)
    np.testing.assert_array_equal(
        tg.intersect_p(_t(o), _t(d), _t(t_max)).numpy(),
        np.asarray(jg.intersect_p(o, d, t_max)))


def test_more_than_64_triangles_raise(monkeypatch):
    """65 triangles, one past brute force's limit: the geometry builds a
    BVH, whose closest hit and occlusion equal brute force's exactly (and
    the JAX package's, which builds the same tree); without the tree the
    brute force raises."""
    from vspg_pbrt_v4_tpu_torch.models import shapes as tshapes

    rng = np.random.default_rng(3)
    tris = _tris(rng, 65)
    tg = TGeometry.build(BOX, tris, device="cpu")
    jg = JGeometry.build(triangles=tris, boxes=BOX)
    assert tg.tri_bvh is not None and jg.tri_bvh is not None
    o, d = _rays(rng, tris)
    th = tg.intersect(_t(o), _t(d))
    jh = jg.intersect(jnp.asarray(o), jnp.asarray(d), jnp.full(N, jnp.inf))
    brute = dataclasses.replace(tg, tri_bvh=None)
    with pytest.raises(NotImplementedError):
        brute.intersect(_t(o), _t(d))
    monkeypatch.setattr(tshapes, "MAX_BRUTE_TRIS", 65)
    bh = brute.intersect(_t(o), _t(d))
    assert ((th.prim_id >= 0) & (th.prim_id < 65)).sum() > N // 4
    for f in ("hit", "t", "p", "n", "ns", "uv", "mat_id", "med_in",
              "med_out", "prim_id"):
        assert torch.equal(getattr(th, f), getattr(bh, f)), f
    for f in ("hit", "prim_id", "mat_id"):
        np.testing.assert_array_equal(getattr(th, f).numpy(),
                                      np.asarray(getattr(jh, f)))
    t_max = rng.uniform(0.5, 4.0, N).astype(np.float32)
    occ = tg.intersect_p(_t(o), _t(d), _t(t_max))
    assert torch.equal(occ, brute.intersect_p(_t(o), _t(d), _t(t_max)))
    np.testing.assert_array_equal(occ.numpy(),
                                  np.asarray(jg.intersect_p(o, d, t_max)))


MATS = {
    "diffuse": dict(type=0, albedo=(0.7, 0.4, 0.2)),
    "conductor": dict(type=1, albedo=(0.9, 0.7, 0.4), roughness=0.0),
    "rough_conductor": dict(type=1, albedo=(0.9, 0.7, 0.4), roughness=0.25),
    "dielectric": dict(type=2, eta=1.5, roughness=0.0),
    "cook_torrance": dict(type=11, albedo=(0.65, 0.3, 0.2), eta=1.5,
                          roughness=0.3),
}


def _lanes(name, n=N):
    mats = [MATS[name]]
    tl = tm.Materials.build(mats, device="cpu").gather(
        torch.zeros(n, dtype=torch.int32))
    jl = jm.Materials.build(mats).gather(jnp.zeros(n, jnp.int32))
    return tl, jl


@pytest.mark.parametrize("fn", ["f", "pdf", "sample"])
@pytest.mark.parametrize("name", sorted(MATS))
def test_bsdf_matches_jax(name, fn):
    """bsdf_f / bsdf_pdf at random direction pairs (both hemispheres), and
    bsdf_sample on random uniforms, per material kind."""
    rng = np.random.default_rng(zlib.crc32(f"{name} {fn}".encode()))
    tl, jl = _lanes(name)
    wo, wi = _dirs(rng, N), _dirs(rng, N)
    wi[: N // 4] = wo[: N // 4] * np.float32([-1, -1, 1])  # mirror pairs
    if fn == "f":
        _close(tm.bsdf_f(tl, _t(wo), _t(wi)), jm.bsdf_f(jl, wo, wi), 1e-5,
               1e-6)
    elif fn == "pdf":
        _close(tm.bsdf_pdf(tl, _t(wo), _t(wi)), jm.bsdf_pdf(jl, wo, wi),
               1e-5, 1e-6)
    else:
        u = rng.uniform(0, 1, (N, 3)).astype(np.float32)
        ts = tm.bsdf_sample(tl, _t(wo), _t(u[:, 0]), _t(u[:, 1:]))
        js = jm.bsdf_sample(jl, wo, u[:, 0], u[:, 1:])
        for f in ("is_specular", "is_transmission", "valid"):
            np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                          np.asarray(getattr(js, f)))
        assert ts.valid.any()
        # a sampled direction passes through sin and cos of 2 pi u, whose
        # last bit XLA and PyTorch round differently; grazing lobes amplify
        # it to ~4e-5 relative
        for f in ("wi", "f", "pdf", "eta"):
            _close(getattr(ts, f), getattr(js, f), 1e-4, 1e-5)


def test_unported_materials_raise():
    """What the port once refused, a rough dielectric, a coated diffuse
    row and an image texture, now builds: the gathered lanes equal the JAX
    package's field for field, and the image albedo within 1e-6 (the test
    keeps its name from the refusals it held)."""
    rng = np.random.default_rng(6)
    mats = [dict(type=2, eta=1.5, roughness=0.2),
            dict(type=5, albedo=(1.0, 1.0, 1.0), roughness=0.1, albedo_tex=0)]
    texs = [dict(kind=2, image_id=0, uvscale=(2.0, 3.0))]
    img = [rng.uniform(0, 1, (6, 5, 3)).astype(np.float32)]
    mid = rng.integers(-1, 2, N).astype(np.int32)
    uv = rng.uniform(-1.5, 1.5, (N, 2)).astype(np.float32)
    tl = tm.Materials.build(mats, device="cpu").gather_textured(
        ttex.Textures.build(texs, img, device="cpu"), _t(mid), _t(uv))
    jl = jm.Materials.build(mats).gather_textured(
        jtex.Textures.build(texs, img), jnp.asarray(mid), jnp.asarray(uv))
    for f in ("mat_type", "eta", "roughness", "roughness2", "albedo2"):
        np.testing.assert_array_equal(getattr(tl, f).numpy(),
                                      np.asarray(getattr(jl, f)), f)
    _close(tl.albedo, jl.albedo, 1e-6, 1e-6)
    assert tl.kinds == {2, 5, tm.ROUGH_DIELECTRIC}


def test_checker_texture_matches_jax():
    """The checker albedo at the hit uv through gather_textured, over a
    checker, a constant and an untextured material."""
    rng = np.random.default_rng(4)
    texs = [dict(kind=1, c0=(0.9, 0.1, 0.1), c1=(0.1, 0.8, 0.2),
                 uvscale=(6.0, 4.0)),
            dict(kind=0, c0=(0.3, 0.3, 0.5))]
    mats = [dict(type=0, albedo=(0.5, 0.5, 0.5), albedo_tex=0),
            dict(type=11, albedo=(0.2, 0.2, 0.2), albedo_tex=1, roughness=0.3),
            dict(type=0, albedo=(0.7, 0.4, 0.2))]
    mid = rng.integers(-1, 3, N).astype(np.int32)
    uv = rng.uniform(-1.5, 1.5, (N, 2)).astype(np.float32)
    tl = tm.Materials.build(mats, device="cpu").gather_textured(
        ttex.Textures.build(texs, device="cpu"), _t(mid), _t(uv))
    jl = jm.Materials.build(mats).gather_textured(
        jtex.Textures.build(texs), jnp.asarray(mid), jnp.asarray(uv))
    np.testing.assert_array_equal(tl.albedo.numpy(), np.asarray(jl.albedo))
    np.testing.assert_array_equal(tl.mat_type.numpy(),
                                  np.asarray(jl.mat_type))


@pytest.mark.parametrize("cosine", [True, False])
def test_surface_distribution_matches_jax(cosine):
    jf = _jax_trained_field()
    tf = field_from_jax(jf, "cpu")
    rng = np.random.default_rng(5)
    n = 96
    p = rng.uniform(-1.09, 1.09, (n, 3)).astype(np.float32)
    ns, wi = _dirs(rng, n), _dirs(rng, n)
    td = tfield.surface_distribution(tf, _t(p), _t(ns), cosine)
    jd = jfield.surface_distribution(jf, p, ns, cosine)
    for f in ("weights", "mu", "kappa", "vsp", "flux"):
        _close(getattr(td, f), getattr(jd, f), 2e-5, 1e-5)
    np.testing.assert_array_equal(td.valid.numpy(), np.asarray(jd.valid))
    assert td.valid.any()
    _close(tfield.dist_pdf(td, _t(wi)), jfield.dist_pdf(jd, wi), 2e-5, 1e-5)
