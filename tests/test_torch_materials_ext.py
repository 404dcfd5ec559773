"""The port's other material families (diffuse transmission, thin
dielectric, coated diffuse and conductor, mix and the rough dielectric)
against the JAX package's on the same numpy-seeded inputs, and the
non-slow cases of tests/test_materials_ext.py on the port.

Tolerances: bsdf_f and bsdf_pdf at given direction pairs within 2e-4
relative or 1e-6 absolute on every lane (both sides run the same float32
formulas; XLA contracts some products into FMAs, and the rough
dielectric's transmission term chains some 40 of them, up to 9e-5
relative). bsdf_sample: the specular, transmission and validity flags
equal on every lane, wi within 1e-3 relative or 1e-5 absolute on every
lane, f, pdf and eta within 1e-4 relative or 1e-5 absolute on at least
0.99 of lanes: a sampled direction passes through sin and cos of 2 pi u,
whose last bit XLA and PyTorch round differently, and the smooth
plastic's coat (alpha clamped to 0.01) turns that 1e-5 into up to 3e-3
of its f and pdf (0.6% of its lanes). The mix resolution's ids
exactly."""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vspg_pbrt_v4_tpu.models import materials as jm
from vspg_pbrt_v4_tpu_torch.models import materials as tm
from vspg_pbrt_v4_tpu_torch.utils.sampling import sample_uniform_sphere

from test_torch_guiding import _dirs

N = 4096

MATS = {
    "diffuse_trans": [dict(type=3, albedo=(0.6, 0.5, 0.4),
                           albedo2=(0.2, 0.3, 0.25))],
    "thin_dielectric": [dict(type=4, eta=1.5)],
    "coated_diffuse": [dict(type=5, albedo=(0.6, 0.3, 0.2), roughness=0.1,
                            eta=1.5)],
    "plastic_smooth": [dict(type=5, albedo=(0.6, 0.3, 0.2), roughness=0.0,
                            eta=1.4)],
    "coated_conductor": [dict(type=6, albedo=(0.9, 0.6, 0.3),
                              roughness=0.2, roughness2=0.05, eta=1.5)],
    "rough_dielectric": [dict(type=2, eta=1.5, roughness=0.3)],
    # lanes of a MIX row after resolution: a rough conductor or a coated
    # diffuse by the position hash
    "mix": [dict(type=1, albedo=(0.9, 0.7, 0.4), roughness=0.2),
            dict(type=5, albedo=(0.2, 0.5, 0.7), roughness=0.2),
            dict(type=7, mix_m1=0, mix_m2=1, mix_amount=0.4)],
}


def _t(x):
    return torch.as_tensor(np.array(x))


def _frac_close(t, j, rtol, atol):
    t, j = np.asarray(t), np.asarray(j)
    d = np.abs(t - j)
    ok = (d <= rtol * np.abs(j)) | (d <= atol)
    return ok.reshape(len(t), -1).all(-1).mean()


def _lanes(name, rng):
    mats = MATS[name]
    row = len(mats) - 1
    mid = np.full(N, row, np.int32)
    p = rng.uniform(-4, 4, (N, 3)).astype(np.float32)
    uv = rng.uniform(0, 1, (N, 2)).astype(np.float32)
    tl = tm.Materials.build(mats, device="cpu").gather_textured(
        None, _t(mid), _t(uv), _t(p))
    jl = jm.Materials.build(mats).gather_textured(
        None, jnp.asarray(mid), jnp.asarray(uv), jnp.asarray(p))
    return tl, jl


@pytest.mark.parametrize("fn", ["f", "pdf", "sample"])
@pytest.mark.parametrize("name", sorted(MATS))
def test_bsdf_matches_jax(name, fn):
    """bsdf_f / bsdf_pdf at random direction pairs (both hemispheres, a
    quarter mirror pairs), and bsdf_sample on random uniforms."""
    rng = np.random.default_rng(zlib.crc32(f"{name} {fn}".encode()))
    tl, jl = _lanes(name, rng)
    np.testing.assert_array_equal(tl.mat_type.numpy(),
                                  np.asarray(jl.mat_type))
    wo, wi = _dirs(rng, N), _dirs(rng, N)
    wi[: N // 4] = wo[: N // 4] * np.float32([-1, -1, 1])
    if fn in ("f", "pdf"):
        t = getattr(tm, "bsdf_" + fn)(tl, _t(wo), _t(wi)).numpy()
        j = np.asarray(getattr(jm, "bsdf_" + fn)(jl, wo, wi))
        np.testing.assert_allclose(t, j, rtol=2e-4, atol=1e-6)
        # the thin dielectric is delta only: f and pdf are 0 in both
        assert np.abs(j).max() > 0 or name == "thin_dielectric"
        return
    u = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    ts = tm.bsdf_sample(tl, _t(wo), _t(u[:, 0]), _t(u[:, 1:]))
    js = jm.bsdf_sample(jl, wo, u[:, 0], u[:, 1:])
    for f in ("is_specular", "is_transmission", "valid"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), f)
    assert ts.valid.float().mean() > 0.05
    np.testing.assert_allclose(ts.wi.numpy(), np.asarray(js.wi), rtol=1e-3,
                               atol=1e-5)
    for f in ("f", "pdf", "eta"):
        frac = _frac_close(getattr(ts, f).numpy(), getattr(js, f), 1e-4,
                           1e-5)
        assert frac >= 0.99, (f, frac)


def test_mix_resolution_ids_match_jax():
    """resolve_mix's constituent ids lane for lane: positions across
    |p| < 65536 (negative coordinates, the uint32 words' top bits),
    non-mix rows and mat_id -1 left alone; and the lanes gathered through
    a mix equal the JAX package's."""
    rng = np.random.default_rng(7)
    mats = MATS["mix"] + [dict(type=7, mix_m1=1, mix_m2=0, mix_amount=0.9)]
    mid = rng.integers(-1, 4, N).astype(np.int32)
    p = (rng.uniform(-1, 1, (N, 3)) * 10.0 ** rng.integers(-3, 5, (N, 1))
         ).astype(np.float32)
    p[:8] = [[65535.0, -65535.5, 0.0]] * 8
    tmats = tm.Materials.build(mats, device="cpu")
    jmats = jm.Materials.build(mats)
    t = tmats.resolve_mix(_t(mid), _t(p)).numpy()
    j = np.asarray(jmats.resolve_mix(jnp.asarray(mid), jnp.asarray(p)))
    np.testing.assert_array_equal(t, j)
    assert set(np.unique(t[mid >= 2])) == {0, 1}
    np.testing.assert_array_equal(t[mid < 2], mid[mid < 2])
    tl = tmats.gather(_t(mid), _t(p))
    jl = jmats.gather(jnp.asarray(mid), jnp.asarray(p))
    for f in ("mat_type", "albedo", "roughness", "eta"):
        np.testing.assert_array_equal(getattr(tl, f).numpy(),
                                      np.asarray(getattr(jl, f)), f)


def test_mix_resolution_statistics():
    """A 0.3 mix picks its first constituent in 30% of 100k positions,
    the same one every time at a position."""
    mats = tm.Materials.build([
        dict(type=0, albedo=(1, 0, 0)), dict(type=0, albedo=(0, 1, 0)),
        dict(type=7, mix_m1=0, mix_m2=1, mix_amount=0.3)], device="cpu")
    n = 100_000
    p = _t(np.random.default_rng(2).uniform(-10, 10, (n, 3)).astype(
        np.float32))
    mid = mats.resolve_mix(torch.full((n,), 2, dtype=torch.int32), p)
    assert set(mid.unique().tolist()) == {0, 1}
    assert abs(float((mid == 0).float().mean()) - 0.3) < 0.01
    assert torch.equal(mid, mats.resolve_mix(
        torch.full((n,), 2, dtype=torch.int32), p))


def _rho_two_ways(mtype, wo_z=0.6, n=200_000, seed=0, **kw):
    """Hemispherical reflectance by BSDF sampling (f cos / pdf) and by
    uniform-sphere Monte Carlo of f cos: they agree when sample, pdf and
    f are consistent (the reference's bsdfs_test.cpp idiom)."""
    gen = torch.Generator().manual_seed(seed)
    lanes = tm.Materials.build([dict(type=mtype, **kw)], device="cpu").gather(
        torch.zeros(n, dtype=torch.int32))
    s = float(np.sqrt(1 - wo_z ** 2))
    wo = torch.tensor([[s, 0.0, wo_z]]).expand(n, 3)
    bs = tm.bsdf_sample(lanes, wo, torch.rand(n, generator=gen),
                        torch.rand(n, 2, generator=gen))
    ok = bs.valid & (bs.pdf > 0) & ~bs.is_specular
    w = torch.where(ok[:, None], bs.f * torch.abs(bs.wi[:, 2:3])
                    / torch.clamp(bs.pdf, min=1e-30)[:, None], 0.0)
    wi_u = sample_uniform_sphere(torch.rand(n, 2, generator=gen))
    f = tm.bsdf_f(lanes, wo, wi_u)
    return (w.mean(0).numpy(),
            (f * torch.abs(wi_u[:, 2:3]) * (4 * np.pi)).mean(0).numpy())


@pytest.mark.parametrize("mtype,kw", [
    (tm.COATED_CONDUCTOR, dict(albedo=(0.9, 0.7, 0.4), roughness=0.3,
                               roughness2=0.1, eta=1.5)),
    (tm.COATED_DIFFUSE, dict(albedo=(0.8, 0.6, 0.4), roughness=0.2,
                             eta=1.5)),
    (tm.COOK_TORRANCE, dict(albedo=(0.8, 0.5, 0.3), roughness=0.2, eta=1.5)),
])
def test_sample_pdf_consistent(mtype, kw):
    a, b = _rho_two_ways(mtype, seed=mtype, **kw)
    assert np.all(np.abs(a - b) < 0.02 + 0.05 * b), (a, b)
    assert np.all(a <= 1.01), a  # energy conservation


@pytest.mark.parametrize("mtype,kw", [
    (tm.COATED_DIFFUSE, dict(albedo=(0.7, 0.5, 0.3), roughness=0.15,
                             eta=1.4)),
    (tm.COOK_TORRANCE, dict(albedo=(0.7, 0.5, 0.3), roughness=0.1,
                            eta=1.5)),
])
def test_reciprocity(mtype, kw):
    """f(wo, wi) = f(wi, wo) on 1000 pairs in the upper hemisphere."""
    n = 1000
    rng = np.random.default_rng(7)
    lanes = tm.Materials.build([dict(type=mtype, **kw)], device="cpu").gather(
        torch.zeros(n, dtype=torch.int32))
    wo, wi = _dirs(rng, n), _dirs(rng, n)
    for w in (wo, wi):
        w[:, 2] = np.abs(w[:, 2]) + 0.05
        w /= np.linalg.norm(w, axis=-1, keepdims=True)
    f_ab = tm.bsdf_f(lanes, _t(wo), _t(wi)).numpy()
    f_ba = tm.bsdf_f(lanes, _t(wi), _t(wo)).numpy()
    assert np.isfinite(f_ab).all()
    np.testing.assert_allclose(f_ab, f_ba, rtol=1e-4, atol=1e-6)


def test_cooktorrance_parser():
    """Material "cooktorrance" parses through the port's builder."""
    from vspg_pbrt_v4_tpu_torch.scene import (build_render_setup,
                                              parse_pbrt_string)

    setup = build_render_setup(parse_pbrt_string("""
    Camera "perspective" "float fov" [40]
    Film "rgb" "integer xresolution" [16] "integer yresolution" [16]
    WorldBegin
    Material "cooktorrance" "rgb reflectance" [0.6 0.4 0.2]
        "float roughness" [0.2] "float eta" [1.4]
    Shape "sphere" "float radius" [1]
    LightSource "infinite" "rgb L" [0.5 0.5 0.5]
    """), device="cpu")
    mats = setup.scene.materials
    assert mats.mat_type.tolist() == [0, tm.COOK_TORRANCE]
    assert abs(float(mats.eta[1]) - 1.4) < 1e-6
    assert abs(float(mats.roughness[1]) - 0.2) < 1e-6
