"""The port's hair fibres and measured BRDFs against the JAX package's on
the same numpy-seeded inputs: hair f, pdf and sample for smooth (the v <=
0.1 branch of Mp) and rough fibres with and without the scale tilt,
hair_sigma_a_from_reflectance, measured_f and the measured family's
bsdf_* on a random table bank, MERL files written here and read back by
both packages, and the non-slow cases of tests/test_measured.py.

Tolerances: hair f and pdf at given directions within 1e-4 relative or
1e-6 absolute on at least 0.999 of lanes, every lane within 1e-2: Mp's
log-Bessel series and the trimmed logistic chain exp, log, arctan2 and
arcsin, whose float32 results XLA and PyTorch round differently in the
last bit, and the exponent 1/v (up to 1e5) amplifies that. Hair samples:
the validity equal on every lane, wi within 1e-3 relative or 1e-5
absolute and f and pdf within 1e-4 relative or 1e-5 absolute on at least
0.99 of lanes (the sampled azimuth passes the trimmed logistic's
inverse). Measured f within 1e-5 relative or 1e-6 absolute on every lane
(a trilinear lookup; arccos and arctan2 only place the lookup). The
MERL tables bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vspg_pbrt_v4_tpu.models import materials as jm
from vspg_pbrt_v4_tpu_torch.models import materials as tm

from test_torch_guiding import _dirs
from test_torch_materials_ext import _frac_close

N = 4096

HAIR = {
    "rough": dict(type=8, albedo2=(0.42, 0.7, 1.4), eta=1.55, roughness=0.3,
                  roughness2=0.3, mix_amount=float(np.radians(2.0))),
    "smooth": dict(type=8, albedo2=(0.1, 0.2, 0.4), eta=1.55,
                   roughness=0.08, roughness2=0.2, mix_amount=0.0),
    "wide": dict(type=8, albedo2=(1.5, 1.5, 1.5), eta=1.4, roughness=0.8,
                 roughness2=0.6, mix_amount=float(np.radians(5.0))),
}


def _t(x):
    return torch.as_tensor(np.array(x))


def _hair_lanes(name, rng):
    uv = rng.uniform(0, 1, (N, 2)).astype(np.float32)
    mid = np.zeros(N, np.int32)
    tl = tm.Materials.build([HAIR[name]], device="cpu").gather_textured(
        None, _t(mid), _t(uv))
    jl = jm.Materials.build([HAIR[name]]).gather_textured(
        None, jnp.asarray(mid), jnp.asarray(uv))
    np.testing.assert_array_equal(tl.h.numpy(), np.asarray(jl.h))
    return tl, jl


@pytest.mark.parametrize("name", sorted(HAIR))
def test_hair_matches_jax(name):
    rng = np.random.default_rng(len(name))
    tl, jl = _hair_lanes(name, rng)
    wo, wi = _dirs(rng, N), _dirs(rng, N)
    for fn in ("bsdf_f", "bsdf_pdf"):
        t = getattr(tm, fn)(tl, _t(wo), _t(wi)).numpy()
        j = np.asarray(getattr(jm, fn)(jl, wo, wi))
        assert np.isfinite(t).all() and np.abs(j).max() > 0
        assert _frac_close(t, j, 1e-4, 1e-6) >= 0.999, fn
        np.testing.assert_allclose(t, j, rtol=1e-2, atol=1e-6, err_msg=fn)
    u = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    ts = tm.bsdf_sample(tl, _t(wo), _t(u[:, 0]), _t(u[:, 1:]))
    js = jm.bsdf_sample(jl, wo, u[:, 0], u[:, 1:])
    np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid))
    assert ts.valid.float().mean() > 0.9
    assert _frac_close(ts.wi.numpy(), js.wi, 1e-3, 1e-5) >= 0.99
    for f in ("f", "pdf"):
        assert _frac_close(getattr(ts, f).numpy(), getattr(js, f), 1e-4,
                           1e-5) >= 0.99, f


def test_hair_sigma_a_from_reflectance():
    for refl, beta_n in (((0.6, 0.4, 0.2), 0.3), ((0.05, 0.9, 0.5), 0.7)):
        np.testing.assert_array_equal(
            tm.hair_sigma_a_from_reflectance(refl, beta_n),
            jm.hair_sigma_a_from_reflectance(refl, beta_n))


def _bank(rng, k=2, res=(16, 8, 8)):
    return rng.uniform(0, 1, (k,) + res + (3,)).astype(np.float32)


def test_measured_matches_jax():
    """measured_f, and bsdf_f / bsdf_pdf / bsdf_sample of a measured row,
    on a two-table bank."""
    rng = np.random.default_rng(3)
    bank = _bank(rng)
    mats = [dict(type=10, meas_id=0), dict(type=10, meas_id=1)]
    mid = rng.integers(0, 2, N).astype(np.int32)
    tl = tm.Materials.build(mats, bank, device="cpu").gather(_t(mid))
    jl = jm.Materials.build(mats, bank).gather(jnp.asarray(mid))
    wo, wi = _dirs(rng, N), _dirs(rng, N)
    np.testing.assert_allclose(tm.measured_f(tl, _t(wo), _t(wi)).numpy(),
                               np.asarray(jm.measured_f(jl, wo, wi)),
                               rtol=1e-5, atol=1e-6)
    for fn in ("bsdf_f", "bsdf_pdf"):
        np.testing.assert_allclose(
            getattr(tm, fn)(tl, _t(wo), _t(wi)).numpy(),
            np.asarray(getattr(jm, fn)(jl, wo, wi)), rtol=1e-5, atol=1e-6,
            err_msg=fn)
    u = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    ts = tm.bsdf_sample(tl, _t(wo), _t(u[:, 0]), _t(u[:, 1:]))
    js = jm.bsdf_sample(jl, wo, u[:, 0], u[:, 1:])
    np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid))
    for f in ("wi", "f", "pdf"):
        assert _frac_close(getattr(ts, f).numpy(), getattr(js, f), 1e-4,
                           1e-5) >= 0.999, f


def test_measured_f_reciprocal():
    table = np.random.default_rng(0).uniform(
        0, 1, (1, 16, 8, 8, 3)).astype(np.float32)
    lanes = tm.Materials.build([dict(type=10, meas_id=0)], table,
                               device="cpu").gather(
        torch.zeros(64, dtype=torch.int32))
    rng = np.random.default_rng(1)

    def hemi(n):
        z = rng.uniform(0.05, 1, n)
        ph = rng.uniform(0, 2 * np.pi, n)
        r = np.sqrt(1 - z * z)
        return _t(np.stack([r * np.cos(ph), r * np.sin(ph), z], -1).astype(
            np.float32))

    wo, wi = hemi(64), hemi(64)
    np.testing.assert_allclose(tm.measured_f(lanes, wo, wi).numpy(),
                               tm.measured_f(lanes, wi, wo).numpy(),
                               rtol=1e-4, atol=1e-5)


def _write_merl(path, vals):
    with open(path, "wb") as f:
        f.write(np.asarray(vals.shape[1:], np.int32).tobytes())
        f.write(vals.astype(np.float64).tobytes())


@pytest.mark.parametrize("out_res", [(9, 9, 18), (32, 16, 16)])
def test_merl_roundtrip(tmp_path, out_res):
    """A synthetic MERL .binary written here, read by both packages at
    its own resolution and resampled to the default grid: the same table
    bit for bit, and at its own resolution the file's values."""
    vals = np.random.default_rng(2).uniform(0, 1, (3, 9, 9, 18))
    path = str(tmp_path / "synthetic.binary")
    _write_merl(path, vals)
    t = tm.load_merl_brdf(path, out_res=out_res)
    np.testing.assert_array_equal(t, jm.load_merl_brdf(path, out_res=out_res))
    assert t.shape == out_res + (3,) and t.dtype == np.float32
    if out_res == (9, 9, 18):
        expect = np.moveaxis(vals, 0, -1) * np.asarray(
            [1 / 1500, 1.15 / 1500, 1.66 / 1500])
        np.testing.assert_allclose(t, expect, rtol=1e-5)


def test_lambertian_table_matches_jax():
    np.testing.assert_array_equal(tm.make_lambertian_table((0.5, 0.6, 0.7)),
                                  jm.make_lambertian_table((0.5, 0.6, 0.7)))


def test_parser_measured_material(tmp_path):
    """Material "measured" from a scene text: the MERL table loads into
    the port's bank as into the JAX builder's, and a missing file warns
    and falls back to diffuse in both."""
    from vspg_pbrt_v4_tpu.scene import build_render_setup as jbuild
    from vspg_pbrt_v4_tpu.scene import parse_pbrt_string as jparse
    from vspg_pbrt_v4_tpu_torch.scene import build_render_setup as tbuild
    from vspg_pbrt_v4_tpu_torch.scene import parse_pbrt_string as tparse

    scales = np.asarray([1 / 1500, 1.15 / 1500, 1.66 / 1500])
    vals = np.empty((3, 9, 9, 18), np.float64)
    for c in range(3):
        vals[c] = (0.6 / np.pi) / scales[c]
    path = tmp_path / "lambert.binary"
    _write_merl(str(path), vals)
    body = ('Film "rgb" "integer xresolution" [8] "integer yresolution" '
            '[8]\nWorldBegin\nMaterial "measured" "string filename" '
            '["{}"]\nShape "sphere" "float radius" [1]\n')
    ts = tbuild(tparse(body.format(path)), device="cpu")
    js = jbuild(jparse(body.format(path)))
    mats = ts.scene.materials
    assert mats.mat_type.tolist() == [0, tm.MEASURED]
    assert int(mats.meas_id[1]) == 0
    np.testing.assert_array_equal(mats.meas_bank.numpy(),
                                  np.asarray(js.scene.materials.meas_bank))
    with pytest.warns(UserWarning, match="failed to load"):
        ts = tbuild(tparse(body.format(tmp_path / "missing.binary")),
                    device="cpu")
    assert ts.scene.materials.mat_type.tolist() == [0, 0]
    assert ts.scene.materials.meas_bank is None
